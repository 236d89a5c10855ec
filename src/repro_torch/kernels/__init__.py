"""Hand-written Hopper kernels and what they share: device resolution and
the build of their CUDA sources (``_build``).

Every kernel module follows one layout: ``ref.py`` holds the plain
PyTorch version, ``ops.py`` the public wrapper, ``csrc/<name>.cu`` the
CUDA C++ kernel.  A wrapper chooses by the device of the tensors it is
given: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``.  Raises when no CUDA device is present and none was asked
    for, so a run never carries on on the CPU by accident."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           "available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as JAX's plain indexing ``x[i, j]`` takes it into an axis
    of ``n`` entries: wrapped once when negative, then clamped into
    ``[0, n - 1]``.  An int64 tensor, ready to index with; the kernels
    read their indices the same way."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along ``x``'s first axis for an integer ``idx`` of any
    shape, the index taken as JAX's plain indexing takes it
    (``gather_index``), read by ``index_select``: its gradient is an
    ``index_add`` (atomics on CUDA), where advanced indexing's is a
    sort-based accumulate."""
    flat = gather_index(idx, x.shape[0]).reshape(-1)
    return torch.index_select(x, 0, flat).reshape(*idx.shape, *x.shape[1:])


# what JAX's take_along_axis reads for an int32 index out of range
INT32_MIN = -(2 ** 31)
# the embedding tables' padding: phi's +inf itemset and psi's unbound
# vertex (``mining.encoding``; the serving join's root frontier)
PAD_PHI = np.int32(0x3FFFFFF)
PAD_PSI = np.int32(-2)
#: prescreen row value that no token-count vector ever satisfies - a
#: masked (tombstoned) pattern or subtree is never joined
REQ_MASKED = 2 ** 31 - 1


def _wrap_once(idx: torch.Tensor, n: int):
    """``idx`` wrapped once when in ``[-n, 0)``, as JAX's ``take`` and
    ``take_along_axis`` take it into an axis of ``n`` entries: (the index
    clamped into range, int64; whether it was in range)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return idx.clamp(0, max(n - 1, 0)), ok


def take_fill(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, dim, idx)`` of an int32 ``x`` with the index
    taken as ``jnp.take_along_axis`` takes it into an axis of ``n``
    entries: wrapped once when in ``[-n, 0)``; any other index out of
    range reads ``INT32_MIN``."""
    idx, ok = _wrap_once(idx, x.shape[dim])
    return torch.where(ok, torch.gather(x, dim, idx), INT32_MIN)


def gather_cell_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[n, idx[n, k]]`` along dim 1 for every trailing column:
    x [N, R, W], idx [N, K] -> [N, K, W] (JAX's take_along_axis with a
    [N, K, 1] index, every index in range)."""
    N, K = idx.shape
    return torch.gather(x, 1, idx.long()[..., None].expand(N, K, x.shape[2]))


def take_nan(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``take_fill``'s counterpart for a floating ``x``: any other index
    out of range reads NaN.  Differentiable in ``x``."""
    idx, ok = _wrap_once(idx, x.shape[dim])
    return torch.where(ok, torch.gather(x, dim, idx), torch.nan)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` of a floating ``table`` and a 1-D
    ``idx``: ``take_nan`` by whole rows, read by ``index_select``."""
    idx, ok = _wrap_once(idx, table.shape[0])
    rows = torch.index_select(table, 0, idx)
    return torch.where(ok.reshape(-1, *[1] * (table.ndim - 1)), rows,
                       torch.nan)


def check_int32(name: str, x, ndim: int, device: torch.device) -> None:
    """Raise unless ``x`` is an int32 tensor of ``ndim`` dims on
    ``device``: what every kernel wrapper checks before it chooses."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
