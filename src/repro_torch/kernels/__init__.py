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
