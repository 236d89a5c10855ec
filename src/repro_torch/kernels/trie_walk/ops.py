"""Public wrappers of the fused trie-walk kernel.

``trie_walk_cells`` takes the batch's shared tables and the ``cells``
that index them, as the serving path holds them; ``trie_walk`` takes
tables already gathered per cell.  Both choose by the device of their
first tensor: CPU tensors run the plain version in ``ref.py``; CUDA
tensors launch ``csrc/trie_walk.cu`` (one kernel, which reads every
table in place through ``cells``; ``trie_walk`` hands it identity
cells) or raise.  ``launches`` counts the kernel launches and nothing
else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_int32, gather_index
from .ref import trie_walk_core

# kernel launches made by this process (the plain version never counts)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("trie_walk")
        lib.trie_walk_launch.argtypes = [_P] * 10 + [_I] * 10 + [_P]
        lib.trie_walk_launch.restype = _I
        _lib = lib
    return _lib


def _check_types(args: dict, ndims: dict, device: torch.device) -> None:
    for name, x in args.items():
        check_int32(name, x, ndims[name], device)


def _check_shapes(args: dict, want: dict) -> None:
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(args[name].shape)}, "
                             f"expected {shape}")


def _check_dims(emax, tmax, ni, nv) -> None:
    if min(emax, tmax, ni, nv) < 1:
        raise ValueError(f"emax, tmax, ni and nv must be >= 1, got "
                         f"{(emax, tmax, ni, nv)}")


def _launch(tokens, order, start, count, cells, steps_s, parent_s, req_s,
            *, emax, tmax, ni, nv):
    """Launch the kernel on CUDA tensors already checked for type and
    shape: ``(acc [N,S] bool, ovf_term [N,S] bool)``."""
    device = tokens.device
    if device.type != "cuda":
        raise ValueError(f"trie_walk runs on cpu or cuda, not {device}")
    tables = {"tokens": tokens, "order": order, "start": start,
              "count": count, "cells": cells, "steps_s": steps_s,
              "parent_s": parent_s, "req_s": req_s}
    for name, x in tables.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, T, _ = tokens.shape
    K = start.shape[1]
    N = cells.shape[0]
    Sp, S, _ = steps_s.shape
    # the kernel writes 0/1 bytes: torch.bool as it is
    acc = torch.empty((N, S), dtype=torch.bool, device=device)
    ovft = torch.empty((N, S), dtype=torch.bool, device=device)
    if N == 0 or S == 0:
        return acc, ovft
    if B == 0 or T == 0 or Sp == 0:
        raise ValueError("cells to walk but an empty token or subtree table")
    lib = _kernel_lib()
    with torch.cuda.device(device):
        err = lib.trie_walk_launch(
            *(x.data_ptr() for x in tables.values()),
            acc.data_ptr(), ovft.data_ptr(),
            N, B, T, K, Sp, S, emax, tmax, ni, nv,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        # the launcher refuses a cell whose buffers need more shared
        # memory than a block may have (CUDA error 1, invalid value)
        raise RuntimeError(
            f"trie_walk launch failed at N={N}, T={T}, K={K}, S={S}, "
            f"emax={emax}, tmax={tmax}, ni={ni}, nv={nv}: CUDA error {err}")
    global launches
    launches += 1
    return acc, ovft


def trie_walk_cells(tokens, order, start, count, cells, steps_s, parent_s,
                    req_s, *, emax: int, tmax: int, ni: int, nv: int):
    """``(acc [N,S] bool, ovf_term [N,S] bool)`` for the cells
    ``cells[i] = (sequence b, subtree s)``: the walk of subtree s's
    packed tables over sequence b's token table and index rows (see
    ``ref.trie_walk_core`` for the contract).

    tokens [B,T,6], order [B,T], start / count [B,K], cells [N,2],
    steps_s [Sp,S,8], parent_s [Sp,S], req_s [Sp,S,K]; all int32 on one
    device.  On a CPU tensor the tables are gathered by cell and walked
    by the plain version; the kernel reads them in place.  Either way a
    cell's indices are taken as JAX's gather takes them: wrapped once
    when negative, then clamped into range (``gather_index``)."""
    device = tokens.device
    args = {"tokens": tokens, "order": order, "start": start,
            "count": count, "cells": cells, "steps_s": steps_s,
            "parent_s": parent_s, "req_s": req_s}
    _check_types(args, {"tokens": 3, "order": 2, "start": 2, "count": 2,
                        "cells": 2, "steps_s": 3, "parent_s": 2,
                        "req_s": 3}, device)
    B, T, _ = tokens.shape
    K = start.shape[1]
    N = cells.shape[0]
    Sp, S, _ = steps_s.shape
    _check_shapes(args, {"tokens": (B, T, 6), "order": (B, T),
                         "start": (B, K), "count": (B, K), "cells": (N, 2),
                         "steps_s": (Sp, S, 8), "parent_s": (Sp, S),
                         "req_s": (Sp, S, K)})
    _check_dims(emax, tmax, ni, nv)
    if device.type == "cpu":
        b = gather_index(cells[:, 0], B)
        s = gather_index(cells[:, 1], Sp)
        return trie_walk_core(tokens[b], order[b], start[b], count[b],
                              steps_s[s], parent_s[s], req_s[s],
                              emax=emax, tmax=tmax, ni=ni, nv=nv)
    return _launch(tokens, order, start, count, cells, steps_s, parent_s,
                   req_s, emax=emax, tmax=tmax, ni=ni, nv=nv)


def trie_walk(tok_c, order_c, start_c, count_c, steps, parent, req, *,
              emax: int, tmax: int, ni: int, nv: int):
    """``(acc [N,S] bool, ovf_term [N,S] bool)``: the fused walk's
    terminal accept and undecidedness bits per subtree slot (see
    ``ref.trie_walk_core`` for the contract), on tables gathered per
    cell.

    tok_c [N,T,6], order_c [N,T], start_c / count_c [N,K], steps
    [N,S,8], parent [N,S], req [N,S,K]; all int32 on one device.  On
    CUDA it is the kernel of ``trie_walk_cells`` with cell i = (i, i)."""
    device = tok_c.device
    args = {"tok_c": tok_c, "order_c": order_c, "start_c": start_c,
            "count_c": count_c, "steps": steps, "parent": parent,
            "req": req}
    _check_types(args, {"tok_c": 3, "order_c": 2, "start_c": 2,
                        "count_c": 2, "steps": 3, "parent": 2, "req": 3},
                 device)
    N, T, _ = tok_c.shape
    K = start_c.shape[1]
    S = steps.shape[1]
    _check_shapes(args, {"tok_c": (N, T, 6), "order_c": (N, T),
                         "start_c": (N, K), "count_c": (N, K),
                         "steps": (N, S, 8), "parent": (N, S),
                         "req": (N, S, K)})
    _check_dims(emax, tmax, ni, nv)
    if device.type == "cpu":
        return trie_walk_core(tok_c, order_c, start_c, count_c, steps,
                              parent, req, emax=emax, tmax=tmax, ni=ni,
                              nv=nv)
    ids = torch.arange(N, dtype=torch.int32, device=device)
    cells = torch.stack([ids, ids], dim=1)
    return _launch(tok_c, order_c, start_c, count_c, cells, steps, parent,
                   req, emax=emax, tmax=tmax, ni=ni, nv=nv)
