"""Public wrapper of the fused trie-walk kernel.

``trie_walk`` chooses by the device of ``tok_c``: CPU tensors run the
plain version in ``ref.py``; CUDA tensors launch ``csrc/trie_walk.cu``
or raise.  ``launches`` counts the kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_int32
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
        lib.trie_walk_launch.argtypes = [_P] * 9 + [_I] * 8 + [_P]
        lib.trie_walk_launch.restype = _I
        _lib = lib
    return _lib


def trie_walk(tok_c, order_c, start_c, count_c, steps, parent, req, *,
              emax: int, tmax: int, ni: int, nv: int):
    """``(acc [N,S] bool, ovf_term [N,S] bool)``: the fused walk's
    terminal accept and undecidedness bits per subtree slot (see
    ``ref.trie_walk_core`` for the contract).

    tok_c [N,T,6], order_c [N,T], start_c / count_c [N,K], steps
    [N,S,8], parent [N,S], req [N,S,K]; all int32 on one device."""
    device = tok_c.device
    args = {
        "tok_c": (tok_c, 3), "order_c": (order_c, 2),
        "start_c": (start_c, 2), "count_c": (count_c, 2),
        "steps": (steps, 3), "parent": (parent, 2), "req": (req, 3),
    }
    for name, (x, ndim) in args.items():
        check_int32(name, x, ndim, device)
    N, T, C6 = tok_c.shape
    K = start_c.shape[1]
    S = steps.shape[1]
    want = {"tok_c": (N, T, 6), "order_c": (N, T), "start_c": (N, K),
            "count_c": (N, K), "steps": (N, S, 8), "parent": (N, S),
            "req": (N, S, K)}
    for name, shape in want.items():
        if tuple(args[name][0].shape) != shape:
            raise ValueError(f"{name} has shape "
                             f"{tuple(args[name][0].shape)}, expected {shape}")
    if min(emax, tmax, ni, nv) < 1:
        raise ValueError(f"emax, tmax, ni and nv must be >= 1, got "
                         f"{(emax, tmax, ni, nv)}")
    if device.type == "cpu":
        return trie_walk_core(tok_c, order_c, start_c, count_c, steps,
                              parent, req, emax=emax, tmax=tmax, ni=ni,
                              nv=nv)
    if device.type != "cuda":
        raise ValueError(f"trie_walk runs on cpu or cuda, not {device}")
    for name, (x, _) in args.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    acc = torch.empty((N, S), dtype=torch.int32, device=device)
    ovft = torch.empty((N, S), dtype=torch.int32, device=device)
    if N == 0 or S == 0:
        return acc > 0, ovft > 0
    if T == 0:
        raise ValueError("cells to walk but an empty token table")
    lib = _kernel_lib()
    with torch.cuda.device(device):
        err = lib.trie_walk_launch(
            tok_c.data_ptr(), order_c.data_ptr(), start_c.data_ptr(),
            count_c.data_ptr(), steps.data_ptr(), parent.data_ptr(),
            req.data_ptr(), acc.data_ptr(), ovft.data_ptr(),
            N, T, K, S, emax, tmax, ni, nv,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        # the launcher refuses sizes that need more shared memory a
        # block than the card has (CUDA error 1, invalid value)
        raise RuntimeError(
            f"trie_walk launch failed at N={N}, T={T}, K={K}, S={S}, "
            f"emax={emax}, tmax={tmax}, ni={ni}, nv={nv}: CUDA error {err}")
    global launches
    launches += 1
    return acc > 0, ovft > 0
