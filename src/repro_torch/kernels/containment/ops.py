"""Public wrapper of the containment-step kernel.

``contain_step`` chooses by the device of ``tok``: CPU tensors run the
plain version in ``ref.py``; CUDA tensors launch
``csrc/containment.cu`` or raise.  ``launches`` counts the kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_int32
from .ref import SROW_FIELDS, contain_step_core

# kernel launches made by this process (the plain version never counts)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("containment")
        lib.contain_step_launch.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.contain_step_launch.restype = _I
        _lib = lib
    return _lib


def contain_step(tok, psi, srow):
    """2-bit orientation mask ``[G,Ein,Tm]`` int32 of the Def-4 join
    predicate for every (cell, frontier row, window token) triple.

    tok [G,Tm,6], psi [G,Ein,NV], srow [G,Ein,8]; all int32 on one
    device.  ``Ein`` is read from ``psi`` (1 on a root step)."""
    device = tok.device
    for name, x in (("tok", tok), ("psi", psi), ("srow", srow)):
        check_int32(name, x, 3, device)
    G, Tm, C = tok.shape
    Gp, Ein, NV = psi.shape
    if C != 6 or srow.shape != (G, Ein, SROW_FIELDS) or Gp != G:
        raise ValueError(
            f"tok [G,Tm,6], psi [G,Ein,NV] and srow [G,Ein,8] expected, got "
            f"{tuple(tok.shape)}, {tuple(psi.shape)}, {tuple(srow.shape)}")
    if device.type == "cpu":
        return contain_step_core(tok, psi, srow)
    if device.type != "cuda":
        raise ValueError(f"containment runs on cpu or cuda, not {device}")
    for name, x in (("tok", tok), ("psi", psi), ("srow", srow)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((G, Ein, Tm), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    if NV < 1:
        raise ValueError("psi needs at least one vertex column")
    lib = _kernel_lib()
    with torch.cuda.device(device):
        err = lib.contain_step_launch(
            tok.data_ptr(), psi.data_ptr(), srow.data_ptr(), out.data_ptr(),
            G, Ein, Tm, NV, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        # the launcher refuses sizes that need more shared memory a
        # block than the card has (CUDA error 1, invalid value)
        raise RuntimeError(f"contain_step launch failed at G={G}, Ein={Ein}, "
                           f"Tm={Tm}, NV={NV}: CUDA error {err}")
    global launches
    launches += 1
    return out
