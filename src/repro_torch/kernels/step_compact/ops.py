"""Public wrapper of the join step's compaction kernel.

``step_compact`` chooses by the device of ``bits``: CPU tensors run the
plain version in ``ref.py``; CUDA tensors launch ``csrc/step_compact.cu``
or raise.  ``launches`` counts the kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_int32
from .ref import step_compact_core

# kernel launches made by this process (the plain version never counts)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib = None
# the launcher's modes
_COMPACT, _TERMINAL, _TERMINAL_COUNT = 0, 1, 2


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("step_compact")
        lib.step_compact_launch.argtypes = (
            [_P] * 6 + [_L, _P, _P, _L, _P, _L] + [_P] * 5 + [_I] * 7 + [_P])
        lib.step_compact_launch.restype = _I
        _lib = lib
    return _lib


def _rows(name, x, n, width, dtype):
    """``x`` as the kernel reads it: [n, width] of ``dtype`` with
    contiguous columns; its row stride is passed beside it."""
    if x.dtype != dtype or x.ndim != 2 or x.shape[0] != n \
            or x.shape[1] < width:
        raise ValueError(f"{name} must be [{n}, >={width}] {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x if x.stride(1) == 1 else x.contiguous()


def step_compact(bits, tok_w, phi, psi, valid, step_k, ct_sel, pu_c, pu_ok,
                 *, emax: int, tmax: int, compact: bool,
                 count_frontier_ovf: bool = False):
    """The first-``emax`` compaction and phi / psi update of one join
    step for N cells, from the predicate's masks ``bits``; see
    ``ref.step_compact_core`` for the arguments and the outputs.

    bits [N,Ein,Tm], tok_w [N,Tm,6], phi [N,Ein,NI], psi [N,Ein,NV],
    step_k [N,8] and ct_sel [N] int32; valid [N,Ein] and pu_ok [N,2]
    bool; pu_c [N,2] int64; all on one device, ``Tm == tmax``."""
    device = bits.device
    for name, x, nd in (("bits", bits, 3), ("tok_w", tok_w, 3),
                        ("phi", phi, 3), ("psi", psi, 3),
                        ("ct_sel", ct_sel, 1)):
        check_int32(name, x, nd, device)
    N, Ein, Tm = bits.shape
    NI, NV = phi.shape[2], psi.shape[2]
    if (tok_w.shape != (N, Tm, 6) or phi.shape[:2] != (N, Ein)
            or psi.shape[:2] != (N, Ein) or valid.shape != (N, Ein)
            or ct_sel.shape != (N,) or Tm != tmax):
        raise ValueError(
            f"bits [N,Ein,Tm={tmax}], tok_w [N,Tm,6], phi / psi [N,Ein,*], "
            f"valid [N,Ein], ct_sel [N] expected, got {tuple(bits.shape)}, "
            f"{tuple(tok_w.shape)}, {tuple(phi.shape)}, {tuple(psi.shape)}, "
            f"{tuple(valid.shape)}, {tuple(ct_sel.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if min(emax, NI, NV) < 1:
        raise ValueError(f"emax, NI and NV must be >= 1, got "
                         f"{(emax, NI, NV)}")
    for name, x in (("valid", valid), ("step_k", step_k), ("pu_c", pu_c),
                    ("pu_ok", pu_ok)):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
    if device.type == "cpu":
        return step_compact_core(bits, tok_w, phi, psi, valid, step_k,
                                 ct_sel, pu_c, pu_ok, emax=emax, tmax=tmax,
                                 compact=compact,
                                 count_frontier_ovf=count_frontier_ovf)
    if device.type != "cuda":
        raise ValueError(f"step_compact runs on cpu or cuda, not {device}")
    step_k = _rows("step_k", step_k, N, 8, torch.int32)
    pu_c = _rows("pu_c", pu_c, N, 2, torch.int64)
    pu_ok = _rows("pu_ok", pu_ok, N, 2, torch.bool)
    bits, tok_w, phi, psi, valid, ct_sel = (
        x.contiguous() for x in (bits, tok_w, phi, psi, valid, ct_sel))
    E = emax
    if compact:
        mode = _COMPACT
        phi_out = torch.empty((N, E, NI), dtype=torch.int32, device=device)
        psi_out = torch.empty((N, E, NV), dtype=torch.int32, device=device)
        valid_out = torch.empty((N, E), dtype=torch.bool, device=device)
        acc_out = None
        outs = (phi_out, psi_out, valid_out)
    else:
        mode = _TERMINAL_COUNT if count_frontier_ovf else _TERMINAL
        phi_out = psi_out = valid_out = None
        acc_out = torch.empty((N,), dtype=torch.bool, device=device)
        outs = (acc_out,)
    ovf_out = torch.empty((N,), dtype=torch.bool, device=device)
    if N == 0:
        return (*outs, ovf_out)
    # a cell's candidates and output rows are indexed in 32 bits
    if max(2 * Ein * Tm, E * NI, E * NV) > 2**31 - 1:
        raise ValueError(f"a cell at Ein={Ein}, Tm={Tm}, E={E}, NI={NI}, "
                         f"NV={NV} is more than the kernel indexes")
    lib = _kernel_lib()
    with torch.cuda.device(device):
        err = lib.step_compact_launch(
            bits.data_ptr(), tok_w.data_ptr(), phi.data_ptr(),
            psi.data_ptr(), valid.data_ptr(), step_k.data_ptr(),
            step_k.stride(0), ct_sel.data_ptr(), pu_c.data_ptr(),
            pu_c.stride(0), pu_ok.data_ptr(), pu_ok.stride(0),
            *(None if x is None else x.data_ptr()
              for x in (phi_out, psi_out, valid_out, acc_out, ovf_out)),
            N, Ein, Tm, NI, NV, E, mode,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        # the launcher refuses an emax whose kept candidates exceed a
        # block's shared memory (CUDA error 1, invalid value)
        raise RuntimeError(f"step_compact launch failed at N={N}, "
                           f"Ein={Ein}, Tm={Tm}, emax={E}: CUDA error {err}")
    global launches
    launches += 1
    return (*outs, ovf_out)
