"""Public wrappers of the match_count kernel.

``match_signatures_batch`` is the per-row form the miner calls once per
wavefront chunk; ``match_signatures_kernel`` is the scalar form (one
shared ``existing`` table and scalar ``nv``/``n_pat``/``mode``), a thin
wrapper over the same kernel with one pattern (NP = 1, ``pid`` all 0).

Both choose by the device of ``tokens``, through the operator
``repro_torch::match_count`` (a ``torch.library.Library`` op: the
``custom_op`` decorator's wrapper imports ``torch._dynamo`` at a
process's first call, seconds in every spawned rank): on CPU tensors its
CPU implementation runs the plain version in ``ref.py``; on CUDA tensors
its CUDA implementation launches ``csrc/match_count.cu`` or raises.  Its
fake implementation makes an empty int32 ``[E, T]`` and computes
nothing: only fake tensors reach it (a ``FakeTensorMode`` trace, as in
``launch.dryrun``, which sees the op by name).  ``launches`` counts the
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .. import check_int32
from .ref import match_signatures_batch_ref

# kernel launches made by this process (the plain version never counts)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("match_count")
        lib.match_count_launch.argtypes = [_P] * 11 + [_I] * 7 + [_P]
        lib.match_count_launch.restype = _I
        _lib = lib
    return _lib


def match_signatures_batch(tokens, gid, phi, psi, emb_valid, pid,
                           ex_stack, nv_stack, npat_stack, mode_stack):
    """Packed int32 extension signatures ``[E,T]`` (-1 = none) for a
    wavefront chunk whose rows belong to different patterns.

    tokens [G,T,6], gid [E], phi [E,NI], psi [E,NV], emb_valid [E],
    pid [E] (row -> pattern), ex_stack [NP,P,5], nv_stack / npat_stack /
    mode_stack [NP]; all int32 on one device.  The kernel does the
    ``tokens[gid]`` and ``ex_stack[pid]`` gathers itself."""
    device = tokens.device
    args = {
        "tokens": (tokens, 3), "gid": (gid, 1), "phi": (phi, 2),
        "psi": (psi, 2), "emb_valid": (emb_valid, 1), "pid": (pid, 1),
        "ex_stack": (ex_stack, 3), "nv_stack": (nv_stack, 1),
        "npat_stack": (npat_stack, 1), "mode_stack": (mode_stack, 1),
    }
    for name, (x, ndim) in args.items():
        check_int32(name, x, ndim, device)
    G, T, C = tokens.shape
    E, NI = phi.shape
    NV = psi.shape[1]
    NP, P, C5 = ex_stack.shape
    if C != 6 or C5 != 5:
        raise ValueError(f"tokens [G,T,6] and ex_stack [NP,P,5] expected, "
                         f"got {tuple(tokens.shape)}, {tuple(ex_stack.shape)}")
    for name in ("gid", "psi", "emb_valid", "pid"):
        if args[name][0].shape[0] != E:
            raise ValueError(f"{name} has {args[name][0].shape[0]} rows, "
                             f"phi has {E}")
    for name in ("nv_stack", "npat_stack", "mode_stack"):
        if args[name][0].shape[0] != NP:
            raise ValueError(f"{name} has {args[name][0].shape[0]} rows, "
                             f"ex_stack has {NP}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"match_count runs on cpu or cuda, not {device}")
    return torch.ops.repro_torch.match_count(
        tokens, gid, phi, psi, emb_valid, pid, ex_stack, nv_stack,
        npat_stack, mode_stack)


def _match_count_fake(tokens, gid, phi, psi, emb_valid, pid, ex_stack,
                      nv_stack, npat_stack, mode_stack):
    return tokens.new_empty((gid.shape[0], tokens.shape[1]))


def _match_count_cuda(tokens, gid, phi, psi, emb_valid, pid, ex_stack,
                      nv_stack, npat_stack, mode_stack):
    args = {"tokens": tokens, "gid": gid, "phi": phi, "psi": psi,
            "emb_valid": emb_valid, "pid": pid, "ex_stack": ex_stack,
            "nv_stack": nv_stack, "npat_stack": npat_stack,
            "mode_stack": mode_stack}
    for name, x in args.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    device = tokens.device
    G, T, _ = tokens.shape
    E, NI = phi.shape
    NV = psi.shape[1]
    NP, P, _ = ex_stack.shape
    if E > 0 and (G == 0 or NP == 0):
        raise ValueError("rows to scan but an empty tokens or ex_stack")
    sigs = torch.empty((E, T), dtype=torch.int32, device=device)
    if E == 0 or T == 0:
        return sigs
    lib = _kernel_lib()
    with torch.cuda.device(device):
        err = lib.match_count_launch(
            tokens.data_ptr(), gid.data_ptr(), phi.data_ptr(),
            psi.data_ptr(), emb_valid.data_ptr(), pid.data_ptr(),
            ex_stack.data_ptr(), nv_stack.data_ptr(), npat_stack.data_ptr(),
            mode_stack.data_ptr(), sigs.data_ptr(),
            E, G, T, NI, NV, NP, P,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"match_count launch failed: CUDA error {err}")
    global launches
    launches += 1
    return sigs


# the operator's registration lives as long as this library object
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("match_count(Tensor tokens, Tensor gid, Tensor phi, Tensor psi, "
            "Tensor emb_valid, Tensor pid, Tensor ex_stack, "
            "Tensor nv_stack, Tensor npat_stack, Tensor mode_stack) "
            "-> Tensor")
_LIB.impl("match_count", match_signatures_batch_ref, "CPU")
_LIB.impl("match_count", _match_count_cuda, "CUDA")
torch.library.register_fake("repro_torch::match_count", _match_count_fake,
                            lib=_LIB)


def match_signatures_kernel(tokens, gid, phi, psi, emb_valid, existing,
                            nv, n_pat, mode):
    """Scalar form: every row scans against one shared ``existing``
    [P,5] table with scalar ``nv``/``n_pat``/``mode``.  Runs the per-row
    kernel with one pattern."""
    device = tokens.device
    check_int32("existing", existing, 2, device)
    scal = torch.tensor([[int(nv)], [int(n_pat)], [int(mode)]],
                        dtype=torch.int32).to(device)
    pid = torch.zeros_like(gid)
    return match_signatures_batch(
        tokens, gid, phi, psi, emb_valid, pid, existing[None].contiguous(),
        scal[0], scal[1], scal[2],
    )
