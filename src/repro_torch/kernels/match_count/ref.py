"""Plain PyTorch version of the match_count kernel.

``match_core`` evaluates the embedding-join predicate for every
(embedding, token) pair over *pre-gathered* tokens and emits packed int32
extension signatures (see repro_torch.mining.encoding for the bit layout
and repro_torch.mining.engine for the search-phase semantics).  It is the
same integer function as the CUDA kernel in ``csrc/match_count.cu``: the
CPU tests run it, and ``chip_smoke.py`` holds the kernel bit-equal to it
on the card.

Every intermediate stays int32 (``torch.arange`` and ``bool.sum`` give
int64 and are cast back), so the shifts that pack the 31-bit signature
wrap exactly as int32 shifts do.
"""
from __future__ import annotations

import torch

from .. import gather_index
from ...mining.encoding import (
    INVALID_SIG,
    SENT_V,
    _LAB_BITS,
    _PU_BITS,
    _SL_BITS,
    _TY_BITS,
)

MODE_ROOT = 0
MODE_VERTEX_PHASE = 1
MODE_EDGE_PHASE = 2
MODE_TAIL = 3

_BIG = 0x3FFFFFF
_I32 = torch.int32


def _lookup(psi, u):
    """psi [E,NV], u [E,T] -> (mapped [E,T] bool, pid [E,T] int32: index of
    the first matching psi column, BIG when unmapped)."""
    eq = psi[:, None, :] == u[:, :, None]  # [E,T,NV]
    nv_ids = torch.arange(psi.shape[-1], dtype=_I32, device=psi.device)
    big = torch.full((), _BIG, dtype=_I32, device=psi.device)
    pid = torch.where(eq, nv_ids, big).amin(dim=-1)
    return pid < _BIG, pid


def _per_row(x, device):
    """A scalar stays 0-d; an [E] vector becomes [E,1] to broadcast
    against [E,T]."""
    x = torch.as_tensor(x, dtype=_I32, device=device)
    return x[:, None] if x.ndim == 1 else x


def match_core(tok, phi, psi, emb_valid, existing, nv, n_pat, mode):
    """tok [E,T,6] int32 (pre-gathered per embedding), phi [E,NI],
    psi [E,NV], emb_valid [E], existing [P,5], scalars nv/n_pat/mode.
    Returns sigs [E,T] int32 (-1 = no extension).

    Per-row form: ``nv``/``n_pat``/``mode`` may be ``[E]`` vectors and
    ``existing`` a per-row ``[E,P,5]`` table, as the wavefront miner
    packs rows of different patterns into one scan."""
    dev = tok.device
    nv = _per_row(nv, dev)
    n_pat = _per_row(n_pat, dev)
    mode = _per_row(mode, dev)
    ty = tok[..., 0]
    u1 = tok[..., 1]
    u2 = tok[..., 2]
    lab = tok[..., 3]
    j = tok[..., 4]
    valid = tok[..., 5] > 0
    is_v = ty <= 2

    m1, pid1 = _lookup(psi, u1)
    m2, pid2 = _lookup(psi, u2)
    pid1 = torch.where(m1, pid1, nv)
    pid2 = torch.where(m2, pid2, nv)

    # vertex-TR candidate
    ok_v = (mode == MODE_ROOT) | (mode == MODE_TAIL) | m1

    # edge-TR candidate
    both = m1 & m2
    one = m1 ^ m2
    mapped_pid = torch.where(m1, pid1, pid2)
    a = torch.where(both, torch.minimum(pid1, pid2),
                    torch.where(one, mapped_pid, nv))
    b = torch.where(both, torch.maximum(pid1, pid2),
                    torch.where(one, nv, nv + 1))
    ok_e = torch.where(
        mode == MODE_VERTEX_PHASE,
        False,
        torch.where(mode == MODE_EDGE_PHASE, m1 | m2, True),
    )

    pu1 = torch.where(is_v, pid1, a).to(_I32)
    pu2 = torch.where(is_v, torch.full_like(b, SENT_V), b).to(_I32)
    allowed = valid & torch.where(is_v, ok_v, ok_e)

    # temporal slot
    in_eq = phi[:, None, :] == j[:, :, None]  # [E,T,NI]
    ni_ids = torch.arange(phi.shape[-1], dtype=_I32, device=dev)
    big = torch.full((), _BIG, dtype=_I32, device=dev)
    in_pos = torch.where(in_eq, ni_ids, big).amin(dim=-1)
    in_any = in_pos < _BIG
    in_idx = torch.where(in_any, in_pos, 0).to(_I32)
    gap_idx = (phi[:, None, :] < j[:, :, None]).sum(-1).to(_I32)
    slot_kind = torch.where(in_any, 0, 1).to(_I32)
    slot_idx = torch.where(in_any, in_idx, gap_idx)

    tail_ok = torch.where(
        mode == MODE_TAIL,
        (in_any & (in_idx == n_pat - 1)) | (~in_any & (gap_idx == n_pat)),
        True,
    )

    # duplicate-TR-in-itemset rejection
    ex = existing  # [P,5] shared, or [E,P,5] per-row
    if ex.ndim == 3:
        def _exc(c):
            return ex[:, None, :, c]      # [E,1,P]
    else:
        def _exc(c):
            return ex[None, None, :, c]   # [1,1,P]
    dup = (
        (_exc(0) == slot_idx[..., None])
        & (_exc(1) == ty[..., None])
        & (_exc(2) == pu1[..., None])
        & (_exc(3) == pu2[..., None])
        & (_exc(4) == lab[..., None])
    ).any(-1) & in_any

    v = slot_kind
    v = (v << _SL_BITS) | slot_idx
    v = (v << _TY_BITS) | ty
    v = (v << _PU_BITS) | pu1
    v = (v << _PU_BITS) | pu2
    v = (v << _LAB_BITS) | (lab + 1)
    keep = allowed & tail_ok & ~dup & (emb_valid[:, None] > 0)
    return torch.where(keep, v, int(INVALID_SIG)).to(_I32)


def match_signatures_ref(tokens, gid, phi, psi, emb_valid, existing, nv,
                         n_pat, mode):
    """Scalar form with the token gather: tokens [G,T,6], gid [E],
    existing [P,5] shared by every row, scalars nv/n_pat/mode.  ``gid``
    is taken as JAX's gather takes it (``gather_index``)."""
    tok = tokens[gather_index(gid, tokens.shape[0])]
    return match_core(tok, phi, psi, emb_valid, existing, nv, n_pat, mode)


def match_signatures_batch_ref(tokens, gid, phi, psi, emb_valid, pid,
                               ex_stack, nv_stack, npat_stack,
                               mode_stack):
    """Per-row form with the gathers: ``pid`` [E] indexes the
    per-pattern tables ``ex_stack`` [NP,P,5] and ``nv_stack`` /
    ``npat_stack`` / ``mode_stack`` [NP].  ``gid`` and ``pid`` are taken
    as JAX's gather takes them (``gather_index``), each table by its own
    length."""
    def by_pid(table):
        return table[gather_index(pid, table.shape[0])]

    return match_core(
        tokens[gather_index(gid, tokens.shape[0])], phi, psi, emb_valid,
        by_pid(ex_stack), by_pid(nv_stack), by_pid(npat_stack),
        by_pid(mode_stack),
    )
