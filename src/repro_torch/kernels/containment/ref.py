"""Plain PyTorch version of the containment-step kernel.

``contain_step_core`` evaluates one step of the query-time embedding join
(``serving.batch``): given the partial-embedding frontiers of a batch of
(sequence, pattern) *cells* and each cell's token window for the step's
(type, label) key, it decides for every (cell, frontier row, token)
triple whether the token realizes the pattern's next TR under the Def-4
constraints the host oracle backtracks over:

* itemset slot: the first TR of a pattern itemset may claim any data
  itemset strictly after the previous one (``j > prev_phi``); later TRs
  of the same itemset must land in the already-claimed one
  (``j == cur_phi``),
* type and label equal exactly,
* psi consistency: mapped pattern vertices must hit their psi image,
  fresh ones may only bind data vertices outside the (injective) image.

Edge TRs may match in two orientations; the result packs both decisions
into one int32 bitmask (bit0: ``pu1->u1, pu2->u2``; bit1: swapped).
Every intermediate stays int32 or bool, as in the JAX reference
(``repro.kernels.containment.ref``), to which it is bit-equal.
"""
from __future__ import annotations

import torch

# plain python int, never a tensor: it must not promote the int32 psi
_BIG = 0x3FFFFFF

# srow column layout (per frontier row):
#   0 ty, 1 pu1, 2 pu2, 3 label, 4 new_itemset,
#   5 prev_phi, 6 cur_phi, 7 row_valid
SROW_FIELDS = 8


def contain_step_core(tok, psi, srow):
    """tok [G,T,6] int32 (per-cell token window: type,u1,u2,label,j,valid),
    psi [G,E,NV] int32 (PAD_PSI = unbound), srow [G,E,SROW_FIELDS] int32.
    Returns bits [G,E,T] int32: 0 = no match, bit0/bit1 = orientation."""
    t_ty = tok[:, None, :, 0]
    u1 = tok[:, None, :, 1]
    u2 = tok[:, None, :, 2]
    t_lab = tok[:, None, :, 3]
    j = tok[:, None, :, 4]
    t_val = tok[:, None, :, 5] > 0

    sty = srow[:, :, 0:1]
    spu1 = srow[:, :, 1:2]
    spu2 = srow[:, :, 2:3]
    slab = srow[:, :, 3:4]
    snew = srow[:, :, 4:5]
    sprev = srow[:, :, 5:6]
    scur = srow[:, :, 6:7]
    sval = srow[:, :, 7:8]

    base = t_val & (sval > 0) & (t_ty == sty) & (t_lab == slab)
    slot_ok = torch.where(snew > 0, j > sprev, j == scur)

    # per-row psi gather at the step's pattern vertices (masked-min: the
    # matching column is unique, so the minimum is the looked-up value)
    nv_ids = torch.arange(psi.shape[-1], dtype=torch.int32,
                          device=psi.device)[None, None, :]
    pvv1 = torch.where(nv_ids == spu1, psi, _BIG).amin(-1, keepdim=True)
    pvv2 = torch.where(nv_ids == spu2, psi, _BIG).amin(-1, keepdim=True)
    bound1 = (pvv1 >= 0) & (pvv1 < _BIG)
    bound2 = (pvv2 >= 0) & (pvv2 < _BIG)

    # injectivity: is a data vertex already in the psi image?
    u1_mapped = (psi[:, :, None, :] == u1[..., None]).any(-1)  # [G,E,T]
    u2_mapped = (psi[:, :, None, :] == u2[..., None]).any(-1)

    is_v = sty <= 2
    ok_vert = torch.where(bound1, u1 == pvv1, ~u1_mapped)

    # edge orientations: v0 assigns (pu1->u1, pu2->u2), v1 the swap
    e1_0 = torch.where(bound1, u1 == pvv1, ~u1_mapped)
    e2_0 = torch.where(bound2, u2 == pvv2, ~u2_mapped)
    e1_1 = torch.where(bound1, u2 == pvv1, ~u2_mapped)
    e2_1 = torch.where(bound2, u1 == pvv2, ~u1_mapped)
    distinct = bound1 | bound2 | (u1 != u2)
    ok_e0 = e1_0 & e2_0 & distinct
    ok_e1 = e1_1 & e2_1 & distinct

    keep = base & slot_ok
    bit0 = keep & torch.where(is_v, ok_vert, ok_e0)
    bit1 = keep & ~is_v & ok_e1
    return bit0.to(torch.int32) | (bit1.to(torch.int32) << 1)
