"""Plain PyTorch version of the fused trie-walk kernel.

The serving trie join (``serving.batch``) advances one frontier per
(sequence, trie node) in a level-synchronous scan: one device call per
trie *level*, frontiers gathered from the previous level's cell array on
every hop.  The fused walk collapses that ladder: one *cell* is a
(sequence, depth-1 subtree) pair, and the whole subtree - every node,
every level - is walked inside a single launch over fixed frontier
buffers:

* ``steps[:, n]`` / ``parent[:, n]`` lay the subtree out in topological
  slot order (parents before children), so one pass over the slots
  visits each node exactly once with its parent's compacted frontier
  already written,
* slot ``n`` seeds from ``parent[:, n]``'s buffer row (or the root
  state when ``parent < 0``), applies the per-node residual-``req``
  prescreen (a failing node's seed frontier dies before the step -
  exactly the per-level path never seeding the cell), advances one
  ``_walk_step``, and writes its compacted frontier back,
* terminal accept/overflow bits for every slot come out together.

``_walk_step`` is ``serving.batch._step_once`` (``uniform=False``,
``compact=True``) on per-cell token arrays: its own reads of the step's
window and step table, then the same compaction and frontier update
(``step_compact.ref.step_compact_core``) - same candidate order, same
first-``emax`` min-extraction, same overflow flags - and the root seed
is the per-level 1-wide root frontier widened to ``emax`` rows with only
row 0 valid: invalid rows flag no candidates and the candidate order is
row-major, so the compacted state agrees bitwise.  Bit-equal to
the JAX reference ``repro.kernels.trie_walk.ref``.
"""
from __future__ import annotations

import torch

from .. import PAD_PHI, PAD_PSI, _wrap_once, take_fill
from ..containment.ref import contain_step_core
from ..step_compact.ref import step_compact_core


def _walk_step(tok_c, order_c, start_c, count_c, step_k, phi, psi,
               valid, *, emax, tmax):
    """One embedding-join step for N cells over *per-cell* token arrays
    (``tok_c[i]`` is cell i's own token table).  Returns
    ``(phi_new, psi_new, new_valid, frontier_ovf, window_ovf)``, both
    overflow legs separately."""
    T = tok_c.shape[1]
    N, Ein, NI = phi.shape
    NV = psi.shape[2]
    Tm = tmax
    m_ids = torch.arange(Tm, dtype=torch.int32, device=phi.device)
    ty_s, pu1_s, pu2_s, lab_s, new_s, idx_s, sval_s, key_s = (
        step_k[:, c] for c in range(8)
    )

    # every lookup below is JAX's take_along_axis: an index in [-n, 0)
    # wraps, any other out of range reads INT32_MIN (``take_fill``), so a
    # step key out of range opens no window and a filled window token is
    # invalid
    # ---- per-cell token window for this step's (type,label) bucket
    st_sel = take_fill(start_c, 1, key_s[:, None])[:, 0]
    ct_sel = take_fill(count_c, 1, key_s[:, None])[:, 0]
    wpos = torch.clamp(st_sel[:, None] + m_ids[None, :], max=T - 1)
    wvalid = m_ids[None, :] < ct_sel[:, None]
    tpos = take_fill(order_c, 1, wpos)                        # [N, Tm]
    tok_w = take_fill(tok_c, 1, tpos[..., None].expand(N, Tm, 6))
    tok_w[..., 5] = torch.where(wvalid, tok_w[..., 5], 0)

    # ---- per-row step table for the predicate
    idx_b = idx_s[:, None, None].expand(N, Ein, 1)
    cur_phi = take_fill(phi, 2, idx_b)[..., 0]
    prev_b = torch.clamp(idx_b.long() - 1, 0, NI - 1)
    prev_phi = torch.gather(phi, 2, prev_b)[..., 0]
    prev_phi = torch.where(idx_s[:, None] > 0, prev_phi, -1)
    row_valid = valid & (sval_s[:, None] > 0)

    def bro(x):  # [N] -> [N, Ein]
        return x[:, None].expand(N, Ein)

    srow = torch.stack(
        [bro(ty_s), bro(pu1_s), bro(pu2_s), bro(lab_s), bro(new_s),
         prev_phi, cur_phi, row_valid.to(torch.int32)],
        dim=-1,
    )

    bits = contain_step_core(tok_w, psi, srow)

    # ---- the compaction and phi / psi update of ``_step_once``; the
    # pattern vertices read as take_along_axis reads them, and the
    # window count clamped to the window so that the flag it returns is
    # the frontier leg alone
    pu_c, pu_ok = _wrap_once(torch.stack([pu1_s, pu2_s], -1), NV)
    phi_new, psi_new, new_valid, frontier_ovf = step_compact_core(
        bits, tok_w, phi, psi, valid, step_k, torch.clamp(ct_sel, max=Tm),
        pu_c, pu_ok, emax=emax, tmax=Tm, compact=True)
    window_ovf = (ct_sel > Tm) & valid.any(-1)
    return phi_new, psi_new, new_valid, frontier_ovf, window_ovf


def trie_walk_core(tok_c, order_c, start_c, count_c, steps, parent, req,
                   *, emax, tmax, ni, nv):
    """Walk S subtree slots for N cells over frontier buffers.

    Per cell i: ``tok_c[i]``/``order_c[i]``/``start_c[i]``/``count_c[i]``
    are its sequence's token table + inverted index, ``steps[i]`` /
    ``parent[i]`` / ``req[i]`` its packed subtree (slot-topological:
    every real slot's parent slot index is smaller; ``parent = -1`` is
    the subtree root, which seeds from the shared root state).  Padding
    slots carry ``step_valid=0`` rows, ``parent=-1`` and
    ``req=REQ_MASKED`` - dead on arrival.

    Returns ``(acc [N,S] bool, ovf_term [N,S] bool)``: per slot the
    terminal accept bit and the terminal-undecidedness flag (which never
    includes the slot's own frontier overflow)."""
    N, S, _ = steps.shape
    E = emax
    dev = steps.device
    i32 = torch.int32
    root_phi = torch.full((N, E, ni), int(PAD_PHI), dtype=i32,
                          device=dev)
    root_psi = torch.full((N, E, nv), int(PAD_PSI), dtype=i32,
                          device=dev)
    root_valid = torch.zeros((N, E), dtype=torch.bool, device=dev)
    root_valid[:, 0] = True
    # per-node residual prescreen, one compare for all slots
    poss_all = (count_c[:, None, :] >= req).all(-1)        # [N, S]
    phi_buf = torch.zeros((N, S, E, ni), dtype=i32, device=dev)
    psi_buf = torch.zeros((N, S, E, nv), dtype=i32, device=dev)
    valid_buf = torch.zeros((N, S, E), dtype=torch.bool, device=dev)
    ovf_buf = torch.zeros((N, S), dtype=torch.bool, device=dev)
    rows = torch.arange(N, device=dev)
    accs, ovfts = [], []
    for n in range(S):
        pidx = parent[:, n]
        isroot = pidx < 0
        pcl = torch.clamp(pidx, 0, max(S - 1, 0)).long()
        seed_phi = torch.where(isroot[:, None, None], root_phi,
                               phi_buf[rows, pcl])
        seed_psi = torch.where(isroot[:, None, None], root_psi,
                               psi_buf[rows, pcl])
        seed_valid = torch.where(isroot[:, None], root_valid,
                                 valid_buf[rows, pcl])
        seed_ovf = ~isroot & ovf_buf[rows, pcl]
        poss = poss_all[:, n]
        # a prescreen-failed node's frontier dies before the step
        seed_valid = seed_valid & poss[:, None]
        phi_n, psi_n, new_valid, frontier_ovf, window_ovf = _walk_step(
            tok_c, order_c, start_c, count_c, steps[:, n],
            seed_phi, seed_psi, seed_valid, emax=emax, tmax=tmax,
        )
        accs.append(new_valid.any(-1) & poss)
        ovfts.append((seed_ovf | window_ovf) & poss)
        phi_buf[:, n] = phi_n
        psi_buf[:, n] = psi_n
        valid_buf[:, n] = new_valid
        ovf_buf[:, n] = (seed_ovf | frontier_ovf | window_ovf) & poss
    return torch.stack(accs, -1), torch.stack(ovfts, -1)
