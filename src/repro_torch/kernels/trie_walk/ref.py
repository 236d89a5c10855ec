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
``compact=True``) on per-cell token arrays - same candidate order, same
first-``emax`` min-extraction compaction, same overflow flags - and the
root seed is the per-level 1-wide root frontier widened to ``emax`` rows
with only row 0 valid: invalid rows flag no candidates and the candidate
order is row-major, so the compacted state agrees bitwise.  Bit-equal to
the JAX reference ``repro.kernels.trie_walk.ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..containment.ref import contain_step_core

# local mirrors of the serving-layer constants (the kernels layer stays
# import-free of serving; serving.batch asserts equality at import)
PAD_PHI = 0x3FFFFFF   # mining.encoding.PAD_PHI: +inf itemset sentinel
PAD_PSI = -2          # mining.encoding.PAD_PSI: unbound-vertex sentinel
REQ_MASKED = int(np.iinfo(np.int32).max)  # serving.trie.REQ_MASKED


def gather_rows(x, idx):
    """``x[n, idx[n, k]]`` along dim 1 for every trailing column:
    x [N, R, W], idx [N, K] -> [N, K, W] (JAX's take_along_axis with a
    [N, K, 1] index)."""
    N, K = idx.shape
    return torch.gather(x, 1, idx.long()[..., None].expand(N, K, x.shape[2]))


def _walk_step(tok_c, order_c, start_c, count_c, step_k, phi, psi,
               valid, *, emax, tmax):
    """One embedding-join step for N cells over *per-cell* token arrays
    (``tok_c[i]`` is cell i's own token table).  Returns
    ``(phi_new, psi_new, new_valid, frontier_ovf, window_ovf)``, both
    overflow legs separately."""
    T = tok_c.shape[1]
    N, Ein, NI = phi.shape
    NV = psi.shape[2]
    E, Tm = emax, tmax
    C = Ein * Tm * 2  # candidates: frontier rows x window x orient
    dev = phi.device
    nv_ids = torch.arange(NV, dtype=torch.int32, device=dev)
    ni_ids = torch.arange(NI, dtype=torch.int32, device=dev)
    m_ids = torch.arange(Tm, dtype=torch.int32, device=dev)
    cand_ids = torch.arange(C, dtype=torch.int32, device=dev)
    ty_s, pu1_s, pu2_s, lab_s, new_s, idx_s, sval_s, key_s = (
        step_k[:, c] for c in range(8)
    )

    # ---- per-cell token window for this step's (type,label) bucket
    st_sel = torch.gather(start_c, 1, key_s.long()[:, None])[:, 0]
    ct_sel = torch.gather(count_c, 1, key_s.long()[:, None])[:, 0]
    wpos = torch.clamp(st_sel[:, None] + m_ids[None, :], max=T - 1)
    wvalid = m_ids[None, :] < ct_sel[:, None]
    tpos = torch.gather(order_c, 1, wpos.long())              # [N, Tm]
    tok_w = gather_rows(tok_c, tpos)                          # [N, Tm, 6]
    tok_w[..., 5] = torch.where(wvalid, tok_w[..., 5], 0)

    # ---- per-row step table for the predicate
    idx_b = idx_s.long()[:, None, None].expand(N, Ein, 1)
    cur_phi = torch.gather(phi, 2, idx_b)[..., 0]
    prev_b = torch.clamp(idx_b - 1, 0, NI - 1)
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

    # ---- first-emax compaction by iterative min-extraction (the same
    # candidate order and extraction as _step_once)
    flags = (torch.stack([bits & 1, (bits >> 1) & 1], -1) > 0).reshape(N, C)
    window_ovf = (ct_sel > Tm) & valid.any(-1)
    cand_row = cand_ids[None, :]
    sels = []
    last = torch.full((N, 1), -1, dtype=torch.int32, device=dev)
    for _ in range(E):
        cur = torch.where(flags & (cand_row > last), cand_row, C).amin(
            -1, keepdim=True)
        sels.append(cur)
        last = cur
    frontier_ovf = torch.where(
        flags & (cand_row > last), cand_row, C).amin(-1) < C
    sel = torch.cat(sels, -1)  # [N, E] ascending, C = empty
    new_valid = sel < C
    sel = torch.clamp(sel, max=C - 1)
    e_old = sel // (Tm * 2)
    t_w = (sel // 2) % Tm
    var = sel % 2

    phi_src = gather_rows(phi, e_old)
    psi_src = gather_rows(psi, e_old)

    def wfield(f):  # [N, E] gather of tok_w[n, t_w, f]
        return torch.gather(tok_w[..., f], 1, t_w.long())

    u1_g, u2_g, j_g = wfield(1), wfield(2), wfield(4)

    claim = (new_s[:, None] > 0) & new_valid
    onehot_ni = ni_ids[None, None, :] == idx_s[:, None, None]
    phi_new = torch.where(onehot_ni & claim[..., None], j_g[..., None],
                          phi_src)

    a_g = torch.where(var == 0, u1_g, u2_g)
    b_g = torch.where(var == 0, u2_g, u1_g)
    is_v = (ty_s <= 2)[:, None]
    pu1_b = pu1_s.long()[:, None, None].expand(N, E, 1)
    pu2_b = pu2_s.long()[:, None, None].expand(N, E, 1)
    fresh1 = torch.gather(psi_src, 2, pu1_b)[..., 0] < 0
    fresh2 = torch.gather(psi_src, 2, pu2_b)[..., 0] < 0
    onehot1 = nv_ids[None, None, :] == pu1_s[:, None, None]
    onehot2 = nv_ids[None, None, :] == pu2_s[:, None, None]
    assign1 = torch.where(is_v, u1_g, a_g)
    psi_new = torch.where(onehot1 & (fresh1 & new_valid)[..., None],
                          assign1[..., None], psi_src)
    psi_new = torch.where(
        onehot2 & ((~is_v) & fresh2 & new_valid)[..., None],
        b_g[..., None], psi_new)
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
    root_phi = torch.full((N, E, ni), PAD_PHI, dtype=i32, device=dev)
    root_psi = torch.full((N, E, nv), PAD_PSI, dtype=i32, device=dev)
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
