"""Plain PyTorch version of the join step's compaction kernel.

One embedding-join step (``serving.batch._step_once``) evaluates the
match predicate for every (frontier row e, window token t, orientation
o) candidate ``c = (e*Tm + t)*2 + o`` of N cells (``contain_step``'s
2-bit masks), then keeps the first ``emax`` accepted candidates in that
order as the cell's next frontier and updates their phi / psi rows.
``step_compact_core`` is everything after the predicate: the first-E
extraction, the frontier and window overflow flags, and the phi / psi
update - or, on a terminal step, whether any candidate was accepted.
It is the code ``_step_once`` ran inline, unchanged, and bit-equal to
the JAX package's ``repro.serving.batch._step_once``.
"""
from __future__ import annotations

import torch

from .. import INT32_MIN, gather_cell_rows

_I32 = torch.int32


def step_compact_core(bits, tok_w, phi, psi, valid, step_k, ct_sel, pu_c,
                      pu_ok, *, emax, tmax, compact,
                      count_frontier_ovf=False):
    """The compaction and frontier update of one join step for N cells.

    bits [N,Ein,Tm] int32 (the predicate's masks), tok_w [N,Tm,6] (the
    step's token window), phi [N,Ein,NI], psi [N,Ein,NV], valid [N,Ein]
    bool (the frontier going into the step), step_k [N,8] (the step
    rows), ct_sel [N] (the window bucket's token count), and ``pu_c``
    [N,2] / ``pu_ok`` [N,2] (the step's pattern vertices as
    ``_step_ranges`` reads them: clamped into range, and whether they
    were in range).

    Returns ``(phi_new [N,E,NI], psi_new [N,E,NV], new_valid [N,E],
    frontier_ovf | window_ovf [N])``; a slot past ``new_valid`` copies
    frontier row ``Ein - 1`` with no update (its candidate clamps to
    ``C - 1``).  With ``compact=False`` returns ``(accepted [N],
    window_ovf [N])``, with ``frontier_ovf`` (``#accepted > emax``)
    folded in when ``count_frontier_ovf``."""
    N, Ein, NI = phi.shape
    NV = psi.shape[2]
    E, Tm = emax, tmax
    C = Ein * Tm * 2  # candidates: frontier rows x window x orient
    dev = phi.device
    nv_ids = torch.arange(NV, dtype=_I32, device=dev)
    ni_ids = torch.arange(NI, dtype=_I32, device=dev)
    cand_ids = torch.arange(C, dtype=_I32, device=dev)
    ty_s, pu1_s, pu2_s, new_s, idx_s = (
        step_k[:, c] for c in (0, 1, 2, 4, 5))

    # ---- compact accepted candidates into the emax frontier slots:
    # first E in (row, token, orientation) order, by iterative
    # min-extraction
    flags = (torch.stack([bits & 1, (bits >> 1) & 1], -1) > 0).reshape(N, C)
    # a truncated window may lose matches only if the frontier was
    # still live going into the step
    window_ovf = (ct_sel > Tm) & valid.any(-1)
    if not compact:
        if count_frontier_ovf:
            # equals the compacted path's frontier flag: the first-E
            # extraction leaves a flagged candidate iff #accepted > E
            frontier_ovf = flags.sum(-1) > E
            return flags.any(-1), window_ovf | frontier_ovf
        return flags.any(-1), window_ovf
    cand_row = cand_ids[None, :]
    sels = []
    last = torch.full((N, 1), -1, dtype=_I32, device=dev)
    for _ in range(E):
        cur = torch.where(flags & (cand_row > last), cand_row, C).amin(
            -1, keepdim=True)
        sels.append(cur)
        last = cur
    # anything still flagged past the E extracted slots was dropped
    frontier_ovf = torch.where(
        flags & (cand_row > last), cand_row, C).amin(-1) < C
    sel = torch.cat(sels, -1)  # [N, E] ascending, C = empty
    new_valid = sel < C
    sel = torch.clamp(sel, max=C - 1)
    e_old = sel // (Tm * 2)
    t_w = (sel // 2) % Tm
    var = sel % 2

    # e_old < Ein and t_w < Tm by construction: these gathers are in range
    phi_src = gather_cell_rows(phi, e_old)
    psi_src = gather_cell_rows(psi, e_old)

    def wfield(f):  # [N, E] gather of tok_w[n, t_w, f]
        return torch.gather(tok_w[..., f], 1, t_w.long())

    u1_g, u2_g, j_g = wfield(1), wfield(2), wfield(4)

    # phi: the first TR of a new pattern itemset claims data itemset j
    claim = (new_s[:, None] > 0) & new_valid
    onehot_ni = ni_ids[None, None, :] == idx_s[:, None, None]
    phi_new = torch.where(onehot_ni & claim[..., None], j_g[..., None],
                          phi_src)

    # psi: fresh pattern vertices bind per the matched orientation
    a_g = torch.where(var == 0, u1_g, u2_g)
    b_g = torch.where(var == 0, u2_g, u1_g)
    is_v = (ty_s <= 2)[:, None]
    fresh = torch.where(
        pu_ok[:, None, :],
        torch.gather(psi_src, 2, pu_c[:, None, :].expand(N, E, 2)),
        INT32_MIN) < 0
    fresh1, fresh2 = fresh[..., 0], fresh[..., 1]
    onehot1 = nv_ids[None, None, :] == pu1_s[:, None, None]
    onehot2 = nv_ids[None, None, :] == pu2_s[:, None, None]
    assign1 = torch.where(is_v, u1_g, a_g)
    psi_new = torch.where(onehot1 & (fresh1 & new_valid)[..., None],
                          assign1[..., None], psi_src)
    psi_new = torch.where(
        onehot2 & ((~is_v) & fresh2 & new_valid)[..., None],
        b_g[..., None], psi_new)
    return phi_new, psi_new, new_valid, frontier_ovf | window_ovf
