"""Batched on-device containment: TRSeq batch x pattern bank -> bool.

The Def-4 containment test is replayed as an *embedding join*: per
(sequence, pattern) cell we scan the pattern's step program (bank.py)
and maintain a fixed-capacity frontier of partial embeddings (phi over
claimed data itemsets, psi over bound data vertices).  One step
evaluates the match predicate for every
(frontier row x window token x orientation) candidate - the
containment kernel (``kernels.containment``) - then compacts the
accepted candidates back into the ``emax`` frontier slots.  The pattern
is contained iff its frontier is non-empty after its last step.

Three query-time reductions keep the join off the B*P*T dense wall:

* **inverted token index** - tokens are bucketed per sequence by
  (type, label) key; a step only ever scans its own bucket, a ``tmax``
  window instead of all T tokens,
* **counts prescreen** (``prescreen_counts``) - psi injectivity +
  strictly increasing phi force distinct pattern TRs onto distinct data
  tokens, so ``counts[b] >= bank.req[p]`` (per key) is a sound
  necessary condition; the server joins only surviving pairs
  (``pair_contains``).  A masked pattern's ``req`` row (or a dead trie
  subtree's ``node_req``) is ``trie.REQ_MASKED``, which no count vector
  satisfies,
* **min-extraction compaction** - frontier selection is "first emax
  accepted candidates" in (row, token, orientation) order.

Exactness: every kept embedding is a genuine prefix embedding, so
``contained=True`` is always exact - truncation (frontier or token
window) can only lose matches, and any step that may have lost one sets
the cell's ``overflow`` flag.  Only ``overflow & ~contained`` cells are
undecided; the server re-checks just those against the host oracle.

Everything runs eagerly on the tensors' device.  The predicate is the
containment kernel on a CUDA tensor and its plain version on a CPU one;
everything around it (the window gather, the compaction, the phi/psi
update) is plain PyTorch.  The ``trie_fused`` layout's whole walk is
one launch of the trie-walk kernel (``fused_trie_walk``).  Every entry
point is bit-equal to its counterpart in the JAX package
(``repro.serving.batch``).

**Trie layout** (trie.py): the same step dynamics, but one frontier per
(sequence, trie *node*) instead of per (sequence, pattern) - a
level-synchronous scan over trie depth where a node's frontier is
seeded from its parent's compacted frontier, so patterns sharing a
program prefix share its join work.  Because ``_step_once`` is shared
and deterministic, trie and flat joins are bit-identical in both
``contained`` and ``overflow``.

Counters: ``predicate_calls`` counts the calls of the predicate made
by ``_step_once`` and ``fused_walks`` the calls of the fused walk; on
a CUDA device each is one kernel launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.containment.ops import contain_step
from ..kernels.trie_walk import ref as _fused_ref
from ..kernels.trie_walk.ref import gather_rows
from ..kernels.trie_walk.ops import trie_walk
from ..mining.encoding import PAD_PHI, PAD_PSI
from .trie import REQ_MASKED

# the kernels layer mirrors the serving constants locally (it stays
# import-free of serving); pin the mirrors here so a drift breaks
# loudly at import instead of silently de-synchronizing the fused walk
assert _fused_ref.PAD_PHI == int(PAD_PHI)
assert _fused_ref.PAD_PSI == int(PAD_PSI)
assert _fused_ref.REQ_MASKED == REQ_MASKED

# predicate evaluations and fused walks made by this process
predicate_calls = 0
fused_walks = 0

_I32 = torch.int32


def token_keys_np(tokens: np.ndarray, n_label_keys: int) -> np.ndarray:
    """Host mirror of the device key computation ([B,T] int, 6*NL =
    out-of-bank dump key)."""
    NL = n_label_keys
    ty, lab, val = tokens[..., 0], tokens[..., 3], tokens[..., 5]
    lab1 = lab + 1
    ok = (val > 0) & (lab1 >= 0) & (lab1 < NL)
    return np.where(ok, ty * NL + lab1, 6 * NL)


def max_key_bucket(tokens: np.ndarray, n_label_keys: int) -> int:
    """Largest same-key token bucket in the batch: the exact ``tmax``
    (no window overflow).  Host-side helper."""
    key = token_keys_np(np.asarray(tokens), n_label_keys)
    K = 6 * n_label_keys
    B = key.shape[0]
    rowed = (key + np.arange(B)[:, None] * (K + 1)).ravel()
    rowed = rowed[(key < K).ravel()]
    if not rowed.size:
        return 1
    return max(int(np.bincount(rowed).max()), 1)


def token_counts_np(tokens: np.ndarray, n_label_keys: int) -> np.ndarray:
    """Host mirror of ``build_token_index``'s ``count`` [B, K] int32:
    the same keys, bincounted.  Lets a launch prescreen on the host with
    no device read."""
    key = token_keys_np(np.asarray(tokens), n_label_keys)
    K = 6 * n_label_keys
    B = key.shape[0]
    rowed = key + np.arange(B)[:, None] * (K + 1)
    return np.bincount(
        rowed.ravel(), minlength=B * (K + 1)
    ).reshape(B, K + 1)[:, :K].astype(np.int32)


def build_token_index(tokens, *, n_label_keys: int):
    """[B,T,6] -> (order [B,T], start [B,K], count [B,K]), all int32;
    bucket k of sequence b is order[b, start[b,k] : start[b,k]+count[b,k]].
    Tokens whose label falls outside the bank's label space go to a dump
    bucket - they can never match a bank step."""
    NL = n_label_keys
    K = 6 * NL
    B, T, _ = tokens.shape
    dev = tokens.device
    ty = tokens[..., 0]
    lab1 = tokens[..., 3] + 1
    ok = (tokens[..., 5] > 0) & (lab1 >= 0) & (lab1 < NL)
    key = torch.where(ok, ty * NL + lab1,
                      torch.full_like(ty, K)).to(_I32)
    # composite sort key makes the order unique hence fully deterministic
    t_ids = torch.arange(T, dtype=_I32, device=dev)
    order = torch.argsort(key * T + t_ids[None, :], dim=1)
    kcol = torch.arange(K, dtype=_I32, device=dev)
    count = (key[:, :, None] == kcol[None, None, :]).sum(1, dtype=_I32)
    start = torch.cumsum(count, -1, dtype=_I32) - count
    return order.to(_I32), start, count


# alias kept for the JAX package's name: the index depends on the query
# batch alone (never on the bank), so it is built once per batch
token_index = build_token_index


def prescreen_counts(tokens, req, *, n_label_keys: int):
    """Sound necessary condition: possible[b,p] = counts_b >= req_p
    elementwise over token keys (see bank.req)."""
    _, _, count = build_token_index(tokens, n_label_keys=n_label_keys)
    return (count[:, None, :] >= req[None, :, :]).all(-1)


def index_and_prescreen(tokens, req, *, n_label_keys: int):
    """One pass producing both the inverted token index and the
    prescreen matrix."""
    order, start, count = build_token_index(
        tokens, n_label_keys=n_label_keys
    )
    possible = (count[:, None, :] >= req[None, :, :]).all(-1)
    return order, start, count, possible


def _step_once(tokens, order, start, count, cell_b, step_k, phi, psi,
               valid, *, emax, tmax, uniform, compact,
               count_frontier_ovf=False):
    """One embedding-join step for N cells: evaluate the match predicate
    for every (frontier row x window token x orientation) candidate of
    step row ``step_k[i]`` against sequence ``cell_b[i]``, then compact
    the accepted candidates into ``emax`` frontier slots.

    The shared core of both bank layouts.  ``uniform`` promises every
    step row is real (no ``step_valid=0`` padding), dropping one select.

    Returns ``(phi_new, psi_new, new_valid, step_ovf)`` with
    ``step_ovf = frontier_ovf | window_ovf``; with ``compact=False``
    (terminal steps) skips compaction and returns ``(accepted,
    step_ovf)``, where ``count_frontier_ovf`` folds in ``#accepted >
    emax`` (the compacted path's frontier flag) or leaves it out.
    """
    global predicate_calls
    T = tokens.shape[1]
    N, Ein, NI = phi.shape  # Ein: 1 on the root frontier, E afterwards
    NV = psi.shape[2]
    E, Tm = emax, tmax
    C = Ein * Tm * 2  # candidates: frontier rows x window x orient
    dev = phi.device
    nv_ids = torch.arange(NV, dtype=_I32, device=dev)
    ni_ids = torch.arange(NI, dtype=_I32, device=dev)
    m_ids = torch.arange(Tm, dtype=_I32, device=dev)
    cand_ids = torch.arange(C, dtype=_I32, device=dev)
    ty_s, pu1_s, pu2_s, lab_s, new_s, idx_s, sval_s, key_s = (
        step_k[:, c] for c in range(8)
    )
    cb = cell_b.long()

    # ---- per-cell token window for this step's (type,label) bucket
    st_sel = start[cb, key_s.long()]   # [N]
    ct_sel = count[cb, key_s.long()]
    wpos = torch.clamp(st_sel[:, None] + m_ids[None, :], max=T - 1)
    wvalid = m_ids[None, :] < ct_sel[:, None]
    tpos = order[cb[:, None], wpos.long()]     # [N, Tm]
    tok_w = tokens[cb[:, None], tpos.long()]   # [N, Tm, 6]
    tok_w[..., 5] = torch.where(wvalid, tok_w[..., 5], 0)

    # ---- per-row step table for the predicate
    idx_b = idx_s.long()[:, None, None].expand(N, Ein, 1)
    cur_phi = torch.gather(phi, 2, idx_b)[..., 0]
    prev_b = torch.clamp(idx_b - 1, 0, NI - 1)
    prev_phi = torch.gather(phi, 2, prev_b)[..., 0]
    prev_phi = torch.where(idx_s[:, None] > 0, prev_phi, -1)
    if uniform:
        row_valid = valid  # every step row is a real step
    else:
        row_valid = valid & (sval_s[:, None] > 0)

    def bro(x):  # [N] -> [N, Ein]
        return x[:, None].expand(N, Ein)

    srow = torch.stack(
        [bro(ty_s), bro(pu1_s), bro(pu2_s), bro(lab_s), bro(new_s),
         prev_phi, cur_phi, row_valid.to(_I32)],
        dim=-1,
    )

    # ---- match predicate over (cell, row, window token)
    bits = contain_step(tok_w.contiguous(), psi.contiguous(),
                        srow.contiguous())
    predicate_calls += 1

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

    phi_src = gather_rows(phi, e_old)
    psi_src = gather_rows(psi, e_old)

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
    return phi_new, psi_new, new_valid, frontier_ovf | window_ovf


def _root_frontier(n: int, ni: int, nv: int, device):
    """One root embedding per cell: the step-0 frontier of every join."""
    phi = torch.full((n, 1, ni), int(PAD_PHI), dtype=_I32, device=device)
    psi = torch.full((n, 1, nv), int(PAD_PSI), dtype=_I32, device=device)
    valid = torch.ones((n, 1), dtype=torch.bool, device=device)
    return phi, psi, valid


def _join(tokens, order, start, count, cell_b, cell_steps, *,
          nv, emax, tmax, uniform_length=False):
    """The embedding-join scan over N cells (cell i = sequence
    cell_b[i] vs step program cell_steps[i]).  ``uniform_length``
    promises every cell's program is exactly L steps (no padding rows),
    which lets the final step skip compaction and the state update.
    Returns (contained [N] bool, overflow [N] bool)."""
    N, L, _ = cell_steps.shape
    NI = L  # a pattern has at most as many itemsets as steps
    tokens = tokens.to(_I32)
    cell_steps = cell_steps.to(_I32)
    cell_b = cell_b.to(_I32)

    # step 0 always joins against the single root embedding, so the
    # initial frontier is one row; compaction widens it to E rows
    phi, psi, valid = _root_frontier(N, NI, nv, tokens.device)
    overflow = torch.zeros((N,), dtype=torch.bool, device=tokens.device)

    for k in range(L):
        step_k = cell_steps[:, k]
        if uniform_length and k == L - 1:
            # every cell ends at step L-1: containment just needs "any
            # candidate accepted", so compaction is skipped entirely
            accepted, window_ovf = _step_once(
                tokens, order, start, count, cell_b, step_k,
                phi, psi, valid, emax=emax, tmax=tmax,
                uniform=True, compact=False,
            )
            return accepted, overflow | window_ovf
        phi_new, psi_new, new_valid, ovf_step = _step_once(
            tokens, order, start, count, cell_b, step_k,
            phi, psi, valid, emax=emax, tmax=tmax,
            uniform=uniform_length, compact=True,
        )
        if uniform_length:
            phi, psi, valid = phi_new, psi_new, new_valid
            overflow = overflow | ovf_step
        else:
            # ---- pass-through for cells already past their last step
            alive = step_k[:, 6] > 0
            phi = torch.where(alive[:, None, None], phi_new, phi)
            psi = torch.where(alive[:, None, None], psi_new, psi)
            valid = torch.where(alive[:, None], new_valid, valid)
            overflow = torch.where(alive, ovf_step | overflow, overflow)
    return valid.any(-1), overflow


def pair_contains(tokens, steps, b_idx, p_idx, *, nv: int,
                  n_label_keys: int, emax: int = 8, tmax: int = 16,
                  uniform_length: bool = False):
    """Containment over a compacted (sequence, pattern) pair list.
    Returns (contained [N], overflow [N])."""
    order, start, count = build_token_index(
        tokens, n_label_keys=n_label_keys
    )
    return _join(
        tokens, order, start, count, b_idx, steps[p_idx.long()],
        nv=nv, emax=emax, tmax=tmax, uniform_length=uniform_length,
    )


def pair_contains_indexed(tokens, order, start, count, steps, b_idx, p_idx,
                          *, nv: int, emax: int = 8, tmax: int = 16,
                          uniform_length: bool = False):
    """``pair_contains`` with the token index precomputed (see
    ``index_and_prescreen``)."""
    return _join(
        tokens, order, start, count, b_idx, steps[p_idx.long()],
        nv=nv, emax=emax, tmax=tmax, uniform_length=uniform_length,
    )


# --------------------------------------------------------------- trie join


def trie_root_state(n: int, ni: int, nv: int, device=None):
    """The seed state for depth-1 trie cells: one root embedding per
    cell, exactly the flat join's step-0 frontier."""
    phi, psi, valid = _root_frontier(n, ni, nv, device)
    ovf = torch.zeros((n,), dtype=torch.bool, device=device)
    return phi, psi, valid, ovf


def trie_level_advance_ref(
    tokens, order, start, count,   # tokens + prebuilt inverted index
    seed_phi, seed_psi, seed_valid, seed_ovf,  # [N,Ein,*], [N,Ein], [N]
    cell_b, cell_step,             # [N], [N, STEP_FIELDS]
    *,
    emax: int,
    tmax: int,
    compact: bool = True,
    count_frontier_ovf: bool = False,
):
    """Advance N (sequence, trie node) cells one step from their seeded
    parent frontiers.  Returns ``(phi, psi, valid, accepted [N],
    ovf_state [N], ovf_term [N])``; with ``compact=False`` (leaf cells)
    just ``(accepted, ovf)``.  ``ovf_state`` (path frontier + window
    losses) is what children inherit; ``ovf_term`` drops this step's own
    frontier overflow - a terminal ending *here* is undecided only via
    ``ovf_term``.  Padding cells carry ``step_valid=0`` rows."""
    tokens = tokens.to(_I32)
    cell_step = cell_step.to(_I32)
    cell_b = cell_b.to(_I32)
    if not compact:
        accepted, step_ovf = _step_once(
            tokens, order, start, count, cell_b, cell_step,
            seed_phi, seed_psi, seed_valid, emax=emax, tmax=tmax,
            uniform=False, compact=False,
            count_frontier_ovf=count_frontier_ovf,
        )
        return accepted, seed_ovf | step_ovf
    phi, psi, valid, ovf_step = _step_once(
        tokens, order, start, count, cell_b, cell_step,
        seed_phi, seed_psi, seed_valid, emax=emax, tmax=tmax,
        uniform=False, compact=True,
    )
    ct_sel = count[cell_b.long(), cell_step[:, 7].long()]
    window_ovf = (ct_sel > tmax) & seed_valid.any(-1)
    return (phi, psi, valid, valid.any(-1), seed_ovf | ovf_step,
            seed_ovf | window_ovf)


trie_level_advance = trie_level_advance_ref


def trie_root_advance(tokens, order, start, count, cells, *, ni: int,
                      nv: int, emax: int, tmax: int, compact: bool = True):
    """``trie_level_advance`` for depth-1 cells from the root seed.
    ``cells`` packs ``[cell_b, parent_idx(unused), step row]`` as one
    [N, 2+F] int32 upload."""
    seed = trie_root_state(cells.shape[0], ni, nv, tokens.device)
    return trie_level_advance_ref(
        tokens, order, start, count, *seed, cells[:, 0], cells[:, 2:],
        emax=emax, tmax=tmax, compact=compact,
    )


def trie_level_advance_gather(tokens, order, start, count, prev_phi,
                              prev_psi, prev_valid, prev_ovf, cells, *,
                              emax: int, tmax: int, compact: bool = True):
    """``trie_level_advance`` with the parent-frontier gather in front
    (cell i seeds from the previous level's cell ``cells[i, 1]``)."""
    pidx = cells[:, 1].long()
    seed = (prev_phi[pidx], prev_psi[pidx], prev_valid[pidx],
            prev_ovf[pidx])
    return trie_level_advance_ref(
        tokens, order, start, count, *seed, cells[:, 0], cells[:, 2:],
        emax=emax, tmax=tmax, compact=compact,
    )


def index_and_node_prescreen(tokens, node_req, *, n_label_keys: int):
    """Inverted token index plus the per-node residual-``req`` prescreen
    (trie.py): ``possible[b, n] = counts_b >= node_req_n`` elementwise."""
    order, start, count = build_token_index(
        tokens, n_label_keys=n_label_keys
    )
    possible = (count[:, None, :] >= node_req[None, :, :]).all(-1)
    return order, start, count, possible


def fused_trie_walk(tokens, order, start, count, cells, steps_s, parent_s,
                    req_s, *, ni: int, nv: int, emax: int, tmax: int):
    """Walk N (sequence, depth-1 subtree) cells through their *entire*
    subtree in one launch of the trie-walk kernel.  The per-cell gathers
    (the sequence's token table + index rows by ``cells[:, 0]``, the
    packed subtree tables by ``cells[:, 1]``) run in front of it.
    Returns ``(acc [N, Nmax] bool, ovf_term [N, Nmax] bool)`` per
    subtree slot, bit-identical to the per-level ladder.  ``ni`` must be
    the *global* trie depth."""
    global fused_walks
    cell_b = cells[:, 0].long()
    s_idx = cells[:, 1].long()
    tokens = tokens.to(_I32)
    out = trie_walk(
        tokens[cell_b], order[cell_b], start[cell_b], count[cell_b],
        steps_s[s_idx], parent_s[s_idx], req_s[s_idx],
        emax=emax, tmax=tmax, ni=ni, nv=nv,
    )
    fused_walks += 1
    return out


def trie_contains_ref(tokens, lvl_steps, lvl_parent_pos, term_level,
                      term_pos, pattern_valid, *, nv: int,
                      n_label_keys: int, emax: int = 8, tmax: int = 16):
    """Dense level-synchronous trie containment: every (sequence, trie
    node) cell advances once per level; pattern answers are read off at
    their terminal (level, position).  Bit-identical to
    ``batch_contains`` over the same bank.  Returns (contained [B,P]
    bool, ovf [B,P] bool)."""
    B = tokens.shape[0]
    D, Mh, _ = lvl_steps.shape
    P = pattern_valid.shape[0]
    NI = D  # a pattern has at most as many itemsets as trie levels
    dev = tokens.device
    tokens = tokens.to(_I32)
    lvl_steps = lvl_steps.to(_I32)
    order, start, count = build_token_index(
        tokens, n_label_keys=n_label_keys
    )
    cell_b = torch.arange(B, dtype=_I32, device=dev).repeat_interleave(Mh)
    # virtual root level: one root embedding per sequence
    phi, psi, valid, _ = trie_root_state(B, NI, nv, dev)
    phi = phi[:, None]          # [B, Mprev=1, Ein=1, NI]
    psi = psi[:, None]
    valid = valid[:, None]
    ovf = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    accs, ovfs = [], []
    for d in range(D):
        pp = lvl_parent_pos[d].long()  # [Mh] (all zeros on level 0)
        seed_phi = phi[:, pp].reshape(B * Mh, *phi.shape[2:])
        seed_psi = psi[:, pp].reshape(B * Mh, *psi.shape[2:])
        seed_valid = valid[:, pp].reshape(B * Mh, valid.shape[2])
        seed_ovf = ovf[:, pp].reshape(B * Mh)
        step_d = lvl_steps[d][None].expand(
            B, Mh, lvl_steps.shape[2]).reshape(B * Mh, lvl_steps.shape[2])
        if d == D - 1:
            # the deepest level is all leaves: skip compaction but keep
            # the compacted path's frontier-overflow semantics
            accepted, lovf = trie_level_advance_ref(
                tokens, order, start, count,
                seed_phi, seed_psi, seed_valid, seed_ovf,
                cell_b, step_d, emax=emax, tmax=tmax, compact=False,
                count_frontier_ovf=True,
            )
        else:
            nphi, npsi, nvalid, accepted, lovf, _ = trie_level_advance_ref(
                tokens, order, start, count,
                seed_phi, seed_psi, seed_valid, seed_ovf,
                cell_b, step_d, emax=emax, tmax=tmax, compact=True,
            )
            phi = nphi.reshape(B, Mh, *nphi.shape[1:])
            psi = npsi.reshape(B, Mh, *npsi.shape[1:])
            valid = nvalid.reshape(B, Mh, nvalid.shape[1])
            ovf = lovf.reshape(B, Mh)
        accs.append(accepted.reshape(B, Mh))
        ovfs.append(lovf.reshape(B, Mh))
    if not accs:  # empty trie: nothing is ever contained
        zero = torch.zeros((B, P), dtype=torch.bool, device=dev)
        return zero, zero
    A = torch.stack(accs)   # [D, B, Mh]
    O = torch.stack(ovfs)
    real = (pattern_valid > 0)[None, :]
    tl, tp = term_level.long(), term_pos.long()
    contained = A[tl, :, tp].T & real
    overflow = O[tl, :, tp].T & real
    return contained, overflow


trie_contains = trie_contains_ref


def batch_contains_ref(tokens, steps, pattern_valid, *, nv: int,
                       n_label_keys: int, emax: int = 8, tmax: int = 16):
    """Dense batch x bank containment (every cell joined).  Returns
    (contained [B,P] bool, overflow [B,P] bool)."""
    B = tokens.shape[0]
    P = steps.shape[0]
    order, start, count = build_token_index(
        tokens, n_label_keys=n_label_keys
    )
    cell_b = torch.arange(B, dtype=_I32,
                          device=tokens.device).repeat_interleave(P)
    cell_steps = steps[None].expand(B, *steps.shape).reshape(
        B * P, *steps.shape[1:])
    contained, overflow = _join(
        tokens, order, start, count, cell_b, cell_steps,
        nv=nv, emax=emax, tmax=tmax,
    )
    real = (pattern_valid > 0)[None, :]
    return (contained.reshape(B, P) & real,
            overflow.reshape(B, P) & real)


batch_contains = batch_contains_ref
