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
  subtree's ``node_req``) is ``kernels.REQ_MASKED``, which no count vector
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
so is the compaction and phi/psi update after it (the step-compaction
kernel, ``kernels.step_compact``).  The window gather and the step table
in front of the predicate are plain PyTorch.  The ``trie_fused``
layout's whole walk is one launch of the trie-walk kernel
(``fused_trie_walk``).  Every entry point is bit-equal to its
counterpart in the JAX package (``repro.serving.batch``).

**Trie layout** (trie.py): the same step dynamics, but one frontier per
(sequence, trie *node*) instead of per (sequence, pattern) - a
level-synchronous scan over trie depth where a node's frontier is
seeded from its parent's compacted frontier, so patterns sharing a
program prefix share its join work.  Because ``_step_once`` is shared
and deterministic, trie and flat joins are bit-identical in both
``contained`` and ``overflow``.

Counters: ``predicate_calls`` counts the calls of the predicate made
by ``_step_once`` and ``fused_walks`` the calls of the fused walk; on
a CUDA device each is one kernel launch (a predicate call also one of
the step-compaction kernel).  Each ``_step_once`` call is one
``serving.step`` span (``obs.trace``), in every layout.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import INT32_MIN, PAD_PHI, PAD_PSI
from ..kernels.containment.ops import contain_step
from ..kernels.step_compact.ops import step_compact
from ..kernels.trie_walk.ops import trie_walk_cells
from ..obs import trace

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


@functools.lru_cache(maxsize=None)
def _range_bounds(wrap, hi, device):
    """``_step_ranges``' bounds on the device, once for each set of axis
    lengths: what a negative field wraps by, and its lower and upper
    clamps."""
    return (torch.tensor(wrap, dtype=_I32, device=device),
            torch.zeros(len(hi), dtype=_I32, device=device),
            torch.tensor(hi, dtype=_I32, device=device))


def _step_ranges(cell_b, step_k, *, n_seq, n_keys, ni, nv):
    """The indices of a join step as JAX reads them, worked out on the
    index fields alone: the sequence ``cell_b`` and the step key are its
    plain indexing ``x[i, j]`` into ``n_seq`` sequences and ``n_keys``
    keys (out of range they wrap once, then clamp); the itemset slot
    ``idx`` and the vertices ``pu1``/``pu2`` are its take_along_axis into
    ``ni`` and ``nv`` entries (wrapped once when in ``[-n, 0)``, any
    other index reads INT32_MIN); ``prev_phi``'s slot ``idx - 1`` is
    clipped into ``[0, ni)``.  ``step_k`` is [N, F] or [N, L, F] for [N]
    cells.  Returns ``(cb, key, idx, idx_ok, pu, pu_ok, prev)``: the
    indices clamped into range (int64) beside the in-range masks of the
    filled ones; ``pu`` and ``pu_ok`` are [..., 2]."""
    lead = step_k.shape[:-1]
    cell = cell_b.reshape(cell_b.shape[0], *(1,) * len(lead))
    f = torch.cat([step_k[..., 1:3], step_k[..., 5:6], step_k[..., 7:8],
                   cell.expand(*lead, 1).to(_I32), step_k[..., 5:6] - 1],
                  -1)
    top = [max(n - 1, 0) for n in (nv, nv, ni, n_keys, n_seq, ni)]
    wrap, lo, hi = _range_bounds((nv, nv, ni, n_keys, n_seq, 0),
                                 tuple(top), f.device)
    f = torch.where(f < 0, f + wrap, f)
    c = torch.clamp(f, lo, hi)
    ok = c == f
    c = c.long()
    return (c[..., 4], c[..., 3], c[..., 2], ok[..., 2], c[..., 0:2],
            ok[..., 0:2], c[..., 5])


def _spanned(name: str):
    """Run the decorated function inside one ``obs.trace`` span."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with trace.span(name):
                return fn(*args, **kw)
        return inner
    return wrap


@_spanned("serving.step")
def _step_once(tokens, order, start, count, cell_b, step_k, phi, psi,
               valid, *, emax, tmax, uniform, compact,
               count_frontier_ovf=False, ranges=None):
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
    ``ranges`` is ``_step_ranges`` of these cells and step rows where the
    caller has worked it out already.
    """
    global predicate_calls
    T = tokens.shape[1]
    N, Ein, NI = phi.shape  # Ein: 1 on the root frontier, E afterwards
    NV = psi.shape[2]
    Tm = tmax
    m_ids = torch.arange(Tm, dtype=_I32, device=phi.device)
    ty_s, pu1_s, pu2_s, lab_s, new_s, idx_s, sval_s, key_s = (
        step_k[:, c] for c in range(8)
    )
    if ranges is None:
        ranges = _step_ranges(cell_b, step_k, n_seq=start.shape[0],
                              n_keys=start.shape[1], ni=NI, nv=NV)
    cb, key, idx_c, idx_ok, pu_c, pu_ok, prev_b = ranges

    # ---- per-cell token window for this step's (type,label) bucket;
    # start and order come from build_token_index, so the window reads
    # are in range
    st_sel = start[cb, key]   # [N]
    ct_sel = count[cb, key]
    wpos = torch.clamp(st_sel[:, None] + m_ids[None, :], max=T - 1)
    wvalid = m_ids[None, :] < ct_sel[:, None]
    tpos = order[cb[:, None], wpos.long()]     # [N, Tm]
    tok_w = tokens[cb[:, None], tpos.long()]   # [N, Tm, 6]
    tok_w[..., 5] = torch.where(wvalid, tok_w[..., 5], 0)

    # ---- per-row step table for the predicate
    cur_phi = torch.gather(phi, 2, idx_c[:, None, None].expand(N, Ein, 1))
    cur_phi = torch.where(idx_ok[:, None], cur_phi[..., 0], INT32_MIN)
    prev_phi = torch.gather(phi, 2, prev_b[:, None, None].expand(N, Ein, 1))
    prev_phi = torch.where(idx_s[:, None] > 0, prev_phi[..., 0], -1)
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

    # ---- compaction into the emax frontier slots and the phi / psi
    # update: one launch of the step-compaction kernel on a CUDA tensor
    return step_compact(bits, tok_w, phi, psi, valid, step_k, ct_sel,
                        pu_c, pu_ok, emax=emax, tmax=Tm, compact=compact,
                        count_frontier_ovf=count_frontier_ovf)


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
    # the range handling of every step at once
    ranges = _step_ranges(cell_b, cell_steps, n_seq=start.shape[0],
                          n_keys=start.shape[1], ni=NI, nv=nv)

    for k in range(L):
        step_k = cell_steps[:, k]
        rk = tuple(r[:, k] for r in ranges)
        if uniform_length and k == L - 1:
            # every cell ends at step L-1: containment just needs "any
            # candidate accepted", so compaction is skipped entirely
            accepted, window_ovf = _step_once(
                tokens, order, start, count, cell_b, step_k,
                phi, psi, valid, emax=emax, tmax=tmax,
                uniform=True, compact=False, ranges=rk,
            )
            return accepted, overflow | window_ovf
        phi_new, psi_new, new_valid, ovf_step = _step_once(
            tokens, order, start, count, cell_b, step_k,
            phi, psi, valid, emax=emax, tmax=tmax,
            uniform=uniform_length, compact=True, ranges=rk,
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
    ranges = _step_ranges(cell_b, cell_step, n_seq=start.shape[0],
                          n_keys=start.shape[1], ni=seed_phi.shape[2],
                          nv=seed_psi.shape[2])
    phi, psi, valid, ovf_step = _step_once(
        tokens, order, start, count, cell_b, cell_step,
        seed_phi, seed_psi, seed_valid, emax=emax, tmax=tmax,
        uniform=False, compact=True, ranges=ranges,
    )
    ct_sel = count[ranges[0], ranges[1]]
    window_ovf = (ct_sel > tmax) & seed_valid.any(-1)
    return (phi, psi, valid, valid.any(-1), seed_ovf | ovf_step,
            seed_ovf | window_ovf)


trie_level_advance = trie_level_advance_ref


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
    subtree in one launch of the trie-walk kernel.  Cell i walks the
    packed subtree ``cells[i, 1]`` over the sequence ``cells[i, 0]``'s
    token table and index rows.  On CUDA the kernel reads those tables
    in place through ``cells`` (no per-cell copy runs in front of it);
    on the CPU the plain version gathers them.  Returns ``(acc [N, Nmax]
    bool, ovf_term [N, Nmax] bool)`` per subtree slot, bit-identical to
    the per-level ladder.  ``ni`` must be the *global* trie depth."""
    global fused_walks
    out = trie_walk_cells(
        tokens.to(_I32), order, start, count, cells, steps_s, parent_s,
        req_s, emax=emax, tmax=tmax, ni=ni, nv=nv,
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
