"""Random match_count scan inputs made with numpy from a seed, shared by
the CPU tests against the JAX package, the tests on the card and
``chip_smoke.py``."""
import numpy as np
import torch

from repro_torch.kernels.match_count.ref import match_core
from repro_torch.mining.encoding import (
    PAD_PHI,
    PAD_PSI,
    _LAB_BITS,
    _PU_BITS,
    _SL_BITS,
    _TY_BITS,
)

# the (E, T) sweep of the JAX package's kernel tests
SHAPES = [(1, 1), (3, 7), (64, 128), (65, 129), (128, 60), (17, 300)]
# the existing-TR tables: ``random`` holds up to 6 real rows then -9
# padding, as encode_pattern_trs pads; the others put duplicates of real
# candidates where a scan that stops early or compares too little would
# miss or invent them:
#   after_pad    real rows after a -9 row, a duplicate among them;
#   full         all P rows real, duplicates in the last rows;
#   odd_itemset  a candidate's row with its itemset field >= NI or
#                negative but not -9 (never a duplicate);
#   last_field   one candidate's row, and another's that differs from
#                it only in the last field (the label)
TABLES = ("random", "after_pad", "full", "odd_itemset", "last_field")
# the row -> pattern ids: ``random``; ``runs``, ascending contiguous runs
# followed by padded rows (pattern 0, emb_valid 0, PAD_PHI / PAD_PSI), as
# the miner packs a chunk; ``one``, every row pattern 0
PIDS = ("random", "runs", "one")
# (NI, NV, P) other than the main path's 16, 12, 64: the kernel takes
# every size at run time, so these run the same code
WIDTHS = [(8, 8, 64), (5, 7, 64), (1, 1, 3), (16, 12, 100)]


def _real_rows(rng, k):
    """``k`` random existing-TR rows with in-range itemset fields."""
    rows = np.empty((k, 5), np.int32)
    rows[:, 0] = rng.integers(0, 3, k)
    rows[:, 1] = rng.integers(0, 6, k)
    rows[:, 2] = rng.integers(0, 4, k)
    rows[:, 3] = np.where(rows[:, 1] <= 2, 15, rng.integers(0, 5, k))
    rows[:, 4] = rng.integers(-1, 5, k)
    return rows


def _candidates(tokens, gid, phi, psi, valid, pid, nv_stack):
    """Per pattern, the (slot, ty, pu1, pu2, lab) rows of the in-itemset
    candidates its valid rows emit against an empty table: what a
    duplicate row must equal.  Decoded from the plain version's packed
    signatures (the fields do not depend on the search phase)."""
    t = torch.from_numpy
    sigs = match_core(
        t(tokens)[t(gid).long()], t(phi), t(psi), t(valid),
        torch.full((1, 5), -9, dtype=torch.int32),
        t(nv_stack)[t(pid).long()], 0, 0).numpy()
    in_set = (sigs >= 0) & ((sigs >> 30) == 0) & (valid[:, None] > 0)
    e, _ = np.nonzero(in_set)
    v = sigs[in_set].astype(np.int64)
    lab = (v & ((1 << _LAB_BITS) - 1)) - 1
    v >>= _LAB_BITS
    pu2 = v & ((1 << _PU_BITS) - 1)
    v >>= _PU_BITS
    pu1 = v & ((1 << _PU_BITS) - 1)
    v >>= _PU_BITS
    ty = v & ((1 << _TY_BITS) - 1)
    slot = (v >> _TY_BITS) & ((1 << _SL_BITS) - 1)
    rows = np.stack([slot, ty, pu1, pu2, lab], 1).astype(np.int32)
    return {int(p): rows[pid[e] == p] for p in np.unique(pid[e])}


def _edge_table(rng, kind, cands, P, NI):
    """One pattern's [P,5] existing table of kind ``kind`` (see
    TABLES), built around its candidates ``cands`` [n,5]."""
    pick = (cands[rng.permutation(len(cands))[:2]] if len(cands)
            else _real_rows(rng, 2))
    if len(pick) < 2:
        pick = np.concatenate([pick, _real_rows(rng, 1)])
    tab = np.full((P, 5), -9, np.int32)
    if kind == "after_pad":
        k = int(rng.integers(0, 3))
        rows = [_real_rows(rng, k), np.full((1, 5), -9, np.int32), pick[:1],
                _real_rows(rng, 1), pick[1:]]
    elif kind == "full":
        rows = [_real_rows(rng, max(P - 2, 0)), pick]
    elif kind == "odd_itemset":
        odd = pick.copy()
        odd[:, 0] = rng.choice([-1, -2, -10, NI, NI + 3], 2)
        rows = [_real_rows(rng, int(rng.integers(0, 4))), odd]
    else:  # last_field
        near = pick[1:].copy()
        near[:, 4] += 1
        rows = [_real_rows(rng, int(rng.integers(0, 3))), pick[:1], near]
    rows = np.concatenate(rows)[:P]
    tab[:len(rows)] = rows
    return tab


def scan_inputs(rng, E, G, T, NI, NV, P, NP, tables="random",
                pids="random"):
    """Per-row scan inputs: random tokens (pad tokens included), embedding
    rows with PAD_PHI / PAD_PSI columns and padded rows (emb_valid 0),
    pattern ids laid out as ``pids`` says, and existing tables of kind
    ``tables`` (TABLES) holding real TR rows so the duplicate rejection
    fires.  The defaults draw the same inputs as before the edge kinds
    existed."""
    tokens = np.zeros((G, T, 6), np.int32)
    tokens[..., 0] = rng.integers(0, 6, (G, T))
    tokens[..., 1] = rng.integers(0, 8, (G, T))
    tokens[..., 2] = np.where(
        tokens[..., 0] >= 3, rng.integers(0, 8, (G, T)), -1)
    tokens[..., 2] = np.where(
        (tokens[..., 0] >= 3) & (tokens[..., 2] == tokens[..., 1]),
        (tokens[..., 2] + 1) % 8, tokens[..., 2])
    tokens[..., 3] = rng.integers(-1, 5, (G, T))
    tokens[..., 4] = np.sort(rng.integers(0, 6, (G, T)), axis=1)
    tokens[..., 5] = rng.integers(0, 2, (G, T))
    pad_tok = rng.random((G, T)) < 0.2  # encode_db's pad rows
    tokens[pad_tok] = (0, -1, -1, -1, 0, 0)
    gid = rng.integers(0, G, (E,)).astype(np.int32)
    phi = np.sort(rng.integers(0, 6, (E, NI)), axis=1).astype(np.int32)
    n_it = rng.integers(0, min(NI, 4) + 1, (E,))
    phi[np.arange(NI)[None, :] >= n_it[:, None]] = PAD_PHI
    psi = np.full((E, NV), PAD_PSI, np.int32)
    for e in range(E):
        m = int(rng.integers(0, min(NV, 8) + 1))
        psi[e, :m] = rng.permutation(8)[:m]
    valid = (rng.random(E) < 0.8).astype(np.int32)
    pid = rng.integers(0, NP, (E,)).astype(np.int32)
    ex_stack = np.full((NP, P, 5), -9, np.int32)
    for p in range(NP):
        k = int(rng.integers(0, min(P, 6) + 1))
        ex_stack[p, :k, 0] = rng.integers(0, 3, k)
        ex_stack[p, :k, 1] = rng.integers(0, 6, k)
        ex_stack[p, :k, 2] = rng.integers(0, 4, k)
        ex_stack[p, :k, 3] = np.where(ex_stack[p, :k, 1] <= 2, 15,
                                      rng.integers(0, 5, k))
        ex_stack[p, :k, 4] = rng.integers(-1, 5, k)
    nv_stack = rng.integers(0, 6, (NP,)).astype(np.int32)
    npat_stack = rng.integers(0, 4, (NP,)).astype(np.int32)

    if pids == "one":
        pid[:] = 0
    elif pids == "runs":
        n_pad = int(rng.integers(0, E // 4 + 1))
        n_real = E - n_pad
        n_used = int(rng.integers(1, max(min(NP, n_real), 1) + 1))
        cuts = np.sort(rng.integers(0, n_real + 1, n_used - 1))
        lens = np.diff(np.concatenate([[0], cuts, [n_real]]))
        first = int(rng.integers(0, NP - n_used + 1))
        pid[:] = 0
        pid[:n_real] = np.repeat(np.arange(first, first + n_used), lens)
        gid[n_real:] = 0
        phi[n_real:] = PAD_PHI
        psi[n_real:] = PAD_PSI
        valid[n_real:] = 0
    elif pids != "random":
        raise ValueError(f"unknown pid layout {pids!r}")
    if tables != "random":
        if tables not in TABLES:
            raise ValueError(f"unknown table kind {tables!r}")
        cands = _candidates(tokens, gid, phi, psi, valid, pid, nv_stack)
        empty = np.zeros((0, 5), np.int32)
        for p in range(NP):
            ex_stack[p] = _edge_table(rng, tables, cands.get(p, empty), P,
                                      NI)
    return tokens, gid, phi, psi, valid, pid, ex_stack, nv_stack, npat_stack
