"""The miner's slice grouping (``engine.signature_entries`` and
``engine.group_slice``) against a frozen copy of the per-chunk
aggregate and dict merge it replaced: per item the same signatures in
the same order, the same gid sets and the same (e, t) rows in the same
order; the one-chunk dict form against the JAX package's; and whole
expansions and jobs of a miner on that frozen path against the miner
as it is, children, gid sets, blocks and order.  The support bound on a
slice's keys (``engine.bound_slice``) against a copy of the child loop
that canonicalises every key: the same children, gid sets, blocks and
order, and every dropped key a child below the minimum support."""
import time
from typing import Dict, List, Set, Tuple

import numpy as np
import pytest

from repro.mining.engine import aggregate_host_batch as j_aggregate_host_batch

from repro_torch.core.canonical import canonical_form
from repro_torch.core.enumerate_host import apply_extension
from repro_torch.core.graphseq import TRType
from repro_torch.core.reverse_search import parent
from repro_torch.data.synthetic import Table3Params, generate_table3_db
from repro_torch.mining import driver
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.mining.encoding import (PAD_PHI, PAD_PSI, SENT_V,
                                         EmbBlock, encode_pattern_trs,
                                         pack_signature,
                                         signature_to_extkey)
from repro_torch.mining.engine import (SliceGroups, aggregate_host_batch,
                                       bound_slice, group_slice,
                                       signature_entries)


# ----------------------------------------------- the frozen merge path
def _frozen_group_finalize(svals, e_idx, t_idx, g):
    order = np.lexsort((t_idx, e_idx, svals))
    svals = svals[order]
    e_idx = e_idx[order]
    t_idx = t_idx[order]
    g = g[order]
    bounds = np.nonzero(np.diff(svals))[0] + 1
    et_groups = np.split(np.stack([e_idx, t_idx], axis=1), bounds)
    gorder = np.lexsort((g, svals))
    s2, g2 = svals[gorder], g[gorder]
    keep = np.empty(len(s2), bool)
    keep[:1] = True
    keep[1:] = (s2[1:] != s2[:-1]) | (g2[1:] != g2[:-1])
    s2, g2 = s2[keep], g2[keep]
    gid_groups = np.split(g2, np.nonzero(np.diff(s2))[0] + 1)
    keys = svals[np.concatenate([[0], bounds])]
    return keys, gid_groups, et_groups


def _frozen_aggregate_host_batch(sigs, gids, pids):
    E, T = sigs.shape
    flat = sigs.reshape(-1).astype(np.int64)
    idx = np.nonzero(flat >= 0)[0]
    if not len(idx):
        return {}
    e_idx = (idx // T).astype(np.int32)
    t_idx = (idx % T).astype(np.int32)
    svals = (np.asarray(pids, np.int64)[e_idx] << 32) | flat[idx]
    g = np.asarray(gids)[e_idx]
    keys, gid_groups, et_groups = _frozen_group_finalize(svals, e_idx,
                                                         t_idx, g)
    return {
        (int(k >> 32), int(k & 0xFFFFFFFF)): (set(gg.tolist()), et)
        for k, gg, et in zip(keys, gid_groups, et_groups)
    }


def _frozen_merge(merged, start, offs, sigs, gid, pid):
    """One chunk folded into the per-item ``{sig: (gids, [et])}``."""
    for (pi, sig), (gset, et) in _frozen_aggregate_host_batch(
            sigs, gid, pid).items():
        et = et.copy()
        et[:, 0] += start - offs[pi]
        got = merged[pi].get(sig)
        if got is None:
            merged[pi][sig] = (gset, [et])
        else:
            got[0].update(gset)
            got[1].append(et)


class FrozenMiner(AcceleratedMiner):
    """The miner with its scan, merge and child expansion as they were
    before the slice grouping (the embedding rebuild is shared)."""

    def _scan_batch(self, items, modes):
        n = len(items)
        n_pad = driver._pow2_pad(n)
        nv_stack = np.zeros(n_pad, np.int32)
        npat_stack = np.zeros(n_pad, np.int32)
        mode_stack = np.zeros(n_pad, np.int32)
        ex_stack = np.full((n_pad, driver.MAX_PATTERN_TRS, 5), -9, np.int32)
        for i, (pattern, _) in enumerate(items):
            nv_stack[i] = len(driver.pattern_vertices(pattern))
            npat_stack[i] = len(pattern)
            mode_stack[i] = modes[i]
            ex_stack[i] = encode_pattern_trs(pattern, driver.MAX_PATTERN_TRS)
        lens = np.asarray([len(b) for _, b in items], np.int64)
        offs = np.cumsum(lens) - lens
        R = int(lens.sum())
        if R:
            gid_all = np.concatenate([b.gid for _, b in items])
            phi_all = np.concatenate([b.phi for _, b in items])
            psi_all = np.concatenate([b.psi for _, b in items])
            pid_all = np.repeat(np.arange(n, dtype=np.int32), lens)
        ex_j, nv_j, npat_j, mode_j = (self._to_device(a) for a in (
            ex_stack, nv_stack, npat_stack, mode_stack))
        merged = [{} for _ in items]
        for start in range(0, R, self.e_batch):
            E = min(self.e_batch, R - start)
            Epad = driver._pow2_pad(E, cap=self.e_batch)
            sl = slice(start, start + E)
            gid, phi, psi, pid = (gid_all[sl], phi_all[sl], psi_all[sl],
                                  pid_all[sl])
            if Epad > E:
                gid = np.pad(gid, (0, Epad - E))
                phi = np.pad(phi, ((0, Epad - E), (0, 0)),
                             constant_values=PAD_PHI)
                psi = np.pad(psi, ((0, Epad - E), (0, 0)),
                             constant_values=PAD_PSI)
                pid = np.pad(pid, (0, Epad - E))
            valid = np.zeros((Epad,), np.int32)
            valid[:E] = 1
            t0 = time.perf_counter()
            sigs = driver.match_signatures_batch(
                self.tokens, *(self._to_device(a) for a in (
                    gid, phi, psi, valid, pid)),
                ex_j, nv_j, npat_j, mode_j)
            self._c_device_s.inc(time.perf_counter() - t0)
            self._c_calls.inc()
            _frozen_merge(merged, start, offs, sigs.cpu().numpy(), gid, pid)
        return merged

    def _children_from_merged(self, pattern, block, merged, min_support,
                              rs, want_embs):
        by_child = {}
        for sig, (gset, et_rows) in merged.items():
            key = signature_to_extkey(sig)
            if max(key[1].u1, key[1].u2) >= self.nv:
                continue
            child = canonical_form(apply_extension(pattern, key))
            if child in by_child:
                by_child[child][0].update(gset)
            else:
                by_child[child] = (set(gset), sig, et_rows)
        out = []
        for child, (gids, sig, et_rows) in by_child.items():
            if len(gids) < min_support:
                continue
            if rs and parent(child) != pattern:
                continue
            if want_embs is not None and not want_embs(child):
                out.append((child, gids, self._no_embs))
                continue
            child_raw = apply_extension(pattern, signature_to_extkey(sig))
            et = np.concatenate(et_rows, axis=0)
            out.append((child, gids, self._rebuild_embeddings(
                pattern, block, sig, et[:, 0], et[:, 1], child_raw)))
        return out

    def expand_children_batch(self, items, min_support, *, rs=True,
                              want_embs=None):
        out = [[] for _ in items]
        live = [(i, p, self._as_block(e)) for i, (p, e) in enumerate(items)
                if len(p) < self.ni]
        if not live:
            return out
        modes = [self._phase_mode(p, rs) for _, p, _ in live]
        merged = self._scan_batch([(p, b) for _, p, b in live], modes)
        for (i, p, b), m in zip(live, merged):
            out[i] = self._children_from_merged(p, b, m, min_support, rs,
                                                want_embs)
        return out


# --------------------------------------------------- grouping vs merge
Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray, int]  # sigs, gid, pid, start
PerItem = List[List[Tuple[int, Set[int], np.ndarray]]]


def _chunks(rng, lens, e_batch, T, sig_values, n_seq, empty=()):
    """A slice of items with ``lens`` rows each, cut into pow-2 padded
    chunks of ``e_batch`` rows as the scan cuts them; each valid
    (row, token) draws a signature from ``sig_values``; the chunks
    numbered in ``empty`` hold no valid entry."""
    lens = np.asarray(lens, np.int64)
    R = int(lens.sum())
    pid_all = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    gid_all = rng.integers(0, n_seq, R).astype(np.int32)
    out: List[Chunk] = []
    for c, start in enumerate(range(0, R, e_batch)):
        E = min(e_batch, R - start)
        Epad = driver._pow2_pad(E, cap=e_batch)
        sigs = np.full((Epad, T), -1, np.int32)
        if c not in empty:
            pick = rng.integers(0, len(sig_values), (E, T))
            hit = rng.random((E, T)) < 0.4
            sigs[:E] = np.where(hit, np.asarray(sig_values, np.int32)[pick],
                                -1)
        gid = np.pad(gid_all[start:start + E], (0, Epad - E))
        pid = np.pad(pid_all[start:start + E], (0, Epad - E))
        out.append((sigs, gid, pid, start))
    return out, np.cumsum(lens) - lens


def _by_merge(chunks: List[Chunk], offs) -> PerItem:
    merged: List[Dict] = [{} for _ in offs]
    for sigs, gid, pid, start in chunks:
        _frozen_merge(merged, start, offs, sigs, gid, pid)
    return [[(sig, gset, np.concatenate(ets)[:, 0], np.concatenate(ets)[:, 1])
             for sig, (gset, ets) in m.items()] for m in merged]


def _by_group(chunks: List[Chunk], offs) -> PerItem:
    parts = []
    for sigs, gid, pid, start in chunks:
        keys, e, t, g = signature_entries(sigs, gid, pid)
        parts.append((keys, e + start, t, g))
    gr = group_slice(parts, offs)
    out = []
    for i in range(len(offs)):
        item = []
        for k in range(gr.items[i], gr.items[i + 1]):
            rows = slice(gr.row_lo[k], gr.row_hi[k])
            gids = gr.gids[gr.gid_lo[k]:gr.gid_hi[k]]
            assert np.all(np.diff(gids) > 0)
            item.append((int(gr.sig[k]), set(gids.tolist()), gr.e[rows],
                         gr.t[rows]))
        out.append(item)
    return out


BIG = 2 ** 31 - 1
CASES = {
    # lens, e_batch, T, signature values, sequences, empty chunks
    "random": ([37, 5, 90, 12, 64], 64, 9, range(40), 50, ()),
    "items_span_chunks": ([300, 7, 260], 32, 5, range(12), 30, ()),
    "empty_chunk": ([40, 40, 40], 16, 7, range(20), 25, (2, 5)),
    "empty_slice": ([0, 0], 64, 5, range(8), 10, ()),
    "one_row_items": ([1] * 23, 8, 6, range(10), 12, ()),
    "sigs_near_int32_max": ([30, 41, 17, 55], 32, 8,
                            [BIG, BIG - 1, BIG - 2, 0, 1, 2 ** 30], 40, ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_group_slice_equals_the_chunk_merge(case, seed):
    lens, e_batch, T, values, n_seq, empty = CASES[case]
    rng = np.random.default_rng(seed)
    chunks, offs = _chunks(rng, lens, e_batch, T, list(values), n_seq, empty)
    want, got = _by_merge(chunks, offs), _by_group(chunks, offs)
    assert len(got) == len(want) == len(lens)
    for w_item, g_item in zip(want, got):
        assert [s for s, *_ in g_item] == [s for s, *_ in w_item]
        for (_, wg, we, wt), (_, gg, ge, gt) in zip(w_item, g_item):
            assert gg == wg
            np.testing.assert_array_equal(ge, we)
            np.testing.assert_array_equal(gt, wt)
    if case == "empty_slice":
        assert got == [[], []]
    else:
        assert sum(map(len, got)) > len(lens)


@pytest.mark.parametrize("case", sorted(CASES))
def test_aggregate_host_batch_equals_jax(case):
    """The port's one-chunk dict form gives the JAX package's keys in
    its order, gid sets and (e, t) rows, chunk by chunk."""
    lens, e_batch, T, values, n_seq, empty = CASES[case]
    chunks, _ = _chunks(np.random.default_rng(7), lens, e_batch, T,
                        list(values), n_seq, empty)
    for sigs, gid, pid, _ in chunks:
        want = j_aggregate_host_batch(sigs, gid, pid)
        got = aggregate_host_batch(sigs, gid, pid)
        assert list(got) == list(want)
        for key, (gset, et) in got.items():
            assert gset == want[key][0]
            assert et.dtype == want[key][1].dtype == np.int32
            np.testing.assert_array_equal(et, want[key][1])


# ----------------------------------------------- whole miners, in order
@pytest.fixture(scope="module")
def t3_db():
    return generate_table3_db(Table3Params(db_size=40), seed=0)


def _same_children(got, want):
    assert [c for c, _, _ in got] == [c for c, _, _ in want]
    for (_, gg, gb), (_, wg, wb) in zip(got, want):
        assert gg == wg
        for a, b in zip((gb.gid, gb.phi, gb.psi), (wb.gid, wb.phi, wb.psi)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_expansions_equal_the_frozen_merge_path(t3_db):
    """Two levels of batched expansion from the root, with chunks small
    enough that items span them, give the frozen path's children, gid
    sets and blocks, in its order; so does a baseline expansion that
    prunes some children's rebuilds."""
    kw = dict(e_batch=64, device="cpu")
    new, old = AcceleratedMiner(t3_db, **kw), FrozenMiner(t3_db, **kw)
    wave = [((), EmbBlock.root(len(t3_db), new.ni, new.nv))]
    for _ in range(2):
        got = new.expand_children_batch(wave, 4)
        want = old.expand_children_batch(wave, 4)
        for g, w in zip(got, want):
            _same_children(g, w)
        wave = [(c, b) for kids in got for c, _, b in kids]
        assert wave
    seen = {c for c, _ in wave[::2]}
    prune = lambda child: child not in seen  # noqa: E731
    got = new.expand_children_batch(wave[:20], 4, rs=False,
                                     want_embs=prune)
    want = old.expand_children_batch(wave[:20], 4, rs=False,
                                     want_embs=prune)
    for g, w in zip(got, want):
        _same_children(g, w)


@pytest.mark.parametrize("rs,sigma", [(True, 4), (False, 10)])
def test_jobs_equal_the_frozen_merge_path_in_order(t3_db, rs, sigma):
    """A whole job gives the frozen path's map in the same insertion
    order, with the same counts and device calls."""
    kw = dict(e_batch=128, device="cpu")
    new, old = AcceleratedMiner(t3_db, **kw), FrozenMiner(t3_db, **kw)
    mine = "mine_rs" if rs else "mine_gtrace"
    got = getattr(new, mine)(sigma, max_len=4)
    want = getattr(old, mine)(sigma, max_len=4)
    assert list(got.patterns.items()) == list(want.patterns.items())
    assert (got.n_enumerated, got.n_extension_scans) == \
        (want.n_enumerated, want.n_extension_scans)
    assert new.n_device_calls == old.n_device_calls
    assert len(got.patterns) > 10


# ------------------------------------------- the support bound on keys
class UnboundedMiner(AcceleratedMiner):
    """The miner with its child expansion as it was before the support
    bound: every key of the slice canonicalised (the scan, the grouping
    and the embedding rebuild are shared)."""

    def _children_from_groups(self, pattern, block, groups, item,
                              min_support, rs, want_embs):
        lo, hi = int(groups.items[item]), int(groups.items[item + 1])
        by_child = {}
        for k, sig in enumerate(groups.sig[lo:hi].tolist(), lo):
            key = signature_to_extkey(sig)
            if max(key[1].u1, key[1].u2) >= self.nv:
                continue
            child_raw = apply_extension(pattern, key)
            child = canonical_form(child_raw)
            if child in by_child:
                by_child[child][1].append(k)
            else:
                by_child[child] = (child_raw, [k])
        out = []
        gid_lo, gid_hi, all_gids = groups.gid_lo, groups.gid_hi, groups.gids
        for child, (child_raw, ks) in by_child.items():
            gids = (all_gids[gid_lo[ks[0]]:gid_hi[ks[0]]] if len(ks) == 1
                    else np.unique(np.concatenate(
                        [all_gids[gid_lo[k]:gid_hi[k]] for k in ks])))
            if len(gids) < min_support:
                continue
            if rs and parent(child) != pattern:
                continue
            gset = set(gids.tolist())
            if want_embs is not None and not want_embs(child):
                out.append((child, gset, self._no_embs))
                continue
            k = ks[0]
            rows = slice(groups.row_lo[k], groups.row_hi[k])
            out.append((child, gset, self._rebuild_embeddings(
                pattern, block, int(groups.sig[k]), groups.e[rows],
                groups.t[rows], child_raw)))
        return out

    def expand_children_batch(self, items, min_support, *, rs=True,
                              want_embs=None):
        out = [[] for _ in items]
        live = [(i, p, self._as_block(e)) for i, (p, e) in enumerate(items)
                if len(p) < self.ni]
        if not live:
            return out
        modes = [self._phase_mode(p, rs) for _, p, _ in live]
        groups = self._scan_batch([(p, b) for _, p, b in live], modes)
        for item, (i, p, b) in enumerate(live):
            out[i] = self._children_from_groups(p, b, groups, item,
                                                min_support, rs, want_embs)
        return out


def _slice_of(keys, n_items):
    """A ``SliceGroups`` of ``keys``, each ``(item, signature, gids)``,
    items in order; the rows are not read by the bound."""
    sizes = [len(g) for _, _, g in keys]
    hi = np.cumsum(sizes)
    zero = np.zeros(len(keys), np.int64)
    return SliceGroups(
        sig=np.asarray([s for _, s, _ in keys], np.int64),
        row_lo=zero, row_hi=zero, e=zero, t=zero,
        gid_lo=hi - sizes, gid_hi=hi,
        gids=np.concatenate([np.asarray(g, np.int64) for _, _, g in keys]),
        items=np.searchsorted([i for i, _, _ in keys], np.arange(n_items + 1)))


VI, EI = int(TRType.VI), int(TRType.EI)
IN, GAP = 0, 1
BOUND_CASES = {
    # n_vertices, keys (item, (kind, idx, type, pu1, pu2, label), gids),
    # the keep mask at sigma 4
    "gap_index_not_kept": ([2], [
        (0, (GAP, 0, VI, 2, SENT_V, 1), [0, 1]),
        (0, (GAP, 2, VI, 2, SENT_V, 1), [2, 3])], [True, True]),
    "in_index_kept": ([2], [
        (0, (IN, 0, VI, 1, SENT_V, 1), [0, 1]),
        (0, (IN, 1, VI, 1, SENT_V, 1), [2, 3])], [False, False]),
    "one_or_two_new_vertices": ([2], [
        (0, (GAP, 1, EI, 0, 2, 3), [0, 1, 2]),
        (0, (GAP, 1, EI, 2, 3, 3), [3, 4, 5])], [False, False]),
    "mapped_endpoints_pooled": ([3], [
        (0, (GAP, 1, EI, 0, 1, 3), [0, 1]),
        (0, (GAP, 1, EI, 1, 2, 3), [1, 2]),
        (0, (GAP, 0, EI, 0, 3, 3), [3])], [True, True, False]),
    "fresh_vertex_or_mapped": ([2], [
        (0, (GAP, 1, VI, 0, SENT_V, 1), [0, 1]),
        (0, (GAP, 1, VI, 2, SENT_V, 1), [2, 3])], [False, False]),
    "type_and_label_kept": ([2], [
        (0, (GAP, 1, VI, 2, SENT_V, 1), [0, 1]),
        (0, (GAP, 1, VI, 2, SENT_V, 2), [2, 3]),
        (0, (GAP, 1, VI + 1, 2, SENT_V, 1), [4, 5])], [False] * 3),
    "items_kept_apart": ([2, 2], [
        (0, (GAP, 1, VI, 2, SENT_V, 1), [0, 1]),
        (1, (GAP, 1, VI, 2, SENT_V, 1), [2, 3]),
        (1, (GAP, 0, VI, 2, SENT_V, 1), [4, 5])], [False, True, True]),
    "a_key_alone": ([1], [
        (0, (IN, 0, VI, 0, SENT_V, 2), [0, 1, 2, 3]),
        (0, (IN, 0, VI, 0, SENT_V, 3), [0, 1, 2])], [True, False]),
}


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_bound_slice_buckets_by_the_fields_a_child_fixes(case):
    """Keys are pooled across gap indices and across which pattern
    vertices an edge's old endpoints are, and kept apart by item, slot
    kind, ``in`` index, type, label and the number of new vertices; a
    bucket is kept when its keys' gid counts add up to sigma, a gid
    that two keys share counted twice."""
    n_vertices, keys, want = BOUND_CASES[case]
    groups = _slice_of([(i, pack_signature(*f), g) for i, f, g in keys],
                       len(n_vertices))
    got = bound_slice(groups, n_vertices, 4)
    assert got.tolist() == want


def _waves(miner, sigma, rs, levels):
    """Each level's slice, from the root: its items and the grouping of
    their signatures."""
    wave = [((), EmbBlock.root(len(miner.db), miner.ni, miner.nv))]
    for _ in range(levels):
        modes = [miner._phase_mode(p, rs) for p, _ in wave]
        yield wave, miner._scan_batch(wave, modes)
        kids = miner.expand_children_batch(wave, sigma, rs=rs)
        wave = [(c, b) for ks in kids for c, _, b in ks]
        if not wave:
            return


@pytest.mark.parametrize("rs,sigma", [(True, 2), (True, 4), (True, 10),
                                      (False, 6), (False, 10)])
def test_bounded_expansions_equal_the_unbounded_loop(t3_db, rs, sigma):
    """Batched expansions level by level, with chunks small enough that
    items span them, give every key's loop's children, gid sets and
    blocks, in its order; so does a baseline expansion that prunes some
    children's rebuilds."""
    kw = dict(e_batch=64, device="cpu")
    new, old = AcceleratedMiner(t3_db, **kw), UnboundedMiner(t3_db, **kw)
    wave = [((), EmbBlock.root(len(t3_db), new.ni, new.nv))]
    for _ in range(3):
        got = new.expand_children_batch(wave, sigma, rs=rs)
        want = old.expand_children_batch(wave, sigma, rs=rs)
        for g, w in zip(got, want):
            _same_children(g, w)
        wave = [(c, b) for kids in got for c, _, b in kids][:40]
        assert wave
    seen = {c for c, _ in wave[::2]}
    prune = lambda child: child not in seen  # noqa: E731
    got = new.expand_children_batch(wave, sigma, rs=rs, want_embs=prune)
    want = old.expand_children_batch(wave, sigma, rs=rs, want_embs=prune)
    for g, w in zip(got, want):
        _same_children(g, w)


@pytest.mark.parametrize("rs,sigma", [(True, 3), (True, 8), (False, 10),
                                      (False, 12)])
def test_bounded_jobs_equal_the_unbounded_loop_in_order(t3_db, rs, sigma):
    """A whole job gives the unbounded loop's map in the same insertion
    order, with the same counts and device calls."""
    kw = dict(e_batch=128, device="cpu")
    new, old = AcceleratedMiner(t3_db, **kw), UnboundedMiner(t3_db, **kw)
    mine = "mine_rs" if rs else "mine_gtrace"
    got = getattr(new, mine)(sigma, max_len=4)
    want = getattr(old, mine)(sigma, max_len=4)
    assert list(got.patterns.items()) == list(want.patterns.items())
    assert (got.n_enumerated, got.n_extension_scans) == \
        (want.n_enumerated, want.n_extension_scans)
    assert new.n_device_calls == old.n_device_calls
    assert len(got.patterns) > 10


@pytest.mark.parametrize("rs,sigma", [(True, 3), (False, 6)])
def test_the_bound_drops_only_keys_of_infrequent_children(t3_db, rs, sigma):
    """Over three levels of slices: every key the bound drops yields a
    canonical child whose gids, over all of its item's keys, are fewer
    than sigma; and no signature repeats a TR of its ``in`` itemset (so
    a key's child has one TR more than its pattern)."""
    miner = AcceleratedMiner(t3_db, e_batch=64, device="cpu")
    n_dropped = n_keys = 0
    for wave, groups in _waves(miner, sigma, rs, 3):
        keep = bound_slice(
            groups, [len(driver.pattern_vertices(p)) for p, _ in wave],
            sigma)
        for item, (pattern, _) in enumerate(wave):
            lo, hi = int(groups.items[item]), int(groups.items[item + 1])
            gids_of: Dict = {}
            child_of = {}
            for k in range(lo, hi):
                (kind, idx), tr = signature_to_extkey(int(groups.sig[k]))
                if kind == "in":
                    assert tr not in pattern[idx], (pattern, kind, idx, tr)
                child = canonical_form(apply_extension(
                    pattern, ((kind, idx), tr)))
                child_of[k] = child
                gids_of.setdefault(child, set()).update(
                    groups.gids[groups.gid_lo[k]:groups.gid_hi[k]].tolist())
            for k in range(lo, hi):
                if not keep[k]:
                    assert len(gids_of[child_of[k]]) < sigma
            n_dropped += int((~keep[lo:hi]).sum())
            n_keys += hi - lo
    assert 0 < n_dropped < n_keys


def test_the_bound_counter_counts_the_dropped_keys(t3_db, monkeypatch):
    """``mining.sig_keys_bounded`` is the number of keys the bound drops
    over a job: more than none and fewer than ``mining.sig_keys``."""
    dropped = []
    bound = driver.bound_slice

    def recording_bound(*args):
        keep = bound(*args)
        dropped.append(int((~keep).sum()))
        return keep

    monkeypatch.setattr(driver, "bound_slice", recording_bound)
    miner = AcceleratedMiner(t3_db, device="cpu")
    res = miner.mine_rs(6, max_len=4)
    snap = miner.metrics.snapshot()
    assert len(res.patterns) > 10
    assert snap["mining.sig_keys_bounded"] == sum(dropped)
    assert 0 < snap["mining.sig_keys_bounded"] < snap["mining.sig_keys"]
