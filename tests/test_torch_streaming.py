"""The streaming window, port vs the JAX package, on the CPU: the
incremental frontier re-mine (``mining.incremental``) and
``StreamingBank`` under all three layouts - supports, tombstones, the
frequent map, counters and the delta tuples bit-equal to the JAX
package's after every observe and refresh, and the frequent map equal
to a batch re-mine of the window after every refresh; and the cluster's
sharded window (``ShardedStreamingBank``) against both.  Inputs are small
seeded DBs shared by both packages (``db_from_reference``); the JAX
package's own property tests cover the wide sweep."""
import numpy as np
import pytest

from conftest import random_db
from repro.core.graphseq import NO_VERTEX, TR, TRType
from repro.mining.driver import AcceleratedMiner as JaxMiner
from repro.mining.incremental import refresh_frontier as j_refresh_frontier
from repro.serving.cluster import ShardedStreamingBank as JSharded
from repro.serving.streaming import StreamingBank as JStreamingBank

from repro_torch.core.graphseq import db_from_reference, pattern_key
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.mining.incremental import (
    depth1_root,
    refresh_frontier,
    subtree_dirty_rows,
)
from repro_torch.serving.cluster import ShardedStreamingBank
from repro_torch.serving.streaming import StreamingBank

MINSUP, MAX_LEN, W = 3, 3, 8
LAYOUTS = ("flat", "trie", "trie_fused")


def _keys(m):
    return {pattern_key(p): int(s) for p, s in m.items()}


def _norm(x):
    """A delta payload as plain comparable values."""
    if isinstance(x, dict):
        return _keys(x)
    if isinstance(x, np.ndarray):
        return (x.dtype.kind, x.tolist())
    return x


def _pair(seed, layout="flat", window=W, minsup=MINSUP, **kw):
    """The same seeded window streamed into both packages' banks, each
    with a delta sink."""
    jdb = random_db(seed, n_seq=window)
    jsb = JStreamingBank.from_db(jdb, minsup=minsup, window=window,
                                 max_len=MAX_LEN, bank_layout=layout, **kw)
    tsb = StreamingBank.from_db(db_from_reference(jdb), minsup=minsup,
                                window=window, max_len=MAX_LEN,
                                bank_layout=layout, device="cpu", **kw)
    for sb in (jsb, tsb):
        sb.deltas = []
        sb.delta_sink = sb.deltas.append
    return tsb, jsb


def _same(tsb, jsb):
    assert [pattern_key(p) for p in tsb.bank.patterns] == \
        [pattern_key(p) for p in jsb.bank.patterns]
    np.testing.assert_array_equal(tsb.support, jsb.support)
    np.testing.assert_array_equal(tsb.active, jsb.active)
    np.testing.assert_array_equal(tsb._fresh, jsb._fresh)
    assert _keys(tsb.frequent()) == _keys(jsb.frequent())
    assert dict(tsb.stats) == dict(jsb.stats)
    assert tsb.delta_seq == jsb.delta_seq
    assert [tuple(_norm(x) for x in d) for d in tsb.deltas] == \
        [tuple(_norm(x) for x in d) for d in jsb.deltas]


def _remine(tsb):
    seqs = tsb.window_seqs
    if not seqs:
        return {}
    return AcceleratedMiner(seqs, device="cpu").mine_rs(
        tsb.minsup, max_len=MAX_LEN).patterns


def _observe(tsb, jsb, jbatch):
    tr = tsb.observe(db_from_reference(jbatch))
    jr = jsb.observe(jbatch)
    assert (tr.arrived, tr.evicted, tr.tombstoned, tr.refreshed) == \
        (jr.arrived, jr.evicted, jr.tombstoned, jr.refreshed)
    _same(tsb, jsb)


def _refresh(tsb, jsb, full=False):
    got = tsb.refresh(full=full)
    assert _keys(got) == _keys(jsb.refresh(full=full))
    _same(tsb, jsb)
    assert got == _remine(tsb)
    return got


def _killers(n):
    """Sequences that contain no bank pattern: their one TR carries a
    label outside every bank's label space."""
    return [((TR(TRType.VI, 0, NO_VERTEX, 90 + i),),) for i in range(n)]


@pytest.mark.parametrize("seed,case", [(41, "all_dirty"), (41, "clean"),
                                       (23, "half_dirty")])
def test_refresh_frontier_matches_jax(seed, case):
    """Everything dirty (a full re-mine), a clean active map (pure
    retention below the root scan), and half the depth-1 subtrees dirty;
    every field of ``FrontierResult`` equals the JAX package's."""
    jdb = random_db(seed, n_seq=10)
    full = JaxMiner(jdb).mine_rs(2, max_len=MAX_LEN).patterns
    db = db_from_reference(jdb)
    tfull = AcceleratedMiner(db, device="cpu").mine_rs(
        2, max_len=MAX_LEN).patterns
    assert _keys(tfull) == _keys(full)
    by_key = {pattern_key(p): p for p in tfull}
    active = {} if case == "all_dirty" else dict(full)
    dirty = set()
    if case == "half_dirty":
        roots = sorted({pattern_key(depth1_root(p)) for p in tfull})
        assert len(roots) > 1
        keep = set(roots[::2])
        dirty = {p for p in full
                 if pattern_key(depth1_root(by_key[pattern_key(p)]))
                 in keep}
    want = j_refresh_frontier(jdb, 2, active=active, dirty=dirty,
                              max_len=MAX_LEN)
    got = refresh_frontier(
        db, 2, active={by_key[pattern_key(p)]: s for p, s in active.items()},
        dirty={by_key[pattern_key(p)] for p in dirty}, max_len=MAX_LEN,
        device="cpu")
    assert _keys(got.patterns) == _keys(want.patterns) == _keys(full)
    assert {pattern_key(p): g for p, g in got.gids.items()} == \
        {pattern_key(p): g for p, g in want.gids.items()}
    for f in ("scans", "scans_skipped", "retained", "discovered",
              "depth1_clean", "depth1_dirty"):
        assert getattr(got, f) == getattr(want, f), f
    if case == "clean":
        assert got.scans == 1 and got.scans_skipped > 0
    if case == "half_dirty":
        assert 0 < got.depth1_clean and 0 < got.depth1_dirty


@pytest.mark.parametrize("layout", LAYOUTS)
def test_streaming_matches_jax_and_remine(layout):
    """Observes, incremental refreshes (the bank extended in place) and
    a full refresh: the state after each equals the JAX package's, and
    each refresh's map a batch re-mine of the window."""
    tsb, jsb = _pair(5, layout)
    _same(tsb, jsb)
    assert tsb.frequent() == _remine(tsb)
    for i, n in enumerate((3, 2)):
        _observe(tsb, jsb, random_db(300 + i, n_seq=n))
    _refresh(tsb, jsb)
    _observe(tsb, jsb, random_db(302, n_seq=3))
    _refresh(tsb, jsb, full=True)
    _observe(tsb, jsb, random_db(303, n_seq=4))
    _refresh(tsb, jsb)
    st = dict(tsb.stats)
    assert st["refreshes"] == 2 and st["full_refreshes"] == 1
    assert st["tombstoned"] > 0 and st["added"] > 0
    assert {d[0] for d in tsb.deltas} == {"support", "mask", "extend",
                                          "recompile"}


def test_tombstone_then_recover_matches_jax():
    """Every pattern tombstoned by a flood of sequences that contain
    none, then recovered by the next refresh with exact recounted
    supports (fused layout: the masks reach the fused walk's req)."""
    tsb, jsb = _pair(2, "trie_fused")
    base = random_db(2, n_seq=W)
    _observe(tsb, jsb, _killers(W - MINSUP + 1))
    assert not tsb.frequent() and not tsb.active.any()
    assert not tsb.server.exact_rows(db_from_reference(base[:2])).any()
    _observe(tsb, jsb, base)
    got = _refresh(tsb, jsb)
    assert got and tsb.stats["recovered"] > 0


def test_auto_compaction_matches_jax():
    tsb, jsb = _pair(2, "trie", compact_threshold=0.5)
    _observe(tsb, jsb, _killers(W - MINSUP + 1))
    assert tsb.stats["auto_compactions"] >= 1
    assert tsb.bank.n_patterns == len(tsb.frequent())
    assert tsb.frequent() == _remine(tsb)


def test_capacity_fallback_matches_jax():
    """New frequent patterns whose labels lie outside the compiled key
    space cannot extend the bank (``BankCapacityError``): the refresh
    falls back to a full recompile, as the JAX package's does."""
    tsb, jsb = _pair(23, "flat", window=10, minsup=2)
    nlk = tsb.bank.n_label_keys
    assert tsb.bank.n_patterns > 0
    _observe(tsb, jsb, random_db(24, n_seq=6, n_vl=9, n_el=9))
    assert any(tr.label + 2 > nlk for seq in tsb.window_seqs
               for s in seq for tr in s)
    _refresh(tsb, jsb)
    assert tsb.stats["refreshes"] == 1 and tsb.stats["full_refreshes"] == 1
    assert tsb.bank.n_label_keys > nlk


def test_dirty_subtree_roots_cover_dirty_rows():
    tsb, jsb = _pair(13, tombstones=False)
    _observe(tsb, jsb, random_db(901, n_seq=3))
    roots = tsb.dirty_subtree_roots()
    assert {pattern_key(p) for p in roots} == \
        {pattern_key(p) for p in jsb.dirty_subtree_roots()}
    widened = subtree_dirty_rows(tsb.bank.patterns, roots)
    assert tsb.dirty_rows().any()
    assert (widened | ~tsb.dirty_rows()).all()


@pytest.mark.parametrize("layout,H", [("flat", 2), ("trie_fused", 4)])
def test_sharded_window_matches_jax_and_single_host(layout, H):
    """The sharded window's refreshes (incremental and full) give the
    map of the single-host StreamingBank, of a batch re-mine and of the
    JAX package's sharded window, with the same counters."""
    jdb = random_db(9, n_seq=W)
    db = db_from_reference(jdb)
    kw = dict(minsup=MINSUP, window=W, max_len=MAX_LEN, bank_layout=layout)
    ref = StreamingBank.from_db(db, device="cpu", **kw)
    sh = ShardedStreamingBank.from_db(db, n_hosts=H, device="cpu", **kw)
    jsh = JSharded.from_db(jdb, n_hosts=H, **kw)
    for step, full in enumerate((False, True, False)):
        jbatch = random_db(500 + step, n_seq=3)
        ref.observe(db_from_reference(jbatch))
        sh.observe(db_from_reference(jbatch))
        jsh.observe(jbatch)
        assert sh.window_seqs == ref.window_seqs
        a, b = ref.refresh(full=full), sh.refresh(full=full)
        want = AcceleratedMiner(sh.window_seqs, device="cpu").mine_rs(
            MINSUP, max_len=MAX_LEN).patterns
        assert a == b == want
        assert _keys(b) == _keys(jsh.refresh(full=full))
        assert dict(sh.stats) == dict(jsh.stats)
    q = db[:3]
    for x, y in zip(ref.query(q, k=5), sh.query(q, host=1, k=5)):
        np.testing.assert_array_equal(x.contained, y.contained)
        assert x.topk == y.topk


def test_observe_returns_the_rows_it_wrote_to_the_ring():
    """``ObserveResult.rows`` are the rows each batch wrote to the ring
    (no refresh in between rewrites them), over the bank as it was when
    the batch joined: rows masked by a tombstone read False, and an
    empty batch gives no rows."""
    sb = StreamingBank.from_db(db_from_reference(random_db(5, n_seq=W)),
                               minsup=MINSUP, window=W, max_len=MAX_LEN,
                               device="cpu")
    masked = 0
    for jbatch in (random_db(300, n_seq=3), _killers(W - MINSUP),
                   random_db(301, n_seq=4)):
        slots = [(sb._head + j) % W for j in range(len(jbatch))]
        active = sb.active.copy()
        res = sb.observe(db_from_reference(jbatch))
        assert res.rows.shape == (len(jbatch), sb.n_patterns)
        np.testing.assert_array_equal(res.rows, sb._bits[slots])
        assert not res.rows[:, ~active].any()
        masked += int((~active).sum())
    assert masked > 0 and sb.support.any()
    assert sb.observe([]).rows.shape == (0, sb.n_patterns)
