"""The port's spans inside mining and serving, on the CPU: which spans a
job and a batch record, how they nest, what their counts equal (the
miner's copies, the predicate calls, the fused walks), that results,
counters and dispatch counts are bit-identical with tracing off, sampled
and full, which spans a stream's observe and refresh record, and that
the profiler-range option mirrors every recorded span as a same-name
profiler range, and only with it on."""
import collections
import json
import os
import random
import tempfile

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.compile import compile_sequence
from repro_torch.core.graphseq import NO_VERTEX, TR, TRType
from repro_torch.data.synthetic import random_graph_sequence
from repro_torch.mining import driver
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.obs import trace
from repro_torch.serving import batch
from repro_torch.serving.bank import compile_bank
from repro_torch.serving.server import PatternServer
from repro_torch.serving.streaming import StreamingBank

MINING_SPANS = ("mining.prepare", "mining.encode", "mining.upload",
                "mining.aggregate", "mining.group", "mining.bound",
                "mining.children", "mining.rebuild")
LAYOUTS = ("flat", "trie", "trie_fused")


def _db(seed, n_seq, n_steps=4, n_v=4):
    rng = random.Random(seed)
    return [compile_sequence(random_graph_sequence(rng, n_steps=n_steps,
                                                   n_v=n_v, n_vl=2, n_el=2))
            for _ in range(n_seq)]


@pytest.fixture(scope="module")
def db():
    return _db(3, 10)


@pytest.fixture(scope="module")
def queries():
    return _db(4, 24, n_steps=5, n_v=5)


@pytest.fixture(scope="module")
def bank(db):
    return compile_bank(AcceleratedMiner(db, device="cpu").mine_rs(2,
                                                                   max_len=4))


def _run(mode, fn, **kw):
    """``fn()`` with tracing ``off``, ``sampled`` (rate 1) or ``full``;
    returns its result and the recorded spans."""
    trace.clear()
    if mode == "sampled":
        trace.enable_sampling(1.0, **kw)
    elif mode == "full":
        trace.enable(**kw)
    try:
        out = fn()
        return out, list(trace.tracer.events)
    finally:
        trace.disable()
        trace.clear()


def _parents(events):
    """Each span's innermost enclosing span (None at the top), by the
    same nesting sweep the trace reports use."""
    order = sorted(range(len(events)),
                   key=lambda i: (events[i]["ts"], -events[i]["dur"]))
    parent = [None] * len(events)
    stack = []
    for i in order:
        ev = events[i]
        while stack and (events[stack[-1]]["ts"]
                         + events[stack[-1]]["dur"]) <= ev["ts"] + 1e-6:
            stack.pop()
        if stack:
            parent[i] = events[stack[-1]]["name"]
        stack.append(i)
    return parent


def _mine(db):
    miner = AcceleratedMiner(db, device="cpu")
    res = miner.mine_rs(2, max_len=4)
    return res, miner.n_device_calls


def test_a_mining_job_records_every_span_nested_and_one_upload_a_copy(db):
    (res, n_calls), ev = _run("sampled", lambda: _mine(db))
    names = collections.Counter(e["name"] for e in ev)
    for name in MINING_SPANS:
        assert names[name] > 0, name
    parent = _parents(ev)
    of = collections.defaultdict(set)
    for e, p in zip(ev, parent):
        of[e["name"]].add(p)
    # a child's rows go straight into its block: nothing to materialize
    assert "mining.materialize" not in names
    assert of["mining.rebuild"] == {"mining.children"}
    assert of["mining.children"] == {"mining.wavefront"}
    assert of["mining.aggregate"] == {"mining.wavefront"}
    assert of["mining.group"] == {"mining.wavefront"}
    assert of["mining.bound"] == {"mining.wavefront"}
    # the constructor is a job's first root: nothing of a job is unspanned
    assert of["mining.prepare"] == {None} and of["mining.mine"] == {None}
    # the chunk uploads sit inside the measured dispatch interval
    assert of["mining.upload"] == {"mining.prepare", "mining.wavefront",
                                   "mining.dispatch"}
    slices = names["mining.wavefront"]
    assert names["mining.upload"] == 1 + 4 * slices + 5 * n_calls
    assert names["mining.aggregate"] == n_calls
    assert names["mining.group"] == names["mining.bound"] == slices
    assert names["mining.encode"] == slices + n_calls
    assert names["mining.rebuild"] == len(res.patterns)
    assert len(res.patterns) > 0


def test_the_grouping_counters_count_the_scans_entries_and_keys(
        db, monkeypatch):
    """``mining.sig_rows`` is the number of valid signature entries the
    plain match_count version returns over a job, ``mining.sig_keys``
    the number of distinct (pattern, signature) keys of each slice,
    summed over the slices."""
    slices = []
    scan, group = driver.match_signatures_batch, AcceleratedMiner._scan_batch

    def recording_scan(*args):
        out = scan(*args)
        slices[-1].append((out.numpy(), args[5].numpy()))  # sigs, pids
        return out

    def one_slice(self, items, modes):
        slices.append([])
        return group(self, items, modes)

    monkeypatch.setattr(driver, "match_signatures_batch", recording_scan)
    monkeypatch.setattr(AcceleratedMiner, "_scan_batch", one_slice)
    miner = AcceleratedMiner(db, device="cpu")
    miner.mine_rs(2, max_len=4)
    rows = sum(int((s >= 0).sum()) for sl in slices for s, _ in sl)
    keys = sum(len({(int(p[e]), int(s[e, t])) for s, p in sl
                    for e, t in zip(*np.nonzero(s >= 0))}) for sl in slices)
    snap = miner.metrics.snapshot()
    assert snap["mining.sig_rows"] == rows > 0
    assert snap["mining.sig_keys"] == keys > len(slices)


def _serve(bank, queries, **kw):
    """Rows, predicate calls, fused walks and the server's counters."""
    srv = PatternServer(bank, device="cpu", max_batch=8, **kw)
    p0, w0 = batch.predicate_calls, batch.fused_walks
    out = srv.query(queries)
    rows = np.stack([r.contained for r in out])
    return (rows, batch.predicate_calls - p0, batch.fused_walks - w0,
            dict(srv.stats))


FUSED_SPANS = ("serving.fused_cells", "serving.fused_walk",
               "serving.fused_gather")


def _check_fused_spans(ev, walks, stats, layout):
    """The fused layout's host spans: one cell pick a device batch,
    nested in the batch's launch; one walk record a walk; one gather a
    walk, nested in the read back; none in the other layouts."""
    names = collections.Counter(e["name"] for e in ev)
    if layout != "trie_fused":
        assert not any(names[n] for n in FUSED_SPANS) and walks == 0
        return
    assert names["serving.fused_cells"] == stats["device_batches"] > 0
    assert names["serving.fused_walk"] == names["serving.fused_gather"] \
        == walks > 0
    parent = dict(zip((id(e) for e in ev), _parents(ev)))
    for e in ev:
        if e["name"] in ("serving.fused_cells", "serving.fused_walk"):
            assert parent[id(e)] == "serving.batch"
        if e["name"] == "serving.fused_gather":
            assert parent[id(e)] == "serving.readback"


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("emax", [1, 4, 16])
def test_serving_steps_equal_the_predicate_calls(bank, queries, layout,
                                                 emax):
    """emax 1 forces undecided (``ovf & ~contained``) cells, 16 leaves
    none at this size: the replay's span appears only with them."""
    (rows, calls, walks, stats), ev = _run("sampled", lambda: _serve(
        bank, queries, emax=emax, emax_retry=2 * emax,
        bank_layout=layout))
    names = collections.Counter(e["name"] for e in ev)
    assert names["serving.step"] == calls
    if layout != "trie_fused" or emax == 1:
        assert calls > 0
    # one read back a batch; the replay only where a cell was undecided
    assert names["serving.readback"] == stats["device_batches"] > 0
    assert (names["serving.escalate"] > 0) == (stats["escalated_cells"] > 0)
    if emax == 1:
        assert stats["escalated_cells"] > 0
    if emax == 16:
        assert stats["escalated_cells"] == 0
    parent = dict(zip((id(e) for e in ev), _parents(ev)))
    for e in ev:
        if e["name"] == "serving.escalate":
            assert parent[id(e)] == "serving.finalize_rows"
        if e["name"] == "serving.readback":
            assert parent[id(e)] == "serving.finalize_rows"
    _check_fused_spans(ev, walks, stats, layout)


@pytest.mark.parametrize("mode", ["sampled", "full"])
def test_one_fused_batch_spans_its_cell_pick_walk_and_gather(
        bank, queries, mode):
    """One trie_fused batch with undecided cells (emax 1): its cell pick
    inside ``serving.batch``, one walk, its gather inside the read back
    of ``serving.finalize_rows``, and rows, counters and dispatch counts
    as with tracing off."""
    def one():
        return _serve(bank, queries[:8], emax=1, emax_retry=2,
                      bank_layout="trie_fused")

    off, _ = _run("off", one)
    (rows, calls, walks, stats), ev = _run(mode, one)
    np.testing.assert_array_equal(rows, off[0])
    assert (calls, walks, stats) == off[1:]
    assert walks == stats["device_batches"] == 1
    assert stats["escalated_cells"] > 0
    _check_fused_spans(ev, walks, stats, "trie_fused")
    parent = dict(zip((id(e) for e in ev), _parents(ev)))
    (rb,) = [e for e in ev if e["name"] == "serving.readback"]
    assert parent[id(rb)] == "serving.finalize_rows"
    if mode == "full":
        # the fenced half of the walk follows its dispatch in the batch
        (dev,) = [e for e in ev if e["name"] == "serving.fused_walk.device"]
        assert parent[id(dev)] == "serving.batch"


@pytest.mark.parametrize("mode,ranges", [("sampled", False),
                                         ("full", False),
                                         ("sampled", True)])
def test_results_are_bit_identical_with_tracing_off_sampled_and_full(
        db, bank, queries, mode, ranges):
    kw = {"profiler_ranges": ranges}
    (res0, calls0), _ = _run("off", lambda: _mine(db))
    (res1, calls1), ev = _run(mode, lambda: _mine(db), **kw)
    assert ev and res1.patterns == res0.patterns and calls1 == calls0
    for layout in LAYOUTS:
        (rows0, *counts0), _ = _run("off", lambda: _serve(
            bank, queries, emax=1, bank_layout=layout))
        (rows1, *counts1), ev = _run(mode, lambda: _serve(
            bank, queries, emax=1, bank_layout=layout), **kw)
        # predicate calls, fused walks and every server counter
        assert ev and counts1 == counts0
        np.testing.assert_array_equal(rows1, rows0)


def _annotations(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return collections.Counter(
        e["name"] for e in doc.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") == "user_annotation")


@pytest.mark.parametrize("mode,ranges", [("sampled", True),
                                         ("sampled", False),
                                         ("full", True)])
def test_profiler_ranges_mirror_every_recorded_span(db, bank, queries,
                                                    monkeypatch, mode,
                                                    ranges):
    """With the option on, each span recorded by ``span`` or
    ``root_or_span`` has one same-name profiler range; intervals added
    after the fact (``add_complete``) have none.  With it off, no span
    has a range."""
    after = collections.Counter()
    add = trace.tracer.add_complete

    def counted(name, cat, start, duration, **args):
        if trace.tracer.enabled:
            after[name] += 1
        add(name, cat, start, duration, **args)

    monkeypatch.setattr(trace.tracer, "add_complete", counted)

    def work():
        _mine(db)
        _serve(bank, queries, emax=1, bank_layout="flat")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, ev = _run(mode, work, profiler_ranges=ranges)
    got = _annotations(prof)
    spans = collections.Counter(e["name"] for e in ev)
    assert spans["mining.upload"] and spans["serving.step"]
    if ranges:
        assert got == spans - after
    else:
        assert not set(got) & set(spans)


def test_the_range_option_is_off_by_default():
    trace.enable_sampling(1.0)
    try:
        assert trace.tracer.ranges is None
    finally:
        trace.disable()
    trace.enable(profiler_ranges=True)
    try:
        assert trace.tracer.ranges is not None
    finally:
        trace.disable()
    assert trace.tracer.ranges is None


# every serving span a traced batch records at emax 1 / emax_retry 2,
# with its parent: the batch's launch, its read back and its escalation
SERVING_SPANS = {
    ("serving.query", None),
    ("serving.cache", "serving.query"),
    ("serving.batch", "serving.query"),
    ("serving.finalize_rows", "serving.query"),
    ("serving.finalize", "serving.query"),
    ("serving.encode", "serving.batch"),
    ("serving.token_index", "serving.batch"),
    ("serving.token_index.device", "serving.batch"),
    ("serving.prescreen_host", "serving.batch"),
    ("serving.readback", "serving.finalize_rows"),
    ("serving.escalate", "serving.finalize_rows"),
    ("serving.oracle", "serving.finalize_rows"),
}
TRIE_ESCALATION_SPANS = {
    ("serving.escalate.trie_level", "serving.escalate"),
    ("serving.escalate.trie_level.device", "serving.escalate"),
    ("serving.step", "serving.escalate.trie_level"),
}
LAYOUT_SPANS = {
    "flat": {
        ("serving.join", "serving.batch"),
        ("serving.join.device", "serving.batch"),
        ("serving.step", "serving.join"),
        ("serving.escalate.join", "serving.escalate"),
        ("serving.escalate.join.device", "serving.escalate"),
        ("serving.step", "serving.escalate.join"),
    },
    "trie": TRIE_ESCALATION_SPANS | {
        ("serving.trie_level", "serving.batch"),
        ("serving.trie_advance", "serving.trie_level"),
        ("serving.trie_advance.device", "serving.trie_level"),
        ("serving.step", "serving.trie_advance"),
    },
    "trie_fused": TRIE_ESCALATION_SPANS | {
        ("serving.fused_cells", "serving.batch"),
        ("serving.fused_walk", "serving.batch"),
        ("serving.fused_walk.device", "serving.batch"),
        ("serving.fused_gather", "serving.readback"),
    },
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_traced_batch_records_every_serving_span_under_its_parent(
        bank, queries, layout):
    """Under full tracing at emax 1 / emax_retry 2 (undecided cells,
    so the escalation runs), the serving spans of each layout are
    exactly these (name, parent) pairs: the join, trie-level and
    escalation spans included, each dispatch beside its fenced half."""
    (rows, calls, walks, stats), ev = _run("full", lambda: _serve(
        bank, queries, emax=1, emax_retry=2, bank_layout=layout))
    assert stats["escalated_cells"] > 0
    pairs = collections.Counter(
        (e["name"], p) for e, p in zip(ev, _parents(ev))
        if e["name"].startswith("serving."))
    assert set(pairs) == SERVING_SPANS | LAYOUT_SPANS[layout]
    assert pairs[("serving.batch", "serving.query")] \
        == pairs[("serving.readback", "serving.finalize_rows")] \
        == pairs[("serving.prescreen_host", "serving.batch")] \
        == stats["device_batches"] > 1
    assert sum(n for (name, _), n in pairs.items()
               if name == "serving.step") == calls


# the stream's spans inside an observe and an incremental refresh, with
# their parents
STREAM_SPANS = {
    ("streaming.mask", "streaming.observe"),
    ("streaming.dirty", "streaming.refresh"),
    ("streaming.extend", "streaming.reconcile"),
    ("streaming.recount", "streaming.reconcile"),
    ("streaming.server", "streaming.reconcile"),
    ("streaming.mask", "streaming.reconcile"),
}


def test_a_stream_records_its_window_and_refresh_spans_under_their_parents():
    """A window of 10 tombstoned whole by sequences that contain no
    pattern (their labels lie outside the bank's), then turned over by
    10 new sequences: the refresh recovers tombstones and grows the bank
    (``extend_bank``, the server rebuilt).  Each new span is recorded
    under its parent, and the map is the one the stream gives untraced."""
    def stream():
        sb = StreamingBank.from_db(_db(3, 10), minsup=3, window=10,
                                   max_len=4, device="cpu")
        sb.observe([((TR(TRType.VI, 0, NO_VERTEX, 90 + i),),)
                    for i in range(8)])
        sb.observe(_db(5, 10))
        return sb.refresh(), dict(sb.stats)

    want, _ = _run("off", stream)
    (got, stats), ev = _run("sampled", stream)
    assert (got, stats) == want
    assert stats["recovered"] > 0 and stats["added"] > 0
    pairs = {(e["name"], p) for e, p in zip(ev, _parents(ev))
             if e["name"].startswith("streaming.")}
    assert STREAM_SPANS <= pairs
    assert ("streaming.frontier", "streaming.refresh") in pairs
