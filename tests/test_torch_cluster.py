"""The simulated serving cluster, port vs the JAX package, on the CPU:
routed and async (continuous-batching) rows, cache counters and stats,
the async ones at one host and at three, against the single-host server
too; ``DrainTicket.queued`` read before and after each flush;
a seeded chaos schedule (delays, transient errors, one host dark) with
the same answers and counters as the JAX package's; read replicas'
delta apply and crash replay; and the launcher's streaming and cluster
modes.  The sharded window is held to single-host streaming by
tests/test_torch_streaming.py.  Small seeded
inputs shared by both packages; the JAX package's property tests cover
the wide sweep."""
import random
import sys

import numpy as np
import pytest

from conftest import random_db
from repro.mining.driver import AcceleratedMiner as JaxMiner
from repro.serving.bank import compile_bank as j_compile_bank
from repro.serving.cluster import ReplicaGroup as JReplicaGroup
from repro.serving.cluster import ServingCluster as JServingCluster
from repro.serving.faults import FaultInjector as JFaultInjector
from repro.serving.faults import RetryPolicy as JRetryPolicy
from repro.serving.streaming import StreamingBank as JStreamingBank

from repro_torch.core.graphseq import db_from_reference, pattern_key
from repro_torch.launch import serve
from repro_torch.serving.bank import bank_from_reference
from repro_torch.serving.cluster import ReplicaGroup, ServingCluster
from repro_torch.serving.faults import FaultInjector, RetryPolicy, \
    _unit_hash
from repro_torch.serving.server import PatternServer
from repro_torch.serving.streaming import StreamingBank

MINSUP, MAX_LEN, W = 3, 3, 8
LAYOUTS = ("flat", "trie", "trie_fused")


@pytest.fixture(scope="module")
def banks():
    """One mined bank in both packages and a query batch."""
    jbank = j_compile_bank(JaxMiner(random_db(41, n_seq=10)).mine_rs(
        2, max_len=MAX_LEN))
    jq = random_db(42, n_seq=8)
    return {"jbank": jbank, "tbank": bank_from_reference(jbank), "jq": jq,
            "tq": db_from_reference(jq)}


@pytest.fixture(scope="module")
def two_tr_banks():
    """The same DB mined to two-TR patterns, in both packages: one join
    group, so that the chaos schedule compiles few JAX shapes."""
    jbank = j_compile_bank(JaxMiner(random_db(41, n_seq=10)).mine_rs(
        2, max_len=2))
    return jbank, bank_from_reference(jbank)


def _spread(queries, n_hosts):
    reqs = {h: [] for h in range(n_hosts)}
    for i, s in enumerate(queries):
        reqs[i % n_hosts].append(s)
    return reqs


def _same_results(got, want):
    """Per-host results equal field for field."""
    assert sorted(got) == sorted(want)
    for hid in want:
        assert len(got[hid]) == len(want[hid])
        for a, b in zip(got[hid], want[hid]):
            np.testing.assert_array_equal(a.contained, b.contained)
            assert (a.fingerprint, a.topk, a.cached, a.exact) == \
                (b.fingerprint, b.topk, b.cached, b.exact)


# the async drains, as query indices: a batch flush, an in-flight
# duplicate, a deadline flush and a forced flush at collect
DRAINS = ([0, 1, 2, 3], [0, 1, 4], [5, 6, 7])


def _async_drains(cl, clock, queries, H):
    """``DRAINS`` through the async pipeline under a fake clock: every
    query's answer, in drain order."""
    tickets = []
    for i, d in enumerate(DRAINS):
        tickets.append(cl.submit(_spread([queries[q] for q in d], H)))
        clock[0] += 0.3 * (i + 1)
        cl.poll()
    return [[res[j % H][j // H] for j in range(len(d))]
            for d, res in zip(DRAINS, (cl.collect(t) for t in tickets))]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_routed_and_async_match_jax(banks, layout):
    """Sync ``route``, cold and then replayed from the other hosts (L1
    and L2 hits): rows, flags, router counters and the summed shard
    counters equal the JAX cluster's, and the rows the single-host
    server's.  The async pipeline's rows equal the routed ones."""
    H = 3
    tcl = ServingCluster(banks["tbank"], H, bank_layout=layout,
                         device="cpu")
    jcl = JServingCluster(banks["jbank"], H, bank_layout=layout)
    assert [h.rows.tolist() for h in tcl.hosts] == \
        [h.rows.tolist() for h in jcl.hosts]
    tq, jq = banks["tq"], banks["jq"]
    want = PatternServer(banks["tbank"], bank_layout=layout,
                         device="cpu").exact_rows(tq)
    for shift in (0, 1):
        treq = {(h + shift) % H: v for h, v in _spread(tq, H).items()}
        jreq = {(h + shift) % H: v for h, v in _spread(jq, H).items()}
        got = tcl.query_multi(treq)
        _same_results(got, jcl.query_multi(jreq))
        for h, rs in got.items():
            ids = [i for i in range(len(tq)) if (i + shift) % H == h]
            np.testing.assert_array_equal(
                np.stack([r.contained for r in rs]), want[ids])
    assert dict(tcl.router.stats) == dict(jcl.router.stats)
    assert tcl.router.stats["l1_hits"] + tcl.router.stats["l2_hits"] > 0
    assert tcl.stats() == jcl.stats()
    clock = [0.0]
    tac = ServingCluster(banks["tbank"], H, bank_layout=layout,
                         device="cpu", flush_batch=3, max_wait=0.5,
                         clock=lambda: clock[0])
    for d, res in zip(DRAINS, _async_drains(tac, clock, tq, H)):
        for q, r in zip(d, res):
            assert r.exact
            np.testing.assert_array_equal(r.contained, want[q])
    assert tac.router.depth() == 0


@pytest.mark.parametrize("H", [1, 3])
def test_async_pipeline_matches_jax(banks, two_tr_banks, H):
    """The async pipeline under a fake clock: answers, every router
    counter (batch, deadline and forced flushes, in-flight hits) and the
    summed shard counters equal the JAX package's, and the answers the
    single-host server's rows and top-k bit for bit."""
    clocks = [[0.0], [0.0]]
    jbank, tbank = two_tr_banks
    tac = ServingCluster(tbank, H, device="cpu", flush_batch=3,
                         max_wait=0.5, clock=lambda: clocks[0][0])
    jac = JServingCluster(jbank, H, flush_batch=3, max_wait=0.5,
                          clock=lambda: clocks[1][0])
    got = _async_drains(tac, clocks[0], banks["tq"], H)
    want = _async_drains(jac, clocks[1], banks["jq"], H)
    server = PatternServer(tbank, device="cpu")
    for d, g, w in zip(DRAINS, got, want):
        _same_results({0: g}, {0: w})
        for r, s in zip(g, server.query([banks["tq"][q] for q in d])):
            assert r.exact and r.topk == s.topk
            np.testing.assert_array_equal(r.contained, s.contained)
    st = dict(tac.router.stats)
    assert st == dict(jac.router.stats)
    assert st["flush_batch"] and st["flush_deadline"] and st["inflight_hits"]
    assert tac.stats() == jac.stats()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("trigger", ["batch", "deadline"])
def test_one_host_pipeline_reads_queued(banks, layout, trigger):
    """One host driven by submit -> poll -> collect under a fake clock:
    each ticket reads ``queued`` until a ``batch`` or ``deadline`` flush
    launches its joins and 0 after, reading it flushes nothing, and
    collect forces no flush."""
    tq = banks["tq"]
    half = len(tq) // 2
    clock = [0.0]
    cl = ServingCluster(banks["tbank"], 1, bank_layout=layout, device="cpu",
                        flush_batch=len(tq) if trigger == "batch" else None,
                        max_wait=0.5, clock=lambda: clock[0])
    tickets = [cl.submit({0: tq[:half]})]
    clock[0] += 0.25
    cl.poll()
    assert tickets[0].queued == tickets[0].queued == half
    assert not any(cl.router.stats["flush_" + r]
                   for r in ("batch", "deadline", "force"))
    # the batch trigger: the queue reaches flush_batch here
    tickets.append(cl.submit({0: tq[half:]}))
    if trigger == "deadline":
        assert [t.queued for t in tickets] == [half, len(tq) - half]
        clock[0] += 0.25
        cl.poll()
    st = dict(cl.router.stats)
    assert st["flush_" + trigger] == 1 and st["flush_force"] == 0
    assert [t.queued for t in tickets] == [0, 0]
    got = [r for t in tickets for r in cl.collect(t)[0]]
    assert len(got) == len(tq) and all(r.exact for r in got)
    assert cl.router.stats["flush_force"] == 0 and cl.router.depth() == 0


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_schedule_matches_jax(two_tr_banks, seed):
    """A seeded schedule of delays, transient errors and one host
    blackout over a few dozen queries: every answer is exact and equal
    to the single-host row, or flagged inexact and a superset of it;
    and answers, fault counters, router counters and the injector's
    call counts equal the JAX package's under the same schedule."""
    rng = random.Random(seed)
    H = rng.choice([2, 3, 4])
    crash = rng.randrange(H)
    rate = rng.choice([0.05, 0.15])
    jbank, tbank = two_tr_banks
    truth_srv = PatternServer(tbank, device="cpu")
    now = {"t": [0.0], "j": [0.0]}

    def cluster(pkg, Cluster, Injector, Policy, bank, **kw):
        inj = Injector(seed, error_rate=rate, delay_rate=0.1, delay=0.01,
                       blackouts=[(crash, 2.0, 6.0)],
                       clock=lambda: now[pkg][0])
        return Cluster(bank, H, bank_layout="flat", injector=inj,
                       fault_policy=Policy(retries=2, backoff_base=0.001,
                                           breaker_threshold=3,
                                           breaker_cooldown=1.5),
                       clock=lambda: now[pkg][0], max_wait=0.5,
                       flush_batch=4, **kw)

    tcl = cluster("t", ServingCluster, FaultInjector, RetryPolicy, tbank,
                  device="cpu")
    jcl = cluster("j", JServingCluster, JFaultInjector, JRetryPolicy,
                  jbank)
    n_answers = n_inexact = 0
    for r in range(6):
        jq = random_db(seed + 1 + r, n_seq=4)
        tq = db_from_reference(jq)
        truth = truth_srv.exact_rows(tq)
        tt, jt = tcl.submit(_spread(tq, H)), jcl.submit(_spread(jq, H))
        step = rng.choice([0.1, 0.6, 1.2])
        for c in now.values():
            c[0] += step
        tcl.poll()
        jcl.poll()
        got = tcl.collect(tt, timeout=1.0)
        _same_results(got, jcl.collect(jt, timeout=1.0))
        for i, q in enumerate(tq):
            a = got[i % H][i // H]
            if a.exact:
                np.testing.assert_array_equal(a.contained, truth[i])
            else:
                assert not (truth[i] & ~a.contained).any()
                n_inexact += 1
            n_answers += 1
    assert n_answers == 24
    assert dict(tcl.router.faults) == dict(jcl.router.faults)
    assert dict(tcl.router.stats) == dict(jcl.router.stats)
    assert tcl.injector.calls == jcl.injector.calls
    assert tcl.router.faults["injected"] > 0
    assert not tcl.router._tickets
    assert [_unit_hash(seed, h, i) for h in range(H) for i in range(8)] == \
        [jcl.injector.decide.__globals__["_unit_hash"](seed, h, i)
         for h in range(H) for i in range(8)]


@pytest.mark.parametrize("log_capacity", [256, 1])
def test_replica_apply_and_replay_match_jax(log_capacity):
    """Replicas serve their old bank while the writer refreshes, then
    converge; a crashed replica restarts by replaying the recovery log
    (or, once the ring evicted its gap, by a full transfer): its state
    and the replay count equal the JAX package's."""
    jdb = random_db(21, n_seq=W)
    kw = dict(minsup=MINSUP, window=W, max_len=MAX_LEN, bank_layout="trie")
    tw = StreamingBank.from_db(db_from_reference(jdb), device="cpu", **kw)
    jw = JStreamingBank.from_db(jdb, **kw)
    tg = ReplicaGroup(tw, 2, log_capacity=log_capacity)
    jg = JReplicaGroup(jw, 2, log_capacity=log_capacity)
    jq = random_db(22, n_seq=5)
    tq = db_from_reference(jq)
    before = tg.query(tq, replica=0, k=5)
    for g, w, batch in ((tg, tw, db_from_reference), (jg, jw, list)):
        w.observe(batch(random_db(400, n_seq=4)))
        g.crash(1)
        w.refresh()
        w.observe(batch(random_db(401, n_seq=2)))
    assert tg.lag(0) == jg.lag(0) > 0
    for a, b in zip(before, tg.query(tq, replica=0, k=5)):
        np.testing.assert_array_equal(a.contained, b.contained)
    tg.sync(0)
    jg.sync(0)
    assert tg.restart(1) == jg.restart(1)
    want = tw.server.exact_rows(tq)
    for rid in (0, 1):
        rep, jrep = tg.replicas[rid], jg.replicas[rid]
        assert [pattern_key(p) for p in rep.bank.patterns] == \
            [pattern_key(p) for p in jrep.bank.patterns]
        np.testing.assert_array_equal(rep.support, jrep.support)
        np.testing.assert_array_equal(rep.active, jrep.active)
        assert (rep.last_seq, rep.applied) == (jrep.last_seq, jrep.applied)
        got = tg.query(tq, replica=rid, k=5)
        np.testing.assert_array_equal(
            np.stack([r.contained for r in got]), want)
        assert [r.topk for r in got] == \
            [r.topk for r in jg.query(jq, replica=rid, k=5)]
    assert tw.metrics.snapshot()["cluster.faults.recoveries"] == 1


@pytest.mark.parametrize("mode", [["--window", "16"], ["--hosts", "4"],
                                  ["--window", "16", "--hosts", "2"],
                                  ["--window", "16", "--replicas", "2"]],
                         ids=["window", "hosts", "sharded", "replicas"])
def test_serve_launcher_modes_on_cpu(monkeypatch, capsys, mode):
    """The streaming window, the cluster, the sharded window and the
    read replicas run on the CPU and check themselves."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--db-size", "16", "--queries", "16",
        "--stream-batch", "4", "--bank-layout", "trie_fused", *mode])
    serve.main()
    out = capsys.readouterr().out
    assert out.count("(verified)") == (2 if "--replicas" in mode else 1)
