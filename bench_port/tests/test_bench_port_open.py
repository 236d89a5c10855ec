"""The open-loop cell, ``t3r.query_open``: a run of the ``open`` kind on
the CPU at a test size is correct with every check at 0 and its span and
histogram metrics read; a flipped bit, an answer flagged inexact and a
dropped answer each read above 0, the first also where the window never
reached the sampled arrivals, and so does the control; under a fake
clock an arrival that fell due while the host was busy counts that wait,
and no flush is forced, through ``DrainTicket.queued`` or, on a program
without it, the router's queue; the five route readers read an open
window and nothing else."""
import copy
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bench_port.lib import driver, registry
from bench_port.lib.systems import ControlSystem, ProgramSystem
from repro_torch.serving import router
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.server import PatternServer

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "t3r.query_open"
SEED = 2**31 + 2030
READERS = ("route.admit_us", "route.queue_wait_ms", "route.join_ms",
           "route.flush_ms", "device_idle.route")
# the one reader of the profiled slice, which only a card records
SLICE = "device_idle.route"


def _small(**mix):
    """The cell at a test size: a 40-sequence DB at sigma 8, patterns of
    up to 4 TRs, 200 arrivals a second over a pool of 256 (no fingerprint
    repeats in a run), 0.2 s of warm-up."""
    cfg = copy.deepcopy(registry.config("gtrace-t3-routed"))
    cfg["db"]["params"][cfg["db"]["size_key"]] = 40
    cfg["min_support_frac"] = 0.2
    cfg["max_len"] = 4
    return cfg, dict(registry.mix("query_open"), **dict(
        dict(rate=200, pool=256, warmup_s=0.2, check_sample=8), **mix))


def _run(system, traced=False, cfg=None):
    small, mix = _small()
    e2e, layer = registry.cell_metrics(BENCH, CELL)
    res = driver.run(cfg or small, mix, SEED, 0.5, traced,
                     {n: registry.metric(n) for n in layer} if traced
                     else {}, system, {})
    names = [n for n in layer if n != SLICE] if traced else e2e
    values = res["per_layer"] if traced else res["end_to_end"]
    return (res, {c["name"]: c["value"] for c in res["checks"]},
            driver.is_correct(res, values, names))


class _FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def sleep(self, dt):
        self.now += dt


def _fake_work(cfg, mix, clock):
    """The kind's work on the CPU under the fake ``clock`` (its schedule
    and the router's), set up."""
    work = registry.make_work(ProgramSystem("cpu"), cfg, mix, SEED)
    work.clock, work.sleep = clock, clock.sleep
    work.setup()
    return work


def test_the_deployment_is_gtrace_t3_behind_one_router_host():
    base = registry.config("gtrace-t3")
    cfg = registry.config("gtrace-t3-routed")
    for key in ("db", "min_support_frac", "max_len", "query_pool", "server",
                "reduced"):
        assert cfg[key] == base[key], key
    assert cfg["router"] == {"hosts": 1, "flush_batch": 256,
                             "max_wait": 0.010, "shed_depth": None}
    assert cfg["router"]["flush_batch"] == cfg["server"]["max_batch"]
    mix = registry.mix("query_open")
    assert (mix["kind"], mix["pool"], mix["warmup_s"], mix["check_sample"],
            mix["profile_ops"]) == ("open", 16384, 4, 256, 16)
    assert mix["rate"] > 0
    assert registry.cell_metrics(BENCH, CELL) == (
        ["setup_s", "queries_per_s", "query_p95_ms"], list(READERS))


@pytest.mark.parametrize("traced", [False, True])
def test_an_open_run_is_correct_and_reads_its_metrics(traced):
    res, checks, ok = _run(ProgramSystem("cpu"), traced=traced)
    assert checks == {"bank_wrong": 0, "answers_missing": 0,
                      "inexact_answers": 0, "rows_wrong": 0,
                      "topk_wrong": 0, "flush_force": 0}
    assert ok and res["attempted"] > 0 and res["failed"] == 0
    if traced:
        got = res["per_layer"]
        # nothing profiled without a card
        assert set(got) == set(READERS) - {SLICE} and res["trace"] is None
        assert all(got[n] > 0 for n in got), got
    else:
        assert res["end_to_end"]["queries_per_s"] > 0


def _flip(res):
    for r in res[0]:
        r.contained = np.array(r.contained)
        r.contained[0] = ~r.contained[0]
    return res


def _inexact(res):
    return {h: [dataclasses.replace(r, exact=False) for r in rs]
            for h, rs in res.items()}


def _drop(res):
    return {h: rs[:-1] for h, rs in res.items()}


@pytest.mark.parametrize("fault,check", [
    (_flip, "rows_wrong"),
    (_inexact, "inexact_answers"),
    (_drop, "answers_missing"),
])
def test_a_broken_answer_is_not_correct(monkeypatch, fault, check):
    collect = ServingCluster.collect
    monkeypatch.setattr(ServingCluster, "collect",
                        lambda self, t=None, timeout=None: fault(
                            collect(self, t, timeout)))
    _, checks, ok = _run(ProgramSystem("cpu"))
    assert checks[check] > 0 and not ok


def test_sampled_arrivals_a_window_never_reached_are_still_checked(
        monkeypatch):
    """A loaded host whose window submits no arrival (its op collects a
    warm-up ticket and the window is over): the check sends the sampled
    arrivals after the window, so a flipped bit still reads."""
    make = registry.make_work

    def idle(*args):
        work = make(*args)
        work.op = lambda: 0
        return work

    monkeypatch.setattr(registry, "make_work", idle)
    collect = ServingCluster.collect
    monkeypatch.setattr(ServingCluster, "collect",
                        lambda self, t=None, timeout=None: _flip(
                            collect(self, t, timeout)))
    _, checks, ok = _run(ProgramSystem("cpu"))
    assert checks["rows_wrong"] > 0 and not ok


def test_the_control_of_the_open_cell_is_not_correct():
    cfg, _ = _small()
    # a frontier of 2 at the test size's bank, as for the serving cells
    cfg["server"] = dict(cfg["server"], emax=2)
    _, checks, ok = _run(ControlSystem(None), cfg=cfg)
    assert checks["rows_wrong"] > 0 and not ok


def test_a_query_due_while_the_host_is_busy_counts_that_wait(monkeypatch):
    busy_s = 0.03
    busy = []   # (start, end) of each fence, on the fake clock
    clock = _FakeClock()
    finalize = PatternServer.finalize_rows

    def slow(self, flight):
        start = clock()
        clock.sleep(busy_s)
        busy.append((start, clock()))
        return finalize(self, flight)

    monkeypatch.setattr(PatternServer, "finalize_rows", slow)
    work = _fake_work(*_small(), clock)
    seen = []   # (due, latency) of each answered arrival of the window
    collect = work._collect

    def spy(ticket, ks, due):
        n = len(work.latencies)
        collect(ticket, ks, due)
        seen.extend(zip(due, work.latencies[n:]))
        # the latency runs from the scheduled arrival to the collect
        assert work.latencies[n:] == [clock() - d for d in due]

    work._collect = spy
    for _ in range(10):
        work.op()
    waited = [(d, lat, end) for d, lat in seen for start, end in busy
              if start < d < end]
    assert waited, "no arrival fell due during a fence"
    assert all(lat >= end - d for d, lat, end in waited)
    assert max(lat for _, lat in seen) >= busy_s


@pytest.mark.parametrize("private", [False, True])
def test_no_flush_is_forced(monkeypatch, private):
    """Batches of at most 6 at 600 arrivals a second: both triggers
    fire, and the client never makes ``collect`` force one, through
    ``DrainTicket.queued`` or, without it, the router's queue."""
    if private:
        monkeypatch.delattr(router.DrainTicket, "queued")
    cfg, mix = _small(rate=600)
    cfg["router"] = dict(cfg["router"], flush_batch=6)
    work = _fake_work(cfg, mix, _FakeClock())
    assert work.client._private is private
    for _ in range(20):
        work.op()
    st = work.client.router.stats
    assert st["flush_batch"] > 0 and st["flush_deadline"] > 0
    assert st["flush_force"] == 0 and work.latencies
    assert {c["name"]: c["value"] for c in work.checks(SEED)} == {
        "bank_wrong": 0, "answers_missing": 0, "inexact_answers": 0,
        "rows_wrong": 0, "topk_wrong": 0, "flush_force": 0}


def _span(name, self_us, *ancestors):
    return {"name": name, "self": self_us, "ancestors": tuple(ancestors)}


SPANS = [
    _span("cluster.submit", 100.0),
    _span("cluster.cache", 300.0, "cluster.submit"),
    _span("cluster.flush", 1000.0, "cluster.submit"),
    _span("serving.batch", 3000.0, "cluster.submit", "cluster.flush"),
    _span("cluster.flush", 2000.0),
    _span("cluster.collect", 50.0),
    _span("cluster.fence", 1000.0, "cluster.collect"),
    _span("cluster.cache_fill", 1000.0, "cluster.collect", "cluster.fence"),
    _span("cluster.finalize", 70.0, "cluster.collect"),
]


@pytest.mark.parametrize("metric,want", [
    ("route.admit_us", 20.0),       # 400 us over 20 queries
    ("route.queue_wait_ms", 5.0),   # 0.02 s over 4 queries
    ("route.join_ms", 2.0),         # 8,000 us over 4 batches
    ("route.flush_ms", 30.0),       # 0.12 s over 4 batches
    ("device_idle.route", 75.0),    # 0.25 s busy of 1 s
])
def test_a_route_reader_reads_an_open_window_and_nothing_else(metric, want):
    read = registry.metric(metric).read

    def art(kind):
        return SimpleNamespace(
            kind=kind, ops=4, spans=SPANS,
            counters={"queries": 20, "flush_batch": 1, "flush_deadline": 3,
                      "flush_force": 0,
                      "cluster.router.queue_wait_seconds.sum": 0.02,
                      "cluster.router.queue_wait_seconds.count": 4,
                      "cluster.router.flush_seconds.sum": 0.12,
                      "cluster.router.flush_seconds.count": 4},
            slice=SimpleNamespace(wall_s=1.0, busy_s=0.25))

    assert read(art("open")) == pytest.approx(want)
    for kind in ("mine", "query", "stream"):
        assert read(art(kind)) is None
