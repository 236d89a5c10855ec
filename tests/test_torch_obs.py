"""The observability layer's export, flight recorder and SLO rules,
port vs the JAX package, on the CPU: the same registry gives the same
exposition text and problem lists, the exporter and the flight
recorder write the same lines under a fake clock, and a watchdog on a
port ``ServingCluster`` breaches as one on the JAX package's cluster
does."""
import json
import os
import random

import pytest

from repro.core.compile import compile_sequence as j_compile_sequence
from repro.data.synthetic import random_graph_sequence as j_random_gs
from repro.mining.driver import AcceleratedMiner as JaxMiner
from repro.obs import FlightRecorder as JFlightRecorder
from repro.obs import MetricsExporter as JMetricsExporter
from repro.obs import SloRule as JSloRule
from repro.obs import SloWatchdog as JSloWatchdog
from repro.obs import evaluate as j_evaluate
from repro.obs import load_rules as j_load_rules
from repro.obs import prometheus_text as j_prometheus_text
from repro.obs import validate_exposition as j_validate_exposition
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.serving.bank import compile_bank as j_compile_bank
from repro.serving.cluster import ServingCluster as JServingCluster

from repro_torch.core.graphseq import db_from_reference
from repro_torch.obs import FlightRecorder, MetricsExporter, \
    MetricsRegistry, SloRule, SloWatchdog, evaluate, load_rules, \
    prometheus_text, validate_exposition
from repro_torch.serving.bank import bank_from_reference
from repro_torch.serving.cluster import ServingCluster

RULES = os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "slo_rules.json")


def _populate(reg):
    """One registry's worth of every metric kind, with dotted names."""
    reg.counter("cluster.router.queries").inc(42)
    reg.counter("mining.rs.n_device_calls").inc(3)
    reg.gauge("cluster.router.queue_depth").set(3)
    reg.gauge("cluster.router.queue_age").set(0.25)
    h = reg.histogram("mining.wavefront.wave_patterns")
    for v in (5.0, 1.0, 9.5):
        h.observe(v)
    b = reg.bucket_histogram("cluster.router.e2e_seconds")
    for v in (0.001, 0.01, 0.5, 3.0):
        b.observe(v)
    return reg


def _texts():
    """A valid exposition and three malformed ones, from the port's
    registry."""
    text = prometheus_text(_populate(MetricsRegistry()))
    lines = text.splitlines()
    return {
        "valid": text,
        "no_inf_bucket": "\n".join(ln for ln in lines
                                   if "+Inf" not in ln) + "\n",
        "untyped_counter": "nameless_total 1\n",
        "bad_value": "\n".join(ln.replace(" 42", " forty-two")
                               for ln in lines) + "\n",
    }


def test_prometheus_text_matches_jax():
    """The same registry renders to the same exposition text, which
    both validators accept."""
    got = prometheus_text(_populate(MetricsRegistry()))
    want = j_prometheus_text(_populate(JMetricsRegistry()))
    assert got == want
    assert validate_exposition(got) == [] == j_validate_exposition(want)


@pytest.mark.parametrize("name", ["valid", "no_inf_bucket",
                                  "untyped_counter", "bad_value"])
def test_validate_exposition_matches_jax(name):
    text = _texts()[name]
    got = validate_exposition(text)
    assert got == j_validate_exposition(text)
    assert bool(got) == (name != "valid")


def _ship(reg_cls, exp_cls, path):
    reg = reg_cls()
    reg.counter("m.q").inc(7)
    now = [50.0]
    exp = exp_cls(reg, path, interval=10.0, clock=lambda: now[0])
    shipped = [exp.maybe_ship()]
    for dt, inc in ((5.0, 0), (5.0, 1), (2.0, 3), (30.0, 0)):
        now[0] += dt
        reg.counter("m.q").inc(inc)
        reg.gauge("m.depth").set(inc)
        shipped.append(exp.maybe_ship())
    with open(path) as f:
        return shipped, f.read()


def test_metrics_exporter_matches_jax(tmp_path):
    """The exporter ships on the same ticks of a fake clock and writes
    the same JSONL lines."""
    got = _ship(MetricsRegistry, MetricsExporter, str(tmp_path / "t.jsonl"))
    want = _ship(JMetricsRegistry, JMetricsExporter,
                 str(tmp_path / "j.jsonl"))
    assert got == want
    assert got[0] == [True, False, True, False, True]


def _flight(reg_cls, fr_cls, tmp_path, tag):
    reg = reg_cls()
    now = [100.0]
    auto = str(tmp_path / f"{tag}_auto.jsonl")
    fr = fr_cls(capacity=3, metrics=reg, metrics_prefix="m",
                clock=lambda: now[0], autodump_path=auto)
    for i in range(5):
        reg.counter("m.q").inc(10 + i)
        reg.counter("other.q").inc(1)
        now[0] += 1.0
        fr.record(f"span{i}", 0.25,
                  [{"name": f"span{i}", "cat": "wall", "ts": 0.0,
                    "dur": 250.0, "trace": i}],
                  kind="tail" if i == 3 else "sampled", trace=i,
                  anomaly="shed" if i == 3 else None)
    path = str(tmp_path / f"{tag}.jsonl")
    n = fr.dump(path, reason="test")
    with open(path) as f, open(auto) as g:
        return n, f.read(), g.read()


def test_flight_recorder_matches_jax(tmp_path):
    """The same ring (capacity 3 of 5 records), metric deltas, anomaly
    autodump and dump, line for line."""
    got = _flight(MetricsRegistry, FlightRecorder, tmp_path, "t")
    want = _flight(JMetricsRegistry, JFlightRecorder, tmp_path, "j")
    assert got == want
    header = json.loads(got[1].splitlines()[0])
    assert got[0] == 3 and header["dropped"] == 2


def test_slo_rules_and_evaluate_match_jax():
    """``load_rules`` reads the repository's rules file alike, and
    ``evaluate`` finds the same breaches, absolute and on deltas."""
    rules, j_rules = load_rules(RULES), j_load_rules(RULES)
    assert [vars(r) for r in rules] == [vars(r) for r in j_rules]
    extra = [("p99", "quantile", "r.e2e_seconds", 0.5, 0.99, None),
             ("shed", "rate", "r.shed", 0.1, None, "r.queries")]
    rules += [SloRule(n, k, m, mx, q=q, den=d)
              for n, k, m, mx, q, d in extra]
    j_rules += [JSloRule(n, k, m, mx, q=q, den=d)
                for n, k, m, mx, q, d in extra]
    sick = {"r.e2e_seconds.p99": 0.9, "r.shed": 30, "r.queries": 100,
            "cluster.router.queue_age": 9.0, "cluster.faults.breaker_open": 2}
    still = dict(sick, **{"r.e2e_seconds.p99": 0.2})
    for snap, prev in ((sick, None), (still, sick), ({}, None)):
        got = evaluate(rules, snap, prev=prev)
        assert [vars(b) for b in got] == \
            [vars(b) for b in j_evaluate(j_rules, snap, prev=prev)]
    assert {b.rule for b in evaluate(rules, sick)} >= {"p99", "shed"}


def _db(seed, n_seq):
    rng = random.Random(seed)
    return [j_compile_sequence(j_random_gs(rng, n_steps=4, n_v=4, n_vl=2,
                                           n_el=2)) for _ in range(n_seq)]


@pytest.fixture(scope="module")
def banks():
    jbank = j_compile_bank(JaxMiner(_db(3, 12)).mine_rs(2, max_len=3))
    assert jbank.n_patterns
    return jbank, bank_from_reference(jbank), _db(7, 8)


def _watch(make_cluster, rec_cls, wd_cls, load, queries, dump):
    """A healthy drain, then fresh queries admitted and never flushed
    while the fake clock runs past the queue-aging bound: the breach
    count after each, the checks, the dump's reason, the last breaches
    and every row."""
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    cl = make_cluster(clock)
    flight = rec_cls(capacity=16, metrics=cl.metrics,
                     metrics_prefix="cluster.router", clock=clock)
    flight.record("q", 0.1, [], kind="sampled", trace=1)
    wd = wd_cls(cl.metrics, load(RULES), clock=clock, min_interval=0.5,
                flight=flight, dump_path=dump)
    cl.attach_watchdog(wd)
    breaches = cl.metrics.counter("cluster.router.slo_breaches")
    t = cl.submit({0: queries[:4]})
    now[0] += 0.01
    healthy = cl.collect(t)
    now[0] += 1.0
    cl.poll()
    seen = [breaches.value]
    stalled = cl.submit({1: queries[4:]})
    for _ in range(8):
        now[0] += 1.5
        cl.poll()
    seen.append(breaches.value)
    with open(dump) as f:
        reason = json.loads(f.readline())["reason"]
    late = cl.collect(stalled)
    rows = [[(r.contained.tolist(), r.exact) for r in res[h]]
            for res in (healthy, late) for h in sorted(res)]
    return seen, wd.checks, reason, [b.rule for b in wd.last_breaches], rows


def test_watchdog_breaches_on_port_cluster(banks, tmp_path):
    """A watchdog riding a port ``ServingCluster`` under a fake clock
    stays quiet on a healthy drain, breaches the aging rules on a
    stalled one and dumps the flight recorder, as on the JAX package's
    cluster; the stalled queries still come back exact."""
    jbank, tbank, queries = banks
    want = _watch(
        lambda clock: JServingCluster(jbank, 2, bank_layout="flat",
                                      max_wait=10.0, clock=clock),
        JFlightRecorder, JSloWatchdog, j_load_rules, queries,
        str(tmp_path / "j.jsonl"))
    got = _watch(
        lambda clock: ServingCluster(tbank, 2, bank_layout="flat",
                                     max_wait=10.0, clock=clock,
                                     device="cpu"),
        FlightRecorder, SloWatchdog, load_rules,
        db_from_reference(queries), str(tmp_path / "t.jsonl"))
    assert got == want
    seen, _, reason, last, rows = got
    assert seen[0] == 0 and seen[1] > 0 and reason.startswith("slo:")
    assert "ticket-aging" in reason
    assert all(exact for host in rows for _, exact in host)
