"""The streaming window's cell, ``t3s.stream``: a run of the ``stream``
kind on the CPU at a test size is correct with every check at 0 and its
span and counter metrics read; a refresh that loses a discovered pattern,
an answer with an active bit flipped, and the control each read above 0;
the six stream readers read a stream window and nothing else; and the
cell reports exactly its end-to-end metrics and those six."""
import copy
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bench_port.lib import driver, registry
from bench_port.lib.systems import ControlSystem, ProgramSystem
from repro_torch.serving import streaming

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "t3s.stream"
SEED = 2**31 + 2028
READERS = ("stream.join_ms", "stream.window_ms", "stream.frontier_ms",
           "stream.reconcile_ms", "stream.frontier_scans",
           "device_idle.stream")
# the one reader of the profiled slice, which only a card records
SLICE = "device_idle.stream"


def _small():
    """The cell at a test size: 60 Table 3 sequences seed a 60-sequence
    window, arrivals of 5, a refresh every 2 batches, 4 warm-up batches."""
    cfg = copy.deepcopy(registry.config("gtrace-t3-stream"))
    cfg["db"]["params"][cfg["db"]["size_key"]] = 60
    cfg["stream"] = dict(cfg["stream"], window=60, refresh_every=2)
    mix = dict(registry.mix("stream"), batch=5, pool=64, warmup_batches=4,
               check_sample=8)
    return cfg, mix


def _run(system, traced=False, cfg=None):
    small, mix = _small()
    _, layer = registry.cell_metrics(BENCH, CELL)
    res = driver.run(cfg or small, mix, SEED, 0.5, traced,
                     {n: registry.metric(n) for n in layer} if traced
                     else {}, system, {})
    return res, {c["name"]: c["value"] for c in res["checks"]}


def test_the_deployment_is_gtrace_t3_as_a_window():
    base = registry.config("gtrace-t3")
    cfg = registry.config("gtrace-t3-stream")
    for key in ("db", "min_support_frac", "max_len", "query_pool", "server",
                "reduced"):
        assert cfg[key] == base[key], key
    assert cfg["stream"] == {"window": 1000, "refresh_every": 4,
                             "compact_threshold": 0.5, "tombstones": True}
    mix = registry.mix("stream")
    assert (mix["kind"], mix["batch"], mix["pool"], mix["warmup_batches"],
            mix["check_sample"], mix["check_refreshes"],
            mix["profile_ops"]) == ("stream", 50, 16384, 20, 64, 2, 8)
    assert registry.cell_metrics(BENCH, CELL) == (
        ["setup_s", "queries_per_s", "query_p95_ms"], list(READERS))


def test_a_traced_stream_run_is_correct_and_reads_its_metrics():
    res, checks = _run(ProgramSystem("cpu"), traced=True)
    assert checks == {"bank_wrong": 0, "answers_missing": 0,
                      "window_wrong": 0, "rows_wrong": 0}
    got = res["per_layer"]
    # nothing profiled without a card
    assert set(got) == set(READERS) - {SLICE} and res["trace"] is None
    assert all(got[n] > 0 for n in got), got
    assert res["attempted"] > 0 and res["failed"] == 0
    assert driver.is_correct(res, got, [n for n in READERS if n != SLICE])


def test_a_refresh_that_loses_a_discovered_pattern_is_not_correct(
        monkeypatch):
    frontier = streaming.refresh_frontier

    def lossy(*args, **kw):
        fr = frontier(*args, **kw)
        lost = [p for p in fr.gids if p in fr.patterns][-1:]
        return dataclasses.replace(fr, patterns={
            p: s for p, s in fr.patterns.items() if p not in lost})

    monkeypatch.setattr(streaming, "refresh_frontier", lossy)
    _, checks = _run(ProgramSystem("cpu"))
    assert checks["window_wrong"] > 0


def test_an_answer_with_an_active_bit_flipped_is_not_correct(monkeypatch):
    observe = streaming.StreamingBank.observe

    def flipped(self, batch):
        first = np.nonzero(self.active)[0][:1]
        res = observe(self, batch)
        rows = res.rows.copy()
        rows[:, first] = ~rows[:, first]
        return dataclasses.replace(res, rows=rows)

    monkeypatch.setattr(streaming.StreamingBank, "observe", flipped)
    _, checks = _run(ProgramSystem("cpu"))
    assert checks["rows_wrong"] > 0
    assert checks["window_wrong"] == 0


def test_the_control_of_the_stream_is_not_correct():
    cfg, _ = _small()
    # a frontier of 2 at the test size's bank, as for the serving cells
    cfg["server"] = dict(cfg["server"], emax=2)
    res, checks = _run(ControlSystem(None), cfg=cfg)
    assert checks["rows_wrong"] > 0
    assert not driver.is_correct(res, res["end_to_end"],
                                 registry.cell_metrics(BENCH, CELL)[0])


def _span(name, self_us, *ancestors):
    return {"name": name, "self": self_us, "ancestors": tuple(ancestors)}


SPANS = [
    _span("streaming.observe", 100.0),
    _span("serving.exact_rows", 300.0, "streaming.observe"),
    _span("serving.step", 500.0, "streaming.observe", "serving.exact_rows"),
    _span("streaming.ring", 40.0, "streaming.observe"),
    _span("streaming.mask", 60.0, "streaming.observe"),
    _span("streaming.refresh", 200.0),
    _span("streaming.dirty", 100.0, "streaming.refresh"),
    _span("streaming.frontier", 1000.0, "streaming.refresh"),
    _span("mining.children", 3000.0, "streaming.refresh",
          "streaming.frontier", "mining.mine"),
    _span("streaming.reconcile", 300.0, "streaming.refresh"),
    _span("streaming.mask", 400.0, "streaming.refresh",
          "streaming.reconcile"),
]


@pytest.mark.parametrize("metric,want", [
    ("stream.join_ms", 0.2),          # 800 us over 4 batches
    ("stream.window_ms", 0.05),       # 200 us over 4 batches
    ("stream.frontier_ms", 4.0),      # 4,000 us over 1 refresh
    ("stream.reconcile_ms", 1.0),     # 1,000 us over 1 refresh
    ("stream.frontier_scans", 12.5),  # 25 scans over 2 refreshes
    ("device_idle.stream", 75.0),     # 0.25 s busy of 1 s
])
def test_a_stream_reader_reads_a_stream_window_and_nothing_else(metric,
                                                                want):
    read = registry.metric(metric).read

    def art(kind):
        return SimpleNamespace(
            kind=kind, ops=4, spans=SPANS,
            counters={"refreshes": 2, "frontier_scans": 25},
            slice=SimpleNamespace(wall_s=1.0, busy_s=0.25))

    assert read(art("stream")) == pytest.approx(want)
    assert read(art("mine")) is None and read(art("query")) is None
