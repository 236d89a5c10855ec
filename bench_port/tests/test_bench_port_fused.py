"""The fused trie layout's cell, ``t3f.query_small``: its deployment is
``gtrace-t3`` served through ``trie_fused``, its three span readers read
a batch's self time (0 where the program records no such span, None in
a mining cell), a traced run on the CPU reads them and the flat cell's
span and counter metrics, and a run with the timed path broken, or the
control, is not correct at its test size."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_port.lib import driver, registry
from bench_port.lib.systems import ControlSystem, ProgramSystem
from test_bench_port_faults import (SEED, AlteredAnswer, AlteredSupport,
                                    AlteredTopk, HalfTheBatch, HalfTheDB,
                                    _small, _verdict)

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "t3f.query_small"
READERS = {"fused.cells_ms": "serving.fused_cells",
           "fused.walk_ms": "serving.fused_walk",
           "fused.gather_ms": "serving.fused_gather"}
# the flat cell's serving metrics, which the fused cell reports too; the
# last two read the profiled slice, which only a card records
SHARED = ("serve.cache_hit_rate", "serve.cache_ms", "serve.prescreen_ms",
          "serve.join_ms", "serve.fallback_cells")
SLICE = ("contain_step.roofline", "device_idle.serve")


def test_the_deployment_is_gtrace_t3_through_the_fused_layout():
    flat = registry.config("gtrace-t3")
    fused = registry.config("gtrace-t3-fused")
    for key in ("db", "min_support_frac", "max_len", "query_pool",
                "guarantees", "reduced"):
        assert fused[key] == flat[key], key
    assert fused["server"] == dict(flat["server"], bank_layout="trie_fused")
    mix = registry.mix("query_small")
    assert (mix["kind"], mix["batch"], mix["pool"], mix["warmup_batches"],
            mix["check_sample"], mix["profile_ops"]) == \
        ("query", 32, 16384, 16, 256, 64)
    assert registry.cell_metrics(BENCH, CELL) == (
        ["setup_s", "queries_per_s", "query_p95_ms"],
        list(SHARED + SLICE) + list(READERS))


def _art(kind="query", ops=4, spans=()):
    return SimpleNamespace(kind=kind, ops=ops, spans=list(spans))


def _span(name, self_us, *ancestors):
    return {"name": name, "self": self_us, "ancestors": tuple(ancestors)}


@pytest.mark.parametrize("metric", list(READERS))
def test_a_fused_reader_reads_its_span_a_batch_or_zero_or_none(metric):
    read = registry.metric(metric).read
    name = READERS[metric]
    spans = [_span("serving.batch", 900.0, "serving.query"),
             _span("serving.finalize_rows", 500.0, "serving.query"),
             _span("serving.readback", 300.0, "serving.query",
                   "serving.finalize_rows"),
             _span(name, 1200.0, "serving.query", "serving.batch"),
             _span(name, 800.0, "serving.query", "serving.batch")]
    # 2,000 us over 4 batches; every other span left out
    assert read(_art(spans=spans)) == pytest.approx(0.5)
    # the parent program records no such span: 0, so a traced run stays
    # correct there
    assert read(_art(spans=spans[:3])) == 0.0
    assert read(_art(kind="mine", spans=spans)) is None
    assert read(_art(ops=0, spans=spans)) is None


def test_a_traced_cpu_run_reads_the_fused_span_metrics():
    """Every metric of the cell that reads spans or counters reads on
    the CPU (the fused spans and the shared serving spans above 0); those
    of the profiled slice are left out without a card."""
    cfg, mix = _small(CELL)
    _, layer = registry.cell_metrics(BENCH, CELL)
    res = driver.run(cfg, mix, SEED, 0.3, True,
                     {n: registry.metric(n) for n in layer},
                     ProgramSystem("cpu"), registry.kernels())
    got = res["per_layer"]
    assert set(got) == set(READERS) | set(SHARED)
    assert all(got[n] > 0 for n in READERS), got
    assert all(got[n] >= 0 for n in SHARED), got
    assert got["serve.cache_ms"] > 0 and got["serve.prescreen_ms"] > 0
    assert got["serve.join_ms"] > 0
    assert res["trace"] is None
    readable = [n for n in layer if n not in SLICE]
    assert driver.is_correct(res, got, readable), res["checks"]


@pytest.mark.parametrize("fault,check", [
    (AlteredAnswer, "rows_wrong"),
    (HalfTheBatch, "answers_missing"),
    (HalfTheDB, "bank_wrong"),
    (AlteredTopk, "topk_wrong"),
    (AlteredSupport, "bank_wrong"),
])
def test_a_broken_fused_run_is_not_correct(fault, check):
    ok, res = _verdict(CELL, fault("cpu"))
    assert not ok
    assert {c["name"]: c["value"] for c in res["checks"]}[check] > 0


def test_the_control_of_the_fused_cell_is_not_correct():
    cfg, mix = _small(CELL)
    # as for the flat cell: a frontier of 2 at the test size's bank
    cfg["server"] = dict(cfg["server"], emax=2)
    res = driver.run(cfg, mix, SEED, 0.3, False, {}, ControlSystem(None), {})
    assert {c["name"]: c["value"] for c in res["checks"]}["rows_wrong"] > 0
    assert not driver.is_correct(res, res["end_to_end"],
                                 registry.cell_metrics(BENCH, CELL)[0])
