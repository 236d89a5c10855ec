"""The reductions on hand-made inputs: the self-time sweep, the busy union
and its gaps, the naming of gaps by span, the tail statistic, the
per-layer readers, and the roofline counts against ``chip_smoke.py``'s
formulas on recorded shapes."""
import importlib.util
import statistics
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_port.lib import driver, readers, registry, timeline

ROOT = Path(__file__).resolve().parents[2]


def test_self_time_subtracts_children_and_keeps_ancestors():
    ev = [
        {"name": "root", "ts": 0.0, "dur": 100.0},
        {"name": "a", "ts": 10.0, "dur": 40.0},
        {"name": "a1", "ts": 15.0, "dur": 10.0},
        {"name": "b", "ts": 60.0, "dur": 30.0},
    ]
    got = {s["name"]: s for s in timeline.self_times(ev)}
    assert got["root"]["self"] == pytest.approx(30.0)
    assert got["a"]["self"] == pytest.approx(30.0)
    assert got["a1"]["self"] == pytest.approx(10.0)
    assert got["a1"]["ancestors"] == ("root", "a")
    assert got["b"]["ancestors"] == ("root",)
    assert sum(s["self"] for s in got.values()) == pytest.approx(100.0)


def test_busy_union_gaps_and_coverage():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert timeline.union(iv) == [(0, 12), (20, 30), (40, 41)]
    assert timeline.covered(iv) == 23
    assert timeline.gaps(timeline.union(iv), -5, 45) == [
        (-5, 0), (12, 20), (30, 40), (41, 45)]
    assert timeline.gaps([], 0, 3) == [(0, 3)]
    # an operator and the kernel it launches overlap: counted once
    assert timeline.covered([(0, 10), (2, 8)]) == 10


def test_idle_gaps_take_the_innermost_span():
    spans = [(0, 100, "root"), (10, 50, "a"), (20, 30, "a1"), (60, 90, "b")]
    pts = [5, 15, 25, 55, 70, 95, 120]
    assert driver._label_points(spans, pts) == [
        "root", "a", "a1", "root", "b", "root",
        "(no span: harness loop)"]


def test_p95_is_the_inclusive_quantile_of_all_samples():
    vals = [float(v) for v in range(1, 201)]
    assert timeline.p95(vals) == pytest.approx(
        statistics.quantiles(vals, n=100, method="inclusive")[94])
    assert timeline.p95([3.0]) == 3.0
    assert timeline.p95([1.0, 2.0]) == pytest.approx(1.95)


def _art(**kw):
    base = dict(kind="query", ops=4, counters={}, spans=[], slice=None,
                calls={}, roofline=registry.kernels(), peaks=None)
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_on_hand_made_artifacts():
    spans = timeline.self_times([
        {"name": "serving.query", "ts": 0.0, "dur": 1000.0},
        {"name": "serving.cache", "ts": 0.0, "dur": 100.0},
        {"name": "serving.batch", "ts": 100.0, "dur": 500.0},
        {"name": "serving.encode", "ts": 110.0, "dur": 50.0},
        {"name": "serving.prescreen_host", "ts": 200.0, "dur": 30.0},
        {"name": "serving.join", "ts": 300.0, "dur": 100.0},
        {"name": "serving.finalize_rows", "ts": 600.0, "dur": 300.0},
        {"name": "serving.oracle", "ts": 700.0, "dur": 80.0},
    ])
    art = _art(spans=spans, counters={"queries": 1000, "cache_hits": 250,
                                      "host_fallback_cells": 6})
    read = {n: registry.metric(n).read(art) for n in (
        "serve.cache_ms", "serve.prescreen_ms", "serve.join_ms",
        "serve.cache_hit_rate", "serve.fallback_cells", "mine.scan_launches",
        "device_idle.serve", "contain_step.roofline")}
    assert read["serve.cache_ms"] == pytest.approx(0.1 / 4)
    assert read["serve.prescreen_ms"] == pytest.approx(0.08 / 4)
    # batch self 320 + join 100 + finalize_rows self 220
    assert read["serve.join_ms"] == pytest.approx(0.64 / 4)
    assert read["serve.cache_hit_rate"] == pytest.approx(25.0)
    assert read["serve.fallback_cells"] == pytest.approx(1.5)
    # no slice (no card): the device readers find nothing to read
    assert read["mine.scan_launches"] is None
    assert read["device_idle.serve"] is None
    assert read["contain_step.roofline"] is None
    sl = SimpleNamespace(ops=2, wall_s=2.0, busy_s=0.5, device=[
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0.0, 1.0),
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5.0, 1.0),
        ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 9.0, 1.0)])
    mine = _art(kind="mine", ops=2, slice=sl, counters={
        "match_count": 130, "job_seconds": 2.0, "device_seconds": 0.1})
    assert registry.metric("mine.scan_launches").read(mine) == 65
    assert registry.metric("mine.h2d_copies").read(mine) == 1
    assert registry.metric("mine.host_share").read(mine) == pytest.approx(95)
    assert registry.metric("device_idle.mine").read(mine) == pytest.approx(75)
    assert registry.metric("device_idle.serve").read(mine) is None


def test_roofline_share_pairs_calls_with_kernel_events():
    mod = SimpleNamespace(KERNEL="k_kernel", launched=lambda n: n > 0,
                          counts=lambda n: (n * 1000, n))
    sl = SimpleNamespace(device=[("void k_kernel(int*)", "kernel", 0.0, 2.0),
                                 ("void k_kernel(int*)", "kernel", 5.0, 2.0),
                                 ("other", "kernel", 9.0, 5.0)])
    art = _art(slice=sl, roofline={"k": mod}, calls={"k": [(1,), (0,), (3,)]},
               peaks={"hbm_bytes_per_s": 1e9, "int32_ops_per_s": 1e3})
    # bounds: max(1e-6, 1e-3) + max(3e-6, 3e-3) = 4e-3 s over 4e-6 s... as %
    assert readers.roofline_share(art, "k") == pytest.approx(
        100 * 4e-3 / 4e-6)
    art.calls = {"k": [(1,)]}           # one call, two kernels: no pairing
    assert readers.roofline_share(art, "k") is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_roofline", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.PEAK_OPS_PER_S = 1.6727e13
    return mod


@pytest.mark.parametrize("E,mode", [(64, None), (129, 2), (1024, 0)])
def test_match_count_counts_equal_chip_smokes(E, mode):
    cs = _chip_smoke()
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                 cs._scan_inputs(np.random.default_rng(E), E, mode))
    _, _, nbytes, ops, _ = cs._bound_ms(args)
    mod = registry.roofline("match_count")
    assert mod.launched(*args)
    assert mod.counts(*args) == (nbytes, ops)


@pytest.mark.parametrize("G,Ein,Tm", [(65, 4, 9), (512, 16, 16), (7, 1, 1)])
def test_contain_step_counts_equal_chip_smokes(G, Ein, Tm):
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(G)
    tok = torch.randint(-1, 4, (G, Tm, 6), generator=g, dtype=torch.int32)
    psi = torch.randint(-1, 6, (G, Ein, 5), generator=g, dtype=torch.int32)
    srow = torch.randint(-1, 4, (G, Ein, 8), generator=g, dtype=torch.int32)
    _, _, nbytes, nops = cs._contain_bound(tok, psi, srow)
    mod = registry.roofline("contain_step")
    assert mod.launched(tok, psi, srow)
    assert mod.counts(tok, psi, srow) == (nbytes, nops)


def test_cyclic_order_walks_the_pool_round_and_round():
    order = registry.kind("query")._Cyclic(3, 5)
    assert [order.next() for _ in range(3)] == [[0, 1, 2], [3, 4, 0],
                                                [1, 2, 3]]
