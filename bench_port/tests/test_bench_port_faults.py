"""A run driven end to end on the CPU (the look for a card skipped, the
port's plain kernel versions underneath) at a test size: sound, it is
correct; with the timed path broken underneath, or with the control in
the program's place, ``correct`` comes out false."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest

from bench_port.lib import driver, registry
from bench_port.lib.systems import ControlSystem, MineOut, ProgramSystem

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 2024


def _small(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    cfg = copy.deepcopy(registry.config(w["config"]))
    cfg["db"]["params"][cfg["db"]["size_key"]] = 40
    cfg["min_support_frac"] = 0.2
    cfg["max_len"] = 4
    mix = dict(registry.mix(w["traffic"]))
    if mix["kind"] == "query":
        mix.update(pool=32, batch=8, check_sample=8, warmup_batches=1)
    return cfg, mix


def _verdict(cell, system):
    cfg, mix = _small(cell)
    res = driver.run(cfg, mix, SEED, 0.3, False, {}, system, {})
    e2e, _ = registry.cell_metrics(BENCH, cell)
    return driver.is_correct(res, res["end_to_end"], e2e), res


class AlteredSupport(ProgramSystem):
    """One support off by one where the miner produces it."""

    def mine(self, db, sigma, max_len):
        out = super().mine(db, sigma, max_len)
        p = next(iter(out.patterns))
        return MineOut({**out.patterns, p: out.patterns[p] + 1},
                       out.device_seconds)


class HalfTheDB(ProgramSystem):
    """Half of the DB left out of the scan."""

    def mine(self, db, sigma, max_len):
        return super().mine(db[: len(db) // 2], sigma, max_len)


class _Wrapped:
    def __init__(self, inner, alter):
        self.inner = inner
        self.alter = alter

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def query(self, seqs):
        return self.alter(self.inner.query(seqs))


def _flip(answers):
    out = []
    for a in answers:
        a = copy.copy(a)
        a.contained = np.array(a.contained)
        a.contained[0] = ~a.contained[0]
        out.append(a)
    return out


class AlteredAnswer(ProgramSystem):
    """Each answer's first contained bit flipped where it is produced."""

    def server(self, patterns, params):
        return _Wrapped(super().server(patterns, params), _flip)


def _bump_topk(answers):
    out = []
    for a in answers:
        a = copy.copy(a)
        if a.topk:
            (row, sup), *rest = a.topk
            a.topk = [(row, sup + 1), *rest]
        out.append(a)
    return out


class AlteredTopk(ProgramSystem):
    """Each answer's first top-k support off by one where it is
    produced."""

    def server(self, patterns, params):
        return _Wrapped(super().server(patterns, params), _bump_topk)


class HalfTheBatch(ProgramSystem):
    """Half of each batch left unanswered."""

    def server(self, patterns, params):
        return _Wrapped(super().server(patterns, params),
                        lambda ans: ans[: len(ans) // 2])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_sound_run_is_correct(cell):
    ok, res = _verdict(cell, ProgramSystem("cpu"))
    assert ok, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell,fault,check", [
    ("t3.mine", AlteredSupport, "patterns_wrong"),
    ("t3.mine", HalfTheDB, "patterns_wrong"),
    ("t3.query_cold", AlteredAnswer, "rows_wrong"),
    ("t3.query_cold", HalfTheBatch, "answers_missing"),
    ("t3.query_cold", HalfTheDB, "bank_wrong"),
    ("t3.query_cold", AlteredTopk, "topk_wrong"),
    ("t3.query_cold", AlteredSupport, "bank_wrong"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, check):
    ok, res = _verdict(cell, fault("cpu"))
    assert not ok
    assert {c["name"]: c["value"] for c in res["checks"]}[check] > 0


@pytest.mark.parametrize("cell,per_seq,check", [
    ("t3.mine", 1, "patterns_wrong"),
    ("t3.query_cold", None, "rows_wrong"),
])
def test_the_control_is_not_correct(cell, per_seq, check):
    cfg, mix = _small(cell)
    if mix["kind"] == "query":
        # the test size's bank is small: a frontier of 2 shows the
        # shortcut here as the server's emax of 4 does at the cell's size
        cfg["server"] = dict(cfg["server"], emax=2)
    res = driver.run(cfg, mix, SEED, 0.3, False, {},
                     ControlSystem(per_seq), {})
    checks = {c["name"]: c["value"] for c in res["checks"]}
    assert checks[check] > 0
    assert not driver.is_correct(res, res["end_to_end"],
                                 registry.cell_metrics(BENCH, cell)[0])


def test_a_traced_cpu_run_reads_the_span_and_counter_metrics():
    cfg, mix = _small("t3.query_cold")
    _, layer = registry.cell_metrics(BENCH, "t3.query_cold")
    res = driver.run(cfg, mix, SEED, 0.3, True,
                     {n: registry.metric(n) for n in layer},
                     ProgramSystem("cpu"), registry.kernels())
    got = res["per_layer"]
    for n in ("serve.cache_ms", "serve.prescreen_ms", "serve.join_ms",
              "serve.cache_hit_rate", "serve.fallback_cells"):
        assert n in got and got[n] >= 0
    # nothing profiled without a card: those metrics are left out
    assert "device_idle.serve" not in got and res["trace"] is None
