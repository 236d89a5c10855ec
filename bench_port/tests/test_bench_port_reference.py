"""The reference, its control, the import guard, and the seeded inputs."""
import shutil
import subprocess
import sys
from pathlib import Path

from bench_port.lib import data, guard
from bench_port.reference import containment, control, reverse_search
from bench_port.reference import synthetic

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "bench_port"


def _small_db(n=40, seed=0):
    return synthetic.generate_table3_db(synthetic.Table3Params(db_size=n),
                                        seed=seed)


def test_reference_miner_equals_the_ports_host_miner_and_its_oracle():
    """The frozen copy mines what the port's own host miner mines (it is
    a copy of it), and each pattern's support is what the containment
    oracle counts over the DB."""
    from repro_torch.core import reverse_search as port_rs

    db = _small_db()
    want = reverse_search.mine_gtrace_rs(db, 8, max_len=4).patterns
    assert len(want) > 20
    got = port_rs.mine_gtrace_rs(db, 8, max_len=4).patterns
    assert {tuple(map(tuple, map(sorted, p))): s for p, s in got.items()} \
        == {tuple(map(tuple, map(sorted, p))): s for p, s in want.items()}
    for p, s in want.items():
        assert containment.support(p, db) == s


def test_the_control_breaks_exactness_at_a_test_size():
    db = _small_db()
    want = reverse_search.mine_gtrace_rs(db, 8, max_len=4).patterns
    capped = control.mine_capped(db, 8, max_len=4, per_seq=1).patterns
    assert capped != want
    big = control.mine_capped(db, 8, max_len=4, per_seq=10**6).patterns
    assert big == want
    pats = list(want)
    q = _small_db(32, seed=7)
    wrong = sum(containment.contains(p, s)
                != control.contains_capped(p, s, 2) for s in q for p in pats)
    assert wrong > 0
    # capped containment never finds what is not there
    assert all(containment.contains(p, s) or not
               control.contains_capped(p, s, 1) for s in q for p in pats)


def test_seed_changes_the_inputs_not_the_work():
    cfg = {"db": {"generator": "table3", "size_key": "db_size", "seed": 0,
                  "params": {"db_size": 40}},
           "query_pool": {"generator": "table3", "size_key": "db_size",
                          "seed": 7, "params": {"db_size": 40}},
           "min_support_frac": 0.2, "max_len": 4}
    a_db, a_pool = data.make_inputs(cfg, 2**31 + 77, pool_size=16)
    b_db, b_pool = data.make_inputs(cfg, 2**31 + 78, pool_size=16)
    again, _ = data.make_inputs(cfg, 2**31 + 77, pool_size=16)
    assert a_db == again and a_db != b_db and a_pool != b_pool
    assert sorted(map(len, a_db)) == sorted(map(len, b_db))
    sigma = data.min_support(cfg, len(a_db))
    ma = reverse_search.mine_gtrace_rs(a_db, sigma, max_len=4).patterns
    mb = reverse_search.mine_gtrace_rs(b_db, sigma, max_len=4).patterns
    assert ma == mb and len(ma) > 10
    # the same queries answer the same rows under any numbering
    for s, t in zip(a_pool, b_pool):
        assert [containment.contains(p, s) for p in ma] == \
            [containment.contains(p, t) for p in ma]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        names = guard.scan_imports(f)
        assert not names.intersection(guard.FORBIDDEN), f
        if "reference" in f.relative_to(BENCH_DIR).parts:
            assert guard.PROGRAM not in names, f


def test_the_runtime_guard_compares_whole_top_level_names():
    assert guard.loaded_forbidden({"repro_torch": 1, "repro_torch.x": 1,
                                   "torch": 1}) == []
    assert guard.loaded_forbidden({"jax.numpy": 1, "repro.core": 1,
                                   "reprox": 1}) == ["jax", "repro"]


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "t3.mine",
         "--seed", "3", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card_or_without_the_port(tmp_path):
    import torch

    if not torch.cuda.is_available():
        out = _run(ROOT)
        assert out.returncode != 0 and out.stdout.strip() == ""
        assert "CUDA" in out.stderr
    # a directory holding only BENCHMARK.json and the benchmark's folder
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "port's package" in out.stderr

