"""The port's AcceleratedMiner on the CPU (the match_count kernel's plain
version) vs the JAX package's miner and the pure-host miners: the same
frequent maps, bit for bit, and the same number of device calls."""
import os
import subprocess
import sys

import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: seeded-sampling fallback
    from hypothesis_compat import given, settings, strategies as st

from conftest import random_db
from repro.core.gtrace import mine_gtrace as j_mine_gtrace
from repro.core.reverse_search import mine_gtrace_rs as j_mine_rs
from repro.mining.driver import AcceleratedMiner as JaxMiner

from repro_torch.core.graphseq import db_from_reference, pattern_key
from repro_torch.mining import checkpoint as ckpt
from repro_torch.mining.driver import AcceleratedMiner

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _keyed(patterns):
    return {pattern_key(p): s for p, s in patterns.items()}


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000), sigma=st.integers(2, 3),
       rs=st.booleans())
def test_miner_equals_jax_and_core(seed, sigma, rs):
    """mine_rs / mine_gtrace in both dispatch modes give the JAX
    miner's and the host miner's frequent map, with as many device
    calls as the JAX miner makes."""
    jdb = random_db(seed, n_seq=6, n_steps=4, n_v=4)
    tdb = db_from_reference(jdb)
    core = (j_mine_rs(jdb, sigma, max_len=4) if rs
            else j_mine_gtrace(jdb, sigma, max_len=4))
    want = _keyed(core.patterns)
    for dispatch in ("wavefront", "pattern"):
        jm = JaxMiner(jdb, dispatch=dispatch)
        tm = AcceleratedMiner(tdb, dispatch=dispatch, device="cpu")
        if rs:
            jr, tr = jm.mine_rs(sigma, max_len=4), tm.mine_rs(sigma, max_len=4)
        else:
            jr, tr = (jm.mine_gtrace(sigma, max_len=4),
                      tm.mine_gtrace(sigma, max_len=4))
        assert _keyed(jr.patterns) == want
        assert _keyed(tr.patterns) == want
        assert (tr.n_enumerated, tr.n_extension_scans) == \
            (jr.n_enumerated, jr.n_extension_scans)
        assert tm.n_device_calls == jm.n_device_calls > 0


def test_wavefront_equals_pattern_dispatch():
    db = db_from_reference(random_db(5, n_seq=10, n_steps=5, n_v=5))
    wf = AcceleratedMiner(db, device="cpu")
    pp = AcceleratedMiner(db, dispatch="pattern", device="cpu")
    assert wf.mine_rs(2, max_len=4).patterns == \
        pp.mine_rs(2, max_len=4).patterns
    assert pp.n_device_calls >= 5 * wf.n_device_calls


def test_timing_counters_on_cpu():
    db = db_from_reference(random_db(2, n_seq=6, n_steps=4, n_v=4))
    m = AcceleratedMiner(db, device="cpu")
    m.mine_rs(2, max_len=3)
    assert m.n_device_calls > 0
    assert m.device_seconds >= m.dispatch_seconds > 0.0
    assert m.metrics.snapshot()["mining.n_device_calls"] == m.n_device_calls


def test_checkpoint_resume_mid_wavefront(tmp_path, monkeypatch):
    """Interrupting at a mid-wavefront checkpoint and resuming gives the
    uninterrupted result bit for bit."""
    db = db_from_reference(random_db(17, n_seq=8, n_steps=5, n_v=5))
    full = AcceleratedMiner(db, device="cpu").mine_rs(2, max_len=5)

    class Stop(Exception):
        pass

    ck = str(tmp_path / "wave.ckpt")
    calls = {"n": 0}
    orig = ckpt.save_state

    def capture(path, patterns, stack, meta=None):
        orig(path, patterns, stack, meta)
        calls["n"] += 1
        if calls["n"] == 1 and stack:
            raise Stop

    m = AcceleratedMiner(db, wave_patterns=1, device="cpu")
    monkeypatch.setattr(ckpt, "save_state", capture)
    with pytest.raises(Stop):
        m._mine(2, 5, rs=True, checkpoint_path=ck, checkpoint_every=1)
    monkeypatch.setattr(ckpt, "save_state", orig)
    resumed = AcceleratedMiner(db, device="cpu")._mine(
        2, 5, rs=True, checkpoint_path=ck, resume=True)
    assert resumed.patterns == full.patterns


def test_no_device_without_cuda_raises(monkeypatch):
    """With no device given the miner runs on cuda; where there is none
    it raises rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = db_from_reference(random_db(1, n_seq=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AcceleratedMiner(db)
    with pytest.raises(RuntimeError):
        AcceleratedMiner(db, device="cuda")


def test_launcher_both_on_cpu():
    """The launcher's --algo both self-check (GTRACE.relevant() ==
    GTRACE-RS) passes on the CPU."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--db-size", "30",
         "--algo", "both", "--device", "cpu", "--max-len", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "GTRACE.relevant() == GTRACE-RS  (verified)" in proc.stdout
