"""The port's AcceleratedMiner on the CPU (the match_count kernel's plain
version) vs the JAX package's miner and the pure-host miners: the same
frequent maps, bit for bit, and the same number of device calls."""
import os
import subprocess
import sys

import numpy as np
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
from repro.mining.encoding import encode_embeddings as j_encode_embeddings

from repro_torch.core.graphseq import (TR, TRType, db_from_reference,
                                       pattern_key, pattern_length)
from repro_torch.mining import checkpoint as ckpt
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.mining.encoding import EmbBlock

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


def _port_pattern(jp):
    return tuple(frozenset(TR(TRType(t), u1, u2, lab) for t, u1, u2, lab in s)
                 for s in pattern_key(jp))


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_block_path_equals_jax_rows(seed):
    """Every child block of a whole max_len 4 walk holds, in order, the
    rows of the JAX miner's Emb list for the same parent and rows; the
    counters see every rebuilt row and no decoded one."""
    jdb = random_db(seed, n_seq=8, n_steps=5, n_v=5)
    jm = JaxMiner(jdb)
    tm = AcceleratedMiner(db_from_reference(jdb), device="cpu")
    wave = [((), EmbBlock.root(len(jdb), tm.ni, tm.nv), (),
             [(g, (), ()) for g in range(len(jdb))])]
    rows = n_children = 0
    while wave:
        kids = tm.expand_children_batch([(p, b) for p, b, _, _ in wave], 2)
        nxt = []
        for (_, _, jp, jembs), tkids in zip(wave, kids):
            want = {pattern_key(c): (c, g, e)
                    for c, g, e in jm.expand_children(jp, jembs, 2)}
            assert sorted(pattern_key(c) for c, _, _ in tkids) == \
                sorted(want)
            for child, gids, block in tkids:
                jc, jgids, jce = want[pattern_key(child)]
                assert gids == jgids
                for got, ref in zip((block.gid, block.phi, block.psi),
                                    j_encode_embeddings(jce, tm.ni, tm.nv)):
                    assert got.dtype == ref.dtype == np.int32
                    np.testing.assert_array_equal(got, ref)
                rows += len(block)
                n_children += 1
                if pattern_length(child) < 4:
                    nxt.append((child, block, jc, jce))
        wave = nxt
    assert n_children > 0
    snap = tm.metrics.snapshot()
    assert snap["mining.emb_rows"] == rows
    assert snap["mining.emb_decoded"] == 0
    job = AcceleratedMiner(db_from_reference(jdb), device="cpu")
    assert len(job.mine_rs(2, max_len=4).patterns) == n_children
    assert job.metrics.snapshot()["mining.emb_rows"] == rows
    assert job.metrics.snapshot()["mining.emb_decoded"] == 0


def _payload(path):
    with open(path, "rb") as f:
        return ckpt._decompress(f.read())


def test_checkpoint_of_emb_tuples_resumes_and_blocks_write_it_alike(
        tmp_path):
    """A work stack of Emb tuples, as the miner's checkpoints held them
    before its pool held blocks, resumes to the uninterrupted map; the
    same stack as blocks writes the same payload and loads back to the
    same tuples; a checkpointing job decodes its pool's rows."""
    jdb = random_db(17, n_seq=8, n_steps=5, n_v=5)
    db = db_from_reference(jdb)
    full = AcceleratedMiner(db, device="cpu").mine_rs(2, max_len=5)
    jkids = JaxMiner(jdb).expand_children(
        (), [(g, (), ()) for g in range(len(db))], 2)
    patterns = {_port_pattern(c): len(g) for c, g, _ in jkids}
    tuples = [(_port_pattern(c), e) for c, _, e in jkids]
    assert tuples and all(e for _, e in tuples)
    meta = {"min_support": 2, "rs": True, "n_enumerated": len(patterns)}
    old, new = str(tmp_path / "tuples.ckpt"), str(tmp_path / "blocks.ckpt")
    ckpt.save_state(old, patterns, tuples, meta=meta)

    m = AcceleratedMiner(db, device="cpu")
    blocks = {c: b for c, _, b in m.expand_children((), EmbBlock.root(
        len(db), m.ni, m.nv), 2)}
    assert [blocks[c].to_embs() for c, _ in tuples] == \
        [e for _, e in tuples]
    ckpt.save_state(new, patterns, [(c, blocks[c]) for c, _ in tuples],
                    meta=meta)
    assert _payload(new) == _payload(old)
    got_patterns, stack, got_meta = ckpt.load_state(new)
    assert (got_patterns, stack, got_meta) == (patterns, tuples, meta)

    resumed = AcceleratedMiner(db, device="cpu")._mine(
        2, 5, rs=True, checkpoint_path=old, resume=True)
    assert resumed.patterns == full.patterns

    job = AcceleratedMiner(db, wave_patterns=1, device="cpu")
    res = job._mine(2, 5, rs=True, checkpoint_path=str(tmp_path / "j.ckpt"),
                    checkpoint_every=1)
    assert res.patterns == full.patterns
    assert job.metrics.snapshot()["mining.emb_decoded"] > 0
