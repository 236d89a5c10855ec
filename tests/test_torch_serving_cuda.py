"""The serving kernels on the card: contain_step and trie_walk bit-equal
to their plain PyTorch versions, and PatternServer on cuda giving the
CPU rows under every layout while launching both kernels.  Imports torch
and the port only, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serving_cuda.py
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core.compile import compile_sequence
from repro_torch.data.synthetic import random_graph_sequence
from repro_torch.kernels.containment import ops as cops
from repro_torch.kernels.trie_walk import ops as wops
from repro_torch.kernels.trie_walk.ref import REQ_MASKED
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.serving import batch
from repro_torch.serving.bank import compile_bank
from repro_torch.serving.server import PatternServer
from contain_inputs import SHAPES, contain_inputs


def _needs_card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 device")


def _db(seed, n_seq, n_steps, n_v):
    rng = random.Random(seed)
    return [compile_sequence(random_graph_sequence(
        rng, n_steps=n_steps, n_v=n_v, n_vl=2, n_el=2))
        for _ in range(n_seq)]


@pytest.mark.cuda
def test_contain_step_kernel_matches_plain():
    _needs_card()
    rng = np.random.default_rng(12)
    for G, E, Tm in SHAPES + [(4096, 4, 16), (4096, 16, 16)]:
        cpu = [torch.from_numpy(a) for a in contain_inputs(rng, G, E, Tm)]
        want = cops.contain_step(*cpu)
        before = cops.launches
        got = cops.contain_step(*[x.cuda() for x in cpu])
        torch.cuda.synchronize()
        assert cops.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_contain_step_refuses_too_much_shared_memory():
    """A window too wide for one block's shared memory raises from the
    wrapper without a launch, and the next call is not charged with its
    error."""
    _needs_card()
    rng = np.random.default_rng(5)
    wide = [torch.from_numpy(a).cuda()
            for a in contain_inputs(rng, 1, 1, 10_000)]
    before = cops.launches
    with pytest.raises(RuntimeError, match="Tm=10000"):
        cops.contain_step(*wide)
    assert cops.launches == before
    cpu = [torch.from_numpy(a) for a in contain_inputs(rng, 65, 4, 9)]
    got = cops.contain_step(*[x.cuda() for x in cpu])
    torch.cuda.synchronize()
    assert cops.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  cops.contain_step(*cpu).numpy())


@pytest.mark.cuda
def test_trie_walk_kernel_matches_plain():
    """Every (query, subtree shard) cell of a mined bank, with and
    without REQ_MASKED slots, at frontier capacities 1 and 4."""
    _needs_card()
    db, queries = _db(7, 10, 5, 5), _db(8, 16, 6, 5)
    bank = compile_bank(AcceleratedMiner(db, device="cuda").mine_rs(
        2, max_len=5))
    recorded = []
    orig = batch.trie_walk

    def record(*args, **kw):
        recorded.append(([a.clone() for a in args], kw))
        return orig(*args, **kw)

    batch.trie_walk = record
    try:
        for emax in (1, 4):
            PatternServer(bank, device="cuda", emax=emax,
                          bank_layout="trie_fused").query(queries)
    finally:
        batch.trie_walk = orig
    assert len(recorded) == 2
    rng = np.random.default_rng(0)
    for args, kw in recorded:
        for masked in (False, True):
            args = [a.clone() for a in args]
            if masked:
                kill = torch.from_numpy(
                    rng.random(args[6].shape[:2]) < 0.3).cuda()
                args[6][kill] = REQ_MASKED
            want = wops.trie_walk(*[a.cpu() for a in args], **kw)
            before = wops.launches
            got = wops.trie_walk(*args, **kw)
            torch.cuda.synchronize()
            assert wops.launches == before + 1
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flat", "trie", "trie_fused"])
def test_server_on_cuda_matches_cpu(layout):
    """Rows and counters on cuda equal the CPU's (plain versions), and
    the kernels launched once per predicate call / fused walk."""
    _needs_card()
    db, queries = _db(3, 10, 5, 5), _db(4, 24, 6, 5)
    bank = compile_bank(AcceleratedMiner(db, device="cpu").mine_rs(
        2, max_len=5))
    for emax, retry in ((4, 16), (1, 2)):
        kw = dict(emax=emax, emax_retry=retry, max_batch=16,
                  bank_layout=layout)
        cpu = PatternServer(bank, device="cpu", **kw)
        want = np.stack([r.contained for r in cpu.query(queries)])
        cops.launches = wops.launches = 0
        batch.predicate_calls = batch.fused_walks = 0
        gpu = PatternServer(bank, device="cuda", **kw)
        got = np.stack([r.contained for r in gpu.query(queries)])
        np.testing.assert_array_equal(got, want)
        assert dict(gpu.stats) == dict(cpu.stats)
        assert cops.launches == batch.predicate_calls > 0
        assert wops.launches == batch.fused_walks
        assert (wops.launches > 0) == (layout == "trie_fused")
