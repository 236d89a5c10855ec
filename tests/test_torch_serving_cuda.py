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
from repro_torch.kernels import REQ_MASKED
from repro_torch.kernels.containment import ops as cops
from repro_torch.kernels.step_compact import ops as sops
from repro_torch.kernels.trie_walk import ops as wops
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.serving import batch
from repro_torch.serving.bank import compile_bank
from repro_torch.serving.server import PatternServer
from contain_inputs import EDGE_SHAPES, SHAPES, contain_inputs, \
    matching_inputs
from gather_inputs import FIELDS, out_of_range_steps


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
    cases = [(contain_inputs, shape) for shape in
             SHAPES + [(4096, 4, 16), (4096, 16, 16)]]
    # the edge shapes on inputs past the cheap gates: every mask value
    # occurs, so the comparison is not one of zeros
    cases += [(matching_inputs, shape) for shape in EDGE_SHAPES]
    for make, (G, E, Tm) in cases:
        cpu = [torch.from_numpy(a) for a in make(rng, G, E, Tm)]
        want = cops.contain_step(*cpu)
        before = cops.launches
        got = cops.contain_step(*[x.cuda() for x in cpu])
        torch.cuda.synchronize()
        assert cops.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        if make is matching_inputs:
            assert set(torch.unique(want).tolist()) == {0, 1, 2, 3}


@pytest.mark.cuda
def test_contain_step_size_limits():
    """The kernel has no shared memory, so no window is too wide: the
    window that one block's shared memory could not stage (Tm = 10,000)
    and wide psi rows run and agree.  Its one limit is its 32-bit
    indices: a tensor past ``MAX_ELEMENTS`` (the output or an input)
    makes the wrapper raise without a launch, as a psi without vertex
    columns does."""
    _needs_card()
    rng = np.random.default_rng(5)
    for G, E, Tm, NV in ((1, 1, 10_000, 6), (3, 16, 2_000, 6),
                         (64, 4, 8, 1_000)):
        cpu = [torch.from_numpy(a) for a in matching_inputs(rng, G, E, Tm,
                                                            NV)]
        want = cops.contain_step(*cpu)
        before = cops.launches
        got = cops.contain_step(*[x.cuda() for x in cpu])
        torch.cuda.synchronize()
        assert cops.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        assert (want > 0).any()
    tok, psi, srow = [torch.from_numpy(a).cuda()
                      for a in contain_inputs(rng, 4, 2, 3)]
    before = cops.launches
    with pytest.raises(ValueError, match="vertex column"):
        cops.contain_step(tok, psi[:, :, :0].contiguous(), srow)
    # 2^31 elements, on stride-0 views (no memory behind them): the
    # output [G,Ein,Tm], then a psi of 2^31 vertex columns
    G, E, Tm = 2**16, 2**8, 2**7
    with pytest.raises(ValueError, match="more than the kernel indexes"):
        cops.contain_step(tok[:1, :1].expand(G, Tm, 6),
                          psi[:1, :1].expand(G, E, 6),
                          srow[:1, :1].expand(G, E, 8))
    with pytest.raises(ValueError, match="more than the kernel indexes"):
        cops.contain_step(tok[:1, :1], psi[:1, :1, :1].expand(1, 1, 2**31),
                          srow[:1, :1])
    assert cops.launches == before


@pytest.fixture(scope="module")
def fused_calls():
    """The trie_walk_cells calls of a trie_fused server at frontier
    capacities 1 and 4 over a mined bank: (tables and cells, kwargs)."""
    _needs_card()
    db, queries = _db(7, 10, 5, 5), _db(8, 16, 6, 5)
    bank = compile_bank(AcceleratedMiner(db, device="cuda").mine_rs(
        2, max_len=5))
    recorded = []
    orig = batch.trie_walk_cells

    def record(*args, **kw):
        recorded.append(([a.clone() for a in args], kw))
        return orig(*args, **kw)

    batch.trie_walk_cells = record
    try:
        for emax in (1, 4):
            PatternServer(bank, device="cuda", emax=emax,
                          bank_layout="trie_fused").query(queries)
    finally:
        batch.trie_walk_cells = orig
    assert len(recorded) == 2
    return recorded


def _walk_equal(args, kw):
    """The kernel (one launch) against the plain version on ``args``."""
    want = wops.trie_walk_cells(*[a.cpu() for a in args], **kw)
    before = wops.launches
    got = wops.trie_walk_cells(*args, **kw)
    torch.cuda.synchronize()
    assert wops.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    return want


@pytest.mark.cuda
def test_trie_walk_kernel_matches_plain(fused_calls):
    """Every (query, subtree shard) cell of a mined bank, with and
    without REQ_MASKED slots, at frontier capacities 1 and 4, through
    the gathered entry and through the per-cell one."""
    rng = np.random.default_rng(0)
    for args, kw in fused_calls:
        for masked in (False, True):
            args = [a.clone() for a in args]
            if masked:
                kill = torch.from_numpy(
                    rng.random(args[7].shape[:2]) < 0.3).cuda()
                args[7][kill] = REQ_MASKED
            _walk_equal(args, kw)
            tokens, order, start, count, cells, steps, parent, req = args
            b, s = cells[:, 0].long(), cells[:, 1].long()
            per_cell = [tokens[b], order[b], start[b], count[b], steps[s],
                        parent[s], req[s]]
            want = wops.trie_walk(*[a.cpu() for a in per_cell], **kw)
            got = wops.trie_walk(*per_cell, **kw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["emax1_tmax1", "emax16_tmax32",
                                  "pad_cells", "masked_25"])
def test_trie_walk_kernel_edge_cases(fused_calls, case):
    """Frontier and window of one, the widest escalation frontier and
    window (emax 16, tmax 32: 512 predicate pairs a slot, 16 rounds of
    ballots), a batch of nothing but pad cells, and a quarter of the
    slots tombstoned."""
    args, kw = fused_calls[1]
    args = [a.clone() for a in args]
    if case == "emax1_tmax1":
        kw = dict(kw, emax=1, tmax=1)
    elif case == "emax16_tmax32":
        kw = dict(kw, emax=16, tmax=32)
    elif case == "pad_cells":
        args[4] = torch.zeros((37, 2), dtype=torch.int32, device="cuda")
    else:
        kill = torch.from_numpy(np.random.default_rng(3).random(
            args[7].shape[:2]) < 0.25).cuda()
        args[7][kill] = REQ_MASKED
    acc, ovft = _walk_equal(args, kw)
    if case == "pad_cells":
        assert (acc == acc[:1]).all() and (ovft == ovft[:1]).all()
    if case == "masked_25":
        dead = kill[args[4][:, 1].long()].cpu()
        assert not (acc[dead].any() or ovft[dead].any())


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["all", *FIELDS])
def test_trie_walk_kernel_out_of_range_steps(fused_calls, field):
    """Step keys, itemset slots and pattern vertices out of range (-1,
    -(n+3), n, n+7) in the subtree tables, at the batch's window and at
    a window of one: the kernel reads them as the plain version does
    (JAX's take_along_axis) and nothing out of bounds."""
    args, kw = fused_calls[1]
    args = [a.clone() for a in args]
    steps, n_bad = out_of_range_steps(
        args[5].cpu().numpy(), K=args[2].shape[1], ni=kw["ni"], nv=kw["nv"],
        fields=tuple(FIELDS) if field == "all" else (field,),
        every=2 if field == "all" else 1)
    assert n_bad >= 16
    args[5] = torch.from_numpy(steps).cuda()
    for tmax in (kw["tmax"], 1):
        acc, _ = _walk_equal(args, dict(kw, tmax=tmax))
        assert acc.any() == (field != "key")


@pytest.mark.cuda
def test_trie_walk_refuses_a_cell_too_large_for_a_block():
    """A shard whose frontier buffers exceed one block's shared memory
    raises without a launch, and the next call is not charged with its
    error."""
    _needs_card()
    dev = "cuda"
    tokens = torch.zeros((1, 4, 6), dtype=torch.int32, device=dev)
    order = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    index = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    cells = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    S = 4000  # 4000 slots x 16 rows x 18 ints: 4.6 MB of buffers
    steps = torch.zeros((1, S, 8), dtype=torch.int32, device=dev)
    parent = torch.full((1, S), -1, dtype=torch.int32, device=dev)
    req = torch.full((1, S, 3), REQ_MASKED, dtype=torch.int32, device=dev)
    before = wops.launches
    with pytest.raises(RuntimeError, match="S=4000"):
        wops.trie_walk_cells(tokens, order, index, index, cells, steps,
                             parent, req, emax=16, tmax=8, ni=6, nv=12)
    assert wops.launches == before
    acc, ovft = wops.trie_walk_cells(
        tokens, order, index, index, cells, steps[:, :8].contiguous(),
        parent[:, :8].contiguous(), req[:, :8].contiguous(), emax=16,
        tmax=8, ni=6, nv=12)
    torch.cuda.synchronize()
    assert wops.launches == before + 1
    assert not (acc.any() or ovft.any())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flat", "trie", "trie_fused"])
def test_server_on_cuda_matches_cpu(layout):
    """Rows and counters on cuda equal the CPU's (plain versions), and
    the kernels launched once per predicate call (contain_step and
    step_compact) / fused walk."""
    _needs_card()
    db, queries = _db(3, 10, 5, 5), _db(4, 24, 6, 5)
    bank = compile_bank(AcceleratedMiner(db, device="cpu").mine_rs(
        2, max_len=5))
    for emax, retry in ((4, 16), (1, 2)):
        kw = dict(emax=emax, emax_retry=retry, max_batch=16,
                  bank_layout=layout)
        cpu = PatternServer(bank, device="cpu", **kw)
        want = np.stack([r.contained for r in cpu.query(queries)])
        cops.launches = wops.launches = sops.launches = 0
        batch.predicate_calls = batch.fused_walks = 0
        gpu = PatternServer(bank, device="cuda", **kw)
        got = np.stack([r.contained for r in gpu.query(queries)])
        np.testing.assert_array_equal(got, want)
        assert dict(gpu.stats) == dict(cpu.stats)
        assert cops.launches == batch.predicate_calls > 0
        assert sops.launches == batch.predicate_calls
        assert wops.launches == batch.fused_walks
        assert (wops.launches > 0) == (layout == "trie_fused")
