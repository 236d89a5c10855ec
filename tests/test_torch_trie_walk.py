"""The fused trie-walk port vs the JAX package: the plain PyTorch
version (the wrappers on CPU tensors) bit-equal to the jnp walk core on
the packed subtrees of a mined bank, and the gathered entry bit-equal to
JAX's ``fused_trie_walk`` on the tables and cells a server holds, with
and without tombstoned (``REQ_MASKED``) slots.  The CUDA kernel itself
is tested on an sm_90 device by test_torch_serving_cuda.py."""
import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import random_db
from repro.kernels.trie_walk import trie_walk_core
from repro.mining.driver import AcceleratedMiner
from repro.mining.encoding import encode_db
from repro.serving.bank import compile_bank
from repro.serving.batch import (build_token_index, fused_trie_walk,
                                 max_key_bucket)
from repro.serving.trie import REQ_MASKED, build_trie, pack_subtrees
from repro_torch.kernels.trie_walk import ops

jax_walk = jax.jit(trie_walk_core,
                   static_argnames=("emax", "tmax", "ni", "nv"))
jax_fused = jax.jit(fused_trie_walk,
                    static_argnames=("emax", "tmax", "ni", "nv"))
N_PAD = 5  # zero rows after the real cells, as a server pads a batch


@pytest.fixture(scope="module")
def walk_tables():
    """A mined bank's packed subtrees and a query batch's token table
    and inverted index, as a server holds them, and the cells of every
    (query, subtree shard) pair followed by ``N_PAD`` zero rows."""
    db = random_db(7, n_seq=8, n_steps=4, n_v=4)
    queries = random_db(8, n_seq=12, n_steps=5, n_v=5)
    bank = compile_bank(AcceleratedMiner(db).mine_rs(2, max_len=4))
    trie = build_trie(bank)
    pack = pack_subtrees(trie)
    assert pack.n_subtrees > 1 and pack.n_slots > 1
    tdb = encode_db(queries)
    order, start, count = (np.asarray(a) for a in build_token_index(
        jnp.asarray(tdb.tokens), n_label_keys=bank.n_label_keys))
    req = pack.pack_req(trie.node_req.reshape(trie.n_nodes, -1))
    b, s = np.meshgrid(np.arange(len(queries)), np.arange(pack.n_subtrees),
                       indexing="ij")
    cells = np.zeros((b.size + N_PAD, 2), np.int32)
    cells[:b.size, 0] = b.ravel()
    cells[:b.size, 1] = s.ravel()
    tables = [tdb.tokens, order, start, count, cells, pack.steps,
              pack.parent, req]
    dims = dict(tmax=max_key_bucket(tdb.tokens, bank.n_label_keys),
                ni=trie.depth, nv=bank.nv)
    return [np.array(a, np.int32, order="C") for a in tables], dims


@pytest.fixture(scope="module")
def walk_inputs(walk_tables):
    """Every (query, subtree shard) cell of a mined bank against a query
    batch: the per-cell token tables, index rows and packed subtrees
    the server hands the fused walk."""
    (tokens, order, start, count, cells, steps, parent, req), dims = \
        walk_tables
    b, s = cells[:-N_PAD, 0], cells[:-N_PAD, 1]
    args = [tokens[b], order[b], start[b], count[b], steps[s], parent[s],
            req[s]]
    return [np.ascontiguousarray(a, np.int32) for a in args], dims


@pytest.mark.parametrize("emax,masked,narrow", [(1, False, False),
                                                (4, True, True)])
def test_plain_walk_matches_jax(walk_inputs, emax, masked, narrow):
    """Frontier capacity 1 overflows the frontier; a one-token window
    (``narrow``) overflows the window; masked slots stay dead."""
    args, dims = walk_inputs
    args = [a.copy() for a in args]
    if masked:
        kill = np.random.default_rng(emax).random(args[6].shape[:2]) < 0.3
        args[6][kill] = REQ_MASKED
    kw = dict(dims, emax=emax)
    if narrow:
        kw["tmax"] = 1
    want = [np.asarray(x) for x in
            jax_walk(*[jnp.asarray(a) for a in args], **kw)]
    got = ops.trie_walk(*[torch.from_numpy(a) for a in args], **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[0].any()
    if masked:
        assert not (want[0][kill].any() or want[1][kill].any())
    assert want[1].any()  # the window or frontier overflowed somewhere


def test_wrapper_checks_inputs(walk_inputs):
    args, dims = walk_inputs
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError):
        ops.trie_walk(*t[:6], t[6][:, :1], emax=2, **dims)
    with pytest.raises(ValueError):
        ops.trie_walk(*t, emax=0, **dims)
    before = ops.launches
    ops.trie_walk(*t, emax=2, **dims)
    assert ops.launches == before  # the plain version never counts


@pytest.mark.parametrize("emax,masked,narrow", [(1, False, False),
                                                (4, True, True)])
def test_plain_cells_match_jax(walk_tables, emax, masked, narrow):
    """ops.trie_walk_cells on CPU tensors (the gathers, then the plain
    walk) is bit-equal to repro.serving.batch.fused_trie_walk on the
    same tables and cells, the pad cells included."""
    tables, dims = walk_tables
    tables = [a.copy() for a in tables]
    req = tables[7]
    if masked:
        kill = np.random.default_rng(emax).random(req.shape[:2]) < 0.3
        req[kill] = REQ_MASKED
    kw = dict(dims, emax=emax)
    if narrow:
        kw["tmax"] = 1
    want = [np.asarray(x) for x in
            jax_fused(*[jnp.asarray(a) for a in tables], **kw)]
    got = ops.trie_walk_cells(*[torch.from_numpy(a) for a in tables], **kw)
    n = len(tables[4])
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and g.shape == (n, req.shape[1])
        np.testing.assert_array_equal(g.numpy(), w)
    # a pad row walks cell (0, 0)
    np.testing.assert_array_equal(want[0][-N_PAD:],
                                  np.repeat(want[0][:1], N_PAD, axis=0))
    assert want[0].any() and want[1].any()
    if masked:
        s = tables[4][:, 1]
        assert not (want[0][kill[s]].any() or want[1][kill[s]].any())


def test_plain_cells_out_of_range_match_jax(walk_tables):
    """Cell indices of -1, -(n+3), n and n+7 in both columns: the CPU
    branch of ops.trie_walk_cells takes them as JAX's gather does, so it
    equals the walk of the cells as jnp indexing normalises them, and
    JAX's fused walk of the same out-of-range cells."""
    tables, dims = walk_tables
    cells = tables[4].copy()
    nb, ns = len(tables[0]), len(tables[5])
    cells[:4, 0] = (-1, -(nb + 3), nb, nb + 7)
    cells[4:8, 1] = (-1, -(ns + 3), ns, ns + 7)
    cells[8:12] = [(nb + 7, -1), (-(nb + 3), ns), (-1, ns + 7),
                   (nb, -(ns + 3))]
    norm = np.stack([np.asarray(jnp.arange(nb)[cells[:, 0]]),
                     np.asarray(jnp.arange(ns)[cells[:, 1]])], 1)
    assert (norm != cells).any(axis=1)[:12].all()
    kw = dict(dims, emax=1)
    t = [torch.from_numpy(a) for a in tables]
    got = ops.trie_walk_cells(*t[:4], torch.from_numpy(cells), *t[5:], **kw)
    want = ops.trie_walk_cells(*t[:4], torch.from_numpy(norm.astype(
        np.int32)), *t[5:], **kw)
    jax_got = jax_fused(*[jnp.asarray(a) for a in tables[:4]],
                        jnp.asarray(cells),
                        *[jnp.asarray(a) for a in tables[5:]], **kw)
    for g, w, j in zip(got, want, jax_got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert want[0].any()


def test_cells_wrapper_checks_inputs(walk_tables):
    tables, dims = walk_tables
    t = [torch.from_numpy(a) for a in tables]
    with pytest.raises(ValueError):  # cells must be [N, 2]
        ops.trie_walk_cells(*t[:4], t[4][:, :1], *t[5:], emax=2, **dims)
    with pytest.raises(ValueError):  # req_s must be [Sp, S, K]
        ops.trie_walk_cells(*t[:7], t[7][:, :, :1], emax=2, **dims)
    with pytest.raises(TypeError):
        ops.trie_walk_cells(*t[:4], t[4].long(), *t[5:], emax=2, **dims)
    with pytest.raises(ValueError):
        ops.trie_walk_cells(*t, emax=2, **dict(dims, tmax=0))
    before = ops.launches
    ops.trie_walk_cells(*t, emax=2, **dims)
    assert ops.launches == before  # the plain version never counts
