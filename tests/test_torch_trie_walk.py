"""The fused trie-walk port vs the JAX package: the plain PyTorch
version (the wrapper on CPU tensors) bit-equal to the jnp walk core on
the packed subtrees of a mined bank, with and without tombstoned
(``REQ_MASKED``) slots.  The CUDA kernel itself is tested on an sm_90
device by test_torch_serving_cuda.py."""
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
from repro.serving.batch import build_token_index, max_key_bucket
from repro.serving.trie import REQ_MASKED, build_trie, pack_subtrees
from repro_torch.kernels.trie_walk import ops

jax_walk = jax.jit(trie_walk_core,
                   static_argnames=("emax", "tmax", "ni", "nv"))


@pytest.fixture(scope="module")
def walk_inputs():
    """Every (query, subtree shard) cell of a mined bank against a query
    batch: the per-cell token tables, index rows and packed subtrees
    the server hands the fused walk."""
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
    b, s = b.ravel(), s.ravel()
    args = [tdb.tokens[b], order[b], start[b], count[b], pack.steps[s],
            pack.parent[s], req[s]]
    dims = dict(tmax=max_key_bucket(tdb.tokens, bank.n_label_keys),
                ni=trie.depth, nv=bank.nv)
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
