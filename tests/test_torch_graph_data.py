"""The port's graph and session generators against the JAX package's on
the same ``np.random.Generator`` seeds: every array bit-equal.  Both
sides are numpy only."""
import numpy as np
import pytest

from repro.data import graphs as jg
from repro.data import recsys as jr

from repro_torch.data import graphs as tg
from repro_torch.data import recsys as tr


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        w, g = want[k], got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.mark.parametrize("seed,n,e,d,c", [(0, 64, 128, 16, 4),
                                          (3, 2708, 10556, 33, 7),
                                          (5, 1, 0, 3, 2)])
def test_random_node_graph(seed, n, e, d, c):
    _same(tg.random_node_graph(np.random.default_rng(seed), n, e, d, c),
          jg.random_node_graph(np.random.default_rng(seed), n, e, d, c))


@pytest.mark.parametrize("seed,g,npg,epg", [(0, 4, 8, 16), (2, 128, 30, 64),
                                            (4, 1, 5, 0)])
def test_random_molecule_batch(seed, g, npg, epg):
    _same(tg.random_molecule_batch(np.random.default_rng(seed), g, npg,
                                   epg),
          jg.random_molecule_batch(np.random.default_rng(seed), g, npg,
                                   epg))


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_sample_and_pad(seed):
    """CSRGraph's tables, a fanout sample (with degree-0 nodes), the
    layer-wise ``sample_blocks`` and ``pad_block`` with its edge_mask."""
    rng = np.random.default_rng(seed)
    n = 500
    g = jg.random_node_graph(rng, n, 900, 12, 5)
    # a few nodes of degree 0: their sample is a self loop
    keep = g["edges"][0] < n - 20
    src, dst = g["edges"][0][keep], g["edges"][1][keep]
    jc, tc = jg.CSRGraph(n, src, dst), tg.CSRGraph(n, src, dst)
    np.testing.assert_array_equal(tc.nbr, jc.nbr)
    np.testing.assert_array_equal(tc.offsets, jc.offsets)
    assert tc.offsets.dtype == jc.offsets.dtype and tc.n_nodes == jc.n_nodes
    nodes = np.arange(n - 40, n, dtype=np.int32)
    got = tc.sample_neighbors(np.random.default_rng(9), nodes, 7)
    want = jc.sample_neighbors(np.random.default_rng(9), nodes, 7)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    seeds = np.random.default_rng(seed).choice(n, 32, replace=False)
    blk_t = tg.sample_blocks(tc, np.random.default_rng(11), seeds, (15, 10),
                             g["x"], g["labels"])
    blk_j = jg.sample_blocks(jc, np.random.default_rng(11), seeds, (15, 10),
                             g["x"], g["labels"])
    _same(blk_t, blk_j)
    nn, ne = blk_j["x"].shape[0], blk_j["edges"].shape[1]
    _same(tg.pad_block(blk_t, nn + 37, ne + 1024),
          jg.pad_block(blk_j, nn + 37, ne + 1024))
    with pytest.raises(AssertionError):
        tg.pad_block(blk_t, nn - 1, ne)


@pytest.mark.parametrize("seed,n_items,batch,seq,m,k", [
    (0, 1000, 4, 32, 4, 32), (1, 64, 8, 8, 8, 16), (2, 1048574, 3, 200, 20,
                                                   1024)])
def test_session_batches(seed, n_items, batch, seq, m, k):
    got = tr.session_batches(seed, n_items, batch, seq, m, n_items + 1, k)
    want = jr.session_batches(seed, n_items, batch, seq, m, n_items + 1, k)
    for _ in range(3):
        _same(next(got), next(want))
