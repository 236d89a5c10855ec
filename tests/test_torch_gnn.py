"""The port's GNNs and EmbeddingBag against the JAX package on the CPU: the
same numpy graphs through ``repro.models.gnn`` and
``repro_torch.models.gnn`` from JAX's init converted
(``models.convert``): GCN, GAT and GIN logits, both losses and their
grads within 1e-4 (rtol and atol), with and without ``edge_mask``; and
``embedding_bag`` in its three modes, with JAX's rules for empty bags,
indices out of range and bag ids out of range."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.graphs import CSRGraph, pad_block, random_molecule_batch, \
    random_node_graph, sample_blocks
from repro.models import gnn as jgnn
from repro.models.embedding import embedding_bag as j_embedding_bag

from repro_torch.models import gnn as tgnn
from repro_torch.models.common import tree_leaves_with_path, path_str, \
    value_and_grad
from repro_torch.models.convert import params_from_numpy, tree_from_numpy
from repro_torch.models.embedding import embedding_bag

TOL = 1e-4


def _cfgs(kind, d_in, n_classes, masked=False):
    kw = dict(name=kind, kind=kind, n_layers=3 if kind == "gin" else 2,
              d_in=d_in, d_hidden=8, n_classes=n_classes,
              n_heads=4 if kind == "gat" else 1)
    return jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, tol=TOL):
    want = {path_str(p): v for p, v in tree_leaves_with_path(_np(want))}
    got = {path_str(p): v for p, v in tree_leaves_with_path(got)}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=tol,
                                   atol=tol, err_msg=k)


def _node_batch(masked: bool):
    rng = np.random.default_rng(0)
    g = random_node_graph(rng, 40, 90, 12, 3)
    if not masked:
        return g
    # a sampled, relabeled block padded with masked edges (edge_mask)
    n = g["x"].shape[0]
    csr = CSRGraph(n, g["edges"][0], g["edges"][1])
    blk = sample_blocks(csr, rng, np.arange(6), (3, 2), g["x"],
                        g["labels"])
    return pad_block(blk, blk["x"].shape[0] + 5, blk["edges"].shape[1] + 29)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "edge_mask"])
@pytest.mark.parametrize("kind", ["gcn", "gat", "gin"])
def test_node_forward_loss_grads(kind, masked):
    batch = _node_batch(masked)
    assert ("edge_mask" in batch) == masked
    jc, tc = _cfgs(kind, 12, 3)
    jp = jgnn.init_params(jax.random.PRNGKey(1), jc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = tree_from_numpy(batch)
    model = params_from_numpy(_np(jp), tc)
    tp = model.tree()
    np.testing.assert_allclose(
        model(tb).detach().numpy(), np.asarray(jgnn.forward(jp, jb, jc)),
        rtol=TOL, atol=TOL)
    jl, jg = jax.value_and_grad(jgnn.node_classification_loss)(jp, jb, jc)
    tl, tg = value_and_grad(tgnn.node_classification_loss)(tp, tb, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    _close_tree(tg, jg)


def test_graph_classification_gin():
    """GIN on batched molecules: sum-pooled logits per graph, the 0-d
    learnable eps."""
    g = random_molecule_batch(np.random.default_rng(2), 6, 7, 12)
    batch = {k: g[k] for k in ("x", "edges", "graph_id", "graph_labels")}
    jc, tc = _cfgs("gin", 10, 2)
    jp = jgnn.init_params(jax.random.PRNGKey(3), jc)
    # a non-zero eps, so its grad and its use both show
    jp["layers"][0]["eps"] = jnp.asarray(0.25, jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["n_graphs"] = 6
    tb = dict(tree_from_numpy(batch), n_graphs=6)
    tp = tree_from_numpy(_np(jp))
    assert tp["layers"][0]["eps"].shape == ()
    jl, jg = jax.value_and_grad(jgnn.graph_classification_loss)(jp, jb, jc)
    tl, tg = value_and_grad(tgnn.graph_classification_loss)(tp, tb, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    _close_tree(tg, jg)


def test_params_module_and_abstract():
    """The module's parameter names are the tree's paths; the abstract
    tree on ``meta`` has JAX's shapes."""
    jc, tc = _cfgs("gat", 12, 3)
    jp = _np(jgnn.init_params(jax.random.PRNGKey(0), jc))
    model = params_from_numpy(jp, tc)
    names = {n for n, _ in model.named_parameters()}
    assert names == {f"layers.{i}.{k}" for i in range(2)
                     for k in ("w", "a_src", "a_dst")}
    abstract = tgnn.abstract_params(tc)
    assert {path_str(p): tuple(x.shape) for p, x in
            tree_leaves_with_path(abstract)} == \
        {path_str(p): x.shape for p, x in tree_leaves_with_path(jp)}
    own = tgnn.init_params(torch.Generator().manual_seed(0), tc)
    assert all(x.device.type == "meta" for _, x in
               tree_leaves_with_path(abstract))
    assert [p for p, _ in tree_leaves_with_path(own)] == \
        [p for p, _ in tree_leaves_with_path(abstract)]


def _bags():
    """Bags over a 30-row table: an empty bag (3), a negative index that
    wraps (-2), indices out of range both ways (30, -31), a bag id past
    ``n_bags`` (7) and a negative one (-1), which are dropped."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    idx = np.array([0, 5, 29, -2, 7, 30, 11, 12, -31, 3, 4, 8], np.int32)
    seg = np.array([0, 0, 1, 1, 2, 2, 4, 4, 5, 5, 7, -1], np.int32)
    w = rng.random(12).astype(np.float32)
    return table, idx, seg, w


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag(mode, weighted):
    table, idx, seg, w = _bags()
    ww = w if weighted else None
    want = np.asarray(j_embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), 6,
        None if ww is None else jnp.asarray(ww), mode))
    tt = torch.tensor(table, requires_grad=True)
    got = embedding_bag(tt, torch.tensor(idx), torch.tensor(seg), 6,
                        None if ww is None else torch.tensor(ww), mode)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6, equal_nan=True)
    # the JAX rules, spelled out: bag 2 and 5 read a NaN row; bag 3 is
    # empty (0, or -inf in max mode)
    assert np.isnan(want[2]).all() and np.isnan(want[5]).all()
    assert (want[3] == (-np.inf if mode == "max" else 0)).all()

    # grads w.r.t. the table through the bags that hold no NaN
    ok = [0, 1, 4]

    def jloss(t):
        return jnp.sum(j_embedding_bag(
            t, jnp.asarray(idx), jnp.asarray(seg), 6,
            None if ww is None else jnp.asarray(ww), mode)[jnp.asarray(ok)])
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    got[ok].sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), jgrad, rtol=1e-6, atol=1e-6)


def test_segment_ops_follow_jax():
    """``segment_sum`` / ``segment_max`` against ``jax.ops`` on ids out
    of range both ways, an empty segment, ties, a NaN and an all -inf
    segment: values and grads (the max's gradient split among ties, the
    ``-inf`` start counted, none through a NaN max)."""
    from repro_torch.models.common import segment_max, segment_sum

    d = np.array([[1., 4.], [np.nan, 2.], [2., 2.], [0.5, -1.],
                  [-np.inf, 0.], [-np.inf, 3.], [3., 3.], [3., 9.],
                  [5., 5.]], np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2, 3, 3, 7], np.int32)
    up = np.arange(1, 11, dtype=np.float32).reshape(5, 2)
    for name, jfn, tfn in (("sum", jax.ops.segment_sum, segment_sum),
                           ("max", jax.ops.segment_max, segment_max)):
        def jl(x):
            out = jfn(x, jnp.asarray(ids), num_segments=5)
            return jnp.nansum(out * up), out
        (_, jout), jgrad = jax.value_and_grad(jl, has_aux=True)(
            jnp.asarray(d))
        t = torch.tensor(d, requires_grad=True)
        out = tfn(t, torch.tensor(ids), 5)
        torch.nansum(out * torch.tensor(up)).backward()
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(jout), err_msg=name)
        # JAX scales by the reciprocal of the count: 1 ulp apart
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-6, atol=0, err_msg=name)
