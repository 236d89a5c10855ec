"""The port's MACE against the JAX package on the CPU: the same numpy
molecules through ``repro.models.mace`` and ``repro_torch.models.mace``
from JAX's init converted (``models.convert``): the basis functions,
the product basis, per-graph energies, the energy loss and its grads
within 1e-4 (rtol and atol), with and without ``edge_mask``; and the
port's energy is invariant under a rotation and translation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.graphs import random_molecule_batch
from repro.models import mace as jm

from repro_torch.models import mace as tm
from repro_torch.models.common import path_str, tree_leaves_with_path, \
    value_and_grad
from repro_torch.models.convert import params_from_numpy, tree_from_numpy
from torch_family_checks import rotation_invariance

TOL = 1e-4
KEYS = ("species", "pos", "edges", "graph_id", "targets")


def _cfgs(**kw):
    kw = dict(name="mace", n_layers=2, d_hidden=16, **kw)
    return jm.MACEConfig(**kw), tm.MACEConfig(**kw)


def _batch(seed=0, n_graphs=4, nodes=8, edges=16, masked=False):
    g = random_molecule_batch(np.random.default_rng(seed), n_graphs, nodes,
                              edges)
    batch = {k: g[k] for k in KEYS}
    if masked:
        # the last 10 edges are padding
        e = batch["edges"].shape[1]
        batch["edge_mask"] = (np.arange(e) < e - 10).astype(np.int32)
    return batch, n_graphs


def test_basis_functions():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    rhat = v / np.linalg.norm(v, axis=1, keepdims=True)
    np.testing.assert_allclose(
        tm.real_sph_harm_l2(torch.tensor(rhat)).numpy(),
        np.asarray(jm.real_sph_harm_l2(jnp.asarray(rhat))), rtol=1e-6,
        atol=1e-6)
    d = np.concatenate([[0.0, 1e-7], rng.random(40) * 7]).astype(np.float32)
    np.testing.assert_allclose(
        tm.bessel_rbf(torch.tensor(d), 8, 5.0).numpy(),
        np.asarray(jm.bessel_rbf(jnp.asarray(d), 8, 5.0)), rtol=1e-5,
        atol=1e-5)
    A = rng.normal(size=(7, 9, 5)).astype(np.float32)
    for got, want in zip(tm.product_basis(torch.tensor(A)),
                         jm.product_basis(jnp.asarray(A))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "edge_mask"])
def test_forward_loss_grads(masked):
    """Energies, the loss and every grad; the batch holds self loops
    (degenerate edges) and, masked, 10 padding edges."""
    batch, g = _batch(masked=masked)
    assert (batch["edges"][0] == batch["edges"][1]).any()
    jc, tc = _cfgs()
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    jb = dict({k: jnp.asarray(v) for k, v in batch.items()}, n_graphs=g)
    tb = dict(tree_from_numpy(batch), n_graphs=g)
    model = params_from_numpy(jax.tree.map(np.asarray, jp), tc)
    np.testing.assert_allclose(model(tb).detach().numpy(),
                               np.asarray(jm.forward(jp, jb, jc)),
                               rtol=TOL, atol=TOL)
    jl, jg = jax.value_and_grad(jm.energy_loss)(jp, jb, jc)
    tl, tg = value_and_grad(tm.energy_loss)(model.tree(), tb, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    want = {path_str(p): np.asarray(v) for p, v in
            tree_leaves_with_path(jax.tree.map(np.asarray, jg))}
    got = {path_str(p): v.numpy() for p, v in tree_leaves_with_path(tg)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_rotation_invariance():
    """The port's energies under a random rotation and translation, at
    ``tests/test_archs.py``'s config and tolerance; the check itself
    fails when the moved molecules are also stretched."""
    batch, g = _batch()
    tc = tm.MACEConfig(name="mace", n_layers=2, d_hidden=32)
    params = tm.init_params(torch.Generator().manual_seed(0), tc)
    tb = dict(tree_from_numpy(batch), n_graphs=g)
    rotation_invariance(lambda p, b: tm.forward(p, b, tc), params, tb)

    def stretched(p, b):
        return tm.forward(p, b if b is tb else dict(b, pos=b["pos"] * 1.5),
                          tc)
    with pytest.raises(AssertionError):
        rotation_invariance(stretched, params, tb)
