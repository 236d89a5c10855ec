"""The configs and registry, port vs the JAX package, on the CPU: the
ids, every arch's full and smoke config field by field, the abstract
params and steps on ``meta`` against ``jax.eval_shape``, the parameter
and FLOP counts, one smoke step, the mining arch's smoke, and the train
launcher on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.common import count_params as j_count_params

from repro_torch.configs import registry as treg
from repro_torch.configs.families import GNNArch, LMArch, MACEArch, \
    MiningArch, RecsysArch
from repro_torch.launch import train as launch_train
from repro_torch.models.common import count_params, path_str, \
    tree_leaves, tree_leaves_with_path
from repro_torch.models.convert import tree_from_numpy

LM_IDS = [a for a in jreg.ARCH_IDS if jreg.get_arch(a).family == "lm"]
FAMILY_IDS = ["mace", "gcn-cora", "gat-cora", "gin-tu", "bert4rec"]
FAMILY_CLASS = {"mace": MACEArch, "gcn-cora": GNNArch, "gat-cora": GNNArch,
                "gin-tu": GNNArch, "bert4rec": RecsysArch}
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def test_registry_ids():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.EXTRA_IDS == jreg.EXTRA_IDS
    assert treg.list_archs(True) == jreg.list_archs(True)
    assert LM_IDS == ["glm4-9b", "gemma-7b", "smollm-135m",
                      "llama4-maverick-400b-a17b", "olmoe-1b-7b"]
    assert sorted(LM_IDS + FAMILY_IDS) == sorted(treg.ARCH_IDS)
    # every id builds, as the JAX registry's family
    for a in treg.ARCH_IDS:
        ta = treg.get_arch(a)
        assert isinstance(ta, FAMILY_CLASS.get(a, LMArch)), a
        assert ta.family == jreg.get_arch(a).family, a
    assert isinstance(treg.get_arch("gtrace-mining"), MiningArch)
    with pytest.raises(KeyError):
        treg.get_arch("no-such-arch")


def _asdict(shapes):
    return {k: dataclasses.asdict(v) for k, v in shapes.items()}


def test_shape_tables_equal():
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
                 "MINING_SHAPES"):
        assert _asdict(getattr(tbase, name)) == \
            _asdict(getattr(jbase, name)), name


def _same_config(tc, jc):
    assert type(tc).__name__ == type(jc).__name__
    for f in dataclasses.fields(jc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        if dataclasses.is_dataclass(jv):
            _same_config(tv, jv)
        elif f.name.endswith("_dtype"):
            assert tv == _DT[jv], f.name
        else:
            assert tv == jv, f.name


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_configs_equal(arch_id):
    ja, ta = jreg.get_arch(arch_id), treg.get_arch(arch_id)
    assert isinstance(ta, LMArch) and ta.family == ja.family == "lm"
    assert ta.name == ja.name
    assert _asdict(ta.shapes) == _asdict(ja.shapes)
    _same_config(ta.cfg, ja.cfg)
    _same_config(ta.smoke_cfg, ja.smoke_cfg)
    assert ta.opt_state_dtype == ja.opt_state_dtype
    jo, to = ja.optimizer(), ta.optimizer()
    assert (to.lr, to.weight_decay, to.state_dtype, to.b1, to.b2,
            to.eps) == (jo.lr, jo.weight_decay, jo.state_dtype, jo.b1,
                        jo.b2, jo.eps)


def _shapes(tree):
    return {path_str(p): (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in tree_leaves_with_path(tree)}


def _jshapes(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", None)))) for k in p): (tuple(x.shape), str(x.dtype))
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_abstract_steps_and_counts(arch_id):
    ja, ta = jreg.get_arch(arch_id), treg.get_arch(arch_id)
    tp = ta.abstract_params("train_4k")
    assert all(x.device.type == "meta" for x in tree_leaves(tp))
    jp = ja.abstract_params("train_4k")
    assert _shapes(tp) == _jshapes(jp)
    assert count_params(tp) == j_count_params(jp)
    assert ta.n_params() == ja.n_params()
    assert ta.n_params(active_only=True) == ja.n_params(active_only=True)
    for shape in ta.shapes:
        assert ta.model_flops(shape) == ja.model_flops(shape), shape
    # the train step's abstract (params, opt_state, batch), and the
    # prefill / decode steps' abstract args
    _, targs = ta.make_step("train_4k")
    _, jargs = ja.make_step("train_4k")
    assert _shapes(targs) == _jshapes(jargs)
    for shape in ("prefill_32k", "decode_32k"):
        _, targs = ta.make_step(shape)
        _, jargs = ja.make_step(shape)
        assert _shapes(targs) == _jshapes(jargs), shape


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_smoke_step(arch_id):
    """JAX's smoke inputs through the port's smoke step, and the port's
    own bundle twice on the CPU (finite, shapes kept, params moved)."""
    ja, ta = jreg.get_arch(arch_id), treg.get_arch(arch_id)
    jstep, jargs = ja.smoke_bundle()
    jloss, jparams, _ = jax.jit(jstep)(*jargs)
    tstep, targs = ta.smoke_bundle(device="cpu")
    loss, params, _ = tstep(*tree_from_numpy(jax.tree.map(np.asarray,
                                                          jargs)))
    # bf16 compute: rounding differs between the frameworks
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    assert _shapes(params) == _jshapes(jparams)

    loss, params, opt_state = tstep(*targs)
    assert np.isfinite(float(loss))
    moved = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(tree_leaves(targs[0]), tree_leaves(params))]
    assert max(moved) > 0
    assert _shapes(params) == _shapes(targs[0])
    loss2, *_ = tstep(params, opt_state, targs[2])
    assert np.isfinite(float(loss2))


def _same_optimizer(ta, ja):
    jo, to = ja.optimizer(), ta.optimizer()
    assert (to.lr, to.weight_decay, to.state_dtype, to.b1, to.b2,
            to.eps) == (jo.lr, jo.weight_decay, jo.state_dtype, jo.b1,
                        jo.b2, jo.eps)


@pytest.mark.parametrize("arch_id", FAMILY_IDS)
def test_family_configs_equal(arch_id):
    """The GNN / MACE / recsys archs: names, shape tables, every config
    field (a GNN's per shape), the optimizers."""
    ja, ta = jreg.get_arch(arch_id), treg.get_arch(arch_id)
    assert type(ta).__name__ == type(ja).__name__
    assert ta.name == ja.name
    assert _asdict(ta.shapes) == _asdict(ja.shapes)
    if isinstance(ta, GNNArch):
        assert (ta.kind, ta.n_layers, ta.d_hidden, ta.n_heads) == \
            (ja.kind, ja.n_layers, ja.d_hidden, ja.n_heads)
        for shape in ta.shapes:
            _same_config(ta._cfg(shape), ja._cfg(shape))
    else:
        _same_config(ta.cfg, ja.cfg)
    if isinstance(ta, RecsysArch):
        _same_config(ta.smoke_cfg, ja.smoke_cfg)
        assert (ta.cfg.vocab, ta.cfg.mask_id) == (ja.cfg.vocab,
                                                  ja.cfg.mask_id)
    if isinstance(ta, MACEArch):
        for shape in ta.shapes:
            assert ta._sizes(shape) == ja._sizes(shape)
    _same_optimizer(ta, ja)


@pytest.mark.parametrize("arch_id", FAMILY_IDS)
def test_family_abstract_steps_and_counts(arch_id):
    """Per shape: the abstract params on ``meta`` and their count, the
    batch, the FLOPs, and the step's abstract args (train: params,
    optimizer state, batch; score: params, batch) against JAX's; for
    BERT4Rec, which serve the step takes over a mesh."""
    ja, ta = jreg.get_arch(arch_id), treg.get_arch(arch_id)
    for shape in ta.shapes:
        tp = ta.abstract_params(shape)
        assert all(x.device.type == "meta" for x in tree_leaves(tp))
        jp = ja.abstract_params(shape)
        assert _shapes(tp) == _jshapes(jp), shape
        assert count_params(tp) == j_count_params(jp), shape
        assert ta.model_flops(shape) == ja.model_flops(shape), shape
        assert _shapes(ta.batch_abstract(shape)) == _jshapes(
            ja.batch_abstract(shape)), shape
        _, targs = ta.make_step(shape)
        _, jargs = ja.make_step(shape)
        assert _shapes(targs) == _jshapes(jargs), shape
    if isinstance(ta, RecsysArch):
        # over a mesh: the vocab-sharded serve where the DP size divides
        # a batch of more than one row, else serve_scores (JAX's branch)
        for sizes, shape, sharded in (((4, 2), "serve_p99", True),
                                      ((4, 2), "retrieval_cand", False),
                                      ((3, 2), "serve_p99", False)):
            step, targs = ta.make_serve_step(shape, mesh=_Mesh(sizes))
            assert getattr(step, "takes_global", False) == sharded, shape
            assert _shapes(targs) == _jshapes(ja.make_step(shape)[1])


class _Mesh:
    """A ("data", "model") stand-in for a ``DeviceMesh``: the names and
    sizes the arch reads, and no process group."""

    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, sizes):
        self._sizes = sizes

    def size(self, dim):
        return self._sizes[dim]

    def get_group(self, name):
        return None


@pytest.mark.parametrize("arch_id", FAMILY_IDS)
def test_family_smoke_step(arch_id):
    """JAX's smoke inputs (its init, its batch) through the port's smoke
    step: the loss within 1e-5 and the updated params within 1e-4 of
    JAX's at fp32; then the port's own bundle twice on the CPU (finite,
    shapes kept, params moved)."""
    ja, ta = jreg.get_arch(arch_id), treg.get_arch(arch_id)
    jstep, jargs = ja.smoke_bundle()
    jloss, jparams, _ = jax.jit(jstep)(*jargs)
    tstep, targs = ta.smoke_bundle(device="cpu")
    loss, params, _ = tstep(*tree_from_numpy(jax.tree.map(np.asarray,
                                                          jargs)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert _shapes(params) == _jshapes(jparams)
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jparams)))
    for path, x in tree_leaves_with_path(params):
        np.testing.assert_allclose(x.numpy(), want[path], rtol=1e-4,
                                   atol=1e-4, err_msg=path_str(path))

    loss, params, opt_state = tstep(*targs)
    assert np.isfinite(float(loss))
    moved = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(targs[0]), tree_leaves(params))]
    assert max(moved) > 0
    assert _shapes(params) == _shapes(targs[0])
    loss2, *_ = tstep(params, opt_state, targs[2])
    assert np.isfinite(float(loss2))


def test_mining_arch_smoke():
    jstep, _ = jreg.get_arch("gtrace-mining").smoke_bundle()
    tstep, targs = treg.get_arch("gtrace-mining").smoke_bundle(device="cpu")
    assert targs == ()
    assert float(tstep()) == float(jstep()) > 0
    ja, ta = jreg.get_arch("gtrace-mining"), treg.get_arch("gtrace-mining")
    for shape in ta.shapes:
        assert ta.model_flops(shape) == ja.model_flops(shape)
        assert _shapes(ta.batch_abstract(shape)) == _jshapes(
            ja.batch_abstract(shape))
    with pytest.raises(RuntimeError):
        ta.make_step("scan_1m")


def test_launch_train_cpu(tmp_path, capsys):
    path = str(tmp_path / "t.npz")
    argv = ["--device", "cpu", "--batch", "4", "--seq", "32",
            "--checkpoint", path]
    losses = launch_train.main(argv + ["--steps", "12"])
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "[train] first-10 mean loss" in out and "-> last-10" in out
    losses = launch_train.main(argv + ["--steps", "14", "--resume"])
    assert len(losses) == 2
    assert "[train] resumed from step 12" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--arch", "gtrace-mining"])
