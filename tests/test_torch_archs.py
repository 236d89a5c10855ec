"""The LM configs and registry, port vs the JAX package, on the CPU: the
ids, every LM arch's full and smoke config field by field, the abstract
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
from repro_torch.configs.families import LMArch, MiningArch
from repro_torch.launch import train as launch_train
from repro_torch.models.common import count_params, path_str, \
    tree_leaves, tree_leaves_with_path
from repro_torch.models.convert import tree_from_numpy

LM_IDS = [a for a in jreg.ARCH_IDS if jreg.get_arch(a).family == "lm"]
LATER = ["mace", "gcn-cora", "gat-cora", "gin-tu", "bert4rec"]
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def test_registry_ids():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.EXTRA_IDS == jreg.EXTRA_IDS
    assert treg.list_archs(True) == jreg.list_archs(True)
    assert LM_IDS == ["glm4-9b", "gemma-7b", "smollm-135m",
                      "llama4-maverick-400b-a17b", "olmoe-1b-7b"]
    assert sorted(LM_IDS + LATER) == sorted(treg.ARCH_IDS)
    for a in LATER:
        with pytest.raises(NotImplementedError, match="slice 8"):
            treg.get_arch(a)
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
