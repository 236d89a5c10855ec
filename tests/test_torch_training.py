"""The training substrate, port vs the JAX package, on the CPU: AdamW in
its three state dtypes, int8 rowwise quantization, the schedule,
clipping, SGD, the step with gradient accumulation, the loop with
resume, checkpoints read across packages, and the LM token stream.

The optimizers are compared on identical grads: with eps 1e-8 a grad
near zero turns a rounding difference into a ±lr step, so params after
a step taken from grads computed apart say nothing of the optimizer.
Tolerances: optimizer and step 1e-6 (fp32, same arithmetic), int8 codes
exactly; the step with accumulation 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.data.lm import token_batches as j_token_batches
from repro.models import transformer as jtf
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop

from repro_torch.data.lm import token_batches
from repro_torch.models.common import tree_leaves_with_path, tree_map
from repro_torch.models.convert import tensor_to_numpy, tree_from_numpy
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as loop


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy() if x.dtype != torch.bfloat16 \
            else x.float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _trees_close(got, want, tol, exact_ints=True):
    flat = {p: _np(v) for p, v in tree_leaves_with_path(got)}
    want = [(tuple(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", None))) for k in p), np.asarray(v))
        for p, v in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert sorted(map(str, flat)) == sorted(str(p) for p, _ in want)
    for p, w in want:
        g = flat[p]
        if exact_ints and w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=str(p))
        else:
            np.testing.assert_allclose(g, _np(w), rtol=tol, atol=tol,
                                       err_msg=str(p))


@pytest.fixture(scope="module")
def tree3():
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(4, 8)).astype(np.float32),
         "b": {"c": rng.normal(size=(3, 5, 6)).astype(np.float32)}}
    gs = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32) * 10.0 ** -k, p) for k in range(3)]
    return p, gs


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_three_updates(tree3, state_dtype):
    p, gs = tree3
    kw = dict(lr=topt.cosine_schedule(1e-2, 2, 10), weight_decay=0.1,
              state_dtype=state_dtype)
    jo = jopt.AdamW(**{**kw, "lr": jopt.cosine_schedule(1e-2, 2, 10)})
    to = topt.AdamW(**kw)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_from_numpy(p)
    js, ts = jo.init(jp), to.init(tp)
    for g in gs:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(tree_from_numpy(g), ts, tp)
        _trees_close(tp, jp, 1e-6)
        _trees_close(ts, js, 1e-6)


def test_quant_row_ties_half_to_even():
    # x / 127 * 127 is exactly k + 0.5 in fp32 for these; the absmax 127
    # sets the scale
    x = np.array([[127.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 4.5]],
                 np.float32)
    jq, js = jopt._quant_row(jnp.asarray(x))
    tq, ts = topt._quant_row(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.tolist() == [[127, 0, 2, 2, 4, 0, -2, -2, 4]]
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(topt._dequant_row(tq, ts).numpy(),
                                  np.asarray(jopt._dequant_row(jq, js)))


def test_schedule_clip_sgd(tree3):
    jlr, tlr = jopt.cosine_schedule(1.0, 10, 110), \
        topt.cosine_schedule(1.0, 10, 110)
    for step in (0, 5, 10, 60, 110, 200):
        np.testing.assert_allclose(float(tlr(step)), float(jlr(step)),
                                   rtol=1e-6, atol=1e-7)
    p, gs = tree3
    for max_norm in (1.0, 1e3):
        want = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, gs[0]),
                                        max_norm)
        got = topt.clip_by_global_norm(tree_from_numpy(gs[0]), max_norm)
        _trees_close(got, want, 1e-6)
    np.testing.assert_allclose(
        float(topt.global_norm(tree_from_numpy(gs[1]))),
        float(jopt.global_norm(gs[1])), rtol=1e-6)
    jo, to = jopt.sgd_momentum(0.1, 0.9), topt.sgd_momentum(0.1, 0.9)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_from_numpy(p)
    js, ts = jo.init(jp), to.init(tp)
    for g in gs:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(tree_from_numpy(g), ts, tp)
    _trees_close(tp, jp, 1e-6)
    _trees_close(ts, js, 1e-6)


def _quad_loss_j(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _quad_loss_t(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


@pytest.fixture(scope="module")
def quad():
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(8, 1)).astype(np.float32)}
    batches = [{"x": rng.normal(size=(16, 8)).astype(np.float32),
                "y": rng.normal(size=(16, 1)).astype(np.float32)}
               for _ in range(6)]
    return params, batches


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_make_step_fn(quad, grad_accum):
    params, batches = quad
    jstep = jloop.make_step_fn(_quad_loss_j, jopt.AdamW(lr=0.1), grad_accum)
    tstep = loop.make_step_fn(_quad_loss_t, topt.AdamW(lr=0.1), grad_accum)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.AdamW(lr=0.1).init(jp)
    tp = tree_from_numpy(params)
    ts = topt.AdamW(lr=0.1).init(tp)
    for b in batches[:2]:
        jl, jp, js = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        tl, tp, ts = tstep(tp, ts, tree_from_numpy(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _trees_close(tp, jp, 1e-5)
    # grad_accum 2 on a batch == one full batch (the JAX test's claim)
    one = loop.make_step_fn(_quad_loss_t, topt.AdamW(lr=0.1), 1)
    tp0 = tree_from_numpy(params)
    l1, p1, _ = one(tp0, topt.AdamW(lr=0.1).init(tp0),
                    tree_from_numpy(batches[0]))
    l2, p2, _ = tstep(tp0, topt.AdamW(lr=0.1).init(tp0),
                      tree_from_numpy(batches[0]))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-4,
                               atol=1e-6)


def test_train_resume(quad, tmp_path):
    params, batches = quad
    logs = []
    kw = dict(opt=topt.AdamW(lr=0.05), log_every=2, log=logs.append)
    # straight through: 6 steps
    p6, s6, l6 = loop.train(_quad_loss_t, tree_from_numpy(params),
                            iter(map(tree_from_numpy, batches)), 6, **kw)
    # JAX's loop on the same batches
    _, _, jl6 = jloop.train(_quad_loss_j, jax.tree.map(jnp.asarray, params),
                            iter(batches), 6, opt=jopt.AdamW(lr=0.05),
                            log=lambda s: None)
    np.testing.assert_allclose(l6, jl6, rtol=1e-5)
    # 4 steps with checkpoints every 2, then resume to 6
    path = str(tmp_path / "q.ckpt.npz")
    loop.train(_quad_loss_t, tree_from_numpy(params),
               iter(map(tree_from_numpy, batches)), 4,
               checkpoint_path=path, checkpoint_every=2, **kw)
    assert json.load(open(path + ".meta.json"))["step"] == 4
    pr, sr, lr = loop.train(_quad_loss_t, tree_from_numpy(params),
                            iter(map(tree_from_numpy, batches[4:])), 6,
                            checkpoint_path=path, resume=True, **kw)
    assert "[train] resumed from step 4" in logs
    assert len(lr) == 2 and lr == pytest.approx(l6[4:], rel=1e-6)
    np.testing.assert_array_equal(pr["w"].numpy(), p6["w"].numpy())
    assert int(sr.step) == 6


@pytest.fixture(scope="module")
def llama_state():
    """(params, AdamWState) of the llama4 smoke config with int8 states
    (``moe`` with a shared expert under sub1), one update taken."""
    cfg = j_get_arch("llama4-maverick-400b-a17b").smoke_cfg
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    opt = jopt.AdamW(lr=1e-3, state_dtype="int8")
    s = opt.init(p)
    g = jax.tree.map(lambda x: x * 0.5 + 0.01, p)
    return opt.update(g, s, p)


def test_checkpoint_across_packages(llama_state, tmp_path):
    jtree = llama_state
    tlike = tree_map(torch.zeros_like,
                     tree_from_numpy(jax.tree.map(np.asarray, jtree)))
    # JAX writes, the port reads
    jpath = str(tmp_path / "j.npz")
    jckpt.save(jpath, jtree, step=3, meta={"by": "jax"})
    got, step = ckpt.restore(jpath, tlike)
    assert step == 3
    _trees_close(got, jtree, 0.0)
    # the port writes, JAX reads; the same keys in both files
    tpath = str(tmp_path / "t.npz")
    ckpt.save(tpath, got, step=5, meta={"by": "torch"})
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "0|sub1|moe|wr" in b.files
        assert "1|m|sub1|moe|shared_wg|q" in b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
    back, step = jckpt.restore(tpath, jtree)
    assert step == 5
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(
        np.asarray(x), np.asarray(y)), back, jtree)
    assert json.load(open(tpath + ".meta.json")) == {"step": 5,
                                                     "by": "torch"}


def test_checkpoint_async_and_bf16(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4).to(torch.bfloat16),
            "b": {"c": torch.ones(2, dtype=torch.int32)}}
    path = str(tmp_path / "m.npz")
    ckpt.save(path, tree, step=7, async_=True).join(timeout=60)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".ckpt-")]
    like = tree_map(torch.zeros_like, tree)
    got, step = ckpt.restore(path, like)
    assert step == 7 and got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    # the bf16 leaf is stored as JAX stores one: 2-byte records
    with np.load(path) as f:
        assert f["a"].dtype == tensor_to_numpy(tree["a"]).dtype
        assert f["a"].dtype.itemsize == 2


@pytest.mark.parametrize("vocab,batch,seq", [(512, 3, 17), (50, 2, 8)])
def test_token_batches_equal(vocab, batch, seq):
    jit_, tit = j_token_batches(7, vocab, batch, seq), \
        token_batches(7, vocab, batch, seq)
    for _ in range(3):
        a, b = next(jit_), next(tit)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(a[k], b[k])
