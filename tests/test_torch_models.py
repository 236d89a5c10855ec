"""The LM family's model code, port vs the JAX package, on the CPU: every
layer, blockwise / naive / decode attention, the MoE FFN, and the
transformer's forward, logits, loss, gradients and decode for each of
the five LM smoke configs.  Inputs come from numpy seeds; the JAX init
is carried into the port through ``repro_torch.models.convert``.

Tolerances: fp32 layers and attention 2e-5 (the JAX attention test's);
the MoE FFN 1e-5; the transformer at fp32 compute 1e-4 (atol and rtol)
with the loss at rtol 1e-5, at bf16 compute the loss at rtol 2e-2 (bf16
rounds at other places in the two frameworks); decode 2e-4 (the JAX
decode test's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import attention as jatt
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jtf

from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as att
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves_with_path, value_and_grad
from repro_torch.models.convert import load_numpy, params_from_numpy, \
    params_to_numpy

LM_IDS = ["glm4-9b", "gemma-7b", "smollm-135m",
          "llama4-maverick-400b-a17b", "olmoe-1b-7b"]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


# ----------------------------------------------------------------- layers
@pytest.fixture(scope="module")
def xs():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(3, 5, 32)).astype(np.float32),
            "w": rng.normal(size=(32,)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(xs, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = xs["x"]
    for name, jargs, targs in (
            ("rms", (xs["w"],), (_t(xs["w"]),)),
            ("layer", (xs["w"], xs["b"]), (_t(xs["w"]), _t(xs["b"])))):
        jf = getattr(jl, f"{name}_norm")
        tfn = getattr(tl, f"{name}_norm")
        want = jf(jnp.asarray(x, jdt), *jargs)
        got = tfn(_t(x).to(tdt), *targs)
        assert got.dtype == tdt
        tol = 2e-5 if dtype == "float32" else 1e-2
        _close(got, np.asarray(want.astype(jnp.float32)), tol, name)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn(xs, name):
    _close(tl.act_fn(name)(_t(xs["x"])), jl.act_fn(name)(xs["x"]), 2e-5)


def test_rope(xs):
    _close(tl.rope_freqs(16, 500.0), jl.rope_freqs(16, 500.0), 1e-6)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    _close(tl.apply_rope(_t(x), _t(pos)), jl.apply_rope(x, pos), 2e-5)


def test_cross_entropy_loss():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 6, 50)).astype(np.float32)
    tg = rng.integers(0, 50, (4, 6)).astype(np.int32)
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
    _close(tl.cross_entropy_loss(_t(logits), _t(tg)),
           jl.cross_entropy_loss(logits, tg), 1e-6)
    _close(tl.cross_entropy_loss(_t(logits), _t(tg), _t(mask)),
           jl.cross_entropy_loss(logits, tg, mask), 1e-6)


# -------------------------------------------------------------- attention
@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(3)
    b, s, h, kv, hd = 2, 64, 8, 2, 16
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in
                 ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


@pytest.fixture(scope="module")
def naive_ref(qkv):
    return np.asarray(jatt.naive_causal_attention(*qkv))


def test_naive_attention(qkv, naive_ref):
    _close(att.naive_causal_attention(*map(_t, qkv)), naive_ref, 2e-5)


@pytest.mark.parametrize("schedule", ["triangular", "full"])
@pytest.mark.parametrize("bq,bk", [(8, 16), (16, 8), (64, 64), (32, 16)])
def test_blockwise_attention(qkv, naive_ref, schedule, bq, bk):
    kw = dict(block_q=bq, block_kv=bk, schedule=schedule)
    want = jatt.blockwise_causal_attention(*qkv, **kw)
    got = att.blockwise_causal_attention(*map(_t, qkv), **kw)
    _close(got, want, 2e-5, "vs JAX")
    _close(got, naive_ref, 2e-5, "vs naive")


def test_decode_attention_ragged_len(qkv):
    q, k, v = qkv
    q1 = q[:, :1]
    cache_len = np.array([5, 64], np.int32)
    want = jatt.decode_attention(q1, k, v, cache_len)
    got = att.decode_attention(_t(q1), _t(k), _t(v), _t(cache_len))
    _close(got, want, 2e-5)


# -------------------------------------------------------------------- MoE
def _moe_case(gated, n_shared, cf, seed):
    rng = np.random.default_rng(seed)
    d, e, f = 16, 4, 24
    p = {"wr": rng.normal(size=(d, e)), "wi": rng.normal(size=(e, d, f)),
         "wo": rng.normal(size=(e, f, d)) * 0.2}
    if gated:
        p["wg"] = rng.normal(size=(e, d, f))
    if n_shared:
        p["shared_wi"] = rng.normal(size=(d, f * n_shared))
        p["shared_wo"] = rng.normal(size=(f * n_shared, d)) * 0.2
        if gated:
            p["shared_wg"] = rng.normal(size=(d, f * n_shared))
    p = {k: (v * d ** -0.5).astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn(gated, n_shared, cf):
    p, x = _moe_case(gated, n_shared, cf, seed=4)
    jcfg = jmoe.MoEConfig(4, 2, 24, capacity_factor=cf, n_shared=n_shared)
    tcfg = tmoe.MoEConfig(4, 2, 24, capacity_factor=cf, n_shared=n_shared)
    want, waux = jmoe.moe_ffn(p, x, jcfg)
    got, gaux = tmoe.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    _close(got, want, 1e-5)
    _close(gaux, waux, 1e-5)
    if cf < 1:
        # 48 routes into 4 experts at capacity ceil(48/4*0.5) = 6: at
        # most 24 are kept, so some token lost at least one route
        assert not np.allclose(_np(got), np.asarray(
            jmoe.moe_ffn(p, x, dataclasses.replace(
                jcfg, capacity_factor=8.0))[0]), atol=1e-3)


# ------------------------------------------------------------ transformer
def _cfgs(arch_id, compute):
    jc = dataclasses.replace(j_get_arch(arch_id).smoke_cfg,
                             compute_dtype=getattr(jnp, compute))
    tc = dataclasses.replace(get_arch(arch_id).smoke_cfg,
                             compute_dtype=getattr(torch, compute))
    return jc, tc


@pytest.fixture(scope="module")
def lm_batch():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (2, 32)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


@pytest.fixture(scope="module")
def jax_params():
    return {a: jax.tree.map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(i), j_get_arch(a).smoke_cfg))
        for i, a in enumerate(LM_IDS)}


def _grads_close(got, want, tol):
    flat = dict(tree_leaves_with_path(got))
    for path, w in tree_leaves_with_path(want):
        _close(flat[path], w, tol, "/".join(map(str, path)))


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_transformer_fp32(arch_id, jax_params, lm_batch):
    jc, tc = _cfgs(arch_id, "float32")
    jp = jax_params[arch_id]
    model = params_from_numpy(jp, tc)
    tp = model.tree()
    jb = {k: jnp.asarray(v) for k, v in lm_batch.items()}
    tb = {k: _t(v) for k, v in lm_batch.items()}

    jh, jaux = jtf.forward(jp, jb["tokens"], jc)
    th, taux = model(tb["tokens"])
    _close(th, jh, 1e-4, "hidden")
    _close(taux, jaux, 1e-4, "aux")
    _close(model.logits(th), jtf.logits_fn(jp, jh, jc), 1e-4, "logits")

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jb, jc)))(jp)
    tloss, tgrads = value_and_grad(
        lambda p, b: tf.lm_loss(p, b, tc))(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _grads_close(tgrads, jax.tree.map(np.asarray, jgrads), 1e-4)


def test_convert_roundtrip(jax_params):
    """JAX tree -> module -> tree is exact, names and dtypes kept, and
    ``load_numpy`` copies a tree into an existing module."""
    _, tc = _cfgs("llama4-maverick-400b-a17b", "float32")
    jp = jax_params["llama4-maverick-400b-a17b"]
    model = params_from_numpy(jp, tc)
    names = {n.replace(".", "/") for n, _ in model.named_parameters()}
    assert names == {"/".join(p) for p, _ in tree_leaves_with_path(jp)}
    back = params_to_numpy(model)
    for path, want in tree_leaves_with_path(jp):
        got = dict(tree_leaves_with_path(back))[path]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    fresh = tf.Transformer(tc, tf.init_params(torch.Generator(), tc))
    load_numpy(fresh, jp)
    for (path, a), (_, b) in zip(tree_leaves_with_path(fresh.tree()),
                                 tree_leaves_with_path(model.tree())):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_transformer_bf16_loss(arch_id, jax_params, lm_batch):
    jc, tc = _cfgs(arch_id, "bfloat16")
    jp = jax_params[arch_id]
    want = jtf.lm_loss(jp, {k: jnp.asarray(v) for k, v in lm_batch.items()},
                       jc)
    with torch.no_grad():
        got = tf.lm_loss(params_from_numpy(jp, tc).tree(),
                         {k: _t(v) for k, v in lm_batch.items()}, tc)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)


def test_decode_matches_jax():
    jc = jtf.TransformerConfig(
        name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        head_dim=8, d_ff=64, vocab=101, block_q=8, block_kv=8,
        compute_dtype=jnp.float32, loss_chunk=8)
    tc = tf.TransformerConfig(
        name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        head_dim=8, d_ff=64, vocab=101, block_q=8, block_kv=8,
        compute_dtype=torch.float32, loss_chunk=8)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    model = params_from_numpy(jax.tree.map(np.asarray, jp), tc)
    toks = np.random.default_rng(6).integers(0, 101, (2, 16)).astype(
        np.int32)
    jcache = jtf.init_cache(jc, 2, 16, jnp.float32)
    tcache = tf.init_cache(tc, 2, 16, torch.float32)
    jstep = jax.jit(lambda p, c, t: jtf.decode_step(p, c, t, jc))
    for t in range(16):
        jlg, jcache = jstep(jp, jcache, toks[:, t:t + 1])
        tlg, tcache = model.decode_step(tcache, _t(toks[:, t:t + 1]))
        _close(tlg, jlg, 2e-4, f"token {t}")
    _close(tcache["kv"]["sub0"]["k"], jcache["kv"]["sub0"]["k"], 2e-4)
    assert tcache["len"].tolist() == [16, 16]
    # and the last step against the port's own forward
    th, _ = model(_t(toks))
    _close(tlg[:, 0], _np(model.logits(th))[:, -1], 2e-4)


def test_remat_full_equals_none(lm_batch):
    _, tc = _cfgs("olmoe-1b-7b", "float32")
    params = tf.init_params(torch.Generator().manual_seed(0), tc)
    tb = {k: _t(v) for k, v in lm_batch.items()}
    out = {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(tc, remat=remat)
        out[remat] = value_and_grad(
            lambda p, b: tf.lm_loss(p, b, cfg))(params, tb)
    assert float(out["full"][0]) == float(out["none"][0])
    _grads_close(out["full"][1], params_to_numpy(out["none"][1]), 1e-6)
