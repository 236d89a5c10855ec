"""Decoder / encoder transformer LM covering the five LM archs (dense
GQA: glm4-9b, gemma-7b, smollm-135m; MoE: llama4-maverick, olmoe).

The parameter tree is the JAX package's: per ``sub{i}`` of a superblock
of ``moe_period`` sublayers, every leaf stacked ``[n_super, ...]``, with
``mlp`` / ``moe`` sub-dicts, and a ``head`` only when the embeddings are
untied.  ``jax.lax.scan`` over the superblocks becomes a loop over the
stacked index; ``remat="full"`` wraps each superblock in
``torch.utils.checkpoint`` (non-reentrant) where JAX has
``jax.checkpoint``.  Casts happen where JAX's do: embedding rows and
each block's params to ``compute_dtype``, ``ln_f`` and the head cast to
it, the loss in fp32.

The functions work on plain dicts of tensors, as the JAX ones do on
dicts of arrays; ``Transformer`` is the same tree held as an
``nn.Module`` whose parameter names are the tree's paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import (
    blockwise_causal_attention,
    constrain_batch,
    decode_attention,
)
from .common import normal_init, tree_map
from .layers import act_fn, apply_rope, rms_norm
from .moe import MoEConfig, moe_ffn

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    moe_period: int = 1
    causal: bool = True
    tie_embeddings: bool = False
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"  # full | none
    block_q: int = 512
    block_kv: int = 1024
    aux_loss_weight: float = 0.01
    logit_softcap: float = 0.0
    loss_chunk: int = 1024  # sequence chunking of the vocab projection
    attn_schedule: str = "triangular"  # or "full" (measured baseline)
    batch_axes: tuple = ()  # DP mesh axes (no constraint on one device)

    @property
    def n_super(self) -> int:
        assert self.n_layers % self.moe_period == 0
        return self.n_layers // self.moe_period

    def sublayer_is_moe(self, i: int) -> bool:
        return self.moe is not None and i == self.moe_period - 1


# ------------------------------------------------------------------ init
def _build(cfg: TransformerConfig, w, ones) -> PyTree:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    n = cfg.n_super
    params: Dict[str, Any] = {
        # d^-0.5 keeps tied-embedding logits at unit variance
        "embed": w((cfg.vocab, d)),
        "ln_f": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["head"] = w((d, cfg.vocab))
    for i in range(cfg.moe_period):
        sub: Dict[str, Any] = {
            "ln1": ones((n, d)),
            "ln2": ones((n, d)),
            "wq": w((n, d, h * hd)),
            "wk": w((n, d, kv * hd)),
            "wv": w((n, d, kv * hd)),
            "wo": w((n, h * hd, d)),
        }
        if cfg.sublayer_is_moe(i):
            m = cfg.moe
            sub["moe"] = {
                "wr": w((n, d, m.n_experts)),
                "wi": w((n, m.n_experts, d, m.d_ff)),
                "wo": w((n, m.n_experts, m.d_ff, d)),
            }
            if cfg.gated_mlp:
                sub["moe"]["wg"] = w((n, m.n_experts, d, m.d_ff))
            if m.n_shared:
                sub["moe"]["shared_wi"] = w((n, d, m.d_ff * m.n_shared))
                sub["moe"]["shared_wo"] = w((n, m.d_ff * m.n_shared, d))
                if cfg.gated_mlp:
                    sub["moe"]["shared_wg"] = w((n, d, m.d_ff * m.n_shared))
        else:
            sub["mlp"] = {
                "wi": w((n, d, f)),
                "wo": w((n, f, d)),
            }
            if cfg.gated_mlp:
                sub["mlp"]["wg"] = w((n, d, f))
        params[f"sub{i}"] = sub
    return params


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device=None) -> PyTree:
    """The JAX tree, drawn from ``gen`` (N(0, 1/d) weights, unit norms)
    and placed on ``device`` (default: the generator's)."""
    device = device or gen.device
    std = cfg.d_model ** -0.5
    return _build(
        cfg,
        lambda shape: normal_init(gen, shape, std, cfg.param_dtype, device),
        lambda shape: torch.ones(shape, dtype=cfg.param_dtype,
                                 device=device))


def abstract_params(cfg: TransformerConfig) -> PyTree:
    """The same tree on the ``meta`` device (``jax.eval_shape``)."""
    def empty(shape):
        return torch.empty(shape, dtype=cfg.param_dtype, device="meta")
    return _build(cfg, empty, empty)


# --------------------------------------------------------------- forward
def _attn(x, sp, cfg: TransformerConfig, positions):
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.einsum("bsd,dk->bsk", x, sp["wq"]).reshape(b, s, h, hd)
    k = torch.einsum("bsd,dk->bsk", x, sp["wk"]).reshape(b, s, kv, hd)
    v = torch.einsum("bsd,dk->bsk", x, sp["wv"]).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.causal:
        o = blockwise_causal_attention(
            q, k, v, block_q=cfg.block_q, block_kv=cfg.block_kv,
            schedule=cfg.attn_schedule, batch_axes=cfg.batch_axes,
        )
    else:
        # bidirectional (encoder): small-S archs use the direct path
        o = _full_bidir_attention(q, k, v)
    o = o.reshape(b, s, h * hd)
    return torch.einsum("bsk,kd->bsd", o, sp["wo"])


def _full_bidir_attention(q, k, v):
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd).float()
    sc = torch.einsum("bqkgd,bskd->bqgks", qg / (hd ** 0.5), k.float())
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bqgks,bskd->bqgkd", p, v.float())
    return o.permute(0, 1, 3, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def _mlp(x, mp, cfg: TransformerConfig):
    h = torch.einsum("bsd,df->bsf", x, mp["wi"])
    if cfg.gated_mlp:
        g = torch.einsum("bsd,df->bsf", x, mp["wg"])
        h = act_fn(cfg.act)(g) * h
    else:
        h = act_fn(cfg.act)(h)
    return torch.einsum("bsf,fd->bsd", h, mp["wo"])


def _superblock(x, blk, cfg: TransformerConfig, positions):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.moe_period):
        sp = blk[f"sub{i}"]
        x = x + _attn(rms_norm(x, sp["ln1"]), sp, cfg, positions)
        hnorm = rms_norm(x, sp["ln2"])
        if cfg.sublayer_is_moe(i):
            y, a = moe_ffn(sp["moe"], hnorm, cfg.moe)
            aux = aux + a
        else:
            y = _mlp(hnorm, sp["mlp"], cfg)
        x = x + y
    return x, aux


def _layer(params, cfg: TransformerConfig, i: int) -> PyTree:
    """Superblock ``i``'s params, cast to the compute dtype."""
    return {f"sub{j}": tree_map(lambda p: p[i].to(cfg.compute_dtype),
                                params[f"sub{j}"])
            for j in range(cfg.moe_period)}


def forward(params, tokens, cfg: TransformerConfig):
    """tokens [B,S] -> hidden [B,S,D] (pre-head), aux loss."""
    b, s = tokens.shape
    x = constrain_batch(
        params["embed"][tokens.long()].to(cfg.compute_dtype), cfg.batch_axes)
    positions = torch.arange(s, device=tokens.device).expand(b, s)

    def block(x, i):
        return _superblock(x, _layer(params, cfg, i), cfg, positions)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_super):
        if cfg.remat == "full" and torch.is_grad_enabled():
            x, a = checkpoint(block, x, i, use_reentrant=False)
        else:
            x, a = block(x, i)
        aux = aux + a
    x = rms_norm(x, params["ln_f"].to(cfg.compute_dtype))
    return x, aux


def logits_fn(params, hidden, cfg: TransformerConfig):
    head = (params["embed"].T if cfg.tie_embeddings else params["head"])
    logits = torch.einsum("bsd,dv->bsv", hidden, head.to(cfg.compute_dtype))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def lm_loss(params, batch, cfg: TransformerConfig):
    """batch: {"tokens": [B,S], "targets": [B,S]}; next-token CE.

    The [B,S,V] logits are never materialized at once: the vocab
    projection and CE run per sequence chunk of ``loss_chunk``
    (un-chunked where it does not divide S)."""
    hidden, aux = forward(params, batch["tokens"], cfg)
    b, s, d = hidden.shape
    ck = cfg.loss_chunk or s
    ck = min(ck, s)
    if s % ck:
        ck = s  # fallback: un-chunked
    targets = batch["targets"].long()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, ck):
        logits = logits_fn(params, hidden[:, lo:lo + ck], cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets[:, lo:lo + ck, None])[..., 0]
        total = total + torch.sum(lse - gold)
    loss = total / (b * s)
    return loss + cfg.aux_loss_weight * aux


# ----------------------------------------------------------------- decode
def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device=None) -> PyTree:
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_super, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kvs = {
        f"sub{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
        for i in range(cfg.moe_period)
    }
    return {"kv": kvs,
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def abstract_cache(cfg, batch, max_len, dtype=None):
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def decode_step(params, cache, tokens, cfg: TransformerConfig):
    """One autoregressive step: tokens [B,1] -> (logits [B,1,V], cache).
    The new K/V is written at ``len`` by a one-hot blend, as in JAX; the
    cache given is left as it was (a new one is returned)."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    pos = cache["len"]  # [B]
    positions = pos[:, None]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    new_kvs = {name: {"k": torch.empty_like(c["k"]),
                      "v": torch.empty_like(c["v"])}
               for name, c in cache["kv"].items()}
    for layer in range(cfg.n_super):
        blk = _layer(params, cfg, layer)
        for i in range(cfg.moe_period):
            sp = blk[f"sub{i}"]
            kc = cache["kv"][f"sub{i}"]["k"][layer]
            vc = cache["kv"][f"sub{i}"]["v"][layer]
            xin = rms_norm(x, sp["ln1"])
            q = torch.einsum("bsd,dk->bsk", xin, sp["wq"]).reshape(
                b, 1, h, hd)
            k = torch.einsum("bsd,dk->bsk", xin, sp["wk"]).reshape(
                b, 1, kv, hd)
            v = torch.einsum("bsd,dk->bsk", xin, sp["wv"]).reshape(
                b, 1, kv, hd)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            # write the new KV at position len
            oh = (torch.arange(kc.shape[1], device=kc.device)[None, :]
                  == pos[:, None]).to(kc.dtype)  # [B,S]
            kc = kc * (1 - oh)[..., None, None] + oh[..., None, None] * k
            vc = vc * (1 - oh)[..., None, None] + oh[..., None, None] * v
            o = decode_attention(q, kc, vc, pos + 1)
            x = x + torch.einsum("bsk,kd->bsd", o.reshape(b, 1, h * hd),
                                 sp["wo"])
            hnorm = rms_norm(x, sp["ln2"])
            if cfg.sublayer_is_moe(i):
                y, _ = moe_ffn(sp["moe"], hnorm, cfg.moe)
            else:
                y = _mlp(hnorm, sp["mlp"], cfg)
            x = x + y
            new_kvs[f"sub{i}"]["k"][layer] = kc
            new_kvs[f"sub{i}"]["v"][layer] = vc
    x = rms_norm(x, params["ln_f"].to(cfg.compute_dtype))
    logits = logits_fn(params, x, cfg)
    return logits, {"kv": new_kvs, "len": cache["len"] + 1}


# ------------------------------------------------------------------ module
class _ParamTree(nn.Module):
    """A nested dict of tensors held as parameters: a dict becomes a
    child module, a tensor a parameter of the same name."""

    def __init__(self, tree: PyTree):
        super().__init__()
        self._keys = list(tree)
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, _ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(
                    val, requires_grad=val.is_floating_point()))

    def tree(self) -> PyTree:
        """The live parameters as the JAX-shaped dict."""
        out = {}
        for key in self._keys:
            val = getattr(self, key)
            out[key] = val.tree() if isinstance(val, _ParamTree) else val
        return out


class Transformer(_ParamTree):
    """The transformer as an ``nn.Module``: ``named_parameters()`` gives
    the tree's paths joined by "." (``sub0.mlp.wi``), and every method
    calls the functional code above on ``tree()``."""

    def __init__(self, cfg: TransformerConfig, params: PyTree):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, tokens):
        return forward(self.tree(), tokens, self.cfg)

    def logits(self, hidden):
        return logits_fn(self.tree(), hidden, self.cfg)

    def loss(self, batch):
        return lm_loss(self.tree(), batch, self.cfg)

    def decode_step(self, cache, tokens):
        return decode_step(self.tree(), cache, tokens, self.cfg)
