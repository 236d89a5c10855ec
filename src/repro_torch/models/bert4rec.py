"""BERT4Rec (arXiv:1904.06690): bidirectional self-attention over item
sequences with a masked-item (Cloze) objective.

Production-scale choices for a 10^6-item catalog, as in the JAX package:
* training uses sampled softmax over the masked positions (gold + shared
  negatives) - a [B,M,V] logits tensor at V=10^6 is not materializable;
* serving never materializes [B, V] scores either: scoring is a chunked
  top-k scan over the item-embedding table (``chunked_topk_scores``),
  which is also the retrieval_cand path (1 query x 1M candidates).

``jax.lax.scan`` over the stacked blocks and over the catalog chunks
becomes a loop.  ``torch.topk`` does not promise ``lax.top_k``'s order
of exact ties (lower index first).  ``make_sharded_serve`` is the serve
over a ``DeviceMesh``, each "model" rank scoring its vocab shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels import gather_rows, take_nan
from .common import _ParamTree, normal_init
from .layers import act_fn, layer_norm

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str
    n_items: int = 1_000_000     # catalog size (retrieval_cand = 1M)
    d_model: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: int = 256
    n_masked: int = 20           # masked positions per sequence
    n_negatives: int = 1024      # shared sampled-softmax negatives
    topk: int = 100
    v_chunk: int = 65536         # scoring chunk over the catalog
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def vocab(self) -> int:
        return self.n_items + 2  # 0 = PAD, n_items+1 = MASK

    @property
    def mask_id(self) -> int:
        return self.n_items + 1


def _build(cfg: Bert4RecConfig, w, ones, zeros) -> PyTree:
    d, n = cfg.d_model, cfg.n_blocks
    params: Dict[str, Any] = {
        "item_emb": w((cfg.vocab, d), 0.02),
        "pos_emb": w((cfg.seq_len, d), 0.02),
        "ln_f_w": ones((d,)),
        "ln_f_b": zeros((d,)),
        "out_bias": zeros(()),
    }
    params["blocks"] = {
        "wqkv": w((n, d, 3 * d), d ** -0.5),
        "wo": w((n, d, d), d ** -0.5),
        "ln1_w": ones((n, d)),
        "ln1_b": zeros((n, d)),
        "ln2_w": ones((n, d)),
        "ln2_b": zeros((n, d)),
        "w1": w((n, d, cfg.d_ff), d ** -0.5),
        "b1": zeros((n, cfg.d_ff)),
        "w2": w((n, cfg.d_ff, d), cfg.d_ff ** -0.5),
        "b2": zeros((n, d)),
    }
    return params


def init_params(gen: torch.Generator, cfg: Bert4RecConfig,
                device=None) -> PyTree:
    """The JAX tree drawn from ``gen`` and placed on ``device`` (default:
    the generator's)."""
    device = device or gen.device
    dt = cfg.param_dtype
    return _build(
        cfg,
        lambda shape, std: normal_init(gen, shape, std, dt, device),
        lambda shape: torch.ones(shape, dtype=dt, device=device),
        lambda shape: torch.zeros(shape, dtype=dt, device=device))


def abstract_params(cfg: Bert4RecConfig) -> PyTree:
    """The same tree on the ``meta`` device (``jax.eval_shape``)."""
    def empty(shape, std=None):
        return torch.empty(shape, dtype=cfg.param_dtype, device="meta")
    return _build(cfg, empty, empty, empty)


def _block(x, bp, pad, cfg: Bert4RecConfig):
    b, s, _ = x.shape
    h = cfg.n_heads
    dh = cfg.d_model // h
    y = layer_norm(x, bp["ln1_w"], bp["ln1_b"])
    qkv = torch.einsum("bsd,dk->bsk", y, bp["wqkv"])
    q, k, v = torch.split(qkv, cfg.d_model, dim=-1)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, h, dh)
    v = v.reshape(b, s, h, dh)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    sc = torch.where(pad[:, None, None, :], -1e30, sc)
    p = torch.softmax(sc.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, cfg.d_model)
    x = x + torch.einsum("bsd,dk->bsk", o, bp["wo"])
    y = layer_norm(x, bp["ln2_w"], bp["ln2_b"])
    # jax.nn.gelu's default: the tanh approximation
    y = act_fn("gelu")(torch.einsum("bsd,df->bsf", y, bp["w1"]) + bp["b1"])
    return x + torch.einsum("bsf,fd->bsd", y, bp["w2"]) + bp["b2"]


def encode(params, seq, cfg: Bert4RecConfig):
    """seq [B,S] item ids (0=PAD) -> hidden [B,S,D]."""
    x = gather_rows(params["item_emb"], seq).to(cfg.compute_dtype)
    return _encoder(params, x, seq, cfg)


def _encoder(params, x, seq, cfg: Bert4RecConfig):
    """The blocks and the final norm over the item embeddings ``x``
    [B,S,D] of ``seq`` [B,S] (which places the pads)."""
    s = seq.shape[1]
    cdt = cfg.compute_dtype
    x = x + params["pos_emb"][None, :s].to(cdt)
    pad = seq == 0  # [B,S]
    for i in range(cfg.n_blocks):
        bp = {k: v[i].to(cdt) for k, v in params["blocks"].items()}
        x = _block(x, bp, pad, cfg)
    return layer_norm(x, params["ln_f_w"].to(cdt),
                      params["ln_f_b"].to(cdt))


def masked_item_loss(params, batch, cfg: Bert4RecConfig):
    """batch: seq [B,S] (with MASK tokens already placed),
    masked_pos [B,M], masked_ids [B,M], negatives [K] shared ids."""
    hidden = encode(params, batch["seq"], cfg)  # [B,S,D]
    pos = batch["masked_pos"]
    hm = take_nan(hidden, 1, pos[..., None].expand(
        *pos.shape, hidden.shape[-1]))  # [B,M,D]
    emb = params["item_emb"].to(cfg.compute_dtype)
    gold_e = gather_rows(emb, batch["masked_ids"])   # [B,M,D]
    neg_e = gather_rows(emb, batch["negatives"])     # [K,D]
    gold_logit = torch.sum(hm * gold_e, -1, dtype=torch.float32)  # [B,M]
    neg_logit = torch.einsum("bmd,kd->bmk", hm, neg_e).float()
    # sampled softmax: gold vs negatives (uniform logQ cancels up to gold)
    logits = torch.cat([gold_logit[..., None], neg_logit], -1)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - gold_logit
    valid = batch["masked_ids"] > 0
    return torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)


def chunked_topk_scores(params, query, cfg: Bert4RecConfig):
    """query [B,D] -> (top-k scores [B,k], ids [B,k]) without a [B,V]
    intermediate: a loop over catalog chunks of ``v_chunk`` rows with a
    running top-k.  The table is read in place; the last chunk is the
    rows left (JAX pads it with zero rows, which score ``-inf``)."""
    k = cfg.topk
    v = cfg.n_items + 1  # score real items 1..n_items (skip PAD row 0)
    chunk = cfg.v_chunk
    emb = params["item_emb"]
    b = query.shape[0]
    best_s = torch.full((b, k), -torch.inf, dtype=torch.float32,
                        device=query.device)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=query.device)
    for lo in range(0, v, chunk):
        tbl = emb[lo:min(lo + chunk, v)].to(cfg.compute_dtype)
        sc = torch.einsum("bd,cd->bc", query, tbl).float()
        ids = torch.arange(lo, lo + tbl.shape[0], dtype=torch.int32,
                           device=query.device)
        sc = torch.where((ids >= 1) & (ids <= cfg.n_items), sc, -torch.inf)
        cat_s = torch.cat([best_s, sc], -1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], -1)
        best_s, idx = torch.topk(cat_s, k, dim=-1)
        best_i = torch.gather(cat_i, -1, idx)
    return best_s, best_i


def _last(hidden, seq):
    """The hidden state at each row's last non-pad position."""
    lengths = torch.sum((seq > 0).to(torch.int32), -1)
    return hidden[torch.arange(seq.shape[0], device=seq.device),
                  torch.clamp(lengths - 1, min=0)]


def serve_scores(params, batch, cfg: Bert4RecConfig):
    """Next-item scoring: encode session, score last position vs catalog."""
    seq = batch["seq"]
    return chunked_topk_scores(params, _last(encode(params, seq, cfg), seq),
                               cfg)


def make_sharded_serve(cfg: Bert4RecConfig, mesh, dp_axes):
    """The serve over ``mesh`` (a ``DeviceMesh`` with a "model" axis):
    each "model" rank scores only its vocab shard and keeps a local
    top-k; the only cross-shard traffic is the embedding all_reduce and
    the [model, B, k] candidate merge.

    Returns ``serve(params, batch) -> (scores [B/dp, k], ids [B/dp,
    k])``, this rank's block of rows over ``dp_axes``.  Every rank passes
    the same global params and ``batch["seq"]`` on its device and cuts
    its blocks (its vocab shard of ``item_emb``, its rows of ``seq``), as
    ``shard_map``'s input specs cut them in the JAX package.  As there,
    and unlike ``serve_scores``: an id outside the vocab embeds as
    zeros, and a shard is scored in whole chunks of ``min(v_chunk,
    shard)`` rows, the last padded with zero rows whose ids run on past
    the shard (score 0, masked only past ``n_items``)."""
    from ..collectives import (all_gather, axes_index, check_device,
                               rank_device, shard_block)

    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    vocab = cfg.vocab
    if vocab % tp:
        raise ValueError(f"the vocab ({vocab}) does not divide into {tp} "
                         f"model shards")
    vshard = vocab // tp
    dp_axes = tuple(dp_axes)
    group = mesh.get_group("model")
    device = rank_device(mesh)
    cdt = cfg.compute_dtype
    kk = cfg.topk
    chunk = min(cfg.v_chunk, vshard)

    def serve(params, batch):
        seq = batch["seq"]
        check_device(device, seq=seq, item_emb=params["item_emb"])
        shard, _ = axes_index(mesh, ("model",))
        row, n_rows = axes_index(mesh, dp_axes)
        emb = params["item_emb"][shard_block(vocab, tp, shard, "the vocab")]
        seq = seq[shard_block(seq.shape[0], n_rows, row, "batch rows")]
        offset = shard * vshard
        # vocab-sharded embedding lookup: partial take + all_reduce
        ids = seq.long() - offset
        ok = (ids >= 0) & (ids < vshard)
        rows = emb[ids.clamp(0, vshard - 1)]
        x = torch.where(ok[..., None], rows, 0.0)
        dist.all_reduce(x, group=group)
        query = _last(_encoder(params, x.to(cdt), seq, cfg), seq)

        # local-vocab chunked top-k
        b = query.shape[0]
        best_s = torch.full((b, kk), -torch.inf, dtype=torch.float32,
                            device=query.device)
        best_i = torch.zeros((b, kk), dtype=torch.int32,
                             device=query.device)
        for lo in range(0, vshard, chunk):
            tbl = emb[lo:lo + chunk]
            tbl = F.pad(tbl, (0, 0, 0, chunk - tbl.shape[0])).to(cdt)
            sc = torch.einsum("bd,cd->bc", query, tbl).float()
            cid = torch.arange(offset + lo, offset + lo + chunk,
                               dtype=torch.int32, device=query.device)
            sc = torch.where((cid >= 1) & (cid <= cfg.n_items), sc,
                             -torch.inf)
            cat_s = torch.cat([best_s, sc], -1)
            cat_i = torch.cat([best_i, cid.expand(b, -1)], -1)
            best_s, idx = torch.topk(cat_s, kk, dim=-1)
            best_i = torch.gather(cat_i, -1, idx)

        # merge the tp local top-k lists (the only gather)
        all_s = torch.stack(all_gather(best_s, group), 1).reshape(b, -1)
        all_i = torch.stack(all_gather(best_i, group), 1).reshape(b, -1)
        s_, idx = torch.topk(all_s, kk, dim=-1)
        return s_, torch.gather(all_i, -1, idx)

    serve.takes_global = True
    return serve


class Bert4Rec(_ParamTree):
    """BERT4Rec as an ``nn.Module`` whose parameter names are the tree's
    paths (``blocks.wqkv``); its methods call the functions above on
    ``tree()``."""

    def __init__(self, cfg: Bert4RecConfig, params: PyTree):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, seq):
        return encode(self.tree(), seq, self.cfg)

    def loss(self, batch):
        return masked_item_loss(self.tree(), batch, self.cfg)

    def serve(self, batch):
        return serve_scores(self.tree(), batch, self.cfg)
