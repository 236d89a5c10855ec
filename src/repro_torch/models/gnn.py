"""GNN message passing via edge-index scatter (segment ops).

As in the JAX package, message passing is a gather of node rows by edge
(``x[src]``) and a segment sum / max over the edges' targets
(``models.common.segment_sum`` / ``segment_max``: ``index_add`` and
``scatter_reduce`` "amax"), over an edge list that holds its own self
loops (the data pipeline adds them).

Covers GCN (sym-norm SpMM), GIN (sum-agg + MLP) and GAT (SDDMM edge
scores -> segment softmax -> weighted SpMM).  Gathers take their
indices as JAX's plain indexing does (``kernels.gather_index``) and read
by ``index_select`` (an ``index_add`` backward); a segment id out of
range is dropped, as ``jax.ops.segment_sum`` drops it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels import gather_index
from .common import _ParamTree, normal_init, segment_max, segment_sum, \
    tree_map
from .layers import cross_entropy_loss

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # gcn | gat | gin
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    n_heads: int = 1          # gat
    gin_eps_learnable: bool = True
    dropout: float = 0.0      # (kept 0 in dry-runs; losses are determin.)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32


def _build(cfg: GNNConfig, w, zeros) -> PyTree:
    """The JAX tree: ``{"layers": [per-layer dict, ...]}``; ``w(shape,
    std)`` makes a weight, ``zeros(shape)`` a bias."""
    layers = []
    d_prev = cfg.d_in
    for li in range(cfg.n_layers):
        last = li == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        if cfg.kind == "gat":
            heads = 1 if last else cfg.n_heads
            lp = {
                "w": w((d_prev, heads * d_out), d_prev ** -0.5),
                "a_src": w((heads, d_out), 0.1),
                "a_dst": w((heads, d_out), 0.1),
            }
            d_prev = heads * d_out if not last else d_out
        elif cfg.kind == "gin":
            lp = {
                "eps": zeros(()),
                "w1": w((d_prev, cfg.d_hidden), d_prev ** -0.5),
                "b1": zeros((cfg.d_hidden,)),
                "w2": w((cfg.d_hidden, d_out), cfg.d_hidden ** -0.5),
                "b2": zeros((d_out,)),
            }
            d_prev = d_out
        else:  # gcn
            lp = {
                "w": w((d_prev, d_out), d_prev ** -0.5),
                "b": zeros((d_out,)),
            }
            d_prev = d_out
        layers.append(lp)
    return {"layers": layers}


def init_params(gen: torch.Generator, cfg: GNNConfig,
                device=None) -> PyTree:
    """The JAX tree drawn from ``gen`` and placed on ``device`` (default:
    the generator's)."""
    device = device or gen.device
    return _build(
        cfg,
        lambda shape, std: normal_init(gen, shape, std, cfg.param_dtype,
                                       device),
        lambda shape: torch.zeros(shape, dtype=cfg.param_dtype,
                                  device=device))


def abstract_params(cfg: GNNConfig) -> PyTree:
    """The same tree on the ``meta`` device (``jax.eval_shape``)."""
    def empty(shape, std=None):
        return torch.empty(shape, dtype=cfg.param_dtype, device="meta")
    return _build(cfg, empty, empty)


def _gcn_layer(lp, x, src, dst, dst_g, n, deg_isqrt):
    norm = deg_isqrt.index_select(0, src) * deg_isqrt.index_select(0, dst_g)
    msg = x.index_select(0, src) * norm[:, None]
    agg = segment_sum(msg, dst, n)
    return agg @ lp["w"] + lp["b"]


def _gin_layer(lp, x, src, dst, n):
    agg = segment_sum(x.index_select(0, src), dst, n)
    h = (1.0 + lp["eps"]) * x + agg
    h = F.relu(h @ lp["w1"] + lp["b1"])
    return h @ lp["w2"] + lp["b2"]


def _gat_layer(lp, x, src, dst, dst_g, n, last: bool):
    heads, d_out = lp["a_src"].shape
    z = (x @ lp["w"]).reshape(n, heads, d_out)
    zs = z.index_select(0, src)
    e = torch.einsum("ehd,hd->eh", zs, lp["a_src"]) + torch.einsum(
        "ehd,hd->eh", z.index_select(0, dst_g), lp["a_dst"])
    e = F.leaky_relu(e, 0.2)
    m = segment_max(e, dst, n)
    p = torch.exp(e - m.index_select(0, dst_g))
    s = segment_sum(p, dst, n)
    w = p / torch.clamp(s.index_select(0, dst_g), min=1e-9)
    agg = segment_sum(zs * w[..., None], dst, n)
    if last:
        return agg.mean(1)
    return F.elu(agg.reshape(n, heads * d_out))


def forward(params, batch, cfg: GNNConfig):
    """batch: x [N,F], edges [2,E] int32 (incl. self loops, both dirs),
    optionally edge_mask [E] (0 pads).  Returns logits [N, n_classes]."""
    x = batch["x"].to(cfg.compute_dtype)
    src, dst = batch["edges"][0], batch["edges"][1]
    masked = "edge_mask" in batch
    if masked:
        # padded edges point at node n (a dummy row is appended)
        pad = batch["edge_mask"] == 0
        src = torch.where(pad, x.shape[0], src)
        dst = torch.where(pad, x.shape[0], dst)
        x = torch.cat([x, x.new_zeros((1, x.shape[1]))], 0)
    n = x.shape[0]
    # gathers clamp as JAX's indexing does; the segment ops drop
    src_g, dst_g = gather_index(src, n), gather_index(dst, n)

    deg = segment_sum(torch.ones(dst.shape, dtype=x.dtype, device=x.device),
                      dst, n)
    deg_isqrt = torch.rsqrt(torch.clamp(deg, min=1.0))

    layers = params["layers"]
    for li, lp in enumerate(layers):
        last = li == len(layers) - 1
        lp = tree_map(lambda p: p.to(cfg.compute_dtype), lp)
        if cfg.kind == "gcn":
            x = _gcn_layer(lp, x, src_g, dst, dst_g, n, deg_isqrt)
        elif cfg.kind == "gin":
            x = _gin_layer(lp, x, src_g, dst, n)
        else:
            x = _gat_layer(lp, x, src_g, dst, dst_g, n, last)
        if not last and cfg.kind != "gat":  # gat applies elu inside
            x = F.relu(x)
    if masked:
        x = x[:-1]
    return x


def node_classification_loss(params, batch, cfg: GNNConfig):
    logits = forward(params, batch, cfg)
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def graph_classification_loss(params, batch, cfg: GNNConfig):
    """GIN on batched small graphs: sum-pool node embeddings per graph."""
    logits = forward(params, batch, cfg)  # [N, C]
    pooled = segment_sum(logits, batch["graph_id"], batch["n_graphs"])
    return cross_entropy_loss(pooled, batch["graph_labels"])


class GNN(_ParamTree):
    """The GNN as an ``nn.Module`` whose parameter names are the tree's
    paths (``layers.0.w``); its methods call the functions above on
    ``tree()``."""

    def __init__(self, cfg: GNNConfig, params: PyTree):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, batch):
        return forward(self.tree(), batch, self.cfg)

    def loss(self, batch):
        return node_classification_loss(self.tree(), batch, self.cfg)
