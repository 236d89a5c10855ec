"""Family adapters with the uniform Arch surface (see base.py): LM / GNN
/ MACE / RecSys / Mining archs, each with the JAX package's sharding
rules (``param_rules``, ``batch_spec_templates``,
``serve_spec_templates``)."""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable

import numpy as np
import torch

from ..kernels import resolve_device
from ..models import bert4rec as b4r
from ..models import gnn as gnn_mod
from ..models import common
from ..models import mace as mace_mod
from ..models import transformer as tf
from ..models.common import tree_map, value_and_grad
from ..training.optimizer import AdamW
from .base import (
    Arch,
    GNN_SHAPES,
    LM_SHAPES,
    MINING_SHAPES,
    RECSYS_SHAPES,
    _sds,
)

PyTree = Any
DATA = "DATA"
MODEL = "MODEL"


def _pad_mult(n: int, mult: int = 1024) -> int:
    """Round edge counts up so every mesh factorization divides them
    (the data pipeline pads edge lists with masked / (0,0)-self-loop
    entries)."""
    return -(-n // mult) * mult


def _on(tree, device) -> PyTree:
    """A numpy batch as tensors on ``device``; ints (``n_graphs``) stay."""
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, np.ndarray) else v for k, v in tree.items()}


def _smoke_step(loss_fn, opt):
    """One value-and-grad and optimizer update, as the JAX smoke steps;
    the step carries its ``loss_fn``."""
    vg = value_and_grad(loss_fn)

    def step(params, opt_state, batch):
        loss, grads = vg(params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return loss, params, opt_state

    step.loss_fn = loss_fn
    return step


def _smoke_params(init, cfg, device):
    """``init(gen, cfg, cpu)`` from seed 0, moved to ``device``: every
    device starts from the same values."""
    params = init(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    return tree_map(lambda x: x.to(device), params)


# =================================================================== LM
class LMArch(Arch):
    family = "lm"
    shapes = LM_SHAPES

    def __init__(self, cfg: tf.TransformerConfig,
                 smoke_cfg: tf.TransformerConfig,
                 opt_state_dtype: str = "float32",
                 active_params_ratio: float = 1.0):
        self.name = cfg.name
        self.cfg = cfg
        self.smoke_cfg = smoke_cfg
        self.opt_state_dtype = opt_state_dtype
        self._active_ratio = active_params_ratio

    # ---- params
    def abstract_params(self, shape: str) -> PyTree:
        return tf.abstract_params(self.cfg)

    def init_params(self, gen, shape: str, device=None) -> PyTree:
        return tf.init_params(gen, self.cfg, device)

    def param_rules(self):
        # TP over "model", FSDP/ZeRO over the pure-DP axes ("DATA")
        return [
            (r"embed", (MODEL, DATA)),                   # [V, D]
            (r"head", (DATA, MODEL)),                    # [D, V]
            (r"moe/wr", (None, DATA, None)),             # router [n,D,E]
            (r"moe/shared_wi|moe/shared_wg", (None, DATA, MODEL)),
            (r"moe/shared_wo", (None, MODEL, DATA)),
            (r"moe/wi|moe/wg", (None, MODEL, DATA, None)),  # [n,E,D,F]
            (r"moe/wo", (None, MODEL, None, DATA)),      # [n,E,F,D]
            (r"wq$|wk$|wv$", (None, DATA, MODEL)),       # [n,D,H*hd]
            (r"wo$", (None, MODEL, DATA)),               # [n,H*hd,D]
            (r"mlp/wi|mlp/wg", (None, DATA, MODEL)),     # [n,D,F]
            (r"mlp/wo", (None, MODEL, DATA)),            # [n,F,D]
            (r"ln", ()),
        ]

    def optimizer(self) -> AdamW:
        return AdamW(lr=3e-4, weight_decay=0.01,
                     state_dtype=self.opt_state_dtype)

    # ---- batches
    def batch_abstract(self, shape: str) -> PyTree:
        m = self.shapes[shape].meta
        return {
            "tokens": _sds((m["batch"], m["seq"]), torch.int32),
            "targets": _sds((m["batch"], m["seq"]), torch.int32),
        }

    def batch_spec_templates(self, shape: str) -> PyTree:
        return {"tokens": (DATA, None), "targets": (DATA, None)}

    def loss_fn(self, shape: str) -> Callable:
        cfg = self.cfg
        return lambda params, batch: tf.lm_loss(params, batch, cfg)

    def _mesh_cfg(self, mesh):
        """The config whose activations are constrained batch-sharded
        over ``mesh``'s DP axes (DTensor inputs only)."""
        if mesh is None:
            return self.cfg
        return dataclasses.replace(self.cfg, batch_axes=common.dp_axes(mesh))

    def make_train_step(self, shape: str, mesh=None):
        if mesh is not None:
            arch = LMArch(self._mesh_cfg(mesh), self.smoke_cfg,
                          self.opt_state_dtype)
            return super(LMArch, arch).make_train_step(shape)
        return super().make_train_step(shape)

    # ---- serve / prefill
    def make_serve_step(self, shape: str, mesh=None):
        sd = self.shapes[shape]
        m = sd.meta
        cfg = self._mesh_cfg(mesh)
        params = self.abstract_params(shape)
        if sd.kind == "prefill":
            def prefill(params, tokens):
                hidden, _ = tf.forward(params, tokens, cfg)
                # return only the last-position logits (next-token)
                return tf.logits_fn(params, hidden[:, -1:, :], cfg)

            tokens = _sds((m["batch"], m["seq"]), torch.int32)
            return prefill, (params, tokens)
        # decode: one token against a full cache
        cache = tf.abstract_cache(cfg, m["batch"], m["seq"])
        tokens = _sds((m["batch"], 1), torch.int32)

        def decode(params, cache, tokens):
            return tf.decode_step(params, cache, tokens, cfg)

        return decode, (params, cache, tokens)

    def serve_spec_templates(self, shape: str):
        sd = self.shapes[shape]
        m = sd.meta
        if sd.kind == "prefill":
            return [(DATA, None)]  # tokens
        batch_axes = DATA if m["batch"] > 1 else None
        # cache [n_super, B, S, KV, hd]: batch over DATA when possible,
        # sequence over MODEL (split-KV decode); B=1 long-context shards
        # the sequence over every axis.
        seq_axes = MODEL if m["batch"] > 1 else (DATA, MODEL)
        kv_spec = (None, batch_axes, seq_axes, None, None)
        cache_spec = {
            "kv": {
                f"sub{i}": {"k": kv_spec, "v": kv_spec}
                for i in range(self.cfg.moe_period)
            },
            "len": (batch_axes,),
        }
        return [cache_spec, (batch_axes, None)]

    # ---- metrics
    def n_params(self, active_only=False) -> float:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.head_dim
        attn = cfg.n_layers * (
            d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        )
        n_moe_layers = (cfg.n_layers // cfg.moe_period
                        if cfg.moe else 0)
        n_dense_layers = cfg.n_layers - n_moe_layers
        nmat = 3 if cfg.gated_mlp else 2
        mlp = n_dense_layers * nmat * d * cfg.d_ff
        moe = 0.0
        if cfg.moe:
            e = cfg.moe.top_k if active_only else cfg.moe.n_experts
            moe = n_moe_layers * (
                nmat * (e + cfg.moe.n_shared) * d * cfg.moe.d_ff
                + d * cfg.moe.n_experts
            )
        embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
        return float(attn + mlp + moe + embed)

    def model_flops(self, shape: str) -> float:
        m = self.shapes[shape].meta
        n_act = self.n_params(active_only=True)
        if self.shapes[shape].kind == "train":
            return 6.0 * n_act * m["batch"] * m["seq"]
        if self.shapes[shape].kind == "prefill":
            return 2.0 * n_act * m["batch"] * m["seq"]
        # decode: one token per row + attention over the cache
        cfg = self.cfg
        attn = (4.0 * m["batch"] * m["seq"] * cfg.n_layers
                * cfg.n_kv_heads * cfg.head_dim)
        return 2.0 * n_act * m["batch"] + attn

    # ---- smoke
    def smoke_bundle(self, device=None):
        """One AdamW step of the smoke config on ``device`` (default
        ``cuda``).  The weights are drawn on the CPU from seed 0 and then
        moved, so every device starts from the same values; the batch's
        tokens come from numpy's seed 0."""
        device = resolve_device(device)
        cfg = self.smoke_cfg
        params = _smoke_params(tf.init_params, cfg, device)
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
        toks = torch.as_tensor(toks, dtype=torch.int32, device=device)
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        opt = AdamW(lr=1e-3)
        step = _smoke_step(lambda p, b: tf.lm_loss(p, b, cfg), opt)
        return step, (params, opt.init(params), batch)


# ================================================================== GNN
class GNNArch(Arch):
    family = "gnn"
    shapes = GNN_SHAPES

    def __init__(self, name: str, kind: str, n_layers: int, d_hidden: int,
                 n_heads: int = 1):
        self.name = name
        self.kind = kind
        self.n_layers = n_layers
        self.d_hidden = d_hidden
        self.n_heads = n_heads

    def _cfg(self, shape: str) -> gnn_mod.GNNConfig:
        m = self.shapes[shape].meta
        return gnn_mod.GNNConfig(
            name=self.name, kind=self.kind, n_layers=self.n_layers,
            d_in=m.get("d_feat", 16), d_hidden=self.d_hidden,
            n_classes=m.get("n_classes", 2), n_heads=self.n_heads,
        )

    def abstract_params(self, shape: str) -> PyTree:
        return gnn_mod.abstract_params(self._cfg(shape))

    def init_params(self, gen, shape: str, device=None) -> PyTree:
        return gnn_mod.init_params(gen, self._cfg(shape), device)

    def param_rules(self):
        return [(r".*", ())]  # GNN params are tiny: replicate

    def optimizer(self) -> AdamW:
        return AdamW(lr=1e-2, weight_decay=5e-4)

    def batch_abstract(self, shape: str) -> PyTree:
        m = self.shapes[shape].meta
        task = m["task"]
        if task == "node":
            n, e = m["n_nodes"], m["n_edges"]
            e_tot = _pad_mult(2 * e + n)  # both dirs + self loops, padded
            return {
                "x": _sds((n, m["d_feat"]), torch.float32),
                "edges": _sds((2, e_tot), torch.int32),
                "labels": _sds((n,), torch.int32),
                "mask": _sds((n,), torch.float32),
            }
        if task == "node_sampled":
            n, e = m["pad_nodes"], m["pad_edges"]
            e_tot = _pad_mult(2 * e + n)
            return {
                "x": _sds((n, m["d_feat"]), torch.float32),
                "edges": _sds((2, e_tot), torch.int32),
                "labels": _sds((n,), torch.int32),
                "mask": _sds((n,), torch.float32),
                "edge_mask": _sds((e_tot,), torch.int32),
            }
        # molecule: batched small graphs
        b, npg, epg = m["batch"], m["n_nodes"], m["n_edges"]
        n = b * npg
        e_tot = _pad_mult(2 * b * epg)
        return {
            "edges": _sds((2, e_tot), torch.int32),
            "graph_id": _sds((n,), torch.int32),
            "graph_labels": _sds((b,), torch.int32),
            "x": _sds((n, m["d_feat"]), torch.float32),
        }

    def batch_spec_templates(self, shape: str) -> PyTree:
        m = self.shapes[shape].meta
        big = m["task"] in ("node", "node_sampled") and m["n_nodes"] > 10000
        espec = (None, DATA) if big else (None, None)
        out = {
            "x": (None, None),  # d_feat of the assigned shapes is not
            # divisible by the model axis; features replicate
            "edges": espec,
            "labels": (None,),
            "mask": (None,),
        }
        if m["task"] == "node_sampled":
            # the JAX rule: the (DATA,) spec of a big graph is overridden,
            # the mask aligned with the edges replicates
            out["edge_mask"] = (DATA,) if big else (None,)
            out["edge_mask"] = (None,)
        if m["task"] == "graph":
            out = {
                "edges": (None, DATA),
                "graph_id": (None,),
                "graph_labels": (None,),
                "x": (None, None),
            }
        return out

    def loss_fn(self, shape: str) -> Callable:
        cfg = self._cfg(shape)
        m = self.shapes[shape].meta
        if m["task"] == "graph":
            return lambda p, b: gnn_mod.graph_classification_loss(
                p, {**b, "n_graphs": m["batch"]}, cfg
            )
        return lambda p, b: gnn_mod.node_classification_loss(p, b, cfg)

    def model_flops(self, shape: str) -> float:
        m = self.shapes[shape].meta
        cfg = self._cfg(shape)
        if m["task"] == "graph":
            n = m["batch"] * m["n_nodes"]
            e = 2 * m["batch"] * m["n_edges"]
            d_in = 10
        elif m["task"] == "node_sampled":
            n, e = m["pad_nodes"], 2 * m["pad_edges"] + m["pad_nodes"]
            d_in = m["d_feat"]
        else:
            n, e = m["n_nodes"], 2 * m["n_edges"] + m["n_nodes"]
            d_in = m["d_feat"]
        fl = 0.0
        d_prev = d_in
        for li in range(cfg.n_layers):
            d_out = (cfg.n_classes if li == cfg.n_layers - 1
                     else cfg.d_hidden)
            heads = cfg.n_heads if cfg.kind == "gat" else 1
            fl += 2.0 * n * d_prev * d_out * heads   # transform
            fl += 2.0 * e * d_out * heads            # message agg
            d_prev = d_out * (heads if cfg.kind == "gat"
                              and li < cfg.n_layers - 1 else 1)
        return 3.0 * fl  # fwd + bwd ~ 3x fwd for message passing

    def smoke_bundle(self, device=None):
        """One AdamW step of node classification on a 64-node random
        graph (numpy seed 0; d_in 16, 4 classes, hidden 8) on ``device``
        (default ``cuda``), from weights drawn on the CPU (seed 0)."""
        from ..data.graphs import random_node_graph

        device = resolve_device(device)
        cfg = dataclasses.replace(
            self._cfg("full_graph_sm"), d_in=16, n_classes=4, d_hidden=8
        )
        g = random_node_graph(np.random.default_rng(0), 64, 128, 16, 4)
        params = _smoke_params(gnn_mod.init_params, cfg, device)
        opt = self.optimizer()
        step = _smoke_step(
            lambda p, b: gnn_mod.node_classification_loss(p, b, cfg), opt)
        return step, (params, opt.init(params), _on(g, device))


# ================================================================= MACE
class MACEArch(Arch):
    family = "gnn"
    shapes = GNN_SHAPES

    def __init__(self, cfg: mace_mod.MACEConfig):
        self.name = cfg.name
        self.cfg = cfg

    def abstract_params(self, shape: str) -> PyTree:
        return mace_mod.abstract_params(self.cfg)

    def init_params(self, gen, shape: str, device=None) -> PyTree:
        return mace_mod.init_params(gen, self.cfg, device)

    def param_rules(self):
        return [(r".*", ())]

    def optimizer(self) -> AdamW:
        return AdamW(lr=1e-2)

    def _sizes(self, shape: str):
        m = self.shapes[shape].meta
        if m["task"] == "graph":
            return (m["batch"] * m["n_nodes"],
                    _pad_mult(2 * m["batch"] * m["n_edges"]), m["batch"])
        if m["task"] == "node_sampled":
            return (m["pad_nodes"],
                    _pad_mult(2 * m["pad_edges"] + m["pad_nodes"]), 1)
        return (m["n_nodes"], _pad_mult(2 * m["n_edges"] + m["n_nodes"]), 1)

    def batch_abstract(self, shape: str) -> PyTree:
        n, e, g = self._sizes(shape)
        return {
            "species": _sds((n,), torch.int32),
            "pos": _sds((n, 3), torch.float32),
            "edges": _sds((2, e), torch.int32),
            "graph_id": _sds((n,), torch.int32),
            "targets": _sds((g,), torch.float32),
        }

    def batch_spec_templates(self, shape: str) -> PyTree:
        n, e, _ = self._sizes(shape)
        big = e > 1_000_000
        return {
            "species": (None,),
            "pos": (None, None),
            "edges": (None, DATA) if big else (None, None),
            "graph_id": (None,),
            "targets": (None,),
        }

    def loss_fn(self, shape: str) -> Callable:
        cfg = self.cfg
        g = self._sizes(shape)[2]
        return lambda p, b: mace_mod.energy_loss(
            p, {**b, "n_graphs": g}, cfg
        )

    def model_flops(self, shape: str) -> float:
        n, e, _ = self._sizes(shape)
        C = self.cfg.d_hidden
        per_layer = (
            2.0 * e * self.cfg.n_rbf * C + 2.0 * e * C * C  # radial MLP
            + 2.0 * e * 9 * C                               # messages
            + 2.0 * n * 9 * 3 * C * C                       # mix
            + 2.0 * n * 9 * C * C                           # self
        )
        return 3.0 * self.cfg.n_layers * per_layer

    def smoke_bundle(self, device=None):
        """One AdamW step of the energy loss on 4 random molecules of 8
        atoms and 16 edges (numpy seed 0; d_hidden 16, 2 layers) on
        ``device`` (default ``cuda``), from weights drawn on the CPU
        (seed 0)."""
        from ..data.graphs import random_molecule_batch

        device = resolve_device(device)
        cfg = dataclasses.replace(self.cfg, d_hidden=16, n_layers=2)
        g = random_molecule_batch(np.random.default_rng(0), 4, 8, 16)
        batch = _on({k: v for k, v in g.items() if k in (
            "species", "pos", "edges", "graph_id", "targets")}, device)
        params = _smoke_params(mace_mod.init_params, cfg, device)
        opt = self.optimizer()
        step = _smoke_step(lambda p, b: mace_mod.energy_loss(
            p, {**b, "n_graphs": 4}, cfg), opt)
        return step, (params, opt.init(params), batch)


# =============================================================== recsys
class RecsysArch(Arch):
    family = "recsys"
    shapes = RECSYS_SHAPES

    def __init__(self, cfg: b4r.Bert4RecConfig,
                 smoke_cfg: b4r.Bert4RecConfig):
        self.name = cfg.name
        self.cfg = cfg
        self.smoke_cfg = smoke_cfg

    def abstract_params(self, shape: str) -> PyTree:
        return b4r.abstract_params(self.cfg)

    def init_params(self, gen, shape: str, device=None) -> PyTree:
        return b4r.init_params(gen, self.cfg, device)

    def param_rules(self):
        return [
            (r"item_emb", (MODEL, None)),  # the big table: vocab-sharded
            (r".*", ()),
        ]

    def batch_abstract(self, shape: str) -> PyTree:
        m = self.shapes[shape].meta
        cfg = self.cfg
        if self.shapes[shape].kind == "train":
            return {
                "seq": _sds((m["batch"], cfg.seq_len), torch.int32),
                "masked_pos": _sds((m["batch"], cfg.n_masked), torch.int32),
                "masked_ids": _sds((m["batch"], cfg.n_masked), torch.int32),
                "negatives": _sds((cfg.n_negatives,), torch.int32),
            }
        return {"seq": _sds((m["batch"], cfg.seq_len), torch.int32)}

    def batch_spec_templates(self, shape: str) -> PyTree:
        if self.shapes[shape].kind == "train":
            return {
                "seq": (DATA, None),
                "masked_pos": (DATA, None),
                "masked_ids": (DATA, None),
                "negatives": (None,),
            }
        m = self.shapes[shape].meta
        return {"seq": ((DATA, None) if m["batch"] > 1 else (None, None))}

    def loss_fn(self, shape: str) -> Callable:
        cfg = self.cfg
        return lambda p, b: b4r.masked_item_loss(p, b, cfg)

    def make_serve_step(self, shape: str, mesh=None):
        """The serve and its abstract (params, batch).  Over a mesh, a
        batch of more than one row that the DP size divides takes the
        vocab-sharded serve (``b4r.make_sharded_serve``: each rank's
        block of the scores); any other takes ``serve_scores``."""
        cfg = self.cfg
        params = self.abstract_params(shape)
        batch = self.batch_abstract(shape)
        m = self.shapes[shape].meta
        if mesh is not None and m["batch"] > 1:
            dp = common.dp_axes(mesh)
            if m["batch"] % common.axes_size(mesh, dp) == 0:
                serve = b4r.make_sharded_serve(cfg, mesh, dp)
                return serve, (params, batch)

        def serve(params, batch):
            return b4r.serve_scores(params, batch, cfg)

        return serve, (params, batch)

    def serve_spec_templates(self, shape: str):
        return [self.batch_spec_templates(shape)]

    def model_flops(self, shape: str) -> float:
        m = self.shapes[shape].meta
        cfg = self.cfg
        d, s = cfg.d_model, cfg.seq_len
        per_tok = cfg.n_blocks * (4 * d * d + 2 * d * cfg.d_ff) * 2
        attn = cfg.n_blocks * 4 * s * d * 2
        enc = m["batch"] * (s * per_tok + attn)
        if self.shapes[shape].kind == "train":
            neg = (m["batch"] * cfg.n_masked
                   * (cfg.n_negatives + 1) * d * 2)
            return 3.0 * (enc + neg)
        score = 2.0 * m["batch"] * cfg.n_items * d
        return enc + score

    def smoke_bundle(self, device=None):
        """One AdamW step of the masked-item loss on the smoke config
        over the first 4 sessions of ``session_batches`` (seed 0) on
        ``device`` (default ``cuda``), from weights drawn on the CPU
        (seed 0)."""
        from ..data.recsys import session_batches

        device = resolve_device(device)
        cfg = self.smoke_cfg
        it = session_batches(0, cfg.n_items, 4, cfg.seq_len,
                             cfg.n_masked, cfg.mask_id, cfg.n_negatives)
        params = _smoke_params(b4r.init_params, cfg, device)
        opt = self.optimizer()
        step = _smoke_step(
            lambda p, b: b4r.masked_item_loss(p, b, cfg), opt)
        return step, (params, opt.init(params), _on(next(it), device))


# =============================================================== mining
class MiningArch(Arch):
    """The paper's own workload as an 'architecture': one distributed
    extension-scan step over a sharded DB."""

    family = "mining"
    shapes = MINING_SHAPES

    def __init__(self, name: str = "gtrace-mining"):
        self.name = name

    def abstract_params(self, shape: str) -> PyTree:
        return {}

    def param_rules(self):
        return [(r".*", ())]

    def batch_abstract(self, shape: str) -> PyTree:
        m = self.shapes[shape].meta
        return {
            "tokens": _sds((m["n_seq"], m["tokens"], 6), torch.int32),
            "gid": _sds((m["emb_batch"],), torch.int32),
            "phi": _sds((m["emb_batch"], m["ni"]), torch.int32),
            "psi": _sds((m["emb_batch"], m["nv"]), torch.int32),
            "valid": _sds((m["emb_batch"],), torch.int32),
            "existing": _sds((64, 5), torch.int32),
        }

    def make_step(self, shape: str, mesh=None):
        raise RuntimeError(
            "mining arch lowers via make_mining_step (needs the mesh); "
            "handled specially by launch.dryrun"
        )

    def model_flops(self, shape: str) -> float:
        m = self.shapes[shape].meta
        # useful int-ops per (embedding, token) pair: psi/phi lookups,
        # predicate evaluation, packing  (~ 2*(NV+NI) + 40)
        per_pair = 2.0 * (m["nv"] + m["ni"]) + 40.0
        return m["emb_batch"] * m["tokens"] * per_pair

    def smoke_bundle(self, device=None):
        """Mine 6 random sequences (seed 0) at sigma 2, max_len 3 on
        ``device`` (default ``cuda``); returns the count of rFTSs."""
        from ..core.compile import compile_sequence
        from ..data.synthetic import random_graph_sequence
        from ..mining.driver import AcceleratedMiner

        device = resolve_device(device)
        rng = random.Random(0)
        db = [
            compile_sequence(random_graph_sequence(rng))
            for _ in range(6)
        ]

        def step():
            res = AcceleratedMiner(db, device=device).mine_rs(2, max_len=3)
            return torch.tensor(float(len(res.patterns)))

        return (lambda: step()), ()
