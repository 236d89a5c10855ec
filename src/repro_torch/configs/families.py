"""Family adapters with the uniform Arch surface (see base.py): the LM
family and the mining arch.  ``GNNArch``, ``MACEArch`` and
``RecsysArch`` come with the GNN / MACE / recsys slice, and
``param_rules`` / ``serve_spec_templates`` / ``batch_spec_templates``
with the dry-run slice."""
from __future__ import annotations

import random
from typing import Any, Callable

import numpy as np
import torch

from ..kernels import resolve_device
from ..models import transformer as tf
from ..models.common import tree_map, value_and_grad
from ..training.optimizer import AdamW
from .base import Arch, LM_SHAPES, MINING_SHAPES, _sds

PyTree = Any
DATA = "DATA"
MODEL = "MODEL"


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

    def loss_fn(self, shape: str) -> Callable:
        cfg = self.cfg
        return lambda params, batch: tf.lm_loss(params, batch, cfg)

    # ---- serve / prefill
    def make_serve_step(self, shape: str, mesh=None):
        sd = self.shapes[shape]
        m = sd.meta
        cfg = self.cfg
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
        gen = torch.Generator().manual_seed(0)
        params = tf.init_params(gen, cfg, torch.device("cpu"))
        params = tree_map(lambda x: x.to(device), params)
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
        toks = torch.as_tensor(toks, dtype=torch.int32, device=device)
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        opt = AdamW(lr=1e-3)
        opt_state = opt.init(params)
        vg = value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg))

        def step(params, opt_state, batch):
            loss, grads = vg(params, batch)
            params, opt_state = opt.update(grads, opt_state, params)
            return loss, params, opt_state

        return step, (params, opt_state, batch)


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
