"""Arch x shape grid: every architecture is an ``Arch`` exposing a uniform
surface to the launchers:

* ``abstract_params(shape)`` / ``init_params(gen, shape, device)``
* ``make_step(shape)``   -> (step_fn, abstract example args)
* ``model_flops(shape)`` -> useful-work FLOPs for the roofline ratio
* ``smoke_bundle()``     -> reduced-config one-step closure and inputs

Abstract values are tensors on the ``meta`` device, where the JAX
package has ``jax.ShapeDtypeStruct``.  Step kinds: "train" runs
loss+grad+optimizer; "prefill"/"serve"/"score" run the inference path
the shape dictates.  The sharding surface of the JAX module
(``arg_specs``, ``resolve_batch``, ``opt_state_specs``) comes with the
dry-run slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..models.common import value_and_grad
from ..training.optimizer import AdamW, clip_by_global_norm

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str  # train | prefill | serve | score
    meta: Dict[str, Any]


LM_SHAPES = {
    "train_4k": ShapeDef("train_4k", "train",
                         {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeDef("prefill_32k", "prefill",
                            {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeDef("decode_32k", "serve",
                           {"seq": 32768, "batch": 128}),
    "long_500k": ShapeDef("long_500k", "serve",
                          {"seq": 524288, "batch": 1}),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeDef(
        "full_graph_sm", "train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
         "n_classes": 7, "task": "node"},
    ),
    "minibatch_lg": ShapeDef(
        "minibatch_lg", "train",
        {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
         "fanout": (15, 10), "d_feat": 602, "n_classes": 41,
         "task": "node_sampled",
         # padded static sizes for one sampled block
         "pad_nodes": 180224, "pad_edges": 179200},
    ),
    "ogb_products": ShapeDef(
        "ogb_products", "train",
        {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
         "n_classes": 47, "task": "node"},
    ),
    "molecule": ShapeDef(
        "molecule", "train",
        {"n_nodes": 30, "n_edges": 64, "batch": 128, "task": "graph",
         "n_classes": 2, "d_feat": 10},
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeDef("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeDef("serve_p99", "score", {"batch": 512}),
    "serve_bulk": ShapeDef("serve_bulk", "score", {"batch": 262144}),
    "retrieval_cand": ShapeDef(
        "retrieval_cand", "score", {"batch": 1, "n_candidates": 1_000_000}
    ),
}

MINING_SHAPES = {
    "scan_1m": ShapeDef(
        "scan_1m", "mine",
        {"n_seq": 1_048_576, "tokens": 128, "emb_batch": 4096, "ni": 16,
         "nv": 12, "k": 8192},
    ),
    "scan_xl": ShapeDef(
        "scan_xl", "mine",
        {"n_seq": 262144, "tokens": 512, "emb_batch": 16384, "ni": 16,
         "nv": 12, "k": 8192},
    ),
}


def _sds(shape, dtype) -> torch.Tensor:
    """An abstract value: a ``meta`` tensor of this shape and dtype."""
    return torch.empty(shape, dtype=dtype, device="meta")


class Arch:
    name: str
    family: str
    shapes: Dict[str, ShapeDef]

    # ---- to implement per family ----
    def abstract_params(self, shape: str) -> PyTree:
        raise NotImplementedError

    def init_params(self, gen, shape: str, device=None) -> PyTree:
        raise NotImplementedError

    def batch_abstract(self, shape: str) -> PyTree:
        raise NotImplementedError

    def loss_fn(self, shape: str) -> Callable:
        raise NotImplementedError

    def model_flops(self, shape: str) -> float:
        raise NotImplementedError

    def smoke_bundle(self, device=None) -> Tuple[Callable, PyTree]:
        """(one-step closure, inputs) on a reduced config; returns loss."""
        raise NotImplementedError

    # ---- shared machinery ----
    def optimizer(self) -> AdamW:
        return AdamW(lr=1e-3, weight_decay=0.01)

    def make_train_step(self, shape: str, mesh=None):
        """(params, opt_state, batch) -> (loss, params, opt_state): value
        and grad, clip at 1.0, the optimizer; with the abstract args."""
        loss_fn = self.loss_fn(shape)
        opt = self.optimizer()
        vg = value_and_grad(loss_fn)

        def train_step(params, opt_state, batch):
            loss, grads = vg(params, batch)
            grads = clip_by_global_norm(grads, 1.0)
            params, opt_state = opt.update(grads, opt_state, params)
            return loss, params, opt_state

        params = self.abstract_params(shape)
        opt_state = opt.init(params)
        batch = self.batch_abstract(shape)
        return train_step, (params, opt_state, batch)

    def make_step(self, shape: str, mesh=None):
        kind = self.shapes[shape].kind
        if kind == "train":
            return self.make_train_step(shape, mesh)
        return self.make_serve_step(shape, mesh)

    def make_serve_step(self, shape: str, mesh=None):
        raise NotImplementedError
