"""Hand-rolled optimizers over dicts of tensors, as the JAX package's are
over pytrees: an update takes (grads, state, params) and returns new
params and a new state; nothing is updated in place.  (Not a
``torch.optim.Optimizer``: the configs call this functional API.)

* ``AdamW`` - AdamW with decoupled weight decay, its moments kept in
  float32, bfloat16 or int8 (rowwise absmax codes and one fp32 scale per
  last-axis row, with the v floor and the update clip of the int8 mode).
* gradient clipping by global norm and cosine LR schedule with warmup.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..models.common import (
    tree_flatten_up_to,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

PyTree = Any
BLOCK = 256


# --------------------------------------------------------------- schedule
def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(1.0, warmup)
        prog = torch.clamp((step - warmup) / max(1.0, total - warmup),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree)


# -------------------------------------------------- 8-bit rowwise quant
# One fp32 absmax scale per last-axis row; codes keep the param's shape.
# torch.round and jnp.round both round half to even.
def _quant_row(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, 1.0)
    q = torch.clamp(torch.round(x / scale * 127.0), -127, 127).to(
        torch.int8)
    return q, scale.float()


def _dequant_row(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale / 127.0


# ---------------------------------------------------------------- adamw
class AdamWState(NamedTuple):
    step: torch.Tensor
    m: PyTree
    v: PyTree


_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: str = "float32"  # float32 | bfloat16 | int8

    # --- state ---
    def init(self, params: PyTree) -> AdamWState:
        if self.state_dtype == "int8":
            def zero(x):
                q, s = _quant_row(torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device))
                return {"q": q, "s": s}
        else:
            dt = _STATE_DTYPES[self.state_dtype]

            def zero(x):
                return torch.zeros(x.shape, dtype=dt, device=x.device)
        device = next(iter(tree_leaves(params))).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(zero, params),
            v=tree_map(zero, params),
        )

    def _load(self, s, is_v: bool = False):
        if self.state_dtype == "int8":
            val = _dequant_row(s["q"], s["s"])
            if is_v:
                # floor the second moment at its quantization resolution:
                # coords whose v underflows the int8 grid would otherwise
                # divide by eps and explode the update
                floor = (s["s"] / 127.0) ** 2 * 0.25
                val = torch.maximum(val, floor)
            return val
        return s.float()

    def _store(self, val):
        if self.state_dtype == "int8":
            q, s = _quant_row(val)
            return {"q": q, "s": s}
        return val.to(_STATE_DTYPES[self.state_dtype])

    # --- update ---
    def update(self, grads: PyTree, state: AdamWState, params: PyTree
               ) -> Tuple[PyTree, AdamWState]:
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        flat_p = tree_leaves(params)
        flat_g = tree_flatten_up_to(params, grads)
        flat_m = tree_flatten_up_to(params, state.m)
        flat_v = tree_flatten_up_to(params, state.v)
        new_p, new_m, new_v = [], [], []
        for p, g, m_s, v_s in zip(flat_p, flat_g, flat_m, flat_v):
            g32 = g.float()
            m = b1 * self._load(m_s) + (1 - b1) * g32
            v = b2 * self._load(v_s, is_v=True) + (1 - b2) * g32 * g32
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.state_dtype == "int8":
                # update clipping (Dettmers-style stability guard)
                upd = torch.clamp(upd, -5.0, 5.0)
            upd = upd + self.weight_decay * p.float()
            new_p.append((p.float() - lr * upd).to(p.dtype))
            new_m.append(self._store(m))
            new_v.append(self._store(v))
        return (
            tree_unflatten(params, new_p),
            AdamWState(
                step=step,
                m=tree_unflatten(params, new_m),
                v=tree_unflatten(params, new_v),
            ),
        )


def sgd_momentum(lr: float = 0.1, momentum: float = 0.9):
    """Minimal SGD+momentum (used by GNN configs, matching their papers)."""

    class _SGD:
        def init(self, params):
            device = next(iter(tree_leaves(params))).device
            return AdamWState(
                step=torch.zeros((), dtype=torch.int32, device=device),
                m=tree_map(lambda x: torch.zeros(x.shape,
                                                 dtype=torch.float32,
                                                 device=x.device), params),
                v=None,
            )

        def update(self, grads, state, params):
            m = tree_map(lambda mm, g: momentum * mm + g.float(),
                         state.m, grads)
            new_p = tree_map(
                lambda p, mm: (p.float() - lr * mm).to(p.dtype), params, m)
            return new_p, AdamWState(step=state.step + 1, m=m, v=None)

    return _SGD()
