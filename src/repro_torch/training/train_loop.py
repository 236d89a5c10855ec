"""Generic training loop used by launch/train.py: gradient accumulation,
clipping, checkpoint/restart.

Nothing is jitted and nothing is donated, as the JAX step is: the step
runs eagerly, and the old params and state are dropped by the caller
once the new ones are returned.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterator, Optional

import torch

from ..models.common import tree_map, value_and_grad
from .checkpoint import restore, save
from .optimizer import AdamW, clip_by_global_norm

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt_state: PyTree
    step: int = 0


def make_step_fn(loss_fn: Callable, opt: AdamW, grad_accum: int = 1,
                 clip: float = 1.0):
    """(params, opt_state, batch) -> (loss, params, opt_state).  The
    batch's leading dim must be divisible by ``grad_accum``; the
    microbatches' grads are summed in fp32 and divided by
    ``grad_accum``."""
    vg = value_and_grad(loss_fn)

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = vg(params, batch)
        else:
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(grad_accum):
                mb = tree_map(
                    lambda x: x.reshape(grad_accum, -1, *x.shape[1:])[i],
                    batch)
                l, g = vg(params, mb)
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        grads = clip_by_global_norm(grads, clip)
        params, opt_state = opt.update(grads, opt_state, params)
        return loss, params, opt_state

    return step


def train(
    loss_fn: Callable,
    init_params: PyTree,
    batches: Iterator[PyTree],
    n_steps: int,
    opt: Optional[AdamW] = None,
    grad_accum: int = 1,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 100,
    resume: bool = False,
    log_every: int = 10,
    log: Callable[[str], None] = print,
):
    opt = opt or AdamW(lr=1e-3)
    params = init_params
    opt_state = opt.init(params)
    start = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        (params, opt_state), start = restore(
            checkpoint_path, (params, opt_state))
        log(f"[train] resumed from step {start}")
    step_fn = make_step_fn(loss_fn, opt, grad_accum)
    losses = []
    t0 = time.time()
    pending = None
    for step in range(start, n_steps):
        batch = next(batches)
        loss, params, opt_state = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if (step + 1) % log_every == 0:
            dt = (time.time() - t0) / log_every
            log(f"[train] step {step+1}/{n_steps} "
                f"loss={sum(losses[-log_every:])/log_every:.4f} "
                f"{dt*1e3:.0f} ms/step")
            t0 = time.time()
        if checkpoint_path and (step + 1) % checkpoint_every == 0:
            if pending is not None:
                pending.join()
            pending = save(checkpoint_path, (params, opt_state), step + 1,
                           async_=True)
    if pending is not None:
        pending.join()
    if checkpoint_path:
        save(checkpoint_path, (params, opt_state), n_steps)
    return params, opt_state, losses
