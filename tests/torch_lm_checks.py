"""Checks of the port's LM family on the card against the same code on the
CPU, shared by ``tests/test_torch_models_cuda.py`` and ``chip_smoke.py``
(phase 11).  Imports torch and the port only.

Each check raises AssertionError on a difference past its tolerance and
returns the largest differences it saw.  Matrix products in fp32 run in
full fp32 on the card (TF32 off, set by the caller).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves_with_path, tree_map, \
    value_and_grad
from repro_torch.training.optimizer import clip_by_global_norm

# bf16 compute: the loss within 2e-2 relative (bf16 rounds in other
# places on the two devices); fp32 compute: loss, grads and updated
# params within 1e-4 (atol and rtol)
BF16_RTOL, FP32_TOL = 2e-2, 1e-4
# the JAX decode test's tolerance (tests/test_archs.py)
DECODE_TOL = 2e-4


def _max_err(got, want, tol):
    """Largest |got - want| over two trees, raising past atol + rtol."""
    worst = 0.0
    flat = dict(tree_leaves_with_path(want))
    for path, g in tree_leaves_with_path(got):
        w = flat[path].to(g.device).float()
        g = g.float()
        err = (g - w).abs()
        bad = err > tol + tol * w.abs()
        if bool(bad.any()):
            raise AssertionError(
                f"{'/'.join(map(str, path))}: max |diff| "
                f"{float(err.max()):.3g} past {tol} (atol and rtol)")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def smoke_step_vs_cpu(arch_id: str) -> dict:
    """The arch's smoke train step on ``cuda`` against the same step on
    the CPU from the same weights and batch.

    bf16 compute (the smoke config as it is): the smoke bundle's step on
    each device, losses within ``BF16_RTOL``.  fp32 compute: loss and
    grads within ``FP32_TOL``; then the arch's optimizer (clip 1.0, its
    state dtype: int8 for llama4) applied on the card to the CPU's grads,
    params and state within ``FP32_TOL`` of the CPU's update (the same
    grads on both sides: with eps 1e-8 a grad near zero turns rounding
    into a ±lr step)."""
    arch = get_arch(arch_id)
    step_c, (params_c, opt_c, batch_c) = arch.smoke_bundle(device="cuda")
    step_h, (params_h, opt_h, batch_h) = arch.smoke_bundle(device="cpu")
    loss_c = float(step_c(params_c, opt_c, batch_c)[0])
    loss_h = float(step_h(params_h, opt_h, batch_h)[0])
    rel = abs(loss_c - loss_h) / abs(loss_h)
    if not rel <= BF16_RTOL:
        raise AssertionError(f"{arch_id} bf16 loss {loss_c} on cuda vs "
                             f"{loss_h} on the CPU: rel {rel:.3g}")

    cfg = dataclasses.replace(arch.smoke_cfg, compute_dtype=torch.float32)
    vg = value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg))
    l32_c, g_c = vg(params_c, batch_c)
    l32_h, g_h = vg(params_h, batch_h)
    out = {"bf16_loss_rel": rel,
           "fp32_loss": _max_err({"l": l32_c}, {"l": l32_h}, FP32_TOL),
           "fp32_grads": _max_err(g_c, g_h, FP32_TOL)}
    opt = arch.optimizer()
    g_h = clip_by_global_norm(g_h, 1.0)
    new_h, state_h = opt.update(g_h, opt.init(params_h), params_h)
    g_on_card = tree_map(lambda g: g.to("cuda"), g_h)
    new_c, state_c = opt.update(g_on_card, opt.init(params_c), params_c)
    out["fp32_update"] = max(_max_err(new_c, new_h, FP32_TOL),
                             _max_err(state_c.m, state_h.m, FP32_TOL),
                             _max_err(state_c.v, state_h.v, FP32_TOL))
    out.update(loss_cuda=loss_c, loss_cpu=loss_h)
    return out


def decode_vs_forward(params, tokens, cfg, tol: float = DECODE_TOL
                      ) -> float:
    """``decode_step`` token by token over ``tokens`` [B, S] against
    ``forward`` + ``logits_fn`` of the whole sequence: every step's
    logits within ``tol``.  Returns the largest difference."""
    b, s = tokens.shape
    with torch.no_grad():
        hidden, _ = tf.forward(params, tokens, cfg)
        full = tf.logits_fn(params, hidden, cfg).float()
        cache = tf.init_cache(cfg, b, s, device=tokens.device)
        worst = 0.0
        for t in range(s):
            logits, cache = tf.decode_step(params, cache,
                                           tokens[:, t:t + 1], cfg)
            worst = max(worst, _max_err({"x": logits[:, 0]},
                                        {"x": full[:, t]}, tol))
    return worst
