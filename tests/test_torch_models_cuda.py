"""The LM family on the card: the five smoke configs' train step on cuda
held to the same step on the CPU, and decode against forward on the
card.  Imports torch and the port only, so it runs on a machine with
the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_models_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer as tf
from torch_lm_checks import decode_vs_forward, smoke_step_vs_cpu

LM_IDS = ["glm4-9b", "gemma-7b", "smollm-135m",
          "llama4-maverick-400b-a17b", "olmoe-1b-7b"]


def _needs_card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_smoke_step_cuda_vs_cpu(arch_id):
    _needs_card()
    errs = smoke_step_vs_cpu(arch_id)
    assert np.isfinite(errs["loss_cuda"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["glm4-9b", "gemma-7b", "smollm-135m"])
def test_decode_matches_forward_cuda(arch_id):
    """The dense archs: an MoE layer's capacity depends on how many
    tokens a call routes, so decode and forward drop different routes
    (in the JAX package too)."""
    _needs_card()
    cfg = dataclasses.replace(get_arch(arch_id).smoke_cfg,
                              compute_dtype=torch.float32)
    params = tf.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)), dtype=torch.int32, device="cuda")
    assert decode_vs_forward(params, toks, cfg) <= 2e-4
