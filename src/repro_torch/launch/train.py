"""Training launcher: trains an LM arch's smoke config on synthetic
tokens, with checkpoint/restart.

    python -m repro_torch.launch.train --arch smollm-135m --steps 100

It runs on ``cuda`` unless ``--device cpu`` is given, and raises where
no CUDA device is present; there is no fallback from one to the other.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs.registry import get_arch
from ..data.lm import token_batches
from ..kernels import resolve_device
from ..models import transformer as tf
from ..training.optimizer import AdamW, cosine_schedule
from ..training.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit(f"train.py drives the LM archs, not {args.arch}")
    cfg = arch.smoke_cfg

    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device)
    batches = (
        {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        for b in token_batches(0, cfg.vocab, args.batch, args.seq)
    )
    opt = AdamW(lr=cosine_schedule(1e-3, 30, args.steps), weight_decay=0.01)
    _, _, losses = train(
        lambda p, b: tf.lm_loss(p, b, cfg),
        params, batches, args.steps, opt=opt,
        grad_accum=args.grad_accum,
        checkpoint_path=args.checkpoint, resume=args.resume,
    )
    print(f"[train] first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean loss {np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
