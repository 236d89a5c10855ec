"""Mixture-of-Experts FFN with top-k routing and capacity.

The dispatch follows the JAX package's step for step: tokens are ranked
within their routed expert by a cumsum of one-hots (token-major,
k-minor), routes past the capacity are dropped (their combine weight is
zero and they land in the drop slot), features are scattered into an
[E, C, D] buffer, the expert FFNs run as one grouped einsum, and the
outputs are gathered back and combined with the router weights.

Two standing differences from JAX: ``torch.topk`` and ``jax.lax.top_k``
may order exact ties differently, and on CUDA ``index_add`` sums with
atomics in no fixed order, so the combine may differ run to run by
rounding (never by route).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .layers import act_fn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    act: str = "silu"
    n_shared: int = 0  # shared (always-on) experts, DeepSeek/Llama-4 style


def moe_route(params, xf, cfg: MoEConfig):
    """The router and the capacity rule over the flat tokens xf [N,D]:
    (aux, flat_tok, flat_gate, keep, slot, cap), one entry a route in
    token-major, k-minor order.  A route past its expert's capacity has
    ``keep`` False, gate 0 and the drop slot ``e*cap``."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, math.ceil(n * k / e * cfg.capacity_factor))

    logits = torch.einsum("nd,de->ne", xf.float(), params["wr"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.topk(probs, k, dim=-1)  # [n,k]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): e * sum_e f_e * p_e
    density = torch.mean(
        (F.one_hot(idx_k, e).sum(1) > 0).float(), 0)
    aux = e * torch.sum(density * probs.mean(0))

    flat_expert = idx_k.reshape(-1)  # [n*k]
    flat_gate = gate_k.reshape(-1)
    flat_tok = torch.arange(n, device=xf.device).repeat_interleave(k)

    # rank of each routed token inside its expert
    onehot = F.one_hot(flat_expert, e).to(torch.int32)  # [n*k, e]
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    rank = torch.gather(pos_in_e, 1, flat_expert[:, None])[:, 0]
    keep = rank < cap
    flat_gate = torch.where(keep, flat_gate, 0.0)
    slot = torch.where(keep, flat_expert * cap + rank, e * cap)  # drop slot
    return aux, flat_tok, flat_gate, keep, slot, cap


def moe_ffn(params, x, cfg: MoEConfig):
    """x [B,S,D] -> ([B,S,D], aux).  params: wr [D,E], wi/wg [E,D,F],
    wo [E,F,D] (+ shared_wi/wg/wo when n_shared>0); aux is the Switch
    load-balance loss."""
    b, s, d = x.shape
    n = b * s
    e = cfg.n_experts
    xf = x.reshape(n, d)
    dev = x.device
    aux, flat_tok, flat_gate, keep, slot, cap = moe_route(params, xf, cfg)

    # scatter tokens into [E*C(+1), D]
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=dev)
    buf = buf.index_put((slot,), xf[flat_tok])
    buf = buf[: e * cap].reshape(e, cap, d)

    h = torch.einsum("ecd,edf->ecf", buf, params["wi"])
    if "wg" in params:
        g = torch.einsum("ecd,edf->ecf", buf, params["wg"])
        h = act_fn(cfg.act)(g) * h
    else:
        h = act_fn(cfg.act)(h)
    out_e = torch.einsum("ecf,efd->ecd", h, params["wo"])  # [e,cap,d]

    # gather back and combine with gates
    flat_out = out_e.reshape(e * cap, d)
    gathered = torch.where(
        keep[:, None], flat_out[torch.clamp(slot, 0, e * cap - 1)], 0.0)
    combined = torch.zeros((n, d), dtype=xf.dtype, device=dev).index_add(
        0, flat_tok, gathered * flat_gate[:, None].to(xf.dtype))

    if cfg.n_shared:
        hs = torch.einsum("nd,df->nf", xf, params["shared_wi"])
        if "shared_wg" in params:
            gs = torch.einsum("nd,df->nf", xf, params["shared_wg"])
            hs = act_fn(cfg.act)(gs) * hs
        else:
            hs = act_fn(cfg.act)(hs)
        combined = combined + torch.einsum("nf,fd->nd", hs,
                                           params["shared_wo"])

    return combined.reshape(b, s, d), aux
