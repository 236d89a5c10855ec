"""Attention: the blockwise (flash-style) causal training path, GQA, and
the KV-cache decode path.

The training path never materializes the [S, S] score matrix: queries
are processed against key/value blocks with an online-softmax
accumulator.  ``jax.lax.scan`` over the block pairs becomes a Python
loop; scores and accumulators stay in fp32, as JAX's do.  Eagerly, each
pair's scores are kept for the backward pass (the JAX scan saves the
same residuals), so the transformer's remat bounds this to one
superblock at a time.

The JAX package pins shardings inside these functions
(``constrain_dims``, ``with_sharding_constraint``); here a constraint
redistributes a DTensor (``launch.dryrun``'s auto-sharded cells) and is
the identity on a plain tensor, which has no sharding to constrain.
"""
from __future__ import annotations

import math

import torch

from .common import P, axes_size, spec_placements

NEG_INF = -1e30


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain_dims(x, dim_axes):
    """``with_sharding_constraint(x, P(...))`` with ``dim_axes`` {dim:
    mesh axes}: a DTensor is redistributed to that layout (every other
    dim replicated); a dim its axes do not divide is left out, and a
    plain tensor is returned as it is."""
    if not dim_axes or not _is_dtensor(x):
        return x
    spec = [None] * x.ndim
    any_set = False
    for dim, axes in dim_axes.items():
        if not axes:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        if x.shape[dim] % axes_size(x.device_mesh, axes) != 0:
            continue
        spec[dim] = axes if len(axes) > 1 else axes[0]
        any_set = True
    if not any_set:
        return x
    return x.redistribute(x.device_mesh,
                          spec_placements(P(*spec), x.device_mesh))


def constrain_batch(x, batch_axes, dim: int = 0):
    return constrain_dims(x, {dim: batch_axes})


def _on_local_blocks(fn, q, k, v, batch_axes, model_axes, **kw):
    """``fn`` on each rank's block of DTensors q [B,S,H,hd], k/v
    [B,S,KV,hd], as the JAX function's constraints partition it: batch
    over ``batch_axes`` where it divides, heads over ``model_axes`` where
    the kv heads divide (whole GQA groups per rank), the rest gathered;
    attention is then independent per block.  Returns a DTensor."""
    from torch.distributed.tensor import DTensor

    mesh = q.device_mesh
    model_axes, batch = tuple(model_axes), tuple(batch_axes)
    spec = [None, None, None, None]
    if batch and q.shape[0] % axes_size(mesh, batch) == 0:
        spec[0] = batch if len(batch) > 1 else batch[0]
    if k.shape[2] % axes_size(mesh, model_axes) == 0:
        spec[2] = model_axes if len(model_axes) > 1 else model_axes[0]
    place = spec_placements(P(*spec), mesh)
    q, k, v = (x.redistribute(mesh, place) for x in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=q.shape, stride=q.stride())


def _gqa_expand(q, n_kv):
    """[B,S,H,hd] -> [B,S,KV,H/KV,hd]."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _default_scale(hd: int) -> float:
    return 1.0 / math.sqrt(hd)


def _merge_heads(o, b, s, h, hd):
    """[B,S,G,KV,hd] -> [B,S,H,hd] with head = kv * G + g."""
    return o.permute(0, 1, 3, 2, 4).reshape(b, s, h, hd)


def blockwise_causal_attention(q, k, v, *, block_q: int = 512,
                               block_kv: int = 512, scale=None,
                               schedule: str = "triangular",
                               batch_axes=(), model_axes=("model",)):
    """Causal GQA attention without materializing S x S scores.

    q [B,S,H,hd], k/v [B,S,KV,hd]; H % KV == 0.  Returns [B,S,H,hd].

    schedule:
    * "triangular" - one pass over the statically enumerated
      lower-triangular (q-block, kv-block) pairs: fully masked pairs are
      never computed; the accumulators reset at each q-block's last pair.
    * "full" - the naive all-pairs grid (kept as the measured baseline).

    Masking is an additive [block_q, block_kv] penalty (0 or NEG_INF).
    DTensor inputs run on each rank's block (``_on_local_blocks``).
    """
    if _is_dtensor(q):
        return _on_local_blocks(
            blockwise_causal_attention, q, k, v, batch_axes, model_axes,
            block_q=block_q, block_kv=block_kv, scale=scale,
            schedule=schedule)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = scale if scale is not None else _default_scale(hd)
    block_q = min(block_q, s)
    block_kv = min(block_kv, s)
    assert s % block_q == 0 and s % block_kv == 0, (s, block_q, block_kv)
    nq, nk = s // block_q, s // block_kv
    dev = q.device

    qg = _gqa_expand(q, kv).float() * scale
    kf = k.float()
    vf = v.float()
    q_blocks = qg.reshape(b, nq, block_q, kv, g, hd)
    ar_q = torch.arange(block_q, device=dev)
    ar_k = torch.arange(block_kv, device=dev)

    def kv_block(ki):
        lo = ki * block_kv
        return kf[:, lo:lo + block_kv], vf[:, lo:lo + block_kv]

    if schedule == "triangular":
        pairs = [
            (qi, ki)
            for qi in range(nq)
            for ki in range(nk)
            if ki * block_kv <= qi * block_q + block_q - 1
        ]
        outs = []
        m = torch.full((b, block_q, g, kv), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, block_q, g, kv), dtype=torch.float32,
                        device=dev)
        o = torch.zeros((b, block_q, g, kv, hd), dtype=torch.float32,
                        device=dev)
        for i, (qi, ki) in enumerate(pairs):
            last = i + 1 == len(pairs) or pairs[i + 1][0] != qi
            qb = q_blocks[:, qi]
            kb, vb = kv_block(ki)
            sc = torch.einsum("bqkgd,bskd->bqgks", qb, kb)
            # additive causal penalty for the (possibly) diagonal block
            dq = qi * block_q + ar_q
            dk = ki * block_kv + ar_k
            pen = torch.where(dq[:, None] >= dk[None, :], 0.0, NEG_INF)
            sc = sc + pen[None, :, None, None, :]
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_new = l * corr + p.sum(-1)
            o_new = o * corr[..., None] + torch.einsum(
                "bqgks,bskd->bqgkd", p, vb)
            if last:
                done = o_new / torch.clamp(l_new, min=1e-30)[..., None]
                outs.append(done.to(q.dtype))
                # reset the accumulators when a q block completes
                m = torch.full_like(m_new, NEG_INF)
                l = torch.zeros_like(l_new)
                o = torch.zeros_like(o_new)
            else:
                m, l, o = m_new, l_new, o_new
        out = torch.stack(outs, 1).reshape(b, s, g, kv, hd)
        return _merge_heads(out, b, s, h, hd).to(q.dtype)

    # ---- "full" baseline schedule (all block pairs) ----
    outs = []
    for qi in range(nq):
        qb = q_blocks[:, qi]
        q_pos = qi * block_q + ar_q
        m = torch.full((b, block_q, g, kv), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, block_q, g, kv), dtype=torch.float32,
                        device=dev)
        o = torch.zeros((b, block_q, g, kv, hd), dtype=torch.float32,
                        device=dev)
        for ki in range(nk):
            kb, vb = kv_block(ki)
            sc = torch.einsum("bqkgd,bskd->bqgks", qb, kb)
            k_pos = ki * block_kv + ar_k
            mask = q_pos[:, None] >= k_pos[None, :]
            sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bqgks,bskd->bqgkd", p,
                                                   vb)
            m = m_new
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, 1).reshape(b, s, g, kv, hd)
    return _merge_heads(out, b, s, h, hd).to(q.dtype)


def naive_causal_attention(q, k, v, scale=None):
    """Reference O(S^2)-memory attention (tests only)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    scale = scale if scale is not None else _default_scale(hd)
    qg = _gqa_expand(q, kv).float() * scale
    sc = torch.einsum("bqkgd,bskd->bqgks", qg, k.float())
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqgks,bskd->bqgkd", p, v.float())
    return _merge_heads(out, b, s, h, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, scale=None):
    """One-step decode: q [B,1,H,hd] against cache [B,S,KV,hd].

    Positions >= cache_len are masked.  The softmax over the cache axis
    is a plain max and sum."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    scale = scale if scale is not None else _default_scale(hd)
    qg = _gqa_expand(q, kv).float() * scale  # [B,1,KV,G,hd]
    sc = torch.einsum("bqkgd,bskd->bqgks", qg, k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < cache_len[:, None]  # [B,S]
    sc = torch.where(mask[:, None, None, None, :], sc, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqgks,bskd->bqgkd", p / l, v_cache.float())
    return _merge_heads(out, b, 1, h, hd).to(q.dtype)
