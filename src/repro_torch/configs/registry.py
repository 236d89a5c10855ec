"""The architecture pool: ``get_arch(id)`` / ``list_archs()``.

Every arch carries its exact config from the JAX package's table
(sources noted inline) and a reduced smoke config.
"""
from __future__ import annotations

import functools

import torch

from ..models.bert4rec import Bert4RecConfig
from ..models.mace import MACEConfig
from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .families import GNNArch, LMArch, MACEArch, MiningArch, RecsysArch


def _smoke_lm(name, **kw):
    base = dict(
        name=name + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, block_q=16,
        block_kv=16, loss_chunk=16,
    )
    base.update(kw)
    return TransformerConfig(**base)


@functools.cache
def get_arch(arch_id: str):
    if arch_id == "glm4-9b":
        # [hf:THUDM/glm-4-9b] 40L d4096 32H GQA(kv=2) dff 13696 v151552
        cfg = TransformerConfig(
            name="glm4-9b", n_layers=40, d_model=4096, n_heads=32,
            n_kv_heads=2, head_dim=128, d_ff=13696, vocab=151552,
            act="silu", gated_mlp=True, rope_theta=10000.0,
            param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        )
        return LMArch(cfg, _smoke_lm("glm4"))
    if arch_id == "gemma-7b":
        # [arXiv:2403.08295] 28L d3072 16H MHA(kv=16) dff 24576 GeGLU
        # head_dim=256, vocab 256000, tied embeddings
        cfg = TransformerConfig(
            name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
            n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000,
            act="gelu", gated_mlp=True, tie_embeddings=True,
            param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        )
        return LMArch(cfg, _smoke_lm("gemma", act="gelu",
                                     tie_embeddings=True))
    if arch_id == "smollm-135m":
        # [hf:HuggingFaceTB/SmolLM-135M] 30L d576 9H GQA(kv=3) dff 1536
        cfg = TransformerConfig(
            name="smollm-135m", n_layers=30, d_model=576, n_heads=9,
            n_kv_heads=3, head_dim=64, d_ff=1536, vocab=49152,
            act="silu", gated_mlp=True, tie_embeddings=True,
            param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        )
        return LMArch(cfg, _smoke_lm("smollm", tie_embeddings=True))
    if arch_id == "llama4-maverick-400b-a17b":
        # [hf:meta-llama (unverified)] 48L d5120 40H GQA(kv=8) vocab
        # 202048; MoE 128 experts top-1 (+1 shared), dff_expert 8192,
        # dense/MoE interleaved (moe_period=2) -> ~400B total / 17B active
        cfg = TransformerConfig(
            name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
            n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
            vocab=202048, act="silu", gated_mlp=True,
            moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, n_shared=1),
            moe_period=2,
            param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        )
        return LMArch(
            cfg,
            _smoke_lm("llama4", moe=MoEConfig(4, 1, 64, n_shared=1),
                      moe_period=2, n_kv_heads=4),
            opt_state_dtype="int8",
        )
    if arch_id == "olmoe-1b-7b":
        # [arXiv:2409.02060] 16L d2048 16H MHA dff 1024/expert,
        # 64 experts top-8, vocab 50304
        cfg = TransformerConfig(
            name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
            n_kv_heads=16, head_dim=128, d_ff=1024, vocab=50304,
            act="silu", gated_mlp=True,
            moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024),
            moe_period=1,
            param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        )
        return LMArch(
            cfg,
            _smoke_lm("olmoe", moe=MoEConfig(8, 2, 32), moe_period=1,
                      n_kv_heads=4),
        )
    if arch_id == "gcn-cora":
        # [arXiv:1609.02907] 2L hidden 16, sym-norm mean aggregation
        return GNNArch("gcn-cora", "gcn", n_layers=2, d_hidden=16)
    if arch_id == "gat-cora":
        # [arXiv:1710.10903] 2L hidden 8, 8 heads, attn aggregation
        return GNNArch("gat-cora", "gat", n_layers=2, d_hidden=8,
                       n_heads=8)
    if arch_id == "gin-tu":
        # [arXiv:1810.00826] 5L hidden 64, sum agg, learnable eps
        return GNNArch("gin-tu", "gin", n_layers=5, d_hidden=64)
    if arch_id == "mace":
        # [arXiv:2206.07697] 2L hidden 128 l_max=2 corr=3 n_rbf=8
        return MACEArch(MACEConfig(name="mace", n_layers=2, d_hidden=128,
                                   l_max=2, correlation=3, n_rbf=8))
    if arch_id == "bert4rec":
        # [arXiv:1904.06690] embed 64, 2 blocks, 2 heads, seq 200.
        # Catalog 2^20-2 items so the table shards 16-way evenly.
        cfg = Bert4RecConfig(name="bert4rec", n_items=1_048_574)
        smoke = Bert4RecConfig(name="bert4rec-smoke", n_items=1000,
                               seq_len=32, n_masked=4, n_negatives=32,
                               v_chunk=256)
        return RecsysArch(cfg, smoke)
    if arch_id == "gtrace-mining":
        return MiningArch()
    raise KeyError(arch_id)


ARCH_IDS = [
    "glm4-9b",
    "gemma-7b",
    "smollm-135m",
    "llama4-maverick-400b-a17b",
    "olmoe-1b-7b",
    "mace",
    "gcn-cora",
    "gat-cora",
    "gin-tu",
    "bert4rec",
]

EXTRA_IDS = ["gtrace-mining"]


def list_archs(include_extra: bool = False):
    return ARCH_IDS + (EXTRA_IDS if include_extra else [])
