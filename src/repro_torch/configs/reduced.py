"""Reduced configs: same structure, tiny dimensions.

Used by the port's CPU parity tests, which reduce a config exactly as the
JAX package does for the transformer, MoE, mamba2 and hybrid families, so
both packages build the same shapes: GQA ratios, head-dim rule, biases, SSD
chunking, the SSM group count, top-k routing, the shared expert and the
hybrid's shared-attention layout stay; only widths, depth, vocab and the
expert count shrink.
"""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig, MoEConfig, SSMConfig


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    kw = {}
    kw["d_model"] = 64
    kw["vocab_size"] = 512
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = max(1, min(cfg.num_kv_heads * 4 // max(cfg.num_heads, 1), 4))
        kw["head_dim"] = 16 if cfg.head_dim != 2 * (cfg.d_model // max(cfg.num_heads, 1)) else 32
    kw["d_ff"] = 128 if cfg.d_ff else 0
    if cfg.family == "hybrid":
        kw["num_layers"] = 7           # 2 groups of (2 mamba + attn) + 1 tail
        kw["attn_every"] = 3
    else:
        kw["num_layers"] = min(cfg.num_layers, 3)
    if cfg.family == "moe":
        kw["moe"] = MoEConfig(
            num_experts=4,
            experts_per_token=cfg.moe.experts_per_token,
            d_ff=96,
            shared_expert=cfg.moe.shared_expert,
            # no capacity drops at smoke scale (the JAX package's choice)
            capacity_factor=8.0,
        )
    if cfg.family in ("mamba2", "hybrid"):
        kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                              conv_width=cfg.ssm.conv_width, chunk_size=8,
                              ngroups=cfg.ssm.ngroups)
    kw["name"] = cfg.name + "-reduced"
    return dataclasses.replace(cfg, **kw)
