"""Reduced configs: same structure, tiny dimensions.

Used by the port's CPU parity tests, which reduce a config exactly as the
JAX package does for the transformer and mamba2 families, so both packages
build the same shapes: GQA ratios, head-dim rule, biases, SSD chunking and
the SSM group count stay; only widths, depth and vocab shrink.
"""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig, SSMConfig


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    kw = {}
    kw["d_model"] = 64
    kw["vocab_size"] = 512
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = max(1, min(cfg.num_kv_heads * 4 // max(cfg.num_heads, 1), 4))
        kw["head_dim"] = 16 if cfg.head_dim != 2 * (cfg.d_model // max(cfg.num_heads, 1)) else 32
    kw["d_ff"] = 128 if cfg.d_ff else 0
    kw["num_layers"] = min(cfg.num_layers, 3)
    if cfg.family == "mamba2":
        kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                              conv_width=cfg.ssm.conv_width, chunk_size=8,
                              ngroups=cfg.ssm.ngroups)
    kw["name"] = cfg.name + "-reduced"
    return dataclasses.replace(cfg, **kw)
