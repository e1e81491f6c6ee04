"""Llama3.1-8B (paper §IV, week 2) [hf:meta-llama/Llama-3.1-8B].
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
"""
from repro_torch.common.registry import register_arch
from repro_torch.config import ModelConfig


@register_arch("llama3.1-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.1-8b",
        family="transformer",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=5e5,
    )
