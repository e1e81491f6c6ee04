"""Hermes2-Pro-8B (paper §IV, week 1) — Llama-3-8B base with the Hermes
function-calling fine-tune's extended vocab [hf:NousResearch/Hermes-2-Pro-Llama-3-8B].
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128288
"""
from repro_torch.common.registry import register_arch
from repro_torch.config import ModelConfig


@register_arch("hermes2-pro-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="hermes2-pro-8b",
        family="transformer",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128288,
        rope_theta=5e5,
    )
