"""llama4-scout-17b-a16e [moe] — MoE top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
"""
from repro_torch.common.registry import register_arch
from repro_torch.config import ModelConfig, MoEConfig


@register_arch("llama4-scout-17b-a16e")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        moe=MoEConfig(num_experts=16, experts_per_token=1, d_ff=8192,
                      shared_expert=True),
        rope_theta=5e5,
    )
