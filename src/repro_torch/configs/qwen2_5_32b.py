"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-32B]
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
"""
from repro_torch.common.registry import register_arch
from repro_torch.config import ModelConfig


@register_arch("qwen2.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="transformer",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
    )
