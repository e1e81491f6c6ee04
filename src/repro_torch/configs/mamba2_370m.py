"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060]
48L d_model=1024 (attn-free) vocab=50280, ssm_state=128
"""
from repro_torch.common.registry import register_arch
from repro_torch.config import ModelConfig, SSMConfig


@register_arch("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="mamba2",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk_size=128, ngroups=1),
        subquadratic=True,
        tie_embeddings=True,
    )
