"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242]
81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64
Layout: every 6th block application is a shared attention+MLP block
(2 alternating weight sets — Zamba2's parameter-sharing trick).
"""
from repro_torch.common.registry import register_arch
from repro_torch.config import ModelConfig, SSMConfig


@register_arch("zamba2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,             # MHA in the shared block
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                      chunk_size=128, ngroups=1),
        attn_every=6,
        num_shared_attn_sets=2,
        subquadratic=True,
    )
