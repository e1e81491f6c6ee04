"""Config dataclasses of the port: models and runtime switches.

`ModelConfig` holds the fields of the JAX package's model description that
the served models set or rely on, under the same names and defaults: the
dense SwiGLU transformer of carboncall-qwen2-7b (full causal attention, no
softcaps, no post-block norms, untied LM head), the attention-free Mamba2
LM of mamba2-370m (`SSMConfig`, tied embeddings), the MoE transformer of
phi3.5-moe and llama4-scout (`MoEConfig`) and the Zamba2 hybrid (a Mamba2
backbone with shared attention blocks: `attn_every`,
`num_shared_attn_sets`). Sliding windows, softcaps, post-block norms and
the encoder-decoder and vision fields come with the slices that port models
that use them (ROADMAP Queue 1). Of its derived quantities the port needs
`resolved_head_dim`, `ssm_heads` and `num_attn_layers` so far.
`RuntimeConfig` holds only the switches the port reads: kernel dispatch here
follows the tensor's device (CUDA -> the hand-written kernel, CPU -> its plain
version), so the JAX package's `use_pallas`/`interpret` have no counterpart.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class _ByValue:
    """Equal by value to any record of the same class name and fields, the
    JAX package's included, so a port config compares equal, field by
    field, to the reference config it copies (its other fields are plain
    values)."""

    def __eq__(self, other):
        if type(other).__name__ != type(self).__name__ \
                or not dataclasses.is_dataclass(other):
            return NotImplemented
        return vars(self) == vars(other)

    def __hash__(self):
        return hash(tuple(sorted(vars(self).items())))


@dataclasses.dataclass(frozen=True, eq=False)
class MoEConfig(_ByValue):
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff: int = 0                       # per-expert hidden
    shared_expert: bool = False         # llama4-style shared expert
    capacity_factor: float = 1.25
    # the reference's training losses (ROADMAP Queue 1 item 8); serving
    # does not read them
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True, eq=False)
class SSMConfig(_ByValue):
    state_dim: int = 0                  # N (ssm_state)
    conv_width: int = 4
    head_dim: int = 64                  # P
    num_heads: int = 0                  # derived if 0: expand*d_model//head_dim
    expand: int = 2
    chunk_size: int = 128
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # transformer | moe | mamba2 | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    act_fn: str = "silu"                # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # hybrid (zamba2): one shared attention block every `attn_every` layers
    attn_every: int = 0
    num_shared_attn_sets: int = 2
    # sub-quadratic? controls long_500k applicability
    subquadratic: bool = False
    # read only to refuse what the port does not serve yet
    local_global_pattern: int = 0       # gemma2: every Nth layer global, rest local
    use_mrope: bool = False             # qwen2-vl M-RoPE

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def ssm_heads(self) -> int:
        s = self.ssm
        return s.num_heads or (s.expand * self.d_model) // s.head_dim

    def num_attn_layers(self) -> int:
        """Hybrid: how many layers are (shared) attention applications."""
        if self.family != "hybrid" or not self.attn_every:
            return 0
        return self.num_layers // self.attn_every


# ---------------------------------------------------------------------------
# Runtime switches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    kv_cache_dtype: str = "bf16"        # bf16 | int8
