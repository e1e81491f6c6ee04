"""Config dataclasses of the port: models and runtime switches.

`ModelConfig` holds the fields of the JAX package's model description that
the served models set or rely on, under the same names and defaults: the
dense SwiGLU transformer of carboncall-qwen2-7b (full causal attention, no
softcaps, no post-block norms, untied LM head) and the attention-free Mamba2
LM of mamba2-370m (`SSMConfig`, tied embeddings). Sliding windows, softcaps,
GeGLU and the MoE, hybrid, encoder-decoder and vision fields come with the
slices that port models that use them (ROADMAP Queue 1). Of its derived
quantities the port needs `resolved_head_dim` and `ssm_heads` so far.
`RuntimeConfig` holds only the switches the port reads: kernel dispatch here
follows the tensor's device (CUDA -> the hand-written kernel, CPU -> its plain
version), so the JAX package's `use_pallas`/`interpret` have no counterpart.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class SSMConfig:
    state_dim: int = 0                  # N (ssm_state)
    conv_width: int = 4
    head_dim: int = 64                  # P
    num_heads: int = 0                  # derived if 0: expand*d_model//head_dim
    expand: int = 2
    chunk_size: int = 128
    ngroups: int = 1

    # Equal by value to any `SSMConfig` record with the same fields, the JAX
    # package's included, so a port config compares equal, field by field,
    # to the reference config it copies (its other fields are plain values).
    def __eq__(self, other):
        if type(other).__name__ != "SSMConfig" \
                or not dataclasses.is_dataclass(other):
            return NotImplemented
        return vars(self) == vars(other)

    def __hash__(self):
        return hash(tuple(sorted(vars(self).items())))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # the port serves transformer | mamba2
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    ssm: SSMConfig = SSMConfig()
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


# ---------------------------------------------------------------------------
# Runtime switches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    kv_cache_dtype: str = "bf16"        # bf16 | int8
