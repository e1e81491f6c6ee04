"""Config dataclasses of the port: models and runtime switches.

`ModelConfig` holds the fields of the JAX package's model description that
carboncall-qwen2-7b sets or relies on, under the same names and defaults:
a dense SwiGLU transformer with full causal attention, no softcaps, no
post-block norms and an untied LM head. Sliding windows, softcaps, GeGLU,
tied embeddings and the MoE, SSM, hybrid, encoder-decoder and vision fields
come with the slices that port models that use them (ROADMAP Queue 1). Of
its derived quantities the port needs only `resolved_head_dim` so far.
`RuntimeConfig` holds only the switches the port reads: kernel dispatch here
follows the tensor's device (CUDA -> the hand-written kernel, CPU -> its plain
version), so the JAX package's `use_pallas`/`interpret` have no counterpart.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # the port serves "transformer" only
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
    # read only to refuse what the port does not serve yet
    local_global_pattern: int = 0       # gemma2: every Nth layer global, rest local
    use_mrope: bool = False             # qwen2-vl M-RoPE

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0


# ---------------------------------------------------------------------------
# Runtime switches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    kv_cache_dtype: str = "bf16"        # bf16 | int8
