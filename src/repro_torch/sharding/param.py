"""ParamDef: single-source-of-truth parameter specs.

Each model defines `param_spec(cfg) -> tree of ParamDef`; the same tree
drives random initialization on a given device (from an explicit
`torch.Generator`) and the quantized-variant spec. The port runs
on one card, so the JAX package's sharding side (logical axes resolved onto a
mesh) has no counterpart here: `logical` is kept so specs compare equal
across packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.common.tree import tree_map

TORCH_DTYPES = {
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
    "fp16": torch.float16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "fan_in"        # fan_in | normal | zeros | ones | embed | small
    dtype: str = "bf16"         # bf16 | fp32 | int8 | uint8 (int4 carrier)
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]


def init_leaf(d: ParamDef, generator: torch.Generator,
              device) -> torch.Tensor:
    """One leaf on `device`: draws f32 normals from `generator` on the
    generator's own device, scales them, casts to the leaf dtype and moves
    the result. A seed gives the same numbers on every target device only
    when the generator is the same kind: a CPU generator's leaves are the
    same on the CPU and on the card (a CUDA generator draws others)."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.torch_dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.torch_dtype, device=device)
    if d.init == "fan_in":
        # last-but-one dim is fan-in for (..., d_in, d_out) kernels
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale / math.sqrt(fan_in)
    elif d.init in ("normal", "embed", "small"):
        std = {"normal": 0.02, "embed": 1.0, "small": 1e-3}[d.init] * d.scale
    else:
        raise ValueError(d.init)
    x = torch.randn(d.shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return x.mul_(std).to(d.torch_dtype).to(device)


def init_params(spec, generator: torch.Generator, device):
    """Materialize a ParamDef tree, leaf by leaf in tree order."""
    return tree_map(lambda d: init_leaf(d, generator, device), spec)

