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


# a leaf with no leading layer axis is drawn in column blocks of at most
# this many elements (the full-width LM heads' f32 draw would otherwise be
# 3 GB at once)
PIECE_ELEMS = 1 << 27


def leaf_pieces(d: ParamDef):
    """The pieces a leaf is drawn in, as indices into it: one layer slice
    `(i,)` for each layer of a stacked leaf (leading logical axis
    "layers"), else column blocks `(..., slice(c0, c1))` of at most
    PIECE_ELEMS elements. Quantization reduces over d_in within one layer,
    column by column, so a piece quantizes to the same index of the
    quantized leaf's every field."""
    if d.logical and d.logical[0] == "layers" and len(d.shape) >= 2:
        return [(i,) for i in range(d.shape[0])]
    n = math.prod(d.shape)
    if len(d.shape) < 2 or n <= PIECE_ELEMS:
        return [(...,)]
    cols = d.shape[-1]
    width = -(-cols // -(-n // PIECE_ELEMS))
    return [(..., slice(c, min(c + width, cols)))
            for c in range(0, cols, width)]


def _std(d: ParamDef) -> float:
    if d.init == "fan_in":
        # last-but-one dim is fan-in for (..., d_in, d_out) kernels
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        return d.scale / math.sqrt(fan_in)
    if d.init in ("normal", "embed", "small"):
        return {"normal": 0.02, "embed": 1.0, "small": 1e-3}[d.init] * d.scale
    raise ValueError(d.init)


def draw_pieces(d: ParamDef, generator: torch.Generator):
    """Yield (index, piece) over `leaf_pieces(d)` in order: each piece drawn
    as f32 normals from `generator` on the generator's own device, scaled
    and cast to the leaf dtype. Only one piece's f32 draw is alive at a
    time, so a stacked leaf's peak is one layer's slice."""
    std = _std(d)
    for idx in leaf_pieces(d):
        shape = torch.empty(d.shape, device="meta")[idx].shape
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        piece = x.mul_(std).to(d.torch_dtype)
        del x                       # not held while the caller quantizes
        yield idx, piece


def init_leaf(d: ParamDef, generator: torch.Generator,
              device) -> torch.Tensor:
    """One leaf on `device`, written piece by piece (`draw_pieces`) into an
    output of the leaf's dtype. A seed gives the same numbers on every
    target device only when the generator is the same kind: a CPU
    generator's leaves are the same on the CPU and on the card (a CUDA
    generator draws others)."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.torch_dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.torch_dtype, device=device)
    out = torch.empty(d.shape, dtype=d.torch_dtype, device=device)
    for idx, piece in draw_pieces(d, generator):
        out[idx] = piece
    return out


def init_params(spec, generator: torch.Generator, device):
    """Materialize a ParamDef tree, leaf by leaf in tree order."""
    return tree_map(lambda d: init_leaf(d, generator, device), spec)

