"""Weight-only quantization: Q8 (int8 per-channel) and Q4 (int4 group-wise).

The port of `repro.quant.qtensor`, bit for bit on the payloads:
  * q8 — symmetric int8, one f32 scale per output channel;
  * q4 — asymmetric 4-bit, group size 128 along the contraction dim with an
         f32 scale and minimum per group; two nibbles packed per uint8, even
         k in the low nibble, odd k in the high nibble.

`dense()` is the single entry point model code uses for every linear layer.
A 2-D `QTensor` goes to the fused dequant-matmul (`kernels/quant_matmul`):
the hand-written Hopper kernel for a CUDA input, its plain version for a CPU
input. The output dtype is x's (bf16 activations stay bf16), as in the JAX
package's `dense`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.common.tree import tree_map
from repro_torch.sharding.param import ParamDef, draw_pieces, init_leaf

Q4_GROUP = 128


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor          # int8 (q8) or uint8 nibble-packed (q4); (..., d_in', d_out)
    scale: torch.Tensor      # q8: (..., 1, d_out); q4: (..., d_in/g, d_out)
    zero: Optional[torch.Tensor]   # q4 only: group minimum, same shape as scale
    fmt: str = "q8"
    group: int = Q4_GROUP

    @property
    def shape(self) -> Tuple[int, ...]:
        # logical (dequantized) shape
        s = list(self.q.shape)
        if self.fmt == "q4":
            s[-2] *= 2
        return tuple(s)

    def nbytes(self) -> int:
        n = self.q.numel() * self.q.element_size()
        n += self.scale.numel() * self.scale.element_size()
        if self.zero is not None:
            n += self.zero.numel() * self.zero.element_size()
        return n

    def __getitem__(self, i) -> "QTensor":
        """Slice the leading (stacked-layer) dim of every field."""
        return QTensor(q=self.q[i], scale=self.scale[i],
                       zero=None if self.zero is None else self.zero[i],
                       fmt=self.fmt, group=self.group)


def quantize(w: torch.Tensor, fmt: str, group: int = Q4_GROUP) -> QTensor:
    """Quantize along the contraction (second-to-last) dimension."""
    wf = w.to(torch.float32)
    if fmt == "q8":
        amax = wf.abs().amax(dim=-2, keepdim=True)
        scale = torch.clamp_min(amax / 127.0, 1e-8)
        # in place after the division: one f32 temporary beside wf
        q = (wf / scale).round_().clamp_(-127, 127).to(torch.int8)
        return QTensor(q=q, scale=scale, zero=None, fmt="q8", group=0)
    if fmt == "q4":
        *lead, din, dout = wf.shape
        if din % group:
            raise ValueError(f"q4: d_in {din} not divisible by group {group}")
        g = wf.reshape(*lead, din // group, group, dout)
        lo = g.amin(dim=-2)                                   # (..., din/g, dout)
        hi = g.amax(dim=-2)
        scale = torch.clamp_min((hi - lo) / 15.0, 1e-8)
        q = (g - lo.unsqueeze(-2)).div_(scale.unsqueeze(-2)).round_() \
            .clamp_(0, 15)
        q = q.to(torch.uint8).reshape(*lead, din, dout)
        packed = q[..., 0::2, :] | (q[..., 1::2, :] << 4)
        return QTensor(q=packed.contiguous(), scale=scale, zero=lo,
                       fmt="q4", group=group)
    raise ValueError(fmt)


def unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """(..., d_in/2, d_out) uint8 -> (..., d_in, d_out) uint8 nibbles."""
    lo = packed & 0x0F
    hi = packed >> 4
    *lead, dhalf, dout = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, dhalf * 2, dout)


def dequantize(t: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    if t.fmt == "q8":
        return (t.q.to(torch.float32) * t.scale).to(dtype)
    if t.fmt == "q4":
        q = unpack_q4(t.q).to(torch.float32)
        *lead, din, dout = q.shape
        g = q.reshape(*lead, din // t.group, t.group, dout)
        w = g * t.scale.unsqueeze(-2) + t.zero.unsqueeze(-2)
        return w.reshape(*lead, din, dout).to(dtype)
    raise ValueError(t.fmt)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) -> (..., d_out) in x's dtype."""
    if isinstance(w, QTensor):
        if w.q.ndim != 2:
            raise NotImplementedError(
                "batched-expert QTensors belong to the MoE family, which the "
                "port has not reached yet (ROADMAP Queue 1 item 7)")
        from repro_torch.kernels.quant_matmul import ops as qm_ops
        return qm_ops.quant_matmul(x, w)
    if w.ndim != 2:
        raise NotImplementedError("dense: 2-D weights only")
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# Tree-level transforms (spec-driven so abstract and concrete trees match)
# ---------------------------------------------------------------------------


def _eligible(d: ParamDef) -> bool:
    """Quantize big matmul weights; skip norms/biases/conv/SSM vectors and the
    embedding table (its lookup path needs the full-precision array)."""
    if len(d.shape) < 2 or min(d.shape[-2:]) < 32:
        return False
    if d.logical[-2] == "vocab":           # (vocab, embed) lookup table
        return False
    if any(ax in ("conv", "state") for ax in d.logical if ax):
        return False
    if d.init in ("zeros", "ones"):        # biases, norm scales
        return False
    return True


def _qfmt(d: ParamDef, fmt: str, group: int) -> str:
    """q4 falls back to q8 when the contraction dim is not group-divisible."""
    return "q4" if fmt == "q4" and d.shape[-2] % group == 0 else "q8"


def _qdef(d: ParamDef, fmt: str, group: int) -> QTensor:
    *lead, din, dout = d.shape
    lead_log = d.logical[:-2]
    if _qfmt(d, fmt, group) == "q4":
        return QTensor(
            q=ParamDef((*lead, din // 2, dout), d.logical, dtype="uint8", init="zeros"),
            scale=ParamDef((*lead, din // group, dout),
                           (*lead_log, None, d.logical[-1]), dtype="fp32", init="ones"),
            zero=ParamDef((*lead, din // group, dout),
                          (*lead_log, None, d.logical[-1]), dtype="fp32", init="zeros"),
            fmt="q4", group=group)
    return QTensor(
        q=ParamDef((*lead, din, dout), d.logical, dtype="int8", init="zeros"),
        scale=ParamDef((*lead, 1, dout), (*lead_log, None, d.logical[-1]),
                       dtype="fp32", init="ones"),
        zero=None, fmt="q8", group=0)


def quant_spec(spec, fmt: str, group: int = Q4_GROUP):
    """ParamDef tree -> tree with QTensor nodes holding ParamDef children."""
    if fmt in ("bf16", "none"):
        return spec
    return tree_map(lambda d: _qdef(d, fmt, group) if _eligible(d) else d,
                    spec)


def quantize_tree(params, spec, fmt: str, group: int = Q4_GROUP):
    """Quantize concrete params guided by the spec (same structure decisions
    as quant_spec)."""
    if fmt in ("bf16", "none"):
        return params
    return tree_map(
        lambda d, p: quantize(p, _qfmt(d, fmt, group), group)
        if _eligible(d) else p, spec, params)


def _empty_like_def(node, device):
    """Uninitialised tensors for a ParamDef, or for a QTensor of ParamDefs."""
    if isinstance(node, QTensor):
        return dataclasses.replace(
            node, q=_empty_like_def(node.q, device),
            scale=_empty_like_def(node.scale, device),
            zero=None if node.zero is None
            else _empty_like_def(node.zero, device))
    return torch.empty(node.shape, dtype=node.torch_dtype, device=device)


def init_quantized(spec, fmts: Sequence[str], generator: torch.Generator,
                   device, group: int = Q4_GROUP) -> Dict[str, dict]:
    """Random weights straight into quantized variants, piece by piece: each
    leaf is drawn one layer slice (or column block) at a time
    (`sharding.param.draw_pieces`), and each piece is quantized into every
    format of `fmts` and written into that format's preallocated stacked
    `q` / `scale` / `zero`. No full-precision leaf, and no full-precision
    tree, is ever whole on the device: the extra peak over the finished
    trees is one piece's f32 draw and its quantized parts. Leaves that stay
    unquantized (embedding, norms, biases) are shared between the
    variants. Draw order is the tree order, and the numbers are
    `init_params`'s: a piece is cast to the leaf dtype before it is
    quantized, as `quantize_tree` quantizes the cast leaf."""
    out: Dict[str, dict] = {f: {} for f in fmts}

    def walk(node, dests):
        for k, d in node.items():
            if isinstance(d, dict):
                subs = [dst.setdefault(k, {}) for dst in dests]
                walk(d, subs)
                continue
            quant = [f not in ("bf16", "none") and _eligible(d) for f in fmts]
            if not any(quant):
                w = init_leaf(d, generator, device)
                for dst in dests:
                    dst[k] = w
                continue
            leaves = [_empty_like_def(_qdef(d, f, group), device) if q
                      else _empty_like_def(d, device)
                      for f, q in zip(fmts, quant)]
            for idx, piece in draw_pieces(d, generator):
                piece = piece.to(device)
                for f, q, leaf in zip(fmts, quant, leaves):
                    if not q:
                        leaf[idx] = piece
                        continue
                    part = quantize(piece, _qfmt(d, f, group), group)
                    leaf.q[idx] = part.q
                    leaf.scale[idx] = part.scale
                    if part.zero is not None:
                        leaf.zero[idx] = part.zero
                    del part
                del piece
            for dst, leaf in zip(dests, leaves):
                dst[k] = leaf

    walk(spec, [out[f] for f in fmts])
    return out
