"""Plain PyTorch versions of the fused dequant-matmul kernels.

They repeat the kernels' arithmetic: f32 products accumulated in f32, the
q8 column scale applied once to the sum, the q4 group terms
s * (x @ q) + (sum x) * z added group by group, and a cast to x's dtype at
the end. CPU tensors take these in `ops.quant_matmul`; on the card they are
what the kernels are held against."""
from __future__ import annotations

import torch

from repro_torch.quant.qtensor import unpack_q4


def q8_matmul_ref(x: torch.Tensor, wq: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ wq (K, N) int8, scale (1, N) f32 -> (M, N) in x's dtype."""
    acc = x.to(torch.float32) @ wq.to(torch.float32)
    return (acc * scale.reshape(1, -1)).to(x.dtype)


def q4_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                  zero: torch.Tensor, group: int = 128) -> torch.Tensor:
    """x (M, K) @ packed wq (K/2, N) uint8 with scale/zero (K/g, N) f32."""
    xf = x.to(torch.float32)
    q = unpack_q4(wq)
    acc = torch.zeros((x.shape[0], wq.shape[1]), dtype=torch.float32,
                      device=x.device)
    for g in range(scale.shape[0]):
        xg = xf[:, g * group:(g + 1) * group]
        qg = q[g * group:(g + 1) * group].to(torch.float32)
        acc += (xg @ qg) * scale[g] + xg.sum(dim=1, keepdim=True) * zero[g]
    return acc.to(x.dtype)
