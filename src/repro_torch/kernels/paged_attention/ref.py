"""Plain PyTorch version of the paged decode attention kernel: gather each
row's block chain into a dense (B, nb*bs, K, H) view and run the stock decode
attention in f32. int8 pools are dequantized in f32 right after the gather,
as the kernel dequantizes right after its load. Materializes the gathered
view — what the kernel avoids."""
from __future__ import annotations

import torch

from repro_torch.models.layers import decode_attention


def gather_pool(pool_leaf: torch.Tensor,
                block_tables: torch.Tensor) -> torch.Tensor:
    """(num_blocks, bs, ...) gathered via (B, nb) tables -> (B, nb*bs, ...)."""
    g = pool_leaf[block_tables.long()]              # (B, nb, bs, ...)
    B, nb, bs = g.shape[:3]
    return g.reshape(B, nb * bs, *g.shape[3:])


def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                        cap=0.0, window=0, k_scale=None, v_scale=None):
    """q: (B, 1, N, H) model layout; pools: (num_blocks, bs, K, H) bf16, or
    int8 with (num_blocks, bs, K) f32 scales -> (B, 1, N, H) in q's dtype."""
    k = gather_pool(k_pool, block_tables).to(torch.float32)
    v = gather_pool(v_pool, block_tables).to(torch.float32)
    if k_scale is not None:
        k = k * gather_pool(k_scale, block_tables).unsqueeze(-1)
        v = v * gather_pool(v_scale, block_tables).unsqueeze(-1)
    return decode_attention(q, k, v, lengths, window=window, cap=cap)
