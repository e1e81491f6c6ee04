"""Plain versions of tool retrieval: the similarity max (paper Eq. 3) and the
top-k over it. CPU tensors take these in `ops`; on the card they are what the
kernel is held against."""
from __future__ import annotations

import torch


def sim_scores_ref(tools: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """tools (N, d), queries (m, d) -> (N,) f32: max_i <tools[j], queries[i]>."""
    sims = tools.to(torch.float32) @ queries.to(torch.float32).T   # (N, m)
    return sims.amax(dim=1)


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys that order f32 scores as `jax.lax.top_k` does: by value,
    with +0.0 above -0.0 (`b ^ ((b >> 31) & 0x7fffffff)` of the bits b).
    NaN is out of scope: unit-vector dots do not produce it."""
    b = scores.to(torch.float32).contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7fffffff)


def top_k(scores: torch.Tensor, k: int):
    """The k largest scores and their indices, highest first, in the total
    order `jax.lax.top_k` uses: +0.0 ranks above -0.0, and equal bits keep
    the lower index first (padded index rows all score exactly 0.0, so ties
    are common)."""
    _, idx = torch.sort(order_key(scores), descending=True, stable=True)
    idx = idx[:k]
    return scores[idx], idx


def topk_tools_ref(tools: torch.Tensor, queries: torch.Tensor, k: int):
    return top_k(sim_scores_ref(tools, queries), k)
