"""Plain versions of tool retrieval: the similarity max (paper Eq. 3) and the
top-k over it. CPU tensors take these in `ops`; on the card they are what the
kernel is held against."""
from __future__ import annotations

import torch


def sim_scores_ref(tools: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """tools (N, d), queries (m, d) -> (N,) f32: max_i <tools[j], queries[i]>."""
    sims = tools.to(torch.float32) @ queries.to(torch.float32).T   # (N, m)
    return sims.amax(dim=1)


def top_k(scores: torch.Tensor, k: int):
    """The k largest scores and their indices, highest first; equal scores
    keep the lower index first, as `jax.lax.top_k` orders them (padded index
    rows all score exactly 0.0, so ties are common)."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def topk_tools_ref(tools: torch.Tensor, queries: torch.Tensor, k: int):
    return top_k(sim_scores_ref(tools, queries), k)
