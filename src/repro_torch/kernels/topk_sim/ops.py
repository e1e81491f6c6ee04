"""Tool retrieval entry point: normalise the queries, score every tool (paper
Eq. 3) and take the top k.

A CUDA input runs `csrc/topk_sim.cu` (replacing the Pallas `sim_scores` of
`repro.kernels.topk_sim`), which takes any number of tools and up to 32
query rows, so neither the tools nor the queries are padded (the Pallas
kernel needed N to be a multiple of its row block and m of 8); a CPU input
takes the plain version in `ref.py`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.topk_sim.ref import sim_scores_ref, top_k

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"sim_scores": [_P, _P, _P, _I, _I, _I, _I, _P]}
MAX_QUERIES = 32                    # query rows: one partial dot each per lane


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(tools: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel: tools (N, d) f32, queries (m, d) f32 -> (N,) f32."""
    if tools.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("sim_scores kernel takes f32 tools and queries, got "
                        f"{tools.dtype} and {queries.dtype}")
    if queries.device != tools.device:
        raise ValueError(f"tools on {tools.device}, queries on {queries.device}")
    N, d = tools.shape
    m = queries.shape[0]
    if queries.ndim != 2 or queries.shape[1] != d:
        raise ValueError(f"tools {tuple(tools.shape)} vs queries "
                         f"{tuple(queries.shape)}")
    if not 1 <= m <= MAX_QUERIES:
        raise ValueError(f"sim_scores kernel takes 1..{MAX_QUERIES} query "
                         f"rows, got {m}")
    tools, queries = tools.contiguous(), queries.contiguous()
    out = torch.empty((N,), dtype=torch.float32, device=tools.device)
    lib = build.load("topk_sim", SIGNATURES)
    err = lib.sim_scores(tools.data_ptr(), queries.data_ptr(), out.data_ptr(),
                         N, d, m, _sm_count(tools.device),
                         torch.cuda.current_stream(tools.device).cuda_stream)
    build.check(err, "sim_scores")
    kernels.LAUNCHES["sim_scores"] += 1
    return out


def sim_scores(tools: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """tools (N, d), queries (m, d), both L2-normalised -> scores (N,)."""
    if tools.device.type == "cuda":
        return launch(tools, queries)
    if tools.device.type != "cpu":
        raise ValueError(f"sim_scores: unsupported device {tools.device}")
    return sim_scores_ref(tools, queries)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf / torch.clamp_min(torch.linalg.vector_norm(
        xf, dim=-1, keepdim=True), 1e-9)


def topk_tools(tool_embeds: torch.Tensor, query_embeds: torch.Tensor, *,
               k: int):
    """tool_embeds: (N, d) pre-normalised; query_embeds: (m, d) raw.
    Returns (scores (k,), indices (k,)), highest first, ties lower index
    first."""
    return top_k(sim_scores(tool_embeds, _normalize(query_embeds)), k)
