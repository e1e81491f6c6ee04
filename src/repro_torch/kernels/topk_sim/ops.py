"""Tool retrieval entry point: normalise the queries, score every tool (paper
Eq. 3) and take the top k.

A CUDA input runs `csrc/topk_sim.cu` (replacing the Pallas `sim_scores` of
`repro.kernels.topk_sim`), which takes any number of tools and up to 32
query rows a launch, so neither the tools nor the queries are padded (the
Pallas kernel needed N to be a multiple of its row block and m of 8). More
query rows are scored in groups of at most 32, one launch each, and the
groups' scores are merged by an elementwise max: the max over queries is
associative, so the result is the same as one pass over all rows. A CPU
input takes the plain version in `ref.py`.
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


def max_over_groups(queries: torch.Tensor, score) -> torch.Tensor:
    """Elementwise max of `score(group)` over the query rows taken in groups
    of at most MAX_QUERIES (the kernel's limit per launch)."""
    out = None
    for g0 in range(0, queries.shape[0], MAX_QUERIES):
        part = score(queries[g0:g0 + MAX_QUERIES])
        out = part if out is None else torch.maximum(out, part)
    return out


def _launch_group(lib, tools: torch.Tensor, queries: torch.Tensor):
    N, d = tools.shape
    out = torch.empty((N,), dtype=torch.float32, device=tools.device)
    err = lib.sim_scores(tools.data_ptr(), queries.data_ptr(), out.data_ptr(),
                         N, d, queries.shape[0], _sm_count(tools.device),
                         torch.cuda.current_stream(tools.device).cuda_stream)
    build.check(err, "sim_scores")
    kernels.LAUNCHES["sim_scores"] += 1
    return out


def launch(tools: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel: tools (N, d) f32, queries (m, d) f32 -> (N,) f32.
    m > MAX_QUERIES takes one launch per group of MAX_QUERIES rows."""
    if tools.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("sim_scores kernel takes f32 tools and queries, got "
                        f"{tools.dtype} and {queries.dtype}")
    if queries.device != tools.device:
        raise ValueError(f"tools on {tools.device}, queries on {queries.device}")
    if queries.ndim != 2 or queries.shape[1] != tools.shape[1]:
        raise ValueError(f"tools {tuple(tools.shape)} vs queries "
                         f"{tuple(queries.shape)}")
    if queries.shape[0] < 1:
        raise ValueError("sim_scores kernel takes at least one query row")
    tools, queries = tools.contiguous(), queries.contiguous()
    lib = build.load("topk_sim", SIGNATURES)
    return max_over_groups(queries,
                           lambda group: _launch_group(lib, tools, group))


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
