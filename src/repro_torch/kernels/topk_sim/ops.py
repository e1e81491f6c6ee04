"""Tool retrieval entry points: score every tool (paper Eq. 3) and take the
top k.

A CUDA input runs `csrc/topk_sim.cu`, which replaces the Pallas
`sim_scores` of `repro.kernels.topk_sim` and the `jax.lax.top_k` after it:
`sim_scores` is one launch for any number of tools, columns and query rows
(query groups of up to 4 are looped inside the kernel), and `topk_tools`
is one launch from raw queries to the k best (score, index) pairs: the
kernel divides each dot by its query row's norm, as `_normalize` takes it,
and selects in the order `jax.lax.top_k` uses (`ref.top_k`). `plan` picks
the launch. A CPU input takes the plain versions in `ref.py`; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.topk_sim.ref import sim_scores_ref, top_k

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"sim_scores": [_P, _P, _P] + [_I] * 6 + [_P],
              "topk_tools": [_P] * 4 + [_I] * 8 + [_P] * 3}
WARPS = 16                      # warps of a block (csrc WARPS)
MAX_GROUP = 4                   # query rows a lane holds at once (csrc MAX_MQ)
ROWS = 4                        # tool rows a warp scores at once (csrc ROWS)
LIST_K = 32                     # keys of a warp's top-k list; a larger k
                                # sorts all N keys instead


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of `csrc/topk_sim.cu`."""
    mq: int             # query rows a lane holds at once: 1, 2 or 4
    groups: int         # query groups looped in the kernel: ceil(m / mq)
    grid: int           # blocks of WARPS warps
    lists: bool         # top k: warp lists (k <= LIST_K), else sort all N
    scratch: int        # top k: 64-bit keys of the cross-block scratch


@functools.lru_cache(maxsize=1024)
def plan(N: int, d: int, m: int, k: int, sms: int, vec: bool = True) -> Plan:
    """The launch for N tools of d columns, m query rows and top k (0 for
    scores only) on `sms` SMs. Query rows go in groups of the least power of
    two >= m, at most MAX_GROUP (always MAX_GROUP for rows that are not
    16-byte aligned, `vec` False); the last group repeats row 0 in its
    unused places, which leaves the max unchanged. Batches of ROWS rows
    spread over one block an SM at most, one batch a warp where N allows."""
    if min(N, d, m, sms) < 1:
        raise ValueError(f"topk_sim kernel: N={N} d={d} m={m} sms={sms}")
    if k and not 1 <= k <= N:
        raise ValueError(f"topk_tools: k={k} must lie in 1..N={N}")
    mq = min(_pow2(m), MAX_GROUP) if vec else MAX_GROUP
    grid = min(-(-N // (ROWS * WARPS)), sms)
    lists = 0 < k <= LIST_K
    scratch = grid * LIST_K if lists else (_pow2(N) if k else 0)
    return Plan(mq, -(-m // mq), grid, lists, scratch)


class _Device:
    """Per-device state: the library's two entries, the SM count, the raw
    stream getter's device index and the top-k scratch (keys, grown when a
    larger call needs them, and the arrival counter, zeroed; the kernel
    leaves it zeroed). One set per device: top-k launches must not overlap,
    which holds for the port's one stream per device."""

    def __init__(self, device: torch.device):
        lib = build.load("topk_sim", SIGNATURES)
        self.scores_fn, self.topk_fn = lib.sim_scores, lib.topk_tools
        self.index = device.index if device.index is not None \
            else torch.cuda.current_device()
        self.sms = torch.cuda.get_device_properties(
            self.index).multi_processor_count
        self.keys = torch.empty((0,), dtype=torch.int64, device=device)
        self.counter = torch.zeros((1,), dtype=torch.int32, device=device)
        self.counter_ptr = self.counter.data_ptr()

    def scratch(self, n: int) -> int:
        if self.keys.numel() < n:
            self.keys = torch.empty((max(n, 2 * self.keys.numel()),),
                                    dtype=torch.int64,
                                    device=self.counter.device)
        return self.keys.data_ptr()

    def stream(self) -> int:
        """The current stream's handle. `torch.cuda.current_stream` builds
        a Stream object each call; the raw getter, which Triton's launcher
        uses too, does not."""
        return torch._C._cuda_getCurrentRawStream(self.index)


_DEVICES: Dict[torch.device, _Device] = {}


def _device(device: torch.device) -> _Device:
    state = _DEVICES.get(device)
    if state is None:
        state = _DEVICES[device] = _Device(device)
    return state


def _prepare(tools: torch.Tensor, queries: torch.Tensor):
    """Checks; -> (tools, queries) contiguous, the device state and whether
    rows are 16-byte aligned."""
    if tools.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("topk_sim kernel takes f32 tools and queries, got "
                        f"{tools.dtype} and {queries.dtype}")
    if queries.device != tools.device:
        raise ValueError(f"tools on {tools.device}, queries on {queries.device}")
    if tools.ndim != 2 or queries.ndim != 2 or \
            queries.shape[1] != tools.shape[1]:
        raise ValueError(f"tools {tuple(tools.shape)} vs queries "
                         f"{tuple(queries.shape)}")
    if queries.shape[0] < 1:
        raise ValueError("topk_sim kernel takes at least one query row")
    tools, queries = tools.contiguous(), queries.contiguous()
    vec = tools.shape[1] % 4 == 0 and tools.data_ptr() % 16 == 0 \
        and queries.data_ptr() % 16 == 0
    return tools, queries, _device(tools.device), vec


def launch(tools: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel: tools (N, d) f32, queries (m, d) f32 -> (N,) f32,
    one launch for any m."""
    tools, queries, dev, vec = _prepare(tools, queries)
    (N, d), m = tools.shape, queries.shape[0]
    pl = plan(N, d, m, 0, dev.sms, vec)
    out = tools.new_empty((N,))
    build.check(dev.scores_fn(tools.data_ptr(), queries.data_ptr(),
                              out.data_ptr(), N, d, m, pl.mq, int(vec),
                              pl.grid, dev.stream()), "sim_scores")
    kernels.LAUNCHES["sim_scores"] += 1
    return out


def launch_topk(tools: torch.Tensor, queries: torch.Tensor, k: int,
                host: bool = False):
    """Run the fused retrieval, one launch: tools (N, d) f32 and raw queries
    (m, d) f32 -> (scores (k,) f32, indices (k,) int64), highest first.
    `host=True` has the kernel write both into one device buffer (the k
    indices, then the k scores) and returns them on the CPU after one
    copy."""
    tools, queries, dev, vec = _prepare(tools, queries)
    (N, d), m = tools.shape, queries.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"topk_tools: k={k} must lie in 1..N={N}")
    pl = plan(N, d, m, k, dev.sms, vec)
    # new_empty: less host time than torch.empty with a device argument
    if host:
        buf = tools.new_empty((3 * k,), dtype=torch.int32)
        idx_ptr = buf.data_ptr()
        scores_ptr = idx_ptr + 8 * k
    else:
        scores, idx = tools.new_empty((k,)), tools.new_empty(
            (k,), dtype=torch.int64)
        scores_ptr, idx_ptr = scores.data_ptr(), idx.data_ptr()
    build.check(dev.topk_fn(
        tools.data_ptr(), queries.data_ptr(), scores_ptr, idx_ptr, N, d, m,
        k, pl.mq, int(vec), int(pl.lists), pl.grid, dev.scratch(pl.scratch),
        dev.counter_ptr, dev.stream()), "topk_tools")
    kernels.LAUNCHES["sim_scores"] += 1
    if host:
        buf = buf.cpu()
        return buf[2 * k:].view(torch.float32), buf[:2 * k].view(torch.int64)
    return scores, idx


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
               k: int, host: bool = False):
    """tool_embeds: (N, d) pre-normalised; query_embeds: (m, d) raw.
    Returns (scores (k,), indices (k,)), highest first, in `ref.top_k`'s
    order. On the card it is one kernel launch; `host=True` returns the pair
    on the CPU after one device-to-host copy."""
    if tool_embeds.device.type == "cuda":
        if query_embeds.dtype != torch.float32:
            query_embeds = query_embeds.to(torch.float32)
        return launch_topk(tool_embeds, query_embeds, k, host=host)
    if tool_embeds.device.type != "cpu":
        raise ValueError(f"topk_tools: unsupported device {tool_embeds.device}")
    return top_k(sim_scores(tool_embeds, _normalize(query_embeds)), k)
