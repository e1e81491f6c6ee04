"""Entry point of the SSD chunk scan (Mamba2 prefill).

`ssd(x, dt, A, Bm, Cm, chunk=...)` runs `csrc/ssd.cu` for CUDA inputs
(replacing the Pallas `ssd_bshp` of `repro.kernels.ssd`) and the plain
version in `ref.py` for CPU inputs. Like the Pallas kernel, the CUDA kernel
takes chunks of Q = min(chunk, S) tokens and needs S % Q == 0 (the plain
version falls back to one chunk of S instead, as `ssd_chunked` does). It
takes bf16 x, B and C (what the model hands over), f32 dt and A, head dims
P in HEAD_DIMS and state dims N in STATE_DIMS; anything else raises, and so
does a library that does not build. No call falls back to the plain version.

One call is one cooperative launch of `plan`'s grid (one block an SM), in
three phases over every (batch, chunk, head) tile: the chunks' own states,
the states passed from chunk to chunk, the chunks' outputs. Phases 1 and 3
take items of `plan(...).heads` heads of one group in one chunk, so the
heads share the chunk's B and C. The passed states live in a workspace kept
per device, grown when a larger call needs it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import ssd_chunked

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"ssd_bshp": [_P] * 8 + [_I] * 9 + [_P]}
MAX_CHUNK = 128                     # chunk rows the kernel holds on chip
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
WG = 128                            # threads of a warpgroup (csrc WG)
THREADS = 2 * WG                    # two warpgroups a block (csrc THREADS)
HG_MAX = 8                          # heads of an item (csrc HG_MAX)
SMEM_MAX = 227 * 1024               # dynamic shared memory of a block


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the SSD kernel."""
    chunks: int         # nc = S / Q
    heads: int          # hg: heads of one group an item of phases 1 and 3
    items: int          # (b, chunk, group of hg heads) items
    units: int          # float4s of all (b, h) states, phase 2
    grid: int           # persistent blocks, at most one an SM
    smem: int           # dynamic shared memory of a block, bytes
    ws_floats: int      # passed states and chunk totals


def state_pad(N: int) -> int:
    """The state dim of the kernel's instantiation: N padded to 64 or 128."""
    return 64 if N <= 64 else 128


def smem_bytes(N: int) -> int:
    """csrc Layout<NP>::TOTAL, bf16 tiles: C's 128 chunk rows (two 64-row
    tiles) and B's, two head buffers (x's 128 rows and the state's hi and
    lo parts, 64 rows; or phase 1's hi and lo parts of x dt w), phase 3's
    C B^T accumulators (three 64 x 64 f32 blocks), then HG_MAX heads' four
    128-float row vectors."""
    np_ = state_pad(N)
    tile64 = 64 * np_ * 2
    buf = max(MAX_CHUNK * 64 * 2 + 2 * tile64, 2 * MAX_CHUNK * 64 * 2)
    return 2 * tile64 + MAX_CHUNK * np_ * 2 + 2 * buf + 3 * 64 * 64 * 4 \
        + HG_MAX * 4 * MAX_CHUNK * 4


def check_shapes(B, S, H, P, G, N, Q):
    if min(B, S, H, G) <= 0 or H % G:
        raise ValueError(f"ssd kernel: B={B} S={S} H={H} G={G} (H % G == 0)")
    if not 0 < Q <= MAX_CHUNK or P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd kernel takes chunk <= {MAX_CHUNK}, P in "
                         f"{HEAD_DIMS}, N in {STATE_DIMS}; got chunk {Q}, "
                         f"P {P}, N {N}")
    if S % Q:
        raise ValueError(f"ssd kernel: sequence {S} is not a multiple of the "
                         f"chunk {Q}")
    if B * H * P * N // 4 >= 1 << 30:
        raise ValueError(f"ssd kernel: {B * H} states of {P} x {N} exceed "
                         f"its 32-bit indices")


def heads_per_item(B: int, nc: int, H: int, G: int, sms: int) -> int:
    """The fewest heads of one group (a divisor of H / G, at most HG_MAX)
    that leave no more items than SMs, so one wave of blocks takes them all
    and the heads of an item share its chunk's B and C; the most such heads
    if no count does."""
    counts = [d for d in range(1, min(H // G, HG_MAX) + 1)
              if (H // G) % d == 0]
    return next((d for d in counts if B * nc * (H // d) <= sms), counts[-1])


@functools.lru_cache(maxsize=1024)
def plan(B: int, S: int, H: int, P: int, G: int, N: int, Q: int,
         sms: int) -> Plan:
    """The launch for these shapes, after checking that the kernel takes
    them: a persistent grid of at most one block on each of `sms` SMs, and
    no more than the larger of phases 1 and 3 (items) and phase 2 (float4s
    of the states) has work for. Each block takes every grid-th item of
    phases 1 and 3 and each thread every (grid x THREADS)-th float4 of
    phase 2; the launch may take fewer blocks, if fewer are resident at
    once, and still covers every output (tests/test_torch_ssd.py spells
    out this order)."""
    check_shapes(B, S, H, P, G, N, Q)
    nc = S // Q
    hg = heads_per_item(B, nc, H, G, sms)
    items = B * nc * H // hg
    units = B * H * P * N // 4
    grid = min(sms, max(items, -(-units // THREADS)))
    return Plan(nc, hg, items, units, grid, smem_bytes(N),
                B * nc * H * (P * N + 1))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_WORKSPACE: Dict[torch.device, torch.Tensor] = {}


def _workspace(device: torch.device, floats: int) -> torch.Tensor:
    """The device's workspace (f32, not zeroed: every launch writes what it
    reads), grown to at least `floats` and never freed. One per device:
    launches must not overlap, which holds for the port's one stream per
    device. A call needs B * (S / Q) * H * (P * N + 1) floats (the plan's
    `ws_floats`; 4 MiB at the least): 16.8 MB for mamba2-370m's 4 x 512
    admission, 268 MB for one 32K-token mamba2-370m prompt."""
    ws = _WORKSPACE.get(device)
    if ws is None or ws.numel() < floats:
        ws = torch.empty((max(floats, 1 << 20),), dtype=torch.float32,
                         device=device)
        _WORKSPACE[device] = ws
    return ws


def _lib():
    return build.load("ssd", SIGNATURES)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Run the CUDA kernel. Returns (y (B,S,H,P) f32, final (B,H,P,N) f32)."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.dtype != torch.bfloat16 or Bm.dtype != torch.bfloat16 \
            or Cm.dtype != torch.bfloat16:
        raise TypeError("ssd kernel takes bf16 x, B and C, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd kernel takes f32 dt and A, got {dt.dtype}, "
                        f"{A.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd kernel: inputs on different devices")
    if tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != (Bb, S, G, N) or Cm.shape != Bm.shape \
            or H % G:
        raise ValueError(f"ssd kernel: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    Q = min(chunk, S)
    check_shapes(Bb, S, H, P, G, N, Q)
    dev = x.device
    p = plan(Bb, S, H, P, G, N, Q, _sm_count(dev))
    lib = _lib()
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    ws = _workspace(dev, p.ws_floats)
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=dev)
    fs = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    err = lib.ssd_bshp(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                       fs.data_ptr(), ws.data_ptr(), Bb, S, H, P, G, N, Q,
                       p.heads, p.grid, _stream(dev))
    build.check(err, "ssd_bshp")
    kernels.LAUNCHES["ssd_bshp"] += 1
    return y, fs


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """-> (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    if x.device.type == "cuda":
        y, fs = launch(x, dt, A, Bm, Cm, chunk=chunk)
        return y.to(x.dtype), fs
    if x.device.type != "cpu":
        raise ValueError(f"ssd: unsupported device {x.device}")
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)
