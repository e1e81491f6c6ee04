"""Flash attention entry point in model layout (B, S, N, H).

A CUDA input runs `csrc/flash_attention.cu` (replacing the Pallas
`flash_attention_bnh`), tensor-core prefill attention that reads the model
layout directly, so no transposes surround it; a CPU input takes the plain
version in `ref.py`. One call is one kernel launch of `plan`'s grid. The
wrapper allocates only the output and raises for what the kernel does not
take; it never falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_attention": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
    "flash_products": [_P] * 5 + [_I, _P],
}
ROW_TILE = 64               # query rows a block: one warpgroup (csrc BM)
KEY_TILE = 64               # keys a K/V tile (csrc BK)
STAGES = 3                  # K/V tile pairs in a block's ring (csrc Smem)
SMEM_MAX = 227 * 1024       # dynamic shared memory of a block


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the flash attention kernel."""
    grid: Tuple[int, int, int]  # (row tiles, heads, batch)
    smem: int                   # dynamic shared memory of a block, bytes


def head_pad(H: int) -> int:
    """The head dim as the kernel stores it: whole 64-column slabs."""
    return 64 if H <= 64 else 128 if H <= 128 else 256


def smem_bytes(H: int) -> int:
    """Dynamic shared memory of one block (csrc Smem::TOTAL): the query
    rows and a ring of K/V tile pairs."""
    hp = head_pad(H)
    return ROW_TILE * hp * 2 + STAGES * 2 * KEY_TILE * hp * 2


def check_head_dim(H):
    if H % 16 or not 16 <= H <= 256:
        raise ValueError(f"flash_attention kernel takes H a multiple of 16 "
                         f"up to 256, got {H}")


def check_shapes(B, Sq, Skv, N, K, H):
    if min(B, Sq, Skv, N, K) <= 0 or N % K:
        raise ValueError(f"flash_attention kernel: B={B} Sq={Sq} Skv={Skv} "
                         f"N={N} K={K} (needs N % K == 0)")
    check_head_dim(H)


@functools.lru_cache(maxsize=4096)
def plan(B: int, Sq: int, Skv: int, N: int, K: int, H: int) -> Plan:
    """The launch the C entry makes for these shapes, after checking that
    the kernel takes them: one block a 64-row tile of one head's query
    positions, so at most 2 blocks an SM at H <= 128 (one at 256). The
    heads of a GQA group read their K/V tile each (L2 serves the re-reads);
    tiles of a group's heads packed by position, and blocks of 128 rows,
    measured no faster on an H100 at the serving buckets (PERF.md)."""
    check_shapes(B, Sq, Skv, N, K, H)
    return Plan((-(-Sq // ROW_TILE), N, B), smem_bytes(H))


def _lib():
    return build.load("flash_attention", SIGNATURES)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(q, k, v, *, causal=True, window=0, cap=0.0, q_offset=0):
    """Run the CUDA kernel; q (B, Sq, N, H), k/v (B, Skv, K, H) bf16."""
    B, Sq, N, H = q.shape
    Skv, K = k.shape[1], k.shape[2]
    for a in (q, k, v):
        if a.dtype != torch.bfloat16 or a.device != q.device:
            raise TypeError("flash_attention kernel takes bf16 q/k/v on one "
                            "device")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != H:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q_offset < 0 or window < 0:
        raise ValueError(f"flash_attention kernel: q_offset {q_offset}, "
                         f"window {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention kernel needs 16-byte aligned q/k/v")
    plan(B, Sq, Skv, N, K, H)
    out = torch.empty_like(q)
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, N, K, H, int(bool(causal)), int(window), float(cap),
        int(q_offset), _stream(q.device))
    build.check(err, "flash_attention")
    kernels.LAUNCHES["flash_attention"] += 1
    return out


def products(q, k, v):
    """The kernel's two tensor-core products alone on one tile, for checking
    them: q (64, H), k/v (64, H) bf16 on the card -> S = q k^T (64, 64)
    and O = bf16(S) v (64, H), both f32, issued as the kernel issues them.
    Not counted as a launch of the attention kernel."""
    H = q.shape[1]
    check_head_dim(H)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.shape != (64, H) or k.shape != (KEY_TILE, H) or v.shape != k.shape:
        raise ValueError(f"products: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    s = torch.empty((64, KEY_TILE), dtype=torch.float32, device=q.device)
    o = torch.empty((64, H), dtype=torch.float32, device=q.device)
    err = _lib().flash_products(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                s.data_ptr(), o.data_ptr(), H,
                                _stream(q.device))
    build.check(err, "flash_products")
    return s, o


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0, q_offset=0):
    """q: (B, Sq, N, H); k/v: (B, Skv, K, H) -> (B, Sq, N, H)."""
    if q.device.type == "cuda":
        return launch(q, k, v, causal=causal, window=window, cap=cap,
                      q_offset=q_offset)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap,
                               q_offset=q_offset)
