"""Flash attention entry point in model layout (B, S, N, H).

A CUDA input runs `csrc/flash_attention.cu` (replacing the Pallas
`flash_attention_bnh`), which reads the model layout directly, so no
transposes surround it; a CPU input takes the plain version in `ref.py`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {"flash_attention": [_P] * 4 + [_I] * 8 + [_F, _I, _P]}


def launch(q, k, v, *, causal=True, window=0, cap=0.0, q_offset=0):
    B, Sq, N, H = q.shape
    Skv, K = k.shape[1], k.shape[2]
    for a in (q, k, v):
        if a.dtype != torch.bfloat16 or a.device != q.device:
            raise TypeError("flash_attention kernel takes bf16 q/k/v on one "
                            "device")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != H or N % K:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H > 256:
        raise ValueError(f"flash_attention kernel takes H <= 256, got {H}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = build.load("flash_attention", SIGNATURES)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, N, K, H, int(bool(causal)), int(window), float(cap),
        int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    kernels.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0, q_offset=0):
    """q: (B, Sq, N, H); k/v: (B, Skv, K, H) -> (B, Sq, N, H)."""
    if q.device.type == "cuda":
        return launch(q, k, v, causal=causal, window=window, cap=cap,
                      q_offset=q_offset)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap,
                               q_offset=q_offset)
