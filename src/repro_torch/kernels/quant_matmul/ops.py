"""QTensor-aware entry point for the fused dequant-matmul.

`quant_matmul(x, w)` flattens x's leading dims to rows and runs
`csrc/quant_matmul.cu` for a CUDA input (replacing the Pallas `q8_matmul` /
`q4_matmul` of `repro.kernels.quant_matmul`), or the plain version in
`ref.py` for a CPU input. The CUDA kernel needs no row padding (the Pallas
kernel padded rows to its 8/128 tiles); it chooses a split-K factor so that
small-N weights still fill the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import ref
from repro_torch.quant.qtensor import QTensor

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "q8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "q4_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}
ROWS, BLOCK_COLS = 8, 512           # per-block tile of the CUDA kernel
MIN_K_CHUNK = 128                   # shortest split-K chunk


def split_k(M: int, K: int, N: int, quantum: int, sms: int):
    """(splits, k_chunk): enough blocks for ~2 waves over `sms` SMs, chunks a
    multiple of `quantum` (the q4 group) and no empty split."""
    blocks = -(-M // ROWS) * -(-N // BLOCK_COLS)
    want = max(1, -(-2 * sms // blocks))
    splits = max(1, min(want, K // max(quantum, MIN_K_CHUNK)))
    k_chunk = -(-K // (splits * quantum)) * quantum
    return -(-K // k_chunk), k_chunk


def _check(x2d: torch.Tensor, t: QTensor):
    if x2d.dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul kernel takes bf16 x, got {x2d.dtype}")
    for name, a in (("q", t.q), ("scale", t.scale), ("zero", t.zero)):
        if a is None:
            continue
        if a.device != x2d.device:
            raise ValueError(f"QTensor.{name} on {a.device}, x on {x2d.device}")
        if not a.is_contiguous():
            raise ValueError(f"QTensor.{name} must be contiguous")
    N = t.q.shape[1]
    if N % 8 or t.q.data_ptr() % 8:
        raise ValueError(f"quant_matmul kernel needs N % 8 == 0 and an 8-byte "
                         f"aligned weight; got N={N}")


def launch(x2d: torch.Tensor, t: QTensor) -> torch.Tensor:
    """Run the CUDA kernel on (M, K) bf16 rows; returns (M, N) bf16."""
    _check(x2d, t)
    x2d = x2d.contiguous()
    M, K = x2d.shape
    N = t.q.shape[1]
    lib = build.load("quant_matmul", SIGNATURES)
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    quantum = t.group if t.fmt == "q4" else 1
    splits, k_chunk = split_k(M, K, N, quantum, sms)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x2d.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2d.device)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    if t.fmt == "q8":
        if t.q.shape[0] != K:
            raise ValueError(f"x {tuple(x2d.shape)} vs q8 weight {tuple(t.q.shape)}")
        err = lib.q8_matmul(x2d.data_ptr(), t.q.data_ptr(), t.scale.data_ptr(),
                            part.data_ptr(), out.data_ptr(), M, K, N, splits,
                            k_chunk, stream)
    elif t.fmt == "q4":
        if t.q.shape[0] * 2 != K:
            raise ValueError(f"x {tuple(x2d.shape)} vs q4 weight {tuple(t.q.shape)}")
        err = lib.q4_matmul(x2d.data_ptr(), t.q.data_ptr(), t.scale.data_ptr(),
                            t.zero.data_ptr(), part.data_ptr(), out.data_ptr(),
                            M, K, N, t.group, splits, k_chunk, stream)
    else:
        raise ValueError(t.fmt)
    build.check(err, f"{t.fmt}_matmul")
    kernels.LAUNCHES[f"{t.fmt}_matmul"] += 1
    return out


def plain(x2d: torch.Tensor, t: QTensor) -> torch.Tensor:
    if t.fmt == "q8":
        return ref.q8_matmul_ref(x2d, t.q, t.scale)
    if t.fmt == "q4":
        return ref.q4_matmul_ref(x2d, t.q, t.scale, t.zero, t.group)
    raise ValueError(t.fmt)


def quant_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x: (..., K) @ QTensor (K, N) -> (..., N) in x's dtype."""
    *lead, K = x.shape
    x2d = x.reshape(-1, K)
    if x.device.type == "cuda":
        out = launch(x2d, w)
    elif x.device.type == "cpu":
        out = plain(x2d, w)
    else:
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    return out.reshape(*lead, out.shape[-1])
