"""QTensor-aware entry point for the fused dequant-matmul.

`quant_matmul(x, w)` flattens x's leading dims to rows and runs
`csrc/quant_matmul.cu` for a CUDA input (replacing the Pallas `q8_matmul` /
`q4_matmul` of `repro.kernels.quant_matmul`), or the plain version in
`ref.py` for a CPU input. One call is one kernel launch. `plan` picks the
regime from the row count: a streaming GEMV for decode rows (M <=
DECODE_MAX_M), which splits K across blocks where the column tiles alone
cannot fill the card and reduces the splits inside the same launch, or a
tensor-core tile kernel for prefill rows. Neither pads rows (the Pallas
kernel padded them to its 8/128 tiles). The wrapper allocates only the
output; the decode regime's split-K workspace and per-tile counters are kept
per device and grow when a larger call needs them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import ref
from repro_torch.quant.qtensor import QTensor

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "quant_matmul": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _P],
}
FMT_CODES = {"q8": 0, "q4": 1}
DECODE_MAX_M = 16       # rows the decode regime takes (mma n8 tiles: 1 or 2)
DEC_COLS = 128          # columns per decode block
DEC_UNIT = 64           # decode K chunks are multiples of this (of the q4 group)
DEC_MIN_CHUNK = 256     # shortest K chunk a decode block takes
DEC_X_BYTES = 65536     # the block's staged x rows stay within this
PF_TILE = 128           # prefill output tile: columns, and rows at most
PF_BK = 64              # prefill K tile


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the quant-matmul kernel."""
    regime: str                     # "decode" or "prefill"
    grid: Tuple[int, int]           # (column tiles, splits) or (row, column tiles)
    splits: int                     # K chunks (decode); 1 for prefill
    k_chunk: int                    # K per chunk (decode); K for prefill


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, fmt: str, group: int, sms: int) -> Plan:
    """The regime and tiling for x (M, K) @ W (K, N). Decode blocks own 128
    columns and a K chunk; K is split into as many chunks as keep the blocks
    within one round of 2 per SM (a second, mostly idle round costs more than
    it spreads), each at least DEC_MIN_CHUNK long, a multiple of DEC_UNIT (of
    the q4 group) and short enough that the staged x rows fit, with no empty
    split. Prefill tiles are 128 columns by 128 rows (64 for M <= 64) over
    all of K."""
    if M <= DECODE_MAX_M:
        rows = 8 if M <= 8 else 16
        unit = group if fmt == "q4" else DEC_UNIT
        tiles = -(-N // DEC_COLS)
        kc_max = (DEC_X_BYTES // (2 * rows)) // unit * unit
        want = max(1, 2 * sms // tiles)         # blocks within one round
        splits = max(1, min(want, K // max(DEC_MIN_CHUNK, unit)))
        splits = max(splits, -(-K // kc_max))
        k_chunk = -(-K // (splits * unit)) * unit
        splits = -(-K // k_chunk)
        return Plan("decode", (tiles, splits), splits, k_chunk)
    rows = 64 if M <= 64 else PF_TILE
    return Plan("prefill", (-(-M // rows), -(-N // PF_TILE)), 1, K)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_WORKSPACE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, floats: int, tiles: int):
    """The device's split-K partials (f32) and per-tile counters (zeroed; the
    kernel leaves them zeroed), grown to at least `floats` and `tiles`. One
    set per device: launches that split K must not overlap, which holds for
    the port's one stream per device."""
    ws, counters = _WORKSPACE.get(device, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty((max(floats, 1 << 16),), dtype=torch.float32,
                         device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros((max(tiles, 1024),), dtype=torch.int32,
                               device=device)
    _WORKSPACE[device] = (ws, counters)
    return ws, counters


def _lib():
    return build.load("quant_matmul", SIGNATURES)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(x2d: torch.Tensor, t: QTensor):
    if x2d.dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul kernel takes bf16 x, got {x2d.dtype}")
    if t.fmt not in FMT_CODES:
        raise ValueError(t.fmt)
    for name, a in (("q", t.q), ("scale", t.scale), ("zero", t.zero)):
        if a is None:
            continue
        if a.device != x2d.device:
            raise ValueError(f"QTensor.{name} on {a.device}, x on {x2d.device}")
        if not a.is_contiguous():
            raise ValueError(f"QTensor.{name} must be contiguous")
    K, N = x2d.shape[1], t.q.shape[1]
    if t.q.shape[0] * (2 if t.fmt == "q4" else 1) != K:
        raise ValueError(f"x {tuple(x2d.shape)} vs {t.fmt} weight "
                         f"{tuple(t.q.shape)}")
    if N % 8 or K % 8 or t.q.data_ptr() % 8:
        raise ValueError(f"quant_matmul kernel needs N % 8 == 0, K % 8 == 0 "
                         f"and an 8-byte aligned weight; got K={K}, N={N}")
    if t.scale.data_ptr() % 16 or (t.zero is not None
                                   and t.zero.data_ptr() % 16):
        raise ValueError("quant_matmul kernel needs 16-byte aligned "
                         "scale and zero")
    if t.fmt == "q4" and (t.zero is None or t.group % 64 or K % t.group):
        raise ValueError(f"q4 kernel needs a zero, a group that is a multiple "
                         f"of 64 and K % group == 0; got K={K}, "
                         f"group={t.group}")


def launch(x2d: torch.Tensor, t: QTensor) -> torch.Tensor:
    """Run the CUDA kernel on (M, K) bf16 rows; returns (M, N) bf16."""
    _check(x2d, t)
    if not x2d.is_contiguous() or x2d.data_ptr() % 16:
        x2d = x2d.clone(memory_format=torch.contiguous_format)
    M, K = x2d.shape
    N = t.q.shape[1]
    dev = x2d.device
    p = plan(M, K, N, t.fmt, t.group, _sm_count(dev))
    ws = counters = None
    if p.splits > 1:
        ws, counters = _workspace(dev, p.splits * M * N, p.grid[0])
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    err = _lib().quant_matmul(
        FMT_CODES[t.fmt], x2d.data_ptr(), t.q.data_ptr(), t.scale.data_ptr(),
        None if t.zero is None else t.zero.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), out.data_ptr(),
        M, K, N, t.group, int(p.regime == "decode"), p.splits, p.k_chunk,
        _stream(dev))
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
