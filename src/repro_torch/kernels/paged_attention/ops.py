"""Model-layout wrapper + dispatch for paged decode attention.

`paged_decode_attention` takes q in model layout (B, 1, N, H), views it as
the kernel's (B, K, G, H) GQA form and runs `csrc/paged_attention.cu`
(replacing the Pallas `paged_attention_bkgh`) for CUDA tensors — bf16 pools
plain, int8 pools with their scales folded into the products — or the
gather reference in `ref.py` for CPU tensors. Both scale q as the JAX
package's plain decode attention does: q / sqrt(H) in bf16, by the root
rounded to bf16. One call is one kernel launch
of `plan`'s grid: the chain is split across blocks so the grid fills the
card, and the last block of a (row, kv head) merges the splits inside the
same launch. The wrapper allocates only the output; the split partials and
arrival counters are kept per device and grow when a larger call needs
them. It raises for what the kernel does not take and never falls back.
`dispatch_paged_attention` is the layer-level entry;
`paged_attention_uses_fallback(device)` says, as a pure function of the
device, whether a decode step reads through the plain version, so the
engine can count those steps into `kernel_fallbacks`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# the reference's flash-decode split: one online-softmax state per
# ~SPLIT_BLOCK_CHAIN blocks (the JAX package's default; the kernel plans its
# own split)
SPLIT_BLOCK_CHAIN = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {"paged_attention": [_P] * 10 + [_I] * 8 + [_F, _I, _P]}
TILE = 16                   # positions a warp takes at a time (csrc TILE)
MAX_WARPS = 4               # warps of a block (csrc WARPS)
STAGES = 3                  # tiles in a warp's ring (csrc STAGES)
G_MAX = 8                   # query heads per kv head: rows of the m16 tile
SMEM_MAX = 222 * 1024       # dynamic shared memory of a block (csrc;
                            # its static arrays take the rest of 227 KB)
BLOCKS_PER_SM = 2           # blocks the split aims for on each SM
MIN_SPLIT_TOKENS = 64       # a split's chain, where one wave allows it


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the paged attention kernel."""
    splits: int                     # chunks of each row's chain
    blocks_per_split: int           # whole pool blocks a chunk (last ragged)
    warps: int                      # warps of a block that take tiles
    grid: Tuple[int, int, int]      # (splits, K, B)
    smem: int                       # dynamic shared memory of a block, bytes
    ws_floats: int                  # f32 partials (0 with one split)
    counters: int                   # per-(row, kv head) counters (idem)


def default_num_splits(nb: int) -> int:
    """The JAX package's flash-decode split count for an `nb`-block chain."""
    return max(1, -(-int(nb) // SPLIT_BLOCK_CHAIN))


def paged_attention_uses_fallback(device) -> bool:
    """True when decode attention on `device` reads through the plain gather
    version instead of the kernel: exactly when the device is not CUDA."""
    return torch.device(device).type != "cuda"


def hmax(H: int) -> int:
    """The kernel instantiation's head dim: H rounded up to 64, 128 or 256
    (the ring rows' columns past H hold zeros)."""
    return 64 if H <= 64 else 128 if H <= 128 else 256


def pitch(H: int, int8: bool) -> int:
    """Bytes between two positions' stripes in a ring tile: hmax(H) values
    rounded up to an odd count of 16-byte chunks (conflict-free ldmatrix)."""
    return 16 * ((hmax(H) * (1 if int8 else 2) // 16) | 1)


def stage_bytes(H: int, int8: bool) -> int:
    """One ring slot: a 16-position K tile and V tile (+ int8 scales)."""
    return 2 * TILE * pitch(H, int8) + (2 * TILE * 4 if int8 else 0)


def smem_bytes(H: int, int8: bool, warps: int, bps: int) -> int:
    """Dynamic shared memory of a block (csrc): the warps' rings and the
    split's block-table entries."""
    return warps * STAGES * stage_bytes(H, int8) + 16 * -(-4 * bps // 16)


def check_shapes(B, K, G, H, bs, nb):
    if min(B, K, nb) <= 0 or not 0 < G <= G_MAX:
        raise ValueError(f"paged_attention kernel: B={B} K={K} nb={nb} and "
                         f"1 <= G <= {G_MAX}; got G={G}")
    if H % 16 or not 16 <= H <= 256:
        raise ValueError(f"paged_attention kernel takes H a multiple of 16 "
                         f"up to 256, got {H}")
    if bs % 16 or not 16 <= bs <= 128:
        raise ValueError(f"paged_attention kernel takes a block size that is "
                         f"a multiple of 16 up to 128, got {bs}")


@functools.lru_cache(maxsize=4096)
def plan(B: int, K: int, G: int, H: int, bs: int, nb: int, sms: int,
         int8: bool = False, num_splits: Optional[int] = None) -> Plan:
    """The launch for these shapes, after checking that the kernel takes
    them. Without `num_splits`, each row's chain is cut into splits of whole
    pool blocks so the grid aims at BLOCKS_PER_SM blocks on each of `sms`
    SMs, with at least MIN_SPLIT_TOKENS positions a split where that still
    leaves one wave of blocks. An explicit `num_splits` cuts the chain as
    the JAX package does (ceil(nb / num_splits) blocks a split). Never reads
    `lengths`: they live on the device. A block's warps (at most MAX_WARPS,
    at most one per 16-position tile of the split) take its tiles."""
    check_shapes(B, K, G, H, bs, nb)
    pairs = B * K
    if num_splits is None:
        bps = -(-nb * pairs // (BLOCKS_PER_SM * sms))
        wave = max(1, nb * pairs // sms)    # the most that keeps one wave
        bps = max(bps, min(-(-MIN_SPLIT_TOKENS // bs), wave))
    else:
        bps = -(-nb // max(1, min(int(num_splits), nb)))
    bps = min(bps, nb)
    splits = -(-nb // bps)
    warps = min(MAX_WARPS, bps * bs // TILE)
    smem = smem_bytes(H, int8, warps, bps)
    if smem > SMEM_MAX:
        raise ValueError(f"paged_attention kernel: {smem} bytes of shared "
                         f"memory for H={H}, {bps} blocks a split")
    ws = pairs * splits * G * (H + 2) if splits > 1 else 0
    return Plan(splits, bps, warps, (splits, K, B), smem, ws,
                pairs if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_WORKSPACE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, floats: int, counters: int):
    """The device's split partials (f32) and per-(row, kv head) counters
    (zeroed; the kernel leaves them zeroed), grown to at least `floats` and
    `counters`. One set per device: launches that split must not overlap,
    which holds for the port's one stream per device."""
    ws, cnt = _WORKSPACE.get(device, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty((max(floats, 1 << 16),), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros((max(counters, 1024),), dtype=torch.int32,
                          device=device)
    _WORKSPACE[device] = (ws, cnt)
    return ws, cnt


def _lib():
    return build.load("paged_attention", SIGNATURES)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(q, k_pool, v_pool, block_tables, lengths, *, k_scale=None,
           v_scale=None, cap=0.0, window=0, num_splits=None):
    """q: (B, K, G, H) bf16 on the card -> (B, K, G, H) bf16. `num_splits`
    None takes the plan's split; an integer cuts the chain into that many
    chunks at most (to put split boundaries where a test wants them)."""
    B, K, G, H = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
    quantized = k_scale is not None
    want_pool = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pool.dtype != want_pool \
            or v_pool.dtype != want_pool:
        raise TypeError(f"paged_attention: q {q.dtype}, pools "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if k_pool.shape[2] != K or k_pool.shape[3] != H \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool {tuple(k_pool.shape)} vs q {tuple(q.shape)}")
    tensors = [q, k_pool, v_pool, block_tables, lengths]
    if quantized:
        tensors += [k_scale, v_scale]
    for a in tensors:
        if a.device != q.device or not a.is_contiguous():
            raise ValueError("paged_attention: every input must be a "
                             "contiguous tensor on q's device")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables/lengths must be int32")
    if quantized and (v_scale is None or k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise TypeError("paged_attention: int8 pool scales must be f32")
    if window < 0:
        raise ValueError(f"paged_attention: window {window}")
    dev = q.device
    p = plan(B, K, G, H, bs, nb, _sm_count(dev), quantized,
             None if num_splits is None else int(num_splits))
    ws = cnt = None
    if p.splits > 1:
        ws, cnt = _workspace(dev, p.ws_floats, p.counters)
    out = torch.empty_like(q)
    err = _lib().paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), lengths.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), out.data_ptr(),
        B, K, G, H, bs, nb, p.blocks_per_split, p.warps, float(cap),
        int(window), _stream(dev))
    build.check(err, "paged_attention")
    kernels.LAUNCHES["paged_attention"] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           k_scale=None, v_scale=None, cap=0.0, window=0,
                           num_splits=None):
    """q: (B, 1, N, H); pools: (num_blocks, bs, K, H) bf16, or int8 with
    (num_blocks, bs, K) f32 scales -> (B, 1, N, H)."""
    if paged_attention_uses_fallback(q.device):
        return paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                   cap=cap, window=window, k_scale=k_scale,
                                   v_scale=v_scale)
    B, _, N, H = q.shape
    K = k_pool.shape[2]
    out = launch(q.reshape(B, K, N // K, H).contiguous(), k_pool, v_pool,
                 block_tables, lengths, k_scale=k_scale, v_scale=v_scale,
                 cap=cap, window=window, num_splits=num_splits)
    return out.reshape(B, 1, N, H)


def dispatch_paged_attention(q, pool_i, block_tables, lengths):
    """Layer-level entry used by the model decode path (full causal
    attention, no softcap). `pool_i` is the per-layer pool dict
    {k, v[, k_scale, v_scale]}; the kernel plans its own split."""
    return paged_decode_attention(
        q, pool_i["k"], pool_i["v"], block_tables, lengths,
        k_scale=pool_i.get("k_scale"), v_scale=pool_i.get("v_scale"))
