"""Model-layout wrapper + dispatch for paged decode attention.

`paged_decode_attention` takes q in model layout (B, 1, N, H), views it as
the kernel's (B, K, G, H) GQA form and runs `csrc/paged_attention.cu`
(replacing the Pallas `paged_attention_bkgh`) for CUDA tensors — bf16 pools
plain, int8 pools with the dequant fused after the load — or the gather
reference in `ref.py` for CPU tensors. `dispatch_paged_attention` is the
layer-level entry; `paged_attention_uses_fallback(device)` says, as a pure
function of the device, whether a decode step reads through the plain
version, so the engine can count those steps into `kernel_fallbacks`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# split-K kicks in past this many chain blocks: one online-softmax state per
# ~SPLIT_BLOCK_CHAIN blocks, partials merged by a second pass
SPLIT_BLOCK_CHAIN = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {"paged_attention": [_P] * 11 + [_I] * 7 + [_F, _I, _P]}


def default_num_splits(nb: int) -> int:
    """Flash-decode split count for an `nb`-block chain."""
    return max(1, -(-int(nb) // SPLIT_BLOCK_CHAIN))


def paged_attention_uses_fallback(device) -> bool:
    """True when decode attention on `device` reads through the plain gather
    version instead of the kernel: exactly when the device is not CUDA."""
    return torch.device(device).type != "cuda"


def launch(q, k_pool, v_pool, block_tables, lengths, *, k_scale=None,
           v_scale=None, cap=0.0, window=0, num_splits=1):
    """q: (B, K, G, H) bf16 on the card -> (B, K, G, H) bf16."""
    B, K, G, H = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
    quantized = k_scale is not None
    want_pool = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pool.dtype != want_pool \
            or v_pool.dtype != want_pool:
        raise TypeError(f"paged_attention: q {q.dtype}, pools "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if k_pool.shape[2] != K or k_pool.shape[3] != H:
        raise ValueError(f"pool {tuple(k_pool.shape)} vs q {tuple(q.shape)}")
    if G > 8 or H > 256:
        raise ValueError(f"paged_attention kernel takes G <= 8, H <= 256; "
                         f"got G={G}, H={H}")
    tensors = [q, k_pool, v_pool, block_tables, lengths]
    if quantized:
        tensors += [k_scale, v_scale]
    for a in tensors:
        if a.device != q.device or not a.is_contiguous():
            raise ValueError("paged_attention: every input must be a "
                             "contiguous tensor on q's device")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables/lengths must be int32")
    if quantized and (k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise TypeError("paged_attention: int8 pool scales must be f32")
    splits = max(1, min(int(num_splits), nb))
    out = torch.empty_like(q)
    dev = q.device
    if splits > 1:
        m_part = torch.empty((B, K, splits, G), dtype=torch.float32, device=dev)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((B, K, splits, G, H), dtype=torch.float32,
                               device=dev)
        parts = (m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr())
    else:
        parts = (None, None, None)
    lib = build.load("paged_attention", SIGNATURES)
    err = lib.paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), lengths.data_ptr(), *parts, out.data_ptr(),
        B, K, G, H, bs, nb, splits, float(cap), int(window),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_attention")
    kernels.LAUNCHES["paged_attention"] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           k_scale=None, v_scale=None, cap=0.0, window=0,
                           num_splits=1):
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
    {k, v[, k_scale, v_scale]}."""
    return paged_decode_attention(
        q, pool_i["k"], pool_i["v"], block_tables, lengths,
        k_scale=pool_i.get("k_scale"), v_scale=pool_i.get("v_scale"),
        num_splits=default_num_splits(block_tables.shape[1]))
