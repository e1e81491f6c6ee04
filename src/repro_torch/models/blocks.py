"""Transformer building blocks of the pattern-1 transformer family.

All parameters are ParamDef-spec'd (see sharding/param.py); attention weights
are stored with flattened head dims, (d, N*H), as in the JAX package, so a
weight tree crosses packages leaf for leaf.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.quant import dense
from repro_torch.sharding.param import ParamDef


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def attn_spec(cfg: ModelConfig, lead=(), lead_log=()):
    d, N, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    H = cfg.resolved_head_dim
    s = {
        "wq": ParamDef((*lead, d, N * H), (*lead_log, "embed", "heads")),
        "wk": ParamDef((*lead, d, K * H), (*lead_log, "embed", "kv_heads")),
        "wv": ParamDef((*lead, d, K * H), (*lead_log, "embed", "kv_heads")),
        "wo": ParamDef((*lead, N * H, d), (*lead_log, "heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamDef((*lead, N * H), (*lead_log, "heads"), init="zeros")
        s["bk"] = ParamDef((*lead, K * H), (*lead_log, "kv_heads"), init="zeros")
        s["bv"] = ParamDef((*lead, K * H), (*lead_log, "kv_heads"), init="zeros")
    return s


def mlp_spec(cfg: ModelConfig, lead=(), lead_log=(), d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": ParamDef((*lead, d, f), (*lead_log, "embed", "mlp")),
        "wu": ParamDef((*lead, d, f), (*lead_log, "embed", "mlp")),
        "wo": ParamDef((*lead, f, d), (*lead_log, "mlp", "embed")),
    }


def norm_spec(cfg: ModelConfig, lead=(), lead_log=()):
    return ParamDef((*lead, cfg.d_model), (*lead_log, None), init="zeros")


def block_norms_spec(cfg: ModelConfig, lead=(), lead_log=()):
    return {
        "pre_attn": norm_spec(cfg, lead, lead_log),
        "pre_mlp": norm_spec(cfg, lead, lead_log),
    }


# ---------------------------------------------------------------------------
# Applies
# ---------------------------------------------------------------------------


def mlp_apply(p, x, cfg: ModelConfig):
    """SwiGLU."""
    h = F.silu(dense(x, p["wg"])) * dense(x, p["wu"])
    return dense(h, p["wo"])


def qkv_proj(p, x, cfg: ModelConfig, cos, sin):
    """Project + reshape to heads + RoPE. Returns q (B,S,N,H), k/v (B,S,K,H)."""
    B, S, _ = x.shape
    N, K, H = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense(x, p["wq"])
    k = dense(x, p["wk"])
    v = dense(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, N, H)
    k = k.reshape(B, S, K, H)
    v = v.reshape(B, S, K, H)
    if cos is not None:
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, *, cos, sin):
    """Full-sequence causal attention (prefill). Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg, cos, sin)
    o = L.attention(q, k, v)
    return dense(o.reshape(B, S, -1), p["wo"]), (k, v)


def _write_row(leaf, row, lengths):
    """leaf[b, lengths[b]] = row[b] for every row b: the JAX package's masked
    blend (`blocks._blend_row`) as a per-row index write. A row whose length
    is the stripe's width matches no position and writes nothing: its index
    is held at the last position and that position's own value goes back."""
    Smax = leaf.shape[1]
    rows = torch.arange(leaf.shape[0], device=leaf.device)
    idx = torch.clamp(lengths, max=Smax - 1).long()
    full = (lengths >= Smax).view(-1, *([1] * (row.ndim - 1)))
    leaf[rows, idx] = torch.where(full, leaf[rows, idx], row.to(leaf.dtype))


def attn_decode_apply(p, x, cfg: ModelConfig, *, cos, sin, cache_i, lengths):
    """One-token decode against a per-layer dense cache dict {k, v[, k_scale,
    v_scale]} of shape (B, Smax, K, H): the new token's KV is written IN
    PLACE at `lengths[b]` (int8 quantizes only the new row), then the row
    attends positions below min(lengths + 1, Smax). The read is the plain
    `layers.decode_attention` over the whole stripe, dequantized to bf16 for
    int8, which is what the JAX package runs here: it has no Pallas kernel
    for the dense layout, so this is the port, not a fallback."""
    from repro_torch.models.transformer import (dequant_cache,
                                                quantize_kv_for_cache)
    B = x.shape[0]
    q, k, v = qkv_proj(p, x, cfg, cos, sin)
    entry = quantize_kv_for_cache("k_scale" in cache_i, k[:, 0], v[:, 0])
    for key, val in entry.items():
        _write_row(cache_i[key], val, lengths)
    k_read, v_read = dequant_cache(cache_i)
    # a saturated row (lengths == Smax, write dropped) reads up to the last
    # stored key, as the paged path's seq_cap clamp does
    read_len = torch.clamp(lengths + 1, max=k_read.shape[1])
    o = L.decode_attention(q, k_read, v_read, read_len)
    return dense(o.reshape(B, 1, -1), p["wo"])


def attn_decode_paged_apply(p, x, cfg: ModelConfig, *, cos, sin, pool_i,
                            lengths, block_tables, seq_cap: int):
    """One-token decode against a per-layer paged pool dict {k, v[, k_scale,
    v_scale]} of shape (num_blocks, bs, K, H). The new token's KV is written
    IN PLACE into the physical block holding position `lengths[b]` (resolved
    through `block_tables`) — the port updates the pool where the JAX package
    returns a new one, which saves a pool-sized copy per layer. Rows at or
    past `seq_cap`, and dead rows (tables pointing at scratch block 0), drop
    their write into the scratch block. Reads go through the paged-attention
    dispatch: the Hopper kernel for CUDA pools, the gather version on CPU."""
    from repro_torch.kernels.paged_attention.ops import dispatch_paged_attention
    from repro_torch.models.transformer import quantize_kv_for_cache
    B = x.shape[0]
    q, k, v = qkv_proj(p, x, cfg, cos, sin)
    k1, v1 = k[:, 0], v[:, 0]                                # (B, K, H)
    bs = pool_i["k"].shape[1]
    nb = block_tables.shape[1]
    writable = lengths < seq_cap
    blk_idx = torch.clamp(lengths // bs, 0, nb - 1).long()
    bid = torch.gather(block_tables, 1, blk_idx[:, None])[:, 0].long()
    bid = torch.where(writable, bid, torch.zeros_like(bid))  # scratch block
    off = torch.where(writable, lengths % bs, torch.zeros_like(lengths)).long()
    entry = quantize_kv_for_cache("k_scale" in pool_i, k1, v1)
    for key, val in entry.items():
        pool_i[key][bid, off] = val.to(pool_i[key].dtype)
    read_len = torch.clamp(lengths + 1, max=seq_cap).to(torch.int32)
    o = dispatch_paged_attention(q, pool_i, block_tables, read_len)
    return dense(o.reshape(B, 1, -1), p["wo"]), pool_i
