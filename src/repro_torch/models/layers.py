"""Core layers: norms, rotary embeddings, GQA attention.

The port of `repro.models.layers` for the pattern-1 transformer family.
Prefill attention comes in three implementations:
  * naive   — O(S^2) materialized logits; the plain version of the flash
              kernel and the oracle in tests;
  * chunked — online softmax over KV chunks, O(S·chunk) memory (plain);
  * flash   — `kernels/flash_attention`, the hand-written Hopper kernel,
              taken by `attention()` for every CUDA input.
`prefix_attention` (the paged engine's cache-hit prefill) and
`decode_attention` (the plain paged-decode oracle) stay plain PyTorch: the
JAX package has no Pallas kernel there either.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
ATTN_CHUNK = 512                # KV block of the plain chunked attention


def rms_norm(x, w, eps: float = 1e-6, *, add_unit_offset: bool = True):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = w.to(torch.float32)
    scale = (1.0 + scale) if add_unit_offset else scale
    return (y * scale).to(x.dtype)


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0.0 else x


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(torch.float32).unsqueeze(-1) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, N, H); cos/sin: (B, S, H/2) or (S, H/2). Split halves."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    xf1, xf2 = x1.to(torch.float32), x2.to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (prefill)
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, kv_pos, *, causal: bool, window: int):
    """(…, Sq, Skv) additive bias from position comparisons."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window > 0:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def repeat_kv(k, n_heads: int):
    """(B,S,K,H) -> (B,S,N,H): GQA KV heads broadcast to the full head count."""
    K = k.shape[2]
    if K == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // K, dim=2)


def naive_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                    q_offset=0):
    """Oracle. q: (B,Sq,N,H), k/v: (B,Skv,K,H) with N = K*G."""
    B, Sq, N, H = q.shape
    kf = repeat_kv(k, N).to(torch.float32)
    vf = repeat_kv(v, N).to(torch.float32)
    qf = q.to(torch.float32)
    logits = torch.einsum("bqnh,bsnh->bnqs", qf, kf) / math.sqrt(H)
    logits = softcap(logits, cap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    logits = logits + _mask_bias(q_pos, kv_pos, causal=causal, window=window)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqs,bsnh->bqnh", p, vf)
    return out.to(q.dtype)


def _scale_q(q, H: int):
    """q / sqrt(H) in q's dtype, by the divisor rounded to that dtype, then
    f32: the JAX package's `(q / jnp.sqrt(H)).astype(f32)`, where the weakly
    typed sqrt takes q's dtype (11.3125 for a bf16 q at H 128): the f32
    quotient, correctly rounded, rounded to q's dtype. Dividing by the f32
    or Python-float root rounds other bf16 quotients. The quotient is taken
    in f64 (then f32): torch's f32 division on a CUDA tensor does not round
    every quotient as IEEE division does."""
    root = torch.tensor(math.sqrt(H)).to(q.dtype).item()
    div = torch.full((), root, dtype=torch.float64, device=q.device)
    return (q.to(torch.float64) / div).to(torch.float32).to(q.dtype).to(
        torch.float32)


def chunked_attention(q, k, v, *, chunk=ATTN_CHUNK):
    """Causal online-softmax attention over KV chunks, O(Sq·chunk) memory;
    query i sits at position i, as in a cold prefill."""
    B, Sq, N, H = q.shape
    Skv = k.shape[1]
    if Skv % chunk != 0:
        chunk = Skv  # degenerate fallback for tiny shapes
    k = repeat_kv(k, N)
    v = repeat_kv(v, N)
    qr = _scale_q(q.transpose(1, 2), H)                      # (B,N,Sq,H)
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, N, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((B, N, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, N, Sq, H), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, chunk):
        kc = k[:, start:start + chunk].to(torch.float32)
        vc = v[:, start:start + chunk].to(torch.float32)
        logits = torch.einsum("bnqh,bsnh->bnqs", qr, kc)
        kv_pos = start + torch.arange(chunk, device=q.device)
        logits = logits + _mask_bias(q_pos, kv_pos, causal=True, window=0)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bnqs,bsnh->bnqh", p, vc)
        m = m_new
    out = acc / torch.clamp_min(lsum, 1e-37)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v):
    """Causal prefill attention: the flash kernel for CUDA inputs, the plain
    naive/chunked versions (chosen by size, as the JAX package's XLA path
    chooses) for CPU inputs."""
    if q.device.type == "cuda":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v)
    if q.shape[1] * k.shape[1] <= ATTN_CHUNK * ATTN_CHUNK:
        return naive_attention(q, k, v)
    return chunked_attention(q, k, v)


def prefix_attention(q, k_pre, v_pre, k_suf, v_suf, prefix_lens, q_positions):
    """Suffix attention over a cached prefix + freshly-projected suffix KV
    (the paged engine's prefix-cache-hit prefill).

      q, k_suf, v_suf: (B, S, N|K, H) at absolute positions `q_positions` —
                       (S,) uniform across rows, or (B, S) per-row
      k_pre, v_pre:    (B, P, K, H) at absolute positions 0..P-1, valid where
                       the position is < prefix_lens[b]
      prefix_lens:     (B,) cached tokens per row (0 = no cached prefix)

    Rows are left-padded: suffix slots whose absolute position falls inside
    the row's cached prefix are pad — masked out as keys, and their query
    outputs are garbage the caller discards. Math mirrors `naive_attention`.
    """
    B, S, N, H = q.shape
    P = k_pre.shape[1]
    dev = q.device
    k = torch.cat([repeat_kv(k_pre, N).to(torch.float32),
                   repeat_kv(k_suf, N).to(torch.float32)], dim=1)
    v = torch.cat([repeat_kv(v_pre, N).to(torch.float32),
                   repeat_kv(v_suf, N).to(torch.float32)], dim=1)
    qf = q.to(torch.float32)
    logits = torch.einsum("bqnh,bsnh->bnqs", qf, k) / math.sqrt(H)
    q_pos = q_positions.to(dev)
    if q_pos.ndim == 1:
        q_pos = q_pos[None, :].expand(B, S)
    k_pos = torch.cat([torch.arange(P, device=dev)[None, :].expand(B, P),
                       q_pos], dim=1)                         # (B, P+S)
    d = q_pos[:, :, None] - k_pos[:, None, :]                 # (B, S, P+S)
    ok = d >= 0                                               # causal
    in_prefix = k_pos[:, None, :] < prefix_lens.to(dev)[:, None, None]
    is_pre = torch.cat([torch.ones(P, dtype=torch.bool, device=dev),
                        torch.zeros(S, dtype=torch.bool, device=dev)])
    # prefix keys count only below the row's cached length; suffix keys only
    # at or above it (their positions overlap the prefix region in pad slots)
    ok &= torch.where(is_pre[None, None, :], in_prefix, ~in_prefix)
    logits = logits + torch.where(ok, 0.0, NEG_INF).to(torch.float32)[:, None]
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqs,bsnh->bqnh", p, v)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Attention (decode: one query position against a cache)
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, length, *, window=0, cap=0.0):
    """q: (B,1,N,H); caches: (B,Smax,K,H); length: (B,) current cache fill.
    GQA stays in (K, G) form; logits and softmax in f32."""
    B, _, N, H = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    G = N // K
    qr = _scale_q(q.reshape(B, K, G, H), H)
    logits = torch.einsum("bkgh,bskh->bkgs", qr, k_cache.to(torch.float32))
    logits = softcap(logits, cap)
    pos = torch.arange(Smax, device=q.device)
    length = torch.as_tensor(length, device=q.device)
    if length.ndim == 0:
        length = length.expand(B)
    valid = pos[None, :] < length[:, None]                   # (B, Smax)
    if window > 0:
        cur = length[:, None] - 1
        valid = valid & (pos[None, :] > cur - window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    logits = logits + bias[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, N, H).to(q.dtype)
