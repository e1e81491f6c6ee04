"""Decoder-only transformer LM: the paged serving contract of
`repro.models.transformer` for the pattern-1, non-M-RoPE transformer family.

Layers are stacked on a leading dim (the JAX package's scan layout, so weight
trees cross packages leaf for leaf) and run by a Python loop over that dim.
Entry points:
  * `forward` / `prefill` — cold prefill of full prompt rows; attention goes
    through `layers.attention` (the flash kernel on the card);
  * `_prefill_window` — a token window over a cached prefix gathered from
    the block pool (`layers.prefix_attention`, plain), behind three entries:
    `prefill_paged` (a prefix-cache hit), `prefill_chunk` (one window of a
    chunked prefill) and `verify_paged` (the k+1 speculative verify window,
    per-row positions, logits at every position);
  * `decode_step_paged` — one token per row against the paged pool (the
    paged-attention kernel on the card);
  * `decode_step` — one token per row against the dense (L, B, max_seq, K,
    H) stripe of `cache_spec` (plain `layers.decode_attention`, as in the
    JAX package, which reaches no Pallas kernel there);
  * `paged_cache_spec` / `paged_block_bytes` / `quantize_kv_for_cache` /
    `dequant_cache` — pool layout, capacity math and the int8 KV encoding.
Every linear layer goes through `quant.dense` (the q8/q4 kernels on the card).
`embed_tokens` and `unembed` (with the tied-embedding head, h @ embed.T in
f32) also serve the mamba2 LM.
"""
from __future__ import annotations

import torch

from repro_torch.common.tree import tree_map
from repro_torch.config import ModelConfig, RuntimeConfig
from repro_torch.models import blocks as B_
from repro_torch.models import layers as L
from repro_torch.quant import dense
from repro_torch.sharding.param import ParamDef


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


def param_spec(cfg: ModelConfig):
    Lc = cfg.num_layers
    d, V = cfg.d_model, cfg.vocab_size
    layer = {
        "attn": B_.attn_spec(cfg, (Lc,), ("layers",)),
        "norms": B_.block_norms_spec(cfg, (Lc,), ("layers",)),
        "mlp": B_.mlp_spec(cfg, (Lc,), ("layers",)),
    }
    spec = {
        "embed": ParamDef((V, d), ("vocab", "embed"), init="embed"),
        "layers": layer,
        "final_norm": ParamDef((d,), (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    return spec


def check_supported(cfg: ModelConfig):
    if cfg.family != "transformer" or (cfg.local_global_pattern or 1) != 1 \
            or cfg.use_mrope:
        raise NotImplementedError(
            f"{cfg.name}: the port serves pattern-1, non-M-RoPE transformer "
            "models so far; other families are ROADMAP Queue 1 item 7")


def layer_params(params, i: int):
    """Layer i's slice of the stacked layer tree (views, no copy)."""
    return tree_map(lambda a: a[i], params["layers"])


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def rope_for(cfg: ModelConfig, positions):
    """positions: (B, S) or (1, S) absolute positions -> cos/sin."""
    return L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(torch.bfloat16)


def unembed(params, h, cfg: ModelConfig):
    if cfg.tie_embeddings:
        # h @ embed.T with f32 accumulation and f32 logits, as the JAX
        # package's bf16 dot with preferred_element_type=f32: a plain product
        # outside any kernel (the embedding table is never quantized)
        return torch.matmul(h.to(torch.float32),
                            params["embed"].to(torch.float32).T)
    return dense(h, params["lm_head"]).to(torch.float32)


def _mlp_residual(p_i, x, cfg: ModelConfig):
    h = L.rms_norm(x, p_i["norms"]["pre_mlp"], cfg.norm_eps)
    return x + B_.mlp_apply(p_i["mlp"], h, cfg)


# ---------------------------------------------------------------------------
# Dense and paged caches (bf16 or int8 with per-(pos, head) scales)
# ---------------------------------------------------------------------------


def _kv_spec(shape, log, kv_cache_dtype: str):
    """k and v leaves of `shape` (..., K, H), bf16, or int8 with f32 scale
    leaves of one position and head each."""
    if kv_cache_dtype == "int8":
        return {
            "k": ParamDef(shape, log, init="zeros", dtype="int8"),
            "v": ParamDef(shape, log, init="zeros", dtype="int8"),
            "k_scale": ParamDef(shape[:-1], log[:-1], init="zeros",
                                dtype="fp32"),
            "v_scale": ParamDef(shape[:-1], log[:-1], init="zeros",
                                dtype="fp32"),
        }
    return {
        "k": ParamDef(shape, log, init="zeros", dtype="bf16"),
        "v": ParamDef(shape, log, init="zeros", dtype="bf16"),
    }


def cache_spec(cfg: ModelConfig, rcfg: RuntimeConfig, batch: int,
               max_seq: int):
    """Dense slot stripes: (layers, batch, max_seq, K, H) per leaf."""
    Lc, K, H = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    return _kv_spec((Lc, batch, max_seq, K, H),
                    ("layers", "cache_batch", "cache_seq", "cache_heads",
                     None), rcfg.kv_cache_dtype)


def paged_cache_spec(cfg: ModelConfig, rcfg: RuntimeConfig, num_blocks: int,
                     block_size: int):
    """Paged pool layout: (layers, num_blocks, block_size, K, H) per leaf."""
    Lc, K, H = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    return _kv_spec((Lc, num_blocks, block_size, K, H),
                    ("layers", None, None, "cache_heads", None),
                    rcfg.kv_cache_dtype)


def paged_block_bytes(cfg: ModelConfig, block_size: int,
                      kv_cache_dtype: str = "bf16") -> int:
    """Bytes one pool block occupies across all layers (k + v leaves, plus
    the f32 scale stripes for int8): the engine's int8 auto-sizing fits
    2H/(H+4) times the bf16 block count into the same byte budget."""
    Lc, K, H = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    if kv_cache_dtype == "int8":
        return Lc * block_size * K * (2 * H + 2 * 4)
    return Lc * block_size * K * (2 * 2 * H)


def requant_cache(cache_i, k, v):
    if "k_scale" not in cache_i:
        return {"k": k, "v": v}
    # in k's own dtype (bf16 activations give bf16-valued scales), as the
    # JAX package computes them, so both packages store the same int8 bits.
    # A bf16 scale can round below amax/127, putting amax/scale past 127: the
    # JAX conversion saturates there, torch's would wrap, so clamp first.
    ks = torch.clamp_min(k.abs().amax(dim=-1), 1e-8) / 127.0
    vs = torch.clamp_min(v.abs().amax(dim=-1), 1e-8) / 127.0

    def codes(x, s):
        return torch.clamp(torch.round(x / s[..., None]), -128, 127).to(
            torch.int8)

    return {
        "k": codes(k, ks),
        "v": codes(v, vs),
        "k_scale": ks.to(torch.float32),
        "v_scale": vs.to(torch.float32),
    }


def dequant_cache(cache_i):
    """A cache dict {k, v[, k_scale, v_scale]} as bf16 (k, v) views: int8
    codes times their scales in f32, rounded to bf16."""
    if "k_scale" not in cache_i:
        return cache_i["k"], cache_i["v"]
    return tuple((cache_i[n].to(torch.float32)
                  * cache_i[n + "_scale"].unsqueeze(-1)).to(torch.bfloat16)
                 for n in ("k", "v"))


def quantize_kv_for_cache(cache_has_scale: bool, k, v):
    if not cache_has_scale:
        return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    return requant_cache({"k_scale": True}, k, v)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def forward(params, batch, cfg: ModelConfig, rcfg: RuntimeConfig, *,
            collect_kv: bool = False):
    """-> (hidden (B,S,d), stacked (k, v) each (L,B,S,K,H) or None)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params, tokens, cfg)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    cos, sin = rope_for(cfg, pos)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        p_i = layer_params(params, i)
        h = L.rms_norm(x, p_i["norms"]["pre_attn"], cfg.norm_eps)
        a, (k, v) = B_.attn_apply(p_i["attn"], h, cfg, cos=cos, sin=sin)
        x = _mlp_residual(p_i, x + a, cfg)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kv


def prefill(params, batch, cfg: ModelConfig, rcfg: RuntimeConfig):
    """Cold prefill of full prompt rows. batch["tokens"]: (B, S).

    Returns (last-position logits (B, V), the prompt's KV encoded for the
    cache — {k, v[, k_scale, v_scale]} each (L, B, S, ...) — and lengths
    (B,)). The JAX package pads the KV into a dense (L, B, max_seq, ...)
    cache here; the port hands back exactly the S written positions, which
    the paged engine scatters into its blocks and the dense engine copies
    into a slot's stripe, zeroing the rest of it."""
    h, (k, v) = forward(params, batch, cfg, rcfg, collect_kv=True)
    entry = quantize_kv_for_cache(rcfg.kv_cache_dtype == "int8", k, v)
    logits = unembed(params, h[:, -1:, :], cfg)[:, 0]
    lengths = torch.full((k.shape[1],), k.shape[2], dtype=torch.int32,
                         device=k.device)
    return logits, entry, lengths


def _prefill_window(params, batch, prefix_k, prefix_v, prefix_lens,
                    cfg: ModelConfig, rcfg: RuntimeConfig, *,
                    need_logits: bool, all_logits: bool = False):
    """Run a token window over a cached (gathered) prefix, returning the
    window's KV stacks and — when `need_logits` — the last-position logits
    ((B, S, V) at every position with `all_logits`). batch["positions"] is
    (S,) uniform across rows or (B, S) per-row absolute positions;
    prefix_k/v: (L, B, P, K, H), valid below prefix_lens[b]."""
    check_supported(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    Bb, S, _ = x.shape
    q_pos = batch["positions"]
    cos, sin = rope_for(cfg, q_pos if q_pos.ndim == 2 else q_pos[None, :])
    ks, vs = [], []
    for i in range(cfg.num_layers):
        p_i = layer_params(params, i)
        h = L.rms_norm(x, p_i["norms"]["pre_attn"], cfg.norm_eps)
        q, k, v = B_.qkv_proj(p_i["attn"], h, cfg, cos, sin)
        o = L.prefix_attention(q, prefix_k[i], prefix_v[i], k, v, prefix_lens,
                               q_pos)
        a = dense(o.reshape(Bb, S, -1), p_i["attn"]["wo"])
        x = _mlp_residual(p_i, x + a, cfg)
        ks.append(k)
        vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs))
    if not need_logits:
        return None, kv
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if all_logits:
        return unembed(params, x, cfg), kv
    return unembed(params, x[:, -1:, :], cfg)[:, 0], kv


def prefill_paged(params, batch, prefix_k, prefix_v, prefix_lens,
                  cfg: ModelConfig, rcfg: RuntimeConfig):
    """Suffix prefill over a cached prompt prefix (paged prefix-cache hit):
    left-padded suffix rows at uniform absolute positions. Returns
    (last-position logits (B, V), suffix (k, v) each (L, B, S_suf, K, H))."""
    return _prefill_window(params, batch, prefix_k, prefix_v, prefix_lens,
                           cfg, rcfg, need_logits=True)


def prefill_chunk(params, batch, prefix_k, prefix_v, prefix_lens,
                  cfg: ModelConfig, rcfg: RuntimeConfig, *,
                  need_logits: bool):
    """One window of a chunked prefill: the window extends a prompt whose
    first prefix_lens[b] positions already sit in the block pool (the parked
    chain of earlier windows), at its exact absolute positions. Middle
    windows pass `need_logits=False` and get (None, (k, v)): only the final
    window pays for the unembed."""
    return _prefill_window(params, batch, prefix_k, prefix_v, prefix_lens,
                           cfg, rcfg, need_logits=need_logits)


def verify_paged(params, batch, prefix_k, prefix_v, prefix_lens,
                 cfg: ModelConfig, rcfg: RuntimeConfig):
    """Speculative-decode verify: one batched forward over each row's k+1
    candidate window (the last emitted token and k drafts) after its
    canonical prefix. batch["positions"] is (B, W): row b continues from its
    own length. Returns (logits (B, W, V) at every window position, window
    (k, v) each (L, B, W, K, H))."""
    return _prefill_window(params, batch, prefix_k, prefix_v, prefix_lens,
                           cfg, rcfg, need_logits=True, all_logits=True)


def decode_step_paged(params, pool, tokens, lengths, block_tables,
                      cfg: ModelConfig, rcfg: RuntimeConfig, *, seq_cap: int):
    """One token per row against the paged block pool. tokens: (B, 1);
    lengths: (B,) int32 logical fill counts; block_tables: (B, nb) int32
    physical block ids (0 = reserved scratch). The new KV is written into
    `pool` in place; writes at or past `seq_cap` are dropped. Returns
    (logits (B, V), pool)."""
    check_supported(cfg)
    x = embed_tokens(params, tokens, cfg)
    cos, sin = rope_for(cfg, lengths[:, None])
    for i in range(cfg.num_layers):
        p_i = layer_params(params, i)
        h = L.rms_norm(x, p_i["norms"]["pre_attn"], cfg.norm_eps)
        pool_i = {key: leaf[i] for key, leaf in pool.items()}
        a, _ = B_.attn_decode_paged_apply(
            p_i["attn"], h, cfg, cos=cos, sin=sin, pool_i=pool_i,
            lengths=lengths, block_tables=block_tables, seq_cap=seq_cap)
        x = _mlp_residual(p_i, x + a, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg)[:, 0], pool


def decode_step(params, cache, tokens, lengths, cfg: ModelConfig,
                rcfg: RuntimeConfig, positions=None):
    """One token per row against the dense cache of `cache_spec`. tokens:
    (B, 1); lengths: (B,) int32 fill counts. Every row writes its new KV at
    lengths[b] in place (a row at max_seq writes nothing) and attends
    positions below min(lengths[b] + 1, max_seq). Returns (logits (B, V),
    cache)."""
    check_supported(cfg)
    x = embed_tokens(params, tokens, cfg)
    cos, sin = rope_for(cfg, lengths[:, None])
    for i in range(cfg.num_layers):
        p_i = layer_params(params, i)
        h = L.rms_norm(x, p_i["norms"]["pre_attn"], cfg.norm_eps)
        cache_i = {key: leaf[i] for key, leaf in cache.items()}
        a = B_.attn_decode_apply(p_i["attn"], h, cfg, cos=cos, sin=sin,
                                 cache_i=cache_i, lengths=lengths)
        x = _mlp_residual(p_i, x + a, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg)[:, 0], cache
