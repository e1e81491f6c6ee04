"""Zamba2-style hybrid: a Mamba2 backbone with *shared* attention blocks, the
port of `repro.models.hybrid`.

Layout for `num_layers` block applications with `attn_every = k`:
  * groups of (k-1) mamba blocks, each followed by one shared attention+MLP
    block;
  * `num_shared_attn_sets` weight sets alternate across groups: group g
    uses set g mod num_shared_attn_sets (zamba2-7b: 13 attention
    applications over 2 sets);
  * the leftover applications at the end are plain mamba blocks (the tail).
As in the JAX package (its documented simplification of the released
Zamba2), the shared block attends over the current hidden state alone,
with no window and no LoRA adapters.

Mamba blocks are `mamba2.mamba_block` (the ssd kernel at prefill on the
card) and the shared block is `blocks.attn_apply` (the flash kernel) /
`blocks.attn_decode_apply` (plain decode attention over the dense stripe,
as the JAX package reads it). The serving cache is the reference's tree:
{"mamba": {conv, ssm} per grouped mamba block, "attn": the KV stripes of
one layer per group (not per weight set), "mamba_tail": {conv, ssm}}. The
hybrid has no paged contract.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.tree import tree_map
from repro_torch.config import ModelConfig, RuntimeConfig
from repro_torch.models import blocks as B_
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mamba2 import mamba_block, mamba_cache_spec, mamba_spec
from repro_torch.sharding.param import ParamDef


def _layout(cfg: ModelConfig):
    k = cfg.attn_every
    groups = cfg.num_layers // k           # full (k-1 mamba + attn) groups
    per_group_mamba = k - 1
    trailing = cfg.num_layers - groups * k  # extra mamba blocks at the end
    return groups, per_group_mamba, trailing


def param_spec(cfg: ModelConfig):
    d, V = cfg.d_model, cfg.vocab_size
    groups, pgm, trailing = _layout(cfg)
    S = cfg.num_shared_attn_sets
    spec = {
        "embed": ParamDef((V, d), ("vocab", "embed"), init="embed"),
        "mamba": mamba_spec(cfg, (groups * pgm,), ("layers",)),
        "shared_attn": {
            "attn": B_.attn_spec(cfg, (S,), ("layers",)),
            "mlp": B_.mlp_spec(cfg, (S,), ("layers",)),
            "norms": B_.block_norms_spec(cfg, (S,), ("layers",)),
        },
        "final_norm": ParamDef((d,), (None,), init="zeros"),
    }
    if trailing:
        spec["mamba_tail"] = mamba_spec(cfg, (trailing,), ("layers",))
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    return spec


def cache_spec(cfg: ModelConfig, rcfg: RuntimeConfig, batch: int,
               max_seq: int):
    """The dense serving cache: the grouped mamba blocks' and the tail's
    {conv, ssm} states and one (max_seq, K, H) KV stripe per group."""
    groups, pgm, trailing = _layout(cfg)
    spec = {
        "mamba": mamba_cache_spec(cfg, groups * pgm, batch),
        "attn": T.cache_spec(dataclasses.replace(cfg, num_layers=groups),
                             rcfg, batch, max_seq),
    }
    if trailing:
        spec["mamba_tail"] = mamba_cache_spec(cfg, trailing, batch)
    return spec


def _at(tree, i: int):
    """Slice i of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


def _mamba_run(params, x, cfg: ModelConfig, first: int, n: int, states):
    """Stacked mamba blocks [first, first + n) of `params` over x in order,
    appending each block's {conv, ssm} state to `states` (a list, or
    None)."""
    for i in range(first, first + n):
        x, st = mamba_block(_at(params, i), x, cfg)
        if states is not None:
            states.append(st)
    return x


def _stack_states(states):
    return {key: torch.stack([s[key] for s in states])
            for key in ("conv", "ssm")}


def forward(params, batch, cfg: ModelConfig, rcfg: RuntimeConfig, *,
            collect_kv: bool = False):
    """-> (hidden (B,S,d), None or {"mamba", "attn_kv" ((k, v) each
    (groups,B,S,K,H)), "mamba_tail"} states)."""
    x = T.embed_tokens(params, batch["tokens"], cfg)
    S = x.shape[1]
    cos, sin = T.rope_for(cfg, torch.arange(S, device=x.device)[None, :])
    groups, pgm, trailing = _layout(cfg)
    nsets = cfg.num_shared_attn_sets
    m_states = [] if collect_kv else None
    t_states = [] if collect_kv else None
    ks, vs = [], []
    for g in range(groups):
        x = _mamba_run(params["mamba"], x, cfg, g * pgm, pgm, m_states)
        p_s = _at(params["shared_attn"], g % nsets)
        h = L.rms_norm(x, p_s["norms"]["pre_attn"], cfg.norm_eps)
        a, (k, v) = B_.attn_apply(p_s["attn"], h, cfg, cos=cos, sin=sin)
        x = T.mlp_residual(p_s, x + a, cfg)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    if trailing:
        x = _mamba_run(params["mamba_tail"], x, cfg, 0, trailing, t_states)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not collect_kv:
        return x, None
    return x, {"mamba": _stack_states(m_states),
               "attn_kv": (torch.stack(ks), torch.stack(vs)),
               "mamba_tail": _stack_states(t_states) if trailing else None}


def prefill(params, batch, cfg: ModelConfig, rcfg: RuntimeConfig):
    """Full prompt rows. batch["tokens"]: (B, S). Returns (last-position
    logits (B, V), the rows' cache entry in `cache_spec`'s tree — the mamba
    and tail states whole, the attention KV of the S written positions,
    bf16 or int8 with scales — and lengths (B,) = S). The dense engine
    copies each row's leaves into its slot."""
    h, states = forward(params, batch, cfg, rcfg, collect_kv=True)
    logits = T.unembed(params, h[:, -1:, :], cfg)[:, 0]
    k, v = states["attn_kv"]
    entry = {"mamba": states["mamba"],
             "attn": T.quantize_kv_for_cache(
                 rcfg.kv_cache_dtype == "int8", k, v)}
    if states["mamba_tail"] is not None:
        entry["mamba_tail"] = states["mamba_tail"]
    Bb, S = batch["tokens"].shape
    lengths = torch.full((Bb,), S, dtype=torch.int32, device=h.device)
    return logits, entry, lengths


def _mamba_decode(params, cache, x, cfg: ModelConfig, first: int, n: int):
    """Stacked blocks [first, first + n) of `params` / `cache`, one token,
    each layer's state replaced in place."""
    for i in range(first, first + n):
        c_i = {key: leaf[i] for key, leaf in cache.items()}
        x, c_new = mamba_block(_at(params, i), x, cfg, cache=c_i)
        for key, val in c_new.items():
            cache[key][i] = val
    return x


def decode_step(params, cache, tokens, lengths, cfg: ModelConfig,
                rcfg: RuntimeConfig, positions=None):
    """One token per row. tokens: (B, 1); lengths: (B,) int32 fill counts
    of the attention stripes. The cache is updated in place: each mamba
    block's state is replaced, and each group's stripe gets the new KV at
    lengths[b] (a row at max_seq writes nothing). Returns (logits (B, V),
    cache)."""
    x = T.embed_tokens(params, tokens, cfg)
    cos, sin = T.rope_for(cfg, lengths[:, None])
    groups, pgm, trailing = _layout(cfg)
    nsets = cfg.num_shared_attn_sets
    for g in range(groups):
        x = _mamba_decode(params["mamba"], cache["mamba"], x, cfg, g * pgm,
                          pgm)
        p_s = _at(params["shared_attn"], g % nsets)
        h = L.rms_norm(x, p_s["norms"]["pre_attn"], cfg.norm_eps)
        a = B_.attn_decode_apply(p_s["attn"], h, cfg, cos=cos, sin=sin,
                                 cache_i=_at(cache["attn"], g),
                                 lengths=lengths)
        x = T.mlp_residual(p_s, x + a, cfg)
    if trailing:
        x = _mamba_decode(params["mamba_tail"], cache["mamba_tail"], x, cfg,
                          0, trailing)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return T.unembed(params, x, cfg)[:, 0], cache
