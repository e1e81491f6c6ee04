"""Mamba2 (SSD — state-space duality) LM: the port of `repro.models.mamba2`.

The O(L) chunked algorithm of the Mamba2 paper: within a chunk of Q tokens
the recurrence is dense masked products, across chunks a carried (P, N)
state per head. Every full-sequence pass (forward, prefill) runs the scan
through `kernels/ssd` — the hand-written Hopper kernel for a CUDA input, the
plain `ssd_chunked` for a CPU input. Decode is the O(1) recurrent step
`ssd_decode` on a (B, H, P, N) state, plain PyTorch (the JAX package has no
Pallas kernel there). Every projection goes through `quant.dense`, so Q8 and
Q4 trees run the quant-matmul kernels on the card.

Layers are stacked on a leading dim (the JAX package's scan layout, so
weight and cache trees cross packages leaf for leaf) and run by a Python
loop. The model is attention-free: its serving cache is the dense per-slot
{conv tail, SSM state} tree of `cache_spec`, and it has no paged contract.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, RuntimeConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import embed_tokens, layer_params, unembed
from repro_torch.quant import dense
from repro_torch.sharding.param import ParamDef


# ---------------------------------------------------------------------------
# SSD decode step
# ---------------------------------------------------------------------------


def ssd_decode(state, x, dt, A, Bv, Cv):
    """One step. state: (B,H,P,N) f32; x: (B,H,P); dt: (B,H); Bv/Cv: (B,G,N)."""
    H = x.shape[1]
    rep = H // Bv.shape[1]
    f32 = torch.float32
    Bh = Bv.repeat_interleave(rep, dim=1).to(f32)
    Ch = Cv.repeat_interleave(rep, dim=1).to(f32)
    dtf = dt.to(f32)
    dA = torch.exp(dtf * A.to(f32))                          # (B,H)
    xdt = x.to(f32) * dtf[..., None]                         # (B,H,P)
    state = state * dA[..., None, None] + xdt[..., :, None] * Bh[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return state, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = cfg.ssm_heads
    conv_dim = d_in + 2 * s.ngroups * s.state_dim
    return d_in, nh, conv_dim


def mamba_spec(cfg: ModelConfig, lead=(), lead_log=()):
    """Split projections (z/x/B/C/dt and three depthwise convs), as the JAX
    package lays them out."""
    d = cfg.d_model
    s = cfg.ssm
    d_in, nh, conv_dim = mamba_dims(cfg)
    gn = s.ngroups * s.state_dim
    w = s.conv_width
    return {
        "norm": ParamDef((*lead, d), (*lead_log, None), init="zeros"),
        "wz": ParamDef((*lead, d, d_in), (*lead_log, "embed", "mlp")),
        "wx": ParamDef((*lead, d, d_in), (*lead_log, "embed", "mlp")),
        "wb": ParamDef((*lead, d, gn), (*lead_log, "embed", None)),
        "wc": ParamDef((*lead, d, gn), (*lead_log, "embed", None)),
        "wdt": ParamDef((*lead, d, nh), (*lead_log, "embed", None)),
        "conv_x_w": ParamDef((*lead, d_in, w), (*lead_log, "mlp", None),
                             init="normal", scale=0.5),
        "conv_x_b": ParamDef((*lead, d_in), (*lead_log, "mlp"), init="zeros"),
        "conv_b_w": ParamDef((*lead, gn, w), (*lead_log, None, None),
                             init="normal", scale=0.5),
        "conv_b_b": ParamDef((*lead, gn), (*lead_log, None), init="zeros"),
        "conv_c_w": ParamDef((*lead, gn, w), (*lead_log, None, None),
                             init="normal", scale=0.5),
        "conv_c_b": ParamDef((*lead, gn), (*lead_log, None), init="zeros"),
        "a_log": ParamDef((*lead, nh), (*lead_log, None), init="ones"),
        "dt_bias": ParamDef((*lead, nh), (*lead_log, None), init="zeros"),
        "d_skip": ParamDef((*lead, nh), (*lead_log, None), init="ones"),
        "gate_norm": ParamDef((*lead, d_in), (*lead_log, None), init="zeros"),
        "out_proj": ParamDef((*lead, d_in, d), (*lead_log, "mlp", "embed")),
    }


def mamba_cache_spec(cfg: ModelConfig, n_layers: int, batch: int):
    s = cfg.ssm
    d_in, nh, conv_dim = mamba_dims(cfg)
    return {
        "conv": ParamDef((n_layers, batch, s.conv_width - 1, conv_dim),
                         ("layers", "cache_batch", None, None),
                         init="zeros", dtype="bf16"),
        "ssm": ParamDef((n_layers, batch, nh, s.head_dim, s.state_dim),
                        ("layers", "cache_batch", "act_heads", None, None),
                        init="zeros", dtype="fp32"),
    }


def _silu(x):
    """SiLU as the JAX package computes it, x * (1 / (1 + exp(-x))) with each
    operation rounded to x's dtype: on bf16 inputs `F.silu` (one rounding)
    lands one bf16 step away from it in ~40% of outputs."""
    return x * (1 / (1 + torch.exp(-x)))


def _causal_conv(x, w, b):
    """x: (B,S,C); w: (C,W); b: (C,). Explicit shifted-sum formulation."""
    W = w.shape[-1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[:, i] for i in range(W))
    return out + b


def mamba_block(p, x, cfg: ModelConfig, *, cache=None):
    """Full-sequence (cache=None -> (y, {conv tail, final state})) or
    one-step decode (cache = {conv, ssm} of this layer, x: (B,1,d))."""
    s = cfg.ssm
    d_in, nh, conv_dim = mamba_dims(cfg)
    gn = s.ngroups * s.state_dim
    f32 = torch.float32
    res = x
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z = dense(h, p["wz"])                                    # (B,S,d_in)
    xr = dense(h, p["wx"])
    Bf = dense(h, p["wb"])                                   # (B,S,gn)
    Cf = dense(h, p["wc"])
    dt_raw = dense(h, p["wdt"])                              # (B,S,nh)
    A = -torch.exp(p["a_log"].to(f32))

    if cache is None:
        conv_tail = torch.cat(
            [t[:, -(s.conv_width - 1):, :] for t in (xr, Bf, Cf)], dim=-1)
        xc = _silu(_causal_conv(xr, p["conv_x_w"], p["conv_x_b"]))
        Bc = _silu(_causal_conv(Bf, p["conv_b_w"], p["conv_b_b"]))
        Cc = _silu(_causal_conv(Cf, p["conv_c_w"], p["conv_c_b"]))
        Bb, S, _ = xc.shape
        xh = xc.reshape(Bb, S, nh, s.head_dim)
        Bm = Bc.reshape(Bb, S, s.ngroups, s.state_dim)
        Cm = Cc.reshape(Bb, S, s.ngroups, s.state_dim)
        dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
        # a CUDA tensor takes the ssd kernel, a CPU tensor ssd_chunked
        y, final = ssd_ops.ssd(xh, dt, A, Bm, Cm, chunk=s.chunk_size)
        y = y + xh * p["d_skip"].to(f32)[None, None, :, None].to(y.dtype)
        y = y.reshape(Bb, S, d_in)
        y = L.rms_norm(y * _silu(z.to(f32)).to(y.dtype), p["gate_norm"],
                       cfg.norm_eps)
        out = dense(y, p["out_proj"])
        return res + out, {"conv": conv_tail.to(torch.bfloat16),
                           "ssm": final}

    # ---- decode: one token ----
    Bb = x.shape[0]
    raw1 = torch.cat([xr[:, 0], Bf[:, 0], Cf[:, 0]], dim=-1)
    full = torch.cat([cache["conv"].to(raw1.dtype), raw1[:, None]],
                     dim=1)                                  # (B, W, conv_dim)
    conv_w = torch.cat([p["conv_x_w"], p["conv_b_w"], p["conv_c_w"]], dim=0)
    conv_b = torch.cat([p["conv_x_b"], p["conv_b_b"], p["conv_c_b"]], dim=0)
    conv_out = _silu(torch.einsum("bwc,cw->bc", full.to(f32), conv_w.to(f32))
                      + conv_b.to(f32)).to(x.dtype)
    new_conv = full[:, 1:].to(cache["conv"].dtype)
    xr2, Bf2, Cf2 = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    xh = xr2.reshape(Bb, nh, s.head_dim)
    Bv = Bf2.reshape(Bb, s.ngroups, s.state_dim)
    Cv = Cf2.reshape(Bb, s.ngroups, s.state_dim)
    dt = F.softplus(dt_raw[:, 0].to(f32) + p["dt_bias"].to(f32))
    state, y = ssd_decode(cache["ssm"], xh, dt, A, Bv, Cv)
    y = y + xh * p["d_skip"].to(y.dtype)[None, :, None]
    y = y.reshape(Bb, 1, d_in)
    y = L.rms_norm(y * _silu(z[:, :1].to(f32)).to(y.dtype), p["gate_norm"],
                   cfg.norm_eps)
    out = dense(y, p["out_proj"])
    return res + out, {"conv": new_conv, "ssm": state}


# ---------------------------------------------------------------------------
# Full mamba2 LM (attention-free)
# ---------------------------------------------------------------------------


def param_spec(cfg: ModelConfig):
    Lc, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    spec = {
        "embed": ParamDef((V, d), ("vocab", "embed"), init="embed"),
        "layers": mamba_spec(cfg, (Lc,), ("layers",)),
        "final_norm": ParamDef((d,), (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    return spec


def cache_spec(cfg: ModelConfig, rcfg: RuntimeConfig, batch: int,
               max_seq: int):
    """Dense serving cache: {conv (L,B,W-1,conv_dim) bf16, ssm (L,B,H,P,N)
    f32}, independent of max_seq."""
    return mamba_cache_spec(cfg, cfg.num_layers, batch)


def forward(params, batch, cfg: ModelConfig, rcfg: RuntimeConfig, *,
            collect_kv: bool = False):
    """-> (hidden (B,S,d), stacked per-layer {conv, ssm} states or None)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    convs, ssms = [], []
    for i in range(cfg.num_layers):
        x, st = mamba_block(layer_params(params, i), x, cfg)
        if collect_kv:
            convs.append(st["conv"])
            ssms.append(st["ssm"])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    states = ({"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
              if collect_kv else None)
    return x, states


def prefill(params, batch, cfg: ModelConfig, rcfg: RuntimeConfig):
    """Full prompt rows. batch["tokens"]: (B, S). Returns (last-position
    logits (B, V), the rows' cache {conv, ssm} each (L, B, ...), lengths (B,)
    = S). The JAX package writes into a zero cache it is handed; the cache
    here is exactly the states, for the engine to copy into its slots."""
    h, states = forward(params, batch, cfg, rcfg, collect_kv=True)
    logits = unembed(params, h[:, -1:, :], cfg)[:, 0]
    Bb, S = batch["tokens"].shape
    lengths = torch.full((Bb,), S, dtype=torch.int32, device=h.device)
    return logits, states, lengths


def decode_step(params, cache, tokens, lengths, cfg: ModelConfig,
                rcfg: RuntimeConfig, positions=None):
    """One token per row. tokens: (B, 1); cache {conv, ssm} (L, B, ...),
    updated in place (each layer's new state replaces its old one). Returns
    (logits (B, V), cache). The state carries the position, so `lengths` and
    `positions` are not read."""
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.num_layers):
        c_i = {k: v[i] for k, v in cache.items()}
        x, c_new = mamba_block(layer_params(params, i), x, cfg, cache=c_i)
        for k, v in c_new.items():
            cache[k][i] = v
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg)[:, 0], cache
