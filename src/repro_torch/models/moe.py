"""Mixture-of-Experts block: top-k routing with capacity-based dispatch.

The port of `repro.models.moe`'s local path (`moe_local`, the JAX package's
single-device path and its oracle); the expert-parallel `moe_shardmap`
waits for the mesh (ROADMAP Queue 1 item 9) and the router's aux and z
losses for training (item 8). Every detail that decides which token is
dropped is the reference's:
  * the capacity `max(8, ceil(k * T * capacity_factor / E))` rounded up to
    8 counts every row of the call, pad rows and pad tokens included, so a
    caller must hand this block the reference's exact (B, S);
  * the router runs in f32 (x @ router, softmax), the top k breaks ties to
    the lower expert index as `jax.lax.top_k` does (`torch.topk` promises
    no order), and the k weights are renormalised by max(sum, 1e-9);
  * a slot's position in its expert is the running count over slots in
    token-major order, each token's k choices in top-k order; a slot at or
    past the capacity is dropped;
  * the combine is in x's dtype: each kept row of the expert output times
    its (weight * keep) cast to that dtype, summed over the token's k slots
    in slot order, then the shared expert's MLP added where there is one.
The expert FFN is one batched product per matrix (`quant.dense`: quantized
experts are dequantized to bf16 first, as in the reference, which reaches
no Pallas kernel there); pad slots of the (E, C, d) buffer are zero rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.topk_sim.ref import order_key
from repro_torch.models.blocks import act, mlp_apply, mlp_spec
from repro_torch.quant import QTensor, dense, dequantize
from repro_torch.sharding.param import ParamDef


def moe_spec(cfg: ModelConfig, lead=(), lead_log=()):
    d, m = cfg.d_model, cfg.moe
    E, f = m.num_experts, m.d_ff
    s = {
        "router": ParamDef((*lead, d, E), (*lead_log, "embed", None),
                           init="small"),
        "wg": ParamDef((*lead, E, d, f),
                       (*lead_log, "experts", "embed", "expert_mlp")),
        "wu": ParamDef((*lead, E, d, f),
                       (*lead_log, "experts", "embed", "expert_mlp")),
        "wo": ParamDef((*lead, E, f, d),
                       (*lead_log, "experts", "expert_mlp", "embed")),
    }
    if m.shared_expert:
        s["shared"] = mlp_spec(cfg, lead, lead_log, d_ff=f)
    return s


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(m.experts_per_token * tokens * m.capacity_factor
                      / m.num_experts))
    return max(8, ((c + 7) // 8) * 8)


def _top_k(probs, k: int):
    """The k largest entries of each row, highest first, equal values in
    index order (`jax.lax.top_k`'s order)."""
    _, idx = torch.sort(order_key(probs), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def _route(x2d, router_w, cfg: ModelConfig):
    """x2d: (T, d) -> (weights (T, k) f32, experts (T, k))."""
    logits = x2d.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    topw, topi = _top_k(probs, cfg.moe.experts_per_token)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return topw, topi


def _dispatch_compute(x2d, topw, topi, wg, wu, wo, cfg: ModelConfig):
    """Capacity dispatch of x2d's T rows over all E experts and the
    weighted combine -> (T, d). No host synchronisation: dropped slots
    write a spare buffer row and combine with weight 0."""
    T, d = x2d.shape
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    C = _capacity(T, cfg)
    slot_e = topi.reshape(T * k)
    slot_w = topw.reshape(T * k)
    slot_tok = torch.arange(T, device=x2d.device).repeat_interleave(k)
    oh = F.one_hot(slot_e, E)                                # (T*k, E)
    pos = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(-1)       # (T*k,)
    keep = pos < C
    # kept slots own distinct rows of the (E * C) buffer; dropped ones all
    # land on row E * C, which is cut off
    dest = torch.where(keep, slot_e * C + pos, torch.full_like(pos, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf.index_copy_(0, dest, x2d[slot_tok])
    buf = buf[:E * C].reshape(E, C, d)
    h = act(dense(buf, wg), cfg.act_fn) * dense(buf, wu)
    out_e = dense(h, wo).reshape(E * C, d)
    src = torch.where(keep, dest, torch.zeros_like(dest))
    scale = (slot_w * keep).to(x2d.dtype)[:, None]
    gathered = (out_e[src] * scale).reshape(T, k, d)
    y = gathered[:, 0]
    for j in range(1, k):
        y = y + gathered[:, j]
    return y


def moe_local(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d), every row of the call routed together."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    router = p["router"]
    if isinstance(router, QTensor):
        router = dequantize(router)
    topw, topi = _route(x2d, router, cfg)
    y = _dispatch_compute(x2d, topw, topi, p["wg"], p["wu"], p["wo"], cfg)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x2d, cfg)
    return y.reshape(B, S, d)


def moe_apply(p, x, cfg: ModelConfig):
    """The MoE MLP of one layer: the local path (one card)."""
    return moe_local(p, x, cfg)
