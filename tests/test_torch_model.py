"""The port's reduced carboncall-qwen2-7b against the JAX package's, logit
for logit, with the same weights moved by `repro_torch.bridge`.

Covers cold prefill (`prefill` -> `forward`), the cache-hit window
(`prefill_paged` -> `_prefill_window`) and one paged decode step, for the Q8
and Q4 trees with bf16 and int8 KV. Both sides get identical inputs: the
decode step reads the same pool contents, the window the same prefix view.

Tolerance: logits leave the model as bf16 values (the LM head's output) cast
to f32, so at |logit| < 4 one bf16 step is up to 0.016; the two packages
round activations at different places and land up to a few steps apart
(measured <= 0.035 for prefill and window, <= 0.05 for an int8 decode
step, whose new KV row is re-encoded on each side). LOGIT_TOL = 0.08.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch as ref_get_arch
from repro.config import RuntimeConfig as RefRuntimeConfig
from repro.configs.reduced import reduce_config as ref_reduce
from repro.models import get_model as ref_get_model
from repro.models import transformer as RT
from repro.quant import QTensor as RefQTensor
from repro.quant import quantize_tree as ref_quantize_tree
from repro.sharding.param import init_params as ref_init_params

from repro_torch.bridge import params_from_numpy
from repro_torch.common.registry import get_arch
from repro_torch.config import RuntimeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import transformer as PT
from repro_torch.sharding.param import init_params

LOGIT_TOL = 0.08
B, S, P = 4, 64, 32


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, RefQTensor):
        return RefQTensor(q=np.asarray(tree.q), scale=np.asarray(tree.scale),
                          zero=None if tree.zero is None
                          else np.asarray(tree.zero),
                          fmt=tree.fmt, group=tree.group)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_reduce(ref_get_arch("carboncall-qwen2-7b"))
    cfg = reduce_config(get_arch("carboncall-qwen2-7b"))
    # the port's fields match; the reference's other fields (MoE, SSM,
    # hybrid, ...) hold their defaults, so the port's config is the same model
    shared = set(cfg.__dict__)
    assert {k: v for k, v in ref_cfg.__dict__.items() if k in shared} \
        == cfg.__dict__
    defaults = {f.name: f.default for f in dataclasses.fields(ref_cfg)}
    assert {k: v for k, v in ref_cfg.__dict__.items() if k not in shared} \
        == {k: v for k, v in defaults.items() if k not in shared}
    spec = ref_get_model(ref_cfg).param_spec()
    params = ref_init_params(spec, jax.random.PRNGKey(5))
    trees = {}
    for fmt in ("q8", "q4"):
        qp = ref_quantize_tree(params, spec, fmt)
        trees[fmt] = (qp, params_from_numpy(_to_numpy(qp), "cpu"))
    toks = np.random.default_rng(11).integers(2, 512, size=(B, S)).astype(
        np.int32)
    return ref_cfg, cfg, trees, toks


def _close(a, b):
    a = np.asarray(a, np.float32)
    b = b.detach().numpy().astype(np.float32)
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err < LOGIT_TOL, err
    return err


CASES = [(f, kv) for f in ("q8", "q4") for kv in ("bf16", "int8")]


@pytest.mark.parametrize("fmt,kv", CASES)
def test_prefill_logits_and_kv(setup, fmt, kv):
    ref_cfg, cfg, trees, toks = setup
    rp, pp = trees[fmt]
    rrc = RefRuntimeConfig(kv_cache_dtype=kv)
    cache = ref_init_params(ref_get_model(ref_cfg).cache_spec(rrc, B, 128),
                            jax.random.PRNGKey(0))
    lr, rcache, rlen = RT.prefill(rp, cache, {"tokens": jnp.asarray(toks)},
                                  ref_cfg, rrc)
    lp, entry, plen = PT.prefill(pp, {"tokens": torch.as_tensor(toks)}, cfg,
                                 RuntimeConfig(kv_cache_dtype=kv))
    _close(lr, lp)
    assert np.array_equal(np.asarray(rlen), plen.numpy())
    # the cached KV, dequantized, agrees within the int8 step / bf16 rounding
    for key in ("k", "v"):
        want = np.asarray(rcache[key][:, :, :S], np.float32)
        got = entry[key].float()
        if kv == "int8":
            want = want * np.asarray(rcache[key + "_scale"][:, :, :S])[..., None]
            got = got * entry[key + "_scale"][..., None]
        got = got.numpy()
        tol = 0.05 * max(1.0, float(np.max(np.abs(want))))
        assert float(np.max(np.abs(want - got))) < tol


@pytest.mark.parametrize("fmt,kv", CASES)
def test_prefix_window_logits(setup, fmt, kv):
    ref_cfg, cfg, trees, toks = setup
    rp, pp = trees[fmt]
    g = np.random.default_rng(12)
    Lc, K, H = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    kpre = (g.standard_normal((Lc, B, P, K, H)) * 2).astype(np.float32)
    vpre = g.standard_normal((Lc, B, P, K, H)).astype(np.float32)
    kpre_t = torch.as_tensor(kpre).bfloat16()
    vpre_t = torch.as_tensor(vpre).bfloat16()
    plens = np.array([0, 16, 32, 32], np.int32)   # a cold row among hits
    pos = np.arange(P, S, dtype=np.int32)
    suf = toks[:, P:]
    lr, (rk, rv) = RT.prefill_paged(
        rp, {"tokens": jnp.asarray(suf), "positions": jnp.asarray(pos)},
        jnp.asarray(kpre).astype(jnp.bfloat16),
        jnp.asarray(vpre).astype(jnp.bfloat16), jnp.asarray(plens), ref_cfg,
        RefRuntimeConfig(kv_cache_dtype=kv))
    lp, (pk, pv) = PT.prefill_paged(
        pp, {"tokens": torch.as_tensor(suf), "positions": torch.as_tensor(pos)},
        kpre_t, vpre_t, torch.as_tensor(plens), cfg,
        RuntimeConfig(kv_cache_dtype=kv))
    _close(lr, lp)
    assert tuple(pk.shape) == tuple(rk.shape)


@pytest.mark.parametrize("fmt,kv", CASES)
def test_decode_step_paged_logits(setup, fmt, kv):
    ref_cfg, cfg, trees, toks = setup
    rp, pp = trees[fmt]
    rc = RuntimeConfig(kv_cache_dtype=kv)
    nb, bs = 8, 16
    pool = init_params(PT.paged_cache_spec(cfg, rc, B * nb + 1, bs), None,
                       "cpu")
    g = np.random.default_rng(13)
    from repro_torch.models.transformer import quantize_kv_for_cache
    Lc, K, H = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    kf = torch.as_tensor(g.standard_normal((Lc, B * nb + 1, bs, K, H)),
                         dtype=torch.float32).bfloat16()
    vf = torch.as_tensor(g.standard_normal((Lc, B * nb + 1, bs, K, H)),
                         dtype=torch.float32).bfloat16()
    for key, val in quantize_kv_for_cache(kv == "int8", kf, vf).items():
        pool[key].copy_(val)
    ref_pool = {k: (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                    if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
                for k, v in pool.items()}
    perm = g.permutation(np.arange(1, B * nb + 1)).astype(np.int32)
    bt = perm.reshape(B, nb)
    bt[0] = 0                                    # a dead row on block 0
    lens = np.array([0, 17, 100, 128], np.int32)  # crosses the split at 8 blocks
    last = toks[:, :1]
    lr, rpool = RT.decode_step_paged(rp, ref_pool, jnp.asarray(last),
                                     jnp.asarray(lens), jnp.asarray(bt),
                                     ref_cfg, RefRuntimeConfig(kv_cache_dtype=kv),
                                     seq_cap=128)
    lp, ppool = PT.decode_step_paged(pp, pool, torch.as_tensor(last),
                                     torch.as_tensor(lens), torch.as_tensor(bt),
                                     cfg, rc, seq_cap=128)
    _close(lr[1:], lp[1:])                       # row 0 is dead
    # the new token's KV landed in the same physical slots, with the same
    # values up to rounding (int8: a few codes, as for the prefill KV)
    for b in (1, 2):
        bid, off = bt[b, lens[b] // bs], lens[b] % bs
        want = np.asarray(rpool["k"][:, bid, off], np.float32)
        got = ppool["k"][:, bid, off].float().numpy()
        if kv == "int8":
            want = want * np.asarray(rpool["k_scale"][:, bid, off])[..., None]
            got = got * ppool["k_scale"][:, bid, off].numpy()[..., None]
        tol = 0.05 * max(1.0, float(np.max(np.abs(want))))
        assert float(np.max(np.abs(want - got))) < tol
