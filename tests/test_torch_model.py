"""The port's reduced carboncall-qwen2-7b against the JAX package's, logit
for logit, with the same weights moved by `repro_torch.bridge`; and the
paper's other two models, hermes2-pro-8b and llama3.1-8b (no qkv bias, GQA
at 32 / 8 heads), whose reduced configs are one model under two names, so
the reduced hermes2-pro-8b runs the same cases.

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
from repro_torch.models import get_model
from repro_torch.models import transformer as PT
from repro_torch.quant import QTensor as PQTensor
from repro_torch.quant.qtensor import init_quantized
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


def _assert_same_model(ref_cfg, cfg):
    """The port's fields match; the reference's other fields (MoE, SSM,
    hybrid, ...) hold their defaults, so the port's config is the same
    model."""
    shared = set(cfg.__dict__)
    assert {k: v for k, v in ref_cfg.__dict__.items() if k in shared} \
        == cfg.__dict__
    defaults = {f.name: f.default for f in dataclasses.fields(ref_cfg)}
    assert {k: v for k, v in ref_cfg.__dict__.items() if k not in shared} \
        == {k: v for k, v in defaults.items() if k not in shared}


def _setup(arch):
    ref_cfg = ref_reduce(ref_get_arch(arch))
    cfg = reduce_config(get_arch(arch))
    _assert_same_model(ref_cfg, cfg)
    spec = ref_get_model(ref_cfg).param_spec()
    params = ref_init_params(spec, jax.random.PRNGKey(5))
    trees = {}
    for fmt in ("q8", "q4"):
        qp = ref_quantize_tree(params, spec, fmt)
        trees[fmt] = (qp, params_from_numpy(_to_numpy(qp), "cpu"))
    toks = np.random.default_rng(11).integers(2, 512, size=(B, S)).astype(
        np.int32)
    return ref_cfg, cfg, trees, toks


@pytest.fixture(scope="module")
def setup():
    return _setup("carboncall-qwen2-7b")


@pytest.fixture(scope="module")
def hermes():
    return _setup("hermes2-pro-8b")


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
    _prefill_logits_and_kv(setup, fmt, kv)


@pytest.mark.parametrize("fmt,kv", CASES)
def test_hermes_prefill_logits_and_kv(hermes, fmt, kv):
    _prefill_logits_and_kv(hermes, fmt, kv)


def _prefill_logits_and_kv(setup, fmt, kv):
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
    _prefix_window_logits(setup, fmt, kv)


@pytest.mark.parametrize("fmt,kv", CASES)
def test_hermes_prefix_window_logits(hermes, fmt, kv):
    _prefix_window_logits(hermes, fmt, kv)


def _prefix_window_logits(setup, fmt, kv):
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
    _decode_step_paged_logits(setup, fmt, kv)


@pytest.mark.parametrize("fmt,kv", CASES)
def test_hermes_decode_step_paged_logits(hermes, fmt, kv):
    _decode_step_paged_logits(hermes, fmt, kv)


def _decode_step_paged_logits(setup, fmt, kv):
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


def _spec_leaves(spec, prefix=""):
    out = {}
    for k, d in spec.items():
        if isinstance(d, dict):
            out.update(_spec_leaves(d, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(d.shape), tuple(d.logical), d.init,
                               d.dtype)
    return out


def _tree_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, (PQTensor, RefQTensor)):
            for f in ("q", "scale", "zero"):
                a = getattr(v, f)
                if a is not None:
                    out[f"{prefix}{k}/{f}"] = (tuple(a.shape),
                                               str(a.dtype).split(".")[-1])
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


def test_paper_model_configs_match_reference(hermes):
    """hermes2-pro-8b and llama3.1-8b at full width are the reference's
    configs field for field; reduced, they are one model under two names
    (`reduce_config` keeps rope_theta and qkv_bias, and sets the same
    widths for both vocabularies); the reduced hermes has no bq / bk / bv in
    either package's param_spec, whose leaves are the same, and the port's
    quantized trees (drawn, and bridged from the reference's) carry the
    same leaves as the reference's quantized tree."""
    for arch in ("hermes2-pro-8b", "llama3.1-8b"):
        _assert_same_model(ref_get_arch(arch), get_arch(arch))
    full = get_arch("hermes2-pro-8b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size,
            full.rope_theta, full.qkv_bias) == \
        (32, 4096, 32, 8, 128, 14336, 128288, 5e5, False)
    assert get_arch("llama3.1-8b").vocab_size == 128256
    rh = reduce_config(get_arch("hermes2-pro-8b"))
    rl = reduce_config(get_arch("llama3.1-8b"))
    assert rl.name == "llama3.1-8b-reduced" and rh.name != rl.name
    assert dataclasses.replace(rl, name=rh.name) == rh
    ref_rh = ref_reduce(ref_get_arch("hermes2-pro-8b"))
    ref_rl = ref_reduce(ref_get_arch("llama3.1-8b"))
    assert dataclasses.replace(ref_rl, name=ref_rh.name) == ref_rh
    ref_spec = _spec_leaves(ref_get_model(ref_rh).param_spec())
    spec = _spec_leaves(get_model(rh).param_spec())
    assert spec == ref_spec
    assert not any(k.split("/")[-1] in ("bq", "bk", "bv") for k in spec)
    assert "layers/attn/wq" in spec
    ref_cfg, cfg, trees, _ = hermes
    drawn = init_quantized(get_model(cfg).param_spec(), ("q8", "q4"),
                           torch.Generator().manual_seed(0), "cpu")
    for fmt in ("q8", "q4"):
        rp, pp = trees[fmt]
        want = _tree_leaves(rp)
        assert _tree_leaves(pp) == want
        assert _tree_leaves(drawn[fmt]) == want


# ---------------------------------------------------------------------------
# qwen2.5-32b: the configuration, and its reduced model against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen25():
    return _setup("qwen2.5-32b")


def test_qwen25_32b_config_matches_reference():
    """qwen2.5-32b at full width is the reference's config field for field
    (64 layers, d 5120, 40 / 8 heads of 128, d_ff 27648, vocab 152064, qkv
    bias, theta 1e6, untied head), with no field the port lacks; its
    param_spec has the reference's leaves."""
    _assert_same_model(ref_get_arch("qwen2.5-32b"), get_arch("qwen2.5-32b"))
    full = get_arch("qwen2.5-32b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size,
            full.rope_theta, full.qkv_bias, full.tie_embeddings) == \
        (64, 5120, 40, 8, 128, 27648, 152064, 1e6, True, False)
    spec = _spec_leaves(get_model(full).param_spec())
    assert spec == _spec_leaves(ref_get_model(
        ref_get_arch("qwen2.5-32b")).param_spec())
    assert spec["layers/mlp/wg"][0] == (64, 5120, 27648)
    assert spec["lm_head"][0] == (5120, 152064)


@pytest.mark.parametrize("fmt,kv", CASES)
def test_qwen25_prefill_logits_and_kv(qwen25, fmt, kv):
    _prefill_logits_and_kv(qwen25, fmt, kv)


@pytest.mark.parametrize("fmt,kv", CASES)
def test_qwen25_prefix_window_logits(qwen25, fmt, kv):
    _prefix_window_logits(qwen25, fmt, kv)


@pytest.mark.parametrize("fmt,kv", CASES)
def test_qwen25_decode_step_paged_logits(qwen25, fmt, kv):
    _decode_step_paged_logits(qwen25, fmt, kv)
