"""Repairs of the port's own faults, on the CPU:

  * `sim_scores` takes any number of query rows in one launch: `ops.plan`
    loops groups of 4 rows inside the kernel, the last group padded with
    copies of row 0, and maxes over the groups. The grouping is checked
    here with the plain scorer per group, against the Pallas kernel in
    interpret mode and the reference's top k. SCORE_TOL = 1e-5, the
    retrieval tolerance.
  * One seed gives the same encoder weights on every device: the selector
    draws its trees on a CPU generator and moves them. The card is stood in
    for by the "meta" device, which keeps shapes and no values: the draw
    must consume the CPU generator exactly as a CPU draw does.
  * The plain decode and chunked attention scale a bf16 query as the JAX
    package does: q / sqrt(H) in q's dtype, by the divisor rounded to it,
    then f32. The scaled query is held to the reference's bit for bit; the
    outputs to ATTN_ULPS bf16 step of the reference's (the step at
    ATTN_FLOOR for outputs below it), with at most
    ATTN_FLIP_FRAC of them differing at all: the two frameworks' f32 exp and
    sum orders differ in the last place (torch.softmax and jax.nn.softmax
    on equal f32 logits differ in about half the probabilities by one f32
    step), which moves a bf16 rounding in about one output in 10^4. Before
    the repair about 40% of the outputs differed (6905 of 14336 in the
    decode case without window or softcap).
  * The engine and the executor serve the transformer's dense layout, with
    and without chunked prefill, as the reference does; speculative decoding
    on it, and chunked prefill over mamba2, stay the reference's
    ValueError.
  * A CUDA paged engine checks, when it is built, that the paged decode
    kernel takes its block size (a multiple of 16 up to 128), its query
    heads per kv head (at most 8) and its head dim; a CPU engine, whose
    decode reads through the plain version, takes any block size.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_sim import ops as ref_ops
from repro.kernels.topk_sim import topk_sim as ref_kernel
from repro.models import layers as RL

from repro_torch.common.hardware import ORIN_AGX
from repro_torch.common.registry import get_arch
from repro_torch.common.tree import tree_map
from repro_torch.config import RuntimeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.core import embedder as E
from repro_torch.core.engine_executor import EngineExecutor
from repro_torch.core.executor import PAPER_MODELS
from repro_torch.core.tool_select import ToolSelector
from repro_torch.kernels.topk_sim import ops
from repro_torch.kernels.topk_sim.ref import sim_scores_ref
from repro_torch.models import layers as PL
from repro_torch.serving import (EngineConfig, ServingEngine,
                                 SpecDecodeConfig)
from repro_torch.serving import engine as engine_mod

SCORE_TOL = 1e-5
ATTN_ULPS = 1                   # bf16 steps of the reference's output
ATTN_FLIP_FRAC = 1e-3           # of the outputs that may differ at all
ATTN_FLOOR = 2.0 ** -10         # |output| below which the step is fixed


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@pytest.mark.parametrize("m", [33, 40, 64])
def test_sim_scores_grouping_matches_reference(m):
    g = np.random.default_rng(m)
    N, d, k = 256, 64, 16
    tools = _unit(g.standard_normal((N, d))).astype(np.float32)
    queries = _unit(g.standard_normal((m, d))).astype(np.float32)
    pl = ops.plan(N, d, m, 0, sms=132)
    assert (pl.mq, pl.groups) == (4, -(-m // 4))
    # the kernel's query rows: m, then copies of row 0 up to whole groups
    rows = np.concatenate([queries, np.repeat(queries[:1],
                                              pl.mq * pl.groups - m, 0)])
    got = torch.stack([
        sim_scores_ref(torch.from_numpy(tools),
                       torch.from_numpy(rows[i * pl.mq:(i + 1) * pl.mq]))
        for i in range(pl.groups)]).amax(0)
    want = np.asarray(ref_kernel.sim_scores(jnp.asarray(tools),
                                            jnp.asarray(queries), bt=256,
                                            interpret=True))
    assert float(np.max(np.abs(got.numpy() - want))) <= SCORE_TOL
    _, got_i = ops.top_k(got, k)
    _, want_i = ref_ops.topk_tools(jnp.asarray(tools), jnp.asarray(queries),
                                   k=k)
    assert got_i.tolist() == np.asarray(want_i).tolist()


def test_encoder_trees_are_drawn_on_the_cpu_for_any_device():
    assert ToolSelector._generator(0).device.type == "cpu"
    for init in (E.init_encoder, E.init_cross):
        g_cpu, g_dev = ToolSelector._generator(0), ToolSelector._generator(0)
        on_cpu = init(g_cpu, "cpu")
        on_dev = init(g_dev, "meta")
        assert torch.equal(g_cpu.get_state(), g_dev.get_state())
        tree_map(lambda a, b: None if (a.shape == b.shape and a.dtype == b.dtype
                                       and b.device.type == "meta")
                 else pytest.fail("leaf differs"), on_cpu, on_dev)
        # and a second CPU draw from the same seed is the same tree
        again = init(ToolSelector._generator(0), "cpu")
        tree_map(lambda a, b: None if torch.equal(a, b)
                 else pytest.fail("draw differs"), on_cpu, again)


def test_selector_on_cpu_uses_the_seeded_cpu_encoder():
    from repro_torch.data.workload import build_catalog
    sel = ToolSelector(build_catalog(16, seed=0), seed=3, device="cpu",
                       rcfg=RuntimeConfig())
    want = E.init_encoder(torch.Generator().manual_seed(3), "cpu")
    tree_map(lambda a, b: None if torch.equal(a, b)
             else pytest.fail("encoder differs"), sel.encoder_params, want)


def _bf16(g, shape, scale=1.0):
    a = (g.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.tensor(a).bfloat16()


def _attn_close(want, got):
    """-> outputs that differ; each within ATTN_ULPS bf16 steps."""
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    assert w.shape == g.shape
    # a bf16 step at |w|: 2^(exponent - 7), taken at |w| >= ATTN_FLOOR: an
    # output near 0 is a cancelling sum, whose f32 error is set by its terms
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), ATTN_FLOOR))) - 7)
    assert (np.abs(w - g) <= ATTN_ULPS * step).all()
    n = int((w != g).sum())
    assert n <= ATTN_FLIP_FRAC * w.size, (n, w.size)
    return n


@pytest.mark.parametrize("kw", [{}, {"window": 8}, {"cap": 5.0}],
                         ids=["plain", "window", "softcap"])
def test_decode_attention_scales_bf16_q_as_reference(kw):
    B, S, K, G, H = 4, 64, 4, 7, 128
    g = np.random.default_rng(0)
    qj, qt = _bf16(g, (B, 1, K * G, H), 3.0)
    kj, kt = _bf16(g, (B, S, K, H))
    vj, vt = _bf16(g, (B, S, K, H))
    lens = np.array([64, 40, 17, 9], np.int32)
    qr = (qj.reshape(B, K, G, H) / jnp.sqrt(H)).astype(jnp.float32)
    assert np.array_equal(np.asarray(qr),
                          PL._scale_q(qt.reshape(B, K, G, H), H).numpy())
    want = RL.decode_attention(qj, kj, vj, jnp.asarray(lens), **kw)
    got = PL.decode_attention(qt, kt, vt, torch.tensor(lens), **kw)
    n = _attn_close(want, got)
    print(f"decode {kw}: {n} of {got.numel()} outputs differ")


def test_chunked_attention_scales_bf16_q_as_reference():
    """Two KV chunks of 512: the carried softmax statistics included."""
    B, S, N, K, H = 2, 1024, 4, 2, 32
    g = np.random.default_rng(1)
    qj, qt = _bf16(g, (B, S, N, H), 3.0)
    kj, kt = _bf16(g, (B, S, K, H))
    vj, vt = _bf16(g, (B, S, K, H))
    qr = (qj.swapaxes(1, 2) / jnp.sqrt(H)).astype(jnp.float32)
    assert np.array_equal(np.asarray(qr),
                          PL._scale_q(qt.transpose(1, 2), H).numpy())
    assert not np.array_equal(                  # what the repair changed
        np.asarray(qr), (qt.transpose(1, 2).float() / math.sqrt(H)).numpy())
    want = RL.chunked_attention(qj, kj, vj, chunk=512)
    got = PL.chunked_attention(qt, kt, vt, chunk=512)
    n = _attn_close(want, got)
    print(f"chunked: {n} of {got.numel()} outputs differ")


def _build(entry, config, arch="carboncall-qwen2-7b"):
    if entry == "engine":
        return ServingEngine(reduce_config(get_arch(arch)), None,
                             RuntimeConfig(), config=config, device="cpu")
    return EngineExecutor(PAPER_MODELS["qwen2-7b"], ORIN_AGX, arch=arch,
                          config=config, device="cpu").engine


@pytest.mark.parametrize("config,item", [
    # the items that refused these are done: the transformer's dense layout
    # (item 4.3) and its chunk branch (item 4.1) are served, as the JAX
    # package serves them; speculative decoding needs the paged layout (the
    # JAX package's ValueError)
    pytest.param(EngineConfig(prefill_chunk=30, kv_layout="dense"), None,
                 id="config0-Queue 1 item 4.1"),
    pytest.param(EngineConfig(spec_decode=SpecDecodeConfig(),
                              kv_layout="dense"),
                 (ValueError, "requires the paged KV layout"),
                 id="config1-Queue 1 item 4.2"),
    pytest.param(EngineConfig(kv_layout="dense"), None,
                 id="config2-Queue 1 item 4.3"),
])
@pytest.mark.parametrize("entry", ["engine", "executor"])
def test_refusals_name_the_roadmap_items(config, item, entry):
    """What stays refused, both entry points refuse before any weights are
    used, so the engine gets none; what the done items brought is served on
    the dense layout, its chunk window unrounded."""
    if item is None:
        eng = _build(entry, config)
        assert eng.kv_layout == "dense"
        assert eng.prefill_chunk == config.prefill_chunk
        assert set(eng.cache) == {"k", "v"}
        return
    exc, match = item
    with pytest.raises(exc, match=match):
        _build(entry, config)


@pytest.mark.parametrize("entry", ["engine", "executor"])
def test_mamba2_refuses_chunked_prefill_as_reference(entry):
    """Chunked prefill over mamba2 is the JAX package's ValueError, from the
    engine and from the executor, which otherwise serves mamba2 on the dense
    layout."""
    with pytest.raises(ValueError, match="chunked prefill contract"):
        _build(entry, EngineConfig(prefill_chunk=32), arch="mamba2-370m")
    assert _build(entry, EngineConfig()).kv_layout == "paged"
    assert _build(entry, EngineConfig(), arch="mamba2-370m").kv_layout \
        == "dense"


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("bs,ok", [(8, False), (24, False), (144, False),
                                   (16, True), (32, True), (128, True)])
def test_paged_engine_checks_the_kernels_block_size(reduced, bs, ok):
    """The check a CUDA paged engine runs at construction, alone, at the
    full-width heads and the reduced ones: a block size the kernel does not
    take raises and names the sizes it takes."""
    cfg = get_arch("carboncall-qwen2-7b")
    cfg = reduce_config(cfg) if reduced else cfg
    if ok:
        engine_mod.check_paged_kernel(cfg, bs)
    else:
        with pytest.raises(ValueError, match="multiple of 16 up to 128"):
            engine_mod.check_paged_kernel(cfg, bs)


def test_paged_engine_refuses_the_block_size_when_built(monkeypatch):
    """A CPU paged engine takes block size 8 (its decode reads through the
    plain version); the same engine on a device whose decode would run the
    kernel (stood in for by the CPU) raises at construction, before any
    step."""
    cfg = reduce_config(get_arch("carboncall-qwen2-7b"))
    eng = ServingEngine(cfg, None, RuntimeConfig(), kv_layout="paged",
                        block_size=8, device="cpu")
    assert eng.block_size == 8 and eng._paged_fallback
    monkeypatch.setattr(engine_mod, "paged_attention_uses_fallback",
                        lambda device: False)
    with pytest.raises(ValueError, match="block size"):
        ServingEngine(cfg, None, RuntimeConfig(), kv_layout="paged",
                      block_size=8, device="cpu")
    ServingEngine(cfg, None, RuntimeConfig(), kv_layout="paged",
                  block_size=16, device="cpu")
