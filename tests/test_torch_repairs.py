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
  * The engine's and the executor's refusals name the ROADMAP items 4.1,
    4.2 and 4.3.
  * A CUDA paged engine checks, when it is built, that the paged decode
    kernel takes its block size (a multiple of 16 up to 128), its query
    heads per kv head (at most 8) and its head dim; a CPU engine, whose
    decode reads through the plain version, takes any block size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_sim import ops as ref_ops
from repro.kernels.topk_sim import topk_sim as ref_kernel

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
from repro_torch.serving import (EngineConfig, ServingEngine,
                                 SpecDecodeConfig)
from repro_torch.serving import engine as engine_mod

SCORE_TOL = 1e-5


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


@pytest.mark.parametrize("config,item", [
    # chunked prefill on the dense layout waits for the transformer's dense
    # decode; speculative decoding needs the paged layout (the JAX package's
    # ValueError)
    pytest.param(EngineConfig(prefill_chunk=32, kv_layout="dense"),
                 (NotImplementedError, "Queue 1 item 4.1"),
                 id="config0-Queue 1 item 4.1"),
    pytest.param(EngineConfig(spec_decode=SpecDecodeConfig(),
                              kv_layout="dense"),
                 (ValueError, "requires the paged KV layout"),
                 id="config1-Queue 1 item 4.2"),
    pytest.param(EngineConfig(kv_layout="dense"),
                 (NotImplementedError, "Queue 1 item 4.3"),
                 id="config2-Queue 1 item 4.3"),
])
@pytest.mark.parametrize("entry", ["engine", "executor"])
def test_refusals_name_the_roadmap_items(config, item, entry):
    """Both entry points refuse before any weights are used, so the engine
    gets none; the dense layout is refused for the transformer family."""
    exc, match = item
    with pytest.raises(exc, match=match):
        if entry == "engine":
            ServingEngine(reduce_config(get_arch("carboncall-qwen2-7b")),
                          None, RuntimeConfig(), config=config, device="cpu")
        else:
            EngineExecutor(PAPER_MODELS["qwen2-7b"], ORIN_AGX,
                           config=config, device="cpu")


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
