"""The port's MoE family (phi3.5-moe-42b-a6.6b, llama4-scout-17b-a16e with
its shared expert) against the JAX package's, and the per-(layer, expert)
weight draw.

Configs and specs: the three new configs (with zamba2-7b) equal the
reference's field by field, full and reduced; both packages make the same
parameter, quantized and cache specs.

The MoE block (`moe_local`): the same seeded x through the reference's and
the port's block with the same weights (bridged), for the Q8 and Q4 trees,
at the reduced config's capacity factor (8: nothing dropped) and at
phi's 1.25 on a batch whose tokens mostly route alike, so capacity drops
slots: both packages route alike and drop the same tokens (those whose
output moves when the capacity is lifted are the slots over capacity by
the JAX package's rule). Outputs within MOE_REL (the quant-matmul
tolerance) of max |want|: both dequantize the experts to bf16 and round
the same products, the port's SiLU in one rounding where `jax.nn.silu`
rounds op by op (measured <= 0.0062 of max |want| for phi; scout's shared
expert's 2-D Q8/Q4 layers go through the port's quant-matmul plain
version, <= 0.0101). A router with tied probabilities picks the lower
expert index first, as `jax.lax.top_k`.

Routing near-ties. The init draws the router at std 1e-3, so at d 64 a
token's router logits spread over ~0.01, and the two packages, which round
the hidden state in bf16 at different places, move them by up to ~3e-4: a
token whose choice is that close flips, and carries another hidden state
into every later layer. So the model and engine tests record the
reference's routing call by call (`_Routing`, a `jax.debug.callback` in its
compiled layers) and make the port take it, as teacher-forcing gives two
engines one token history; each port call must route as many tokens (the
capacity counts them), and its own choice must be the reference's for
every token clear of ROUTE_MARGIN.

Models: the reduced phi (Q4, int8 KV) and scout (Q8, bf16 KV) through
`prefill`, (phi) the cache-hit window, `decode_step_paged` and the dense
`decode_step`, with the model tests' tolerance (`tests/test_torch_model.py`,
`tests/test_torch_dense.py`).

Engine: the paged engine, monolithic, chunked (int8 KV) and speculative,
against the reference's at capacity factor 1.25 (reduced phi), in one
subprocess that waits for every jitted call (`tests/test_torch_spec_chunk.py`'s
script, without its week): teacher-forced onto its tokens, draft and verify
argmaxes and routing, the whole step log and EngineStats equal and every
decision's logits within ENGINE_LOGIT_TOL; its MoE calls drop slots.
Port-only: the MoE serves on the dense layout, with chunked prefill.
"""
import dataclasses
import json
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch as ref_get_arch
from repro.config import RuntimeConfig as RefRuntimeConfig
from repro.configs.reduced import reduce_config as ref_reduce
from repro.models import get_model as ref_get_model
from repro.models import moe as RMoE
from repro.quant import quant_spec as ref_quant_spec
from repro.quant import quantize_tree as ref_quantize_tree
from repro.sharding.param import init_params as ref_init_params

from repro_torch.bridge import params_from_numpy
from repro_torch.common.registry import get_arch
from repro_torch.config import RuntimeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import get_model
from repro_torch.models import moe as PMoE
from repro_torch.quant import QTensor
from repro_torch.quant.qtensor import init_quantized, quant_spec, quantize_tree
from repro_torch.serving import (EngineClient, ServingEngine, SessionRequest,
                                 SpecDecodeConfig, VirtualClock,
                                 check_invariants)
from repro_torch.sharding import param as param_mod
from repro_torch.sharding.param import ParamDef, init_params
from test_torch_dense import _decode_step_case
from test_torch_engine import ENGINE_LOGIT_TOL, MARGIN_BOUND, _port_variants
from test_torch_mamba2 import _defs
from test_torch_model import (_assert_same_model, _decode_step_paged_logits,
                              _prefill_logits_and_kv, _prefix_window_logits,
                              _setup, _to_numpy)
from test_torch_spec_chunk import REF_SCRIPT as SPEC_CHUNK_SCRIPT
from test_torch_spec_chunk import _Recorder, _env

PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
FAMILY_ARCHS = (PHI, SCOUT, "zamba2-7b")
MOE_REL = 0.02
SEED = 7
STEP_COST_S = 0.001
PHI_CF = 1.25
REF_ROUTE, PORT_ROUTE = RMoE._route, PMoE._route
# neighbours among a token's k + 1 largest router logits closer than this
# are a near-tie: the init draws the router at std 1e-3, so at d 64 a
# token's logits spread over ~0.01, and the packages' bf16 roundings of the
# hidden state move them by up to 2.9e-4 (`_Routing.drift`, measured)
ROUTE_MARGIN = 1e-3


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_configs_match_reference(arch):
    """Full and reduced: the port's fields equal the reference's, and the
    reference's other fields hold their defaults."""
    _assert_same_model(ref_get_arch(arch), get_arch(arch))
    _assert_same_model(ref_reduce(ref_get_arch(arch)),
                       reduce_config(get_arch(arch)))
    assert get_arch(arch).moe == ref_get_arch(arch).moe
    assert ref_get_arch(arch).moe == get_arch(arch).moe


@pytest.mark.parametrize("arch", [PHI, SCOUT])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_moe_specs_match_reference(arch, width):
    """Same parameter, quantized and cache specs: the stacked experts are
    quantized (Q4 along d_in), the (d, E) router is not (fewer than 32
    columns), and scout's shared expert is a gated MLP of the expert
    width."""
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    if width == "reduced":
        ref_cfg, cfg = ref_reduce(ref_cfg), reduce_config(cfg)
    ref_spec = ref_get_model(ref_cfg).param_spec()
    spec = get_model(cfg).param_spec()
    assert _defs(spec) == _defs(ref_spec)
    assert ("shared" in spec["layers"]["moe"]) == (arch == SCOUT)
    for fmt in ("q8", "q4"):
        got = _defs(quant_spec(spec, fmt))
        assert got == _defs(ref_quant_spec(ref_spec, fmt))
        # 64 rows (reduced) hold no q4 group: q8 in the q4 tree there
        want_fmt = fmt if width == "full" else "q8"
        assert got["/layers/moe/wg"][0] == want_fmt
        assert got["/layers/moe/router"][0] not in ("q8", "q4")
    for kv in ("bf16", "int8"):
        rc, rrc = RuntimeConfig(kv_cache_dtype=kv), \
            RefRuntimeConfig(kv_cache_dtype=kv)
        model, ref = get_model(cfg), ref_get_model(ref_cfg)
        assert _defs(model.cache_spec(rc, 4, 256)) == \
            _defs(ref.cache_spec(rrc, 4, 256))
        assert _defs(model.paged_cache_spec(rc, 33, 16)) == \
            _defs(ref.paged_cache_spec(rrc, 33, 16))


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _block_inputs(arch, cf, alike):
    """Reference and port configs at capacity factor `cf`, the reference's
    block weights from a seed in every format, and x (2, 32, d): Gaussian,
    or with `alike` a common vector plus a tenth of noise per token."""
    ref_cfg = _with_cf(ref_reduce(ref_get_arch(arch)), cf)
    cfg = _with_cf(reduce_config(get_arch(arch)), cf)
    spec = RMoE.moe_spec(ref_cfg)
    params = ref_init_params(spec, jax.random.PRNGKey(SEED))
    trees = {"bf16": params}
    for fmt in ("q8", "q4"):
        trees[fmt] = ref_quantize_tree(params, spec, fmt)
    g = np.random.default_rng(SEED)
    x = g.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    if alike:
        x = g.standard_normal((1, 1, cfg.d_model)).astype(np.float32) \
            + 0.1 * x
    return ref_cfg, cfg, trees, x


def _run_block(ref_cfg, cfg, tree, x):
    want, _ = RMoE.moe_local(tree, jnp.asarray(x).astype(jnp.bfloat16),
                             ref_cfg, RefRuntimeConfig())
    got = PMoE.moe_local(params_from_numpy(_to_numpy(tree)),
                         torch.as_tensor(x).bfloat16(), cfg)
    return np.asarray(want, np.float32), got.float().numpy()


def _dropped_slots(cfg, topi):
    """Slots at or past the capacity, token-major, each token's choices in
    top-k order (the JAX package's rule), from the routing alone."""
    T, k = topi.shape
    C = PMoE._capacity(T, cfg)
    flat = topi.reshape(-1)
    seen = np.zeros(cfg.moe.num_experts, int)
    dropped = []
    for s, e in enumerate(flat):
        if seen[e] >= C:
            dropped.append(s)
        seen[e] += 1
    return dropped


@pytest.mark.parametrize("arch,fmt", [(PHI, "q8"), (PHI, "q4"),
                                      (SCOUT, "q4")])
@pytest.mark.parametrize("cf", [8.0, PHI_CF])
def test_moe_local_matches_reference(arch, fmt, cf):
    alike = cf == PHI_CF
    ref_cfg, cfg, trees, x = _block_inputs(arch, cf, alike)
    want, got = _run_block(ref_cfg, cfg, trees[fmt], x)
    assert want.shape == got.shape
    err = float(np.abs(want - got).max())
    assert err < MOE_REL * float(np.abs(want).max()), err
    # the same routing, and the same slots over capacity
    x2d = torch.as_tensor(x).bfloat16().reshape(-1, cfg.d_model)
    router = params_from_numpy(_to_numpy(trees["bf16"]))["router"]
    _, topi = PMoE._route(x2d, router, cfg)
    _, ref_topi, _ = RMoE._route(jnp.asarray(x).astype(jnp.bfloat16).reshape(
        -1, cfg.d_model), trees["bf16"]["router"], ref_cfg)
    assert np.array_equal(topi.numpy(), np.asarray(ref_topi))
    dropped = _dropped_slots(cfg, topi.numpy())
    assert bool(dropped) == alike, len(dropped)
    if alike:
        # lifting the capacity moves exactly the tokens with a dropped
        # slot, in both packages (a dropped slot takes one expert's share
        # away; other rows move by rounding at most)
        want_all, got_all = _run_block(_with_cf(ref_cfg, 100.0),
                                       _with_cf(cfg, 100.0), trees[fmt], x)
        k = cfg.moe.experts_per_token
        tokens = sorted({s // k for s in dropped})
        for a, b in ((want, want_all), (got, got_all)):
            moved = np.abs(a - b).reshape(-1, cfg.d_model).max(-1)
            changed = np.nonzero(moved > MOE_REL * np.abs(b).max())[0]
            assert changed.tolist() == tokens
    print(f"{arch} {fmt} cf {cf}: max |diff| {err:.5f} of max |want| "
          f"{np.abs(want).max():.3f}; {len(_dropped_slots(cfg, topi.numpy()))}"
          f" slots dropped")


@pytest.mark.parametrize("arch", [PHI, SCOUT])
def test_router_ties_follow_jax_order(arch):
    """Equal router probabilities rank the lower expert first, as
    `jax.lax.top_k` does (`torch.topk` promises no order): an all-zero
    router, and one whose experts 3 and 1 share the largest column."""
    ref_cfg = ref_reduce(ref_get_arch(arch))
    cfg = reduce_config(get_arch(arch))
    d, E, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.experts_per_token
    x = np.random.default_rng(SEED).standard_normal((16, d)).astype(
        np.float32)
    col = np.abs(np.random.default_rng(1).standard_normal(d)).astype(
        np.float32)
    tied = np.zeros((d, E), np.float32)
    tied[:, 1] = tied[:, 3] = col
    for router in (np.zeros((d, E), np.float32), tied):
        xb = torch.as_tensor(x).bfloat16()
        w, idx = PMoE._route(xb, torch.as_tensor(router).bfloat16(), cfg)
        rw, ridx, _ = RMoE._route(jnp.asarray(x).astype(jnp.bfloat16),
                                  jnp.asarray(router).astype(jnp.bfloat16),
                                  ref_cfg)
        assert np.array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6)
    rows = idx.numpy()
    positive = (x @ col) > 0
    assert (rows[positive, 0] == 1).all()
    if k > 1:
        assert (rows[positive, 1] == 3).all()


# ---------------------------------------------------------------------------
# the models: prefill, the cache-hit window, paged and dense decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def phi():
    return _setup(PHI)


@pytest.fixture(scope="module")
def scout():
    return _setup(SCOUT)


def _route_gaps(logits, k):
    """Each token's smallest gap between neighbours among its k + 1
    largest router logits: what decides its k experts and their order
    (the order of its slots)."""
    top = np.sort(logits, axis=-1)[:, ::-1][:, :k + 1]
    return (top[:, :-1] - top[:, 1:]).min(-1)


class _Routing:
    """The reference's routing, call by call, and the port made to take it.

    `record` stands in for the reference's `_route`: it keeps every call's
    weights, experts and each token's router-logit gap between its k-th and
    (k+1)-th expert. `force` stands in for the port's `_route`: it takes the
    next recorded call's weights and experts (so both packages dispatch
    the same slots, as teacher-forcing gives both engines one token
    history), after checking that the call routes as many tokens (the
    capacity counts them) and that the port's own choice is the
    reference's for every token whose gap is at least ROUTE_MARGIN. A
    smaller gap is a near-tie: one bf16 rounding of the hidden state,
    which the packages make at different places, moves a router logit by
    up to `drift` (printed), and may flip the choice there."""

    def __init__(self, recorded=None):
        self.calls = [] if recorded is None else recorded
        self.n = self.sure = self.agree = 0
        self.drift = 0.0

    def record(self, x2d, router_w, cfg):
        topw, topi, aux = REF_ROUTE(x2d, router_w, cfg)
        logits = x2d.astype(jnp.float32) @ router_w.astype(jnp.float32)
        # inside the reference's layer scan: the values arrive at run time
        jax.debug.callback(self._keep, topw, topi, logits, ordered=True)
        return topw, topi, aux

    def _keep(self, topw, topi, logits):
        self.calls.append((np.asarray(topw), np.asarray(topi),
                           np.asarray(logits)))

    def force(self, x2d, router_w, cfg):
        _, idx = PORT_ROUTE(x2d, router_w, cfg)
        topw, topi, logits = self.calls[self.n]
        self.n += 1
        assert topi.shape == tuple(idx.shape), (topi.shape, idx.shape)
        mine = x2d.float().numpy() @ router_w.float().numpy()
        self.drift = max(self.drift, float(np.abs(mine - logits).max()))
        sure = _route_gaps(logits, cfg.moe.experts_per_token) >= ROUTE_MARGIN
        self.sure += int(sure.sum())
        self.agree += int((idx.numpy() == topi).all(-1)[sure].sum())
        return torch.tensor(topw), torch.tensor(topi, dtype=torch.long)

    def check(self):
        """Every recorded call was taken, the port chose the reference's
        experts for every token clear of a near-tie, and most were (at k 2
        a token has two gaps that can be small: 72% of phi's were clear)."""
        total = sum(len(c[1]) for c in self.calls)
        assert self.n == len(self.calls) > 0
        print(f"routing: {self.n} calls, {total} tokens, {self.sure} clear "
              f"of a near-tie, the port's choice the reference's on "
              f"{self.agree}; logit drift {self.drift:.2e}")
        assert self.agree == self.sure >= 0.6 * total, \
            (self.agree, self.sure, total)
        assert self.drift < ROUTE_MARGIN / 2, self.drift


def _forced(monkeypatch, routing=None):
    routing = routing or _Routing()
    monkeypatch.setattr(RMoE, "_route", routing.record)
    monkeypatch.setattr(PMoE, "_route", routing.force)
    return routing


MODEL_PATHS = {"prefill": _prefill_logits_and_kv,
               "window": _prefix_window_logits,
               "decode_paged": _decode_step_paged_logits,
               "decode_dense": _decode_step_case}


def _model_path(setup, path, fmt, kv, monkeypatch):
    """One of the model tests' cases with the reference's routing recorded
    as it runs and the port on that routing."""
    routing = _forced(monkeypatch)
    MODEL_PATHS[path](setup, fmt, kv)
    routing.check()


@pytest.mark.parametrize("path", list(MODEL_PATHS))
def test_phi_model_paths_match_reference(phi, path, monkeypatch):
    _model_path(phi, path, "q4", "int8", monkeypatch)


@pytest.mark.parametrize("path", ["prefill", "decode_paged",
                                  "decode_dense"])
def test_scout_model_paths_match_reference(scout, path, monkeypatch):
    _model_path(scout, path, "q8", "bf16", monkeypatch)


# ---------------------------------------------------------------------------
# the per-(layer, expert) draw
# ---------------------------------------------------------------------------

def _pieces_before(d: ParamDef):
    """`leaf_pieces` as it was before expert leaves were drawn an expert at
    a time: the pieces of every leaf of the models served until then."""
    if d.logical and d.logical[0] == "layers" and len(d.shape) >= 2:
        return [(i,) for i in range(d.shape[0])]
    n = math.prod(d.shape)
    if len(d.shape) < 2 or n <= param_mod.PIECE_ELEMS:
        return [(...,)]
    cols = d.shape[-1]
    width = -(-cols // -(-n // param_mod.PIECE_ELEMS))
    return [(..., slice(c, min(c + width, cols)))
            for c in range(0, cols, width)]


def _spec_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ["carboncall-qwen2-7b", "hermes2-pro-8b",
                                  "llama3.1-8b", "qwen2.5-32b",
                                  "mamba2-370m", "zamba2-7b"])
def test_leaf_pieces_unchanged_for_dense_and_ssm_leaves(arch):
    """Every leaf of the models served before the MoE family (and of the
    hybrid, which has no experts) keeps its pieces, so their seed-0
    weights do not change."""
    spec = get_model(get_arch(arch)).param_spec()
    for name, d in _spec_leaves(spec):
        assert param_mod.leaf_pieces(d) == _pieces_before(d), name


def test_expert_leaves_drawn_per_layer_and_expert():
    """A stacked expert leaf is drawn one (layer, expert) slice at a time:
    phi's full-width wg in 32 x 16 pieces of 26.2 M elements (a layer
    slice would be 419 M), and at the reduced width `init_quantized`
    equals `init_params` + `quantize_tree` from one seed, leaf for leaf."""
    full = get_model(get_arch(PHI)).param_spec()["layers"]["moe"]["wg"]
    pieces = param_mod.leaf_pieces(full)
    assert len(pieces) == 32 * 16 and pieces[17] == (1, 1)
    assert math.prod(full.shape[2:]) == 4096 * 6400
    for arch in (PHI, SCOUT):
        spec = get_model(reduce_config(get_arch(arch))).param_spec()
        params = init_params(spec, torch.Generator().manual_seed(9), "cpu")
        drawn = init_quantized(spec, ("q8", "q4", "bf16"),
                               torch.Generator().manual_seed(9), "cpu")
        for fmt in ("q8", "q4", "bf16"):
            want = dict(_spec_leaves(quantize_tree(params, spec, fmt)))
            got = dict(_spec_leaves(drawn[fmt]))
            assert got.keys() == want.keys()
            for name, w in want.items():
                g = got[name]
                if isinstance(w, QTensor):
                    assert g.fmt == w.fmt, name
                    for f in ("q", "scale", "zero"):
                        a, b = getattr(w, f), getattr(g, f)
                        assert (a is None) == (b is None), name
                        assert a is None or torch.equal(a, b), (name, f)
                else:
                    assert torch.equal(w, g), name
        wg = drawn["q8"]["layers"]["moe"]["wg"]
        assert isinstance(wg, QTensor) and wg.q.ndim == 4


# ---------------------------------------------------------------------------
# the engine: paged monolithic, chunked and speculative, against the
# reference's at capacity factor 1.25
# ---------------------------------------------------------------------------

_CFG_LINE = 'cfg = reduce_config(get_arch("carboncall-qwen2-7b"))'
_LOOP = "results, saved = {}, {}"
_WEEK = "# the engine-backed week with a chunked, speculative executor"
# recorded in the reference's jitted programs as they run: each MoE call's
# weights, experts and router logits, one list a scenario
_ROUTES = r"""
import repro.models.moe as RMoE
ROUTES = []
_ref_route = RMoE._route
def _keep(w, i, lg):
    ROUTES[-1].append((np.asarray(w), np.asarray(i), np.asarray(lg)))
def _route(x2d, router_w, cfg):
    topw, topi, aux = _ref_route(x2d, router_w, cfg)
    lg = x2d.astype(jax.numpy.float32) @ router_w.astype(jax.numpy.float32)
    jax.debug.callback(_keep, topw, topi, lg, ordered=True)
    return topw, topi, aux
RMoE._route = _route
_instrument = instrument
def instrument(eng):
    ROUTES.append([])
    _instrument(eng)
"""
_DUMP = r"""
for (name, res), routes in zip(results.items(), ROUTES):
    res["routes"] = len(routes)
    for n, (w, i, lg) in enumerate(routes):
        saved[f"{name}/route/{n}/w"] = w
        saved[f"{name}/route/{n}/i"] = i
        saved[f"{name}/route/{n}/logits"] = lg
np.savez(out_dir + "/logits.npz", **saved)
json.dump({"meta": meta, "results": results},
          open(out_dir + "/results.json", "w"))
"""


def _ref_script():
    """`tests/test_torch_spec_chunk.py`'s reference script over the reduced
    phi at `spec_in["capacity_factor"]`, recording every MoE call's
    routing, without its engine-backed week."""
    for part in (_CFG_LINE, _LOOP, _WEEK):
        assert SPEC_CHUNK_SCRIPT.count(part) == 1, part
    head = SPEC_CHUNK_SCRIPT.split(_WEEK)[0].replace(
        "import json, sys", "import dataclasses, json, sys", 1)
    head = head.replace(_CFG_LINE, (
        'cfg = reduce_config(get_arch(spec_in["arch"]))\n'
        'cfg = dataclasses.replace(cfg, moe=dataclasses.replace(\n'
        '    cfg.moe, capacity_factor=spec_in["capacity_factor"]))'), 1)
    head = head.replace(_LOOP, _ROUTES + _LOOP, 1)
    return head + _DUMP


def _scenarios():
    rng = np.random.default_rng(SEED)

    def toks(n):
        return [int(t) for t in rng.integers(2, 512, size=n)]

    def req(prompt, at=0):
        return {"prompt": prompt, "at": at, "priority": 0, "deadline": None,
                "temperature": 0.0}

    base = {"kv": "bf16", "max_batch": 4, "max_seq": 256, "num_blocks": None,
            "chunk": None, "spec": None, "draft": True, "max_new": 8,
            "events": [], "reference": True}
    long, short, tail = toks(60), toks(40), toks(28)
    # tests/test_chunked.py's mix: one 64 bucket, the third prompt sharing
    # the second's first 32 tokens; pad rows and pad tokens route alike
    mix = [req(short), req(long), req(long[:32] + tail, at=40)]
    tool = toks(32)
    spec_prompts = [p for pair in zip([tool + toks(16) for _ in range(4)],
                                      [toks(n) for n in (9, 20, 41, 27)])
                    for p in pair]
    return [
        dict(base, name="mono", requests=mix),
        dict(base, name="chunk_int8", kv="int8", chunk=16, requests=mix),
        dict(base, name="spec_k2", max_new=12, spec=2,
             requests=[req(p) for p in spec_prompts]),
    ]


SCENARIOS = [s["name"] for s in _scenarios()]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_moe_engine")
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps({
        "seed": SEED, "cost": STEP_COST_S, "arch": PHI,
        "capacity_factor": PHI_CF, "scenarios": _scenarios()}))
    proc = subprocess.run([sys.executable, "-c", _ref_script(),
                           str(spec_path), str(out)], env=_env(),
                          cwd=str(out), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    data = json.loads((out / "results.json").read_text())
    return data, dict(np.load(out / "weights.npz")), \
        dict(np.load(out / "logits.npz"))


@pytest.fixture(scope="module")
def port_variants(reference):
    data, weights, _ = reference
    return _port_variants(data["meta"], weights)


def _recorded_routes(reference, name):
    data, _, saved = reference
    return [tuple(saved[f"{name}/route/{n}/{f}"] for f in ("w", "i",
                                                            "logits"))
            for n in range(data["results"][name]["routes"])]


CFG = _with_cf(reduce_config(get_arch(PHI)), PHI_CF)


def _serve(variants, sc, force=None, calls=None, layout="paged"):
    """Serve scenario `sc` on the port as the reference script does."""
    clock = VirtualClock()
    sd = None if sc["spec"] is None else SpecDecodeConfig("q4", k=sc["spec"])
    eng = ServingEngine(
        CFG, variants["q8"], RuntimeConfig(kv_cache_dtype=sc["kv"]),
        max_batch=sc["max_batch"], max_seq=sc["max_seq"], kv_layout=layout,
        num_blocks=sc["num_blocks"], prefill_chunk=sc["chunk"],
        spec_decode=sd, clock=clock, device="cpu",
        step_cost_fn=lambda kind, n, active: STEP_COST_S * (1 + n))
    eng.variant_name = "q8"
    if sd is not None:
        eng.set_draft_params(variants["q4"], "q4")
    rec = _Recorder(eng, force, calls)
    client = EngineClient(eng)
    hs = []
    pending = sorted(sc["requests"], key=lambda r: r["at"])
    steps = 0
    while pending or eng.has_work():
        while pending and pending[0]["at"] <= steps:
            r = pending.pop(0)
            hs.append(client.submit(SessionRequest(
                prompt=r["prompt"], max_new_tokens=sc["max_new"], eos_id=-1)))
        if eng.has_work():
            eng.step()
        else:
            clock.advance(STEP_COST_S)
        steps += 1
    return eng, [h.request for h in hs], rec


@pytest.mark.parametrize("name", SCENARIOS)
def test_moe_engine_matches_reference_teacher_forced(reference,
                                                     port_variants, name,
                                                     monkeypatch):
    """On the reference's history (its tokens, draft and verify argmaxes,
    and its routing: `_Routing`): every MoE call routes as many tokens as
    the reference's, the port's own routing is the reference's clear of
    near-ties, the whole step log and EngineStats are equal, the
    invariants clean, and every decision's logits within ENGINE_LOGIT_TOL,
    the port's argmax the reference's where the margin is at least
    MARGIN_BOUND."""
    data, _, ref_logits = reference
    ref = data["results"][name]
    sc = {s["name"]: s for s in _scenarios()}[name]
    calls = [ref_logits[f"{name}/call/{n}/argmax"]
             for n in range(len(ref["calls"]))]
    routing = _Routing(_recorded_routes(reference, name))
    monkeypatch.setattr(PMoE, "_route", routing.force)
    eng, reqs, rec = _serve(port_variants, sc, force=ref["output"],
                            calls=calls)
    routing.check()
    assert [r.output for r in reqs] == ref["output"]
    assert rec.log() == ref["log"]
    assert eng.stats().to_wire() == ref["stats"]
    # after the stats: the sweep flushes the prefix cache
    assert ref["invariants"] == [] and check_invariants(eng, reqs) == []
    pairs = [(np.stack(rec.rows[r.rid]), ref_logits[f"{name}/rows/{i}"],
              np.asarray(ref["output"][i]))
             for i, r in enumerate(reqs) if r.rid in rec.rows]
    assert len(rec.calls) == len(ref["calls"])
    for n, ((got, lv), want_lv) in enumerate(zip(rec.calls, ref["calls"])):
        assert lv == want_lv
        pairs.append((got[lv], ref_logits[f"{name}/call/{n}/logits"][lv],
                      ref_logits[f"{name}/call/{n}/argmax"][lv]))
    worst = 0.0
    for got, want, toks in pairs:
        err = np.abs(got - want).max(axis=-1)
        worst = max(worst, float(err.max()))
        assert (err < ENGINE_LOGIT_TOL).all(), (name, err.max())
        top2 = np.sort(want, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) >= MARGIN_BOUND
        assert (got.argmax(-1)[sure] == toks[sure]).all(), name
    print(f"{name}: max |logit diff| {worst:.4f} over {len(pairs)} arrays")


def test_moe_engine_scenarios_reach_their_paths(reference):
    """The reference's scenarios reach what they are named for: chunk
    windows, spec steps with accepted drafts, and MoE calls that drop
    slots at capacity factor 1.25 (its own routing, counted by the
    JAX package's rule)."""
    res = reference[0]["results"]
    assert res["chunk_int8"]["stats"]["chunk_steps"] > 0
    st = res["spec_k2"]["stats"]
    assert st["spec_steps"] > 0 and 0 < st["accepted_tokens"] \
        <= st["draft_tokens"]
    for name in SCENARIOS:
        dropped = [len(_dropped_slots(CFG, i))
                   for _, i, _ in _recorded_routes(reference, name)]
        assert sum(dropped) > 0, name


def test_moe_serves_dense_with_chunked_prefill(port_variants):
    """The MoE on the dense layout, monolithic and in windows of 16 (as
    the JAX package serves it): every request DONE with its tokens, the
    invariants clean, chunk windows taken; `kv_layout="auto"` is paged."""
    sc = {s["name"]: s for s in _scenarios()}["chunk_int8"]
    for chunk in (None, 16):
        eng, reqs, _ = _serve(port_variants, dict(sc, chunk=chunk),
                              layout="dense")
        assert eng.kv_layout == "dense"
        assert all(r.status == "done" and len(r.output) == sc["max_new"]
                   for r in reqs)
        assert check_invariants(eng, reqs) == []
        assert (eng.stats().chunk_steps > 0) == (chunk is not None)
    assert ServingEngine(CFG, port_variants["q8"], RuntimeConfig(),
                         device="cpu").kv_layout == "paged"
