"""The transformer's dense KV layout in the port, against the JAX package's,
on the reduced carboncall-qwen2-7b (and its `decode_step` on the reduced
hermes2-pro-8b, which has no qkv bias).

Model (in this process, weights moved by `repro_torch.bridge` as in
`tests/test_torch_model.py`): `cache_spec` leaf for leaf at the reduced and
the full width; the dense `prefill`, its KV copied into a slot stripe the
way the engine copies it (`ServingEngine._write_slot`: the written positions
at the head, zeros after them), and one `decode_step` on a filled cache with
one row saturated at max_seq, for the Q8 and Q4 trees with bf16 and int8
KV. Logits within LOGIT_TOL (the model test's, same reasoning); the new KV
row within the model test's KV tolerance; every other position, the
saturated row's whole stripe included, equal bit for bit.

Engine: the reference engine runs in a subprocess (`sys.executable -c`,
JAX_PLATFORMS=cpu), which waits for every jitted call as
`tests/test_torch_spec_chunk.py`'s does, and writes its weights and results
as files. Scenarios: `tests/test_chunked.py`'s dense mix, monolithic and in
windows of 16 and of 10 (unrounded: the dense layout has no block grid), on
bf16 and int8 KV, and an int8 run with a row decoding past max_seq, a
cancelled parked chunk and a Q8 -> Q4 swap that drops another. With
`eos_id=-1` and fixed budgets nothing in the scheduling reads a token, so
the whole step log and the EngineStats snapshot must be equal; tokens up to
each stream's first emission with a top-2 margin below MARGIN_BOUND; and,
teacher-forced onto the reference's tokens, every emission's logits within
ENGINE_LOGIT_TOL with the port's argmax equal to the reference's where the
margin is at least MARGIN_BOUND. In the port alone, the dense engine's step
kinds, rids, tokens and variants equal the paged engine's on the same
requests, and its tokens equal the paged engine's up to the first near-tie.
"""
import json
import os
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
from repro.models import transformer as RT
from repro.quant import quantize_tree as ref_quantize_tree
from repro.sharding.param import init_params as ref_init_params

from repro_torch.bridge import params_from_numpy
from repro_torch.common.registry import get_arch
from repro_torch.config import RuntimeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import get_model
from repro_torch.models import transformer as PT
from repro_torch.models.transformer import quantize_kv_for_cache
from repro_torch.serving import (EngineClient, ServingEngine, SessionRequest,
                                 VirtualClock, check_invariants)
from repro_torch.sharding.param import init_params
from test_torch_engine import ENGINE_LOGIT_TOL, MARGIN_BOUND, _port_variants
from test_torch_model import LOGIT_TOL, _to_numpy
from test_torch_spec_chunk import _Recorder, _first_tie, _tokens_by_margin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 6
STEP_COST_S = 0.001
B, S, SMAX = 4, 64, 128
KV_REL = 0.05                   # the model test's KV tolerance, of max |want|
CASES = [(f, kv) for f in ("q8", "q4") for kv in ("bf16", "int8")]


# ---------------------------------------------------------------------------
# model: cache_spec, dense prefill, decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("reduced", [True, False])
def test_cache_spec_matches_reference(kv, reduced):
    ref_cfg = ref_get_arch("carboncall-qwen2-7b")
    cfg = get_arch("carboncall-qwen2-7b")
    if reduced:
        ref_cfg, cfg = ref_reduce(ref_cfg), reduce_config(cfg)
    want = ref_get_model(ref_cfg).cache_spec(
        RefRuntimeConfig(kv_cache_dtype=kv), 3, 96)
    got = get_model(cfg).cache_spec(RuntimeConfig(kv_cache_dtype=kv), 3, 96)
    assert set(got) == set(want)
    for key, d in want.items():
        g = got[key]
        assert (g.shape, tuple(g.logical), g.init, g.dtype) == \
            (d.shape, tuple(d.logical), d.init, d.dtype), key


def _setup(arch):
    ref_cfg = ref_reduce(ref_get_arch(arch))
    cfg = reduce_config(get_arch(arch))
    spec = ref_get_model(ref_cfg).param_spec()
    params = ref_init_params(spec, jax.random.PRNGKey(SEED))
    trees = {}
    for fmt in ("q8", "q4"):
        qp = ref_quantize_tree(params, spec, fmt)
        trees[fmt] = (qp, params_from_numpy(_to_numpy(qp), "cpu"))
    toks = np.random.default_rng(SEED).integers(2, 512, size=(B, S)).astype(
        np.int32)
    return ref_cfg, cfg, trees, toks


@pytest.fixture(scope="module")
def setup():
    return _setup("carboncall-qwen2-7b")


@pytest.fixture(scope="module")
def hermes():
    """The reduced hermes2-pro-8b (no qkv bias; the reduced llama3.1-8b is
    the same model under another name)."""
    return _setup("hermes2-pro-8b")


def _logits_close(want, got):
    err = float(np.max(np.abs(np.asarray(want, np.float32)
                              - got.float().numpy())))
    assert err < LOGIT_TOL, err
    return err


def _dequant(cache, key, sl):
    """Leaf `key` of a cache (numpy views) at index `sl`, int8 codes times
    their scales."""
    a = np.asarray(cache[key][sl], np.float32)
    if key + "_scale" in cache:
        a = a * np.asarray(cache[key + "_scale"][sl], np.float32)[..., None]
    return a


def _np(tree):
    return {k: (np.asarray(v.float()) if v.dtype == torch.bfloat16
                else v.numpy()) for k, v in tree.items()}


def _jnp_cache(cache):
    return {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
            if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
            for k, v in cache.items()}


@pytest.mark.parametrize("fmt,kv", CASES)
def test_dense_prefill_fills_the_stripe_as_reference(setup, fmt, kv):
    ref_cfg, cfg, trees, toks = setup
    rp, pp = trees[fmt]
    rrc, rc = RefRuntimeConfig(kv_cache_dtype=kv), \
        RuntimeConfig(kv_cache_dtype=kv)
    cache0 = ref_init_params(ref_get_model(ref_cfg).cache_spec(rrc, B, SMAX),
                             jax.random.PRNGKey(0))
    lr, rcache, rlen = RT.prefill(rp, cache0, {"tokens": jnp.asarray(toks)},
                                  ref_cfg, rrc)
    lp, entry, plen = PT.prefill(pp, {"tokens": torch.as_tensor(toks)}, cfg,
                                 rc)
    _logits_close(lr, lp)
    assert np.array_equal(np.asarray(rlen), plen.numpy())
    # into a cache full of another request's KV, one slot a row
    cache = init_params(PT.cache_spec(cfg, rc, B, SMAX),
                        torch.Generator().manual_seed(1), "cpu")
    for leaf in cache.values():
        leaf.copy_(torch.randint_like(leaf, 1, 100) if not
                   leaf.dtype.is_floating_point else torch.rand_like(leaf))
    for i in range(B):
        for key, leaf in cache.items():
            ServingEngine._write_slot(leaf[:, i], entry[key][:, i])
    got, want = _np(cache), _to_numpy(rcache)
    for key in cache:
        assert got[key].shape == want[key].shape
        assert (got[key][:, :, S:] == 0).all() and \
            (want[key][:, :, S:] == 0).all(), key
    for key in ("k", "v"):
        w = _dequant(want, key, np.s_[:, :, :S])
        g = _dequant(got, key, np.s_[:, :, :S])
        assert np.max(np.abs(w - g)) < KV_REL * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("fmt,kv", CASES)
def test_decode_step_matches_reference(setup, fmt, kv):
    """Rows at length 0, mid-stripe and SMAX (saturated: writes nothing,
    reads the whole stripe) decode one token on the same cache."""
    _decode_step_case(setup, fmt, kv)


@pytest.mark.parametrize("fmt,kv", CASES)
def test_hermes_decode_step_matches_reference(hermes, fmt, kv):
    """The same on the reduced hermes2-pro-8b: no qkv bias."""
    _decode_step_case(hermes, fmt, kv)


def _decode_step_case(setup, fmt, kv):
    ref_cfg, cfg, trees, toks = setup
    rp, pp = trees[fmt]
    rc = RuntimeConfig(kv_cache_dtype=kv)
    Lc, K, H = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    g = np.random.default_rng(SEED + 1)
    kf = torch.as_tensor(g.standard_normal((Lc, B, SMAX, K, H)),
                         dtype=torch.float32).bfloat16()
    vf = torch.as_tensor(g.standard_normal((Lc, B, SMAX, K, H)),
                         dtype=torch.float32).bfloat16()
    cache = init_params(PT.cache_spec(cfg, rc, B, SMAX), None, "cpu")
    for key, val in quantize_kv_for_cache(kv == "int8", kf, vf).items():
        cache[key].copy_(val)
    before = _np(cache)
    ref_cache = _jnp_cache(cache)
    lens = np.array([0, 17, 100, SMAX], np.int32)
    last = toks[:, :1]
    lr, rcache = RT.decode_step(rp, ref_cache, jnp.asarray(last),
                                jnp.asarray(lens), ref_cfg,
                                RefRuntimeConfig(kv_cache_dtype=kv))
    lp, pcache = PT.decode_step(pp, cache, torch.as_tensor(last),
                                torch.as_tensor(lens), cfg, rc)
    err = _logits_close(lr, lp)
    got, want = _np(pcache), _to_numpy(rcache)
    for key in got:
        new = np.zeros(got[key].shape[:3], bool)     # (L, B, SMAX)
        for b in range(B):
            if lens[b] < SMAX:
                new[:, b, lens[b]] = True
        assert np.array_equal(got[key][~new], before[key][~new]), key
        assert np.array_equal(want[key][~new], before[key][~new]), key
    for key in ("k", "v"):
        for b in range(B - 1):
            sl = np.s_[:, b, lens[b]]
            w, gg = _dequant(want, key, sl), _dequant(got, key, sl)
            assert np.max(np.abs(w - gg)) < KV_REL * max(1.0,
                                                         np.abs(w).max())
    print(f"{fmt} {kv}: max |logit diff| {err:.4f}")


# ---------------------------------------------------------------------------
# engine: against the reference's dense engine, and against the paged one
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from repro.common.registry import get_arch
from repro.config import RuntimeConfig
from repro.configs.reduced import reduce_config
from repro.models import get_model
from repro.quant import QTensor, quantize_tree
from repro.serving import (EngineClient, ServingEngine, SessionRequest,
                           VirtualClock, check_invariants)
from repro.serving import engine as E
from repro.sharding.param import init_params

spec_in = json.loads(open(sys.argv[1]).read())
out_dir = sys.argv[2]
cfg = reduce_config(get_arch("carboncall-qwen2-7b"))
spec = get_model(cfg).param_spec()
params = init_params(spec, jax.random.PRNGKey(spec_in["seed"]))
variants = {f: quantize_tree(params, spec, f) for f in ("q8", "q4")}

arrays, meta = {}, {}
def flat(prefix, node, fmt):
    if isinstance(node, dict):
        for k, v in node.items():
            flat(prefix + "/" + k, v, fmt)
    elif isinstance(node, QTensor):
        meta[fmt + prefix] = {"fmt": node.fmt, "group": node.group}
        for f in ("q", "scale", "zero"):
            if getattr(node, f) is not None:
                flat(prefix + "/" + f, getattr(node, f), fmt)
    else:
        a = np.asarray(node)
        name = a.dtype.name
        arrays[fmt + prefix] = a.view(np.uint16) if name == "bfloat16" else a
        meta[fmt + prefix] = {"dtype": name}
for f, tree in variants.items():
    flat("", tree, f)
np.savez(out_dir + "/weights.npz", **arrays)

# copy host arrays at the hand-over to jitted calls and wait for each call's
# inputs and outputs (tests/test_torch_spec_chunk.py says why)
class _CopyingJnp:
    def __getattr__(self, name):
        return getattr(E.jax.numpy, name)
    @staticmethod
    def asarray(x, *args, **kwargs):
        return E.jax.numpy.array(x, *args, **kwargs)
E.jnp = _CopyingJnp()
orig_shared = E.ServingEngine._shared_exec
def _shared_exec(self, kind, build, *extra):
    fn = orig_shared(self, kind, build, *extra)
    def synced(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))
    return synced
E.ServingEngine._shared_exec = _shared_exec

def margin(rows):
    top2 = np.sort(rows, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())
orig_sample, orig_emit = E.ServingEngine._sample, E.ServingEngine._emit
def _sample(self, logits, req):
    lg = np.asarray(logits, np.float32)
    self._logits_last = lg
    live = [i for i, s in enumerate(self.slots) if s is not None]
    rows = lg if len(lg) == 1 else lg[live]
    if rows.size:
        self._step_margin = min(self._step_margin, margin(rows))
    return orig_sample(self, logits, req)
def _emit(self, req, slot, tok):
    lg = self._logits_last
    self._rows.setdefault(req.rid, []).append(lg[0 if len(lg) == 1 else slot])
    return orig_emit(self, req, slot, tok)
E.ServingEngine._sample, E.ServingEngine._emit = _sample, _emit

results, saved = {}, {}
for sc in spec_in["scenarios"]:
    clock = VirtualClock()
    eng = ServingEngine(
        cfg, variants["q8"], RuntimeConfig(kv_cache_dtype=sc["kv"]),
        max_batch=sc["max_batch"], max_seq=sc["max_seq"], kv_layout="dense",
        prefill_chunk=sc["chunk"], clock=clock,
        step_cost_fn=lambda kind, n, active: spec_in["cost"] * (1 + n))
    eng.variant_name = "q8"
    eng._rows, eng._margins = {}, []
    client = EngineClient(eng)
    hs = []
    pending = sorted(sc["requests"], key=lambda r: r["at"])
    steps = 0
    while pending or eng.has_work():
        while pending and pending[0]["at"] <= steps:
            r = pending.pop(0)
            hs.append(client.submit(SessionRequest(
                prompt=r["prompt"], max_new_tokens=r["max_new"], eos_id=-1)))
        for at, what, arg in sc["events"]:
            if at != steps:
                continue
            if what == "swap":
                eng.swap_params(variants[arg], arg)
            elif what == "cancel":
                hs[arg].cancel()
        if eng.has_work():
            eng._step_margin = np.inf
            eng.step()
            eng._margins.append(eng._step_margin)
        else:
            clock.advance(spec_in["cost"])
        steps += 1
    reqs = [h.request for h in hs]
    name = sc["name"]
    for i, r in enumerate(reqs):
        if eng._rows.get(r.rid):
            saved[f"{name}/rows/{i}"] = np.stack(eng._rows[r.rid])
    results[name] = {
        "status": [r.status for r in reqs],
        "output": [[int(t) for t in r.output] for r in reqs],
        "log": [[s["kind"], list(s["rids"]), s["tokens"], s["variant"],
                 s["prompt_tokens"], s["cached_tokens"], 0, 0, [], 0]
                for s in eng.step_log],
        "margins": [float(m) for m in eng._margins],
        "stats": eng.stats().to_wire(),
        "invariants": check_invariants(eng, reqs),
    }
np.savez(out_dir + "/logits.npz", **saved)
json.dump({"meta": meta, "results": results},
          open(out_dir + "/results.json", "w"))
"""


def _scenarios():
    rng = np.random.default_rng(SEED)

    def toks(n):
        return [int(t) for t in rng.integers(2, 512, size=n)]

    def req(prompt, at=0, max_new=8):
        return {"prompt": prompt, "at": at, "max_new": max_new}

    base = {"kv": "bf16", "max_batch": 2, "max_seq": 128, "chunk": None,
            "events": []}
    # tests/test_chunked.py's mix: one bucket (64) for every prompt; the
    # third arrives once the first two have drained and shares the second's
    # first 32 tokens
    long, short, tail = toks(60), toks(40), toks(28)
    mix = [req(short), req(long), req(long[:32] + tail, at=40)]
    return [
        dict(base, name="mix", requests=mix),
        dict(base, name="mix_chunk16", chunk=16, requests=mix),
        dict(base, name="mix_int8", kv="int8", requests=mix),
        dict(base, name="mix_int8_chunk10", kv="int8", chunk=10,
             requests=mix),
        # three slots of 96 positions: the first row decodes 45 tokens past
        # its 64-position prompt (its length saturates at 96), the second
        # decodes beside it; the third's windows run into a reserved
        # stripe; the fourth's parked chunk is cancelled, the fifth's is
        # dropped by a Q8 -> Q4 swap and restarts under Q4
        dict(base, name="events_int8", kv="int8", max_batch=3, max_seq=96,
             chunk=16, requests=[req(toks(30), max_new=45), req(toks(25)),
                                 req(toks(60), at=1), req(toks(50), at=2),
                                 req(toks(56), at=3)],
             events=[[18, "cancel", 3], [22, "swap", "q4"]]),
    ]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dense")
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps({"seed": SEED, "cost": STEP_COST_S,
                                     "scenarios": _scenarios()}))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(spec_path),
                           str(out)], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    data = json.loads((out / "results.json").read_text())
    variants = _port_variants(data["meta"], dict(np.load(out / "weights.npz")))
    return data, variants, dict(np.load(out / "logits.npz"))


CFG = reduce_config(get_arch("carboncall-qwen2-7b"))
SCENARIOS = [s["name"] for s in _scenarios()]


def _serve(variants, sc, layout="dense", force=None):
    """Serve scenario `sc` on the port as the reference script does."""
    clock = VirtualClock()
    eng = ServingEngine(
        CFG, variants["q8"], RuntimeConfig(kv_cache_dtype=sc["kv"]),
        max_batch=sc["max_batch"], max_seq=sc["max_seq"], kv_layout=layout,
        prefill_chunk=sc["chunk"], clock=clock, device="cpu",
        step_cost_fn=lambda kind, n, active: STEP_COST_S * (1 + n))
    eng.variant_name = "q8"
    rec = _Recorder(eng, force)
    client = EngineClient(eng)
    hs = []
    pending = sorted(sc["requests"], key=lambda r: r["at"])
    steps = 0
    while pending or eng.has_work():
        while pending and pending[0]["at"] <= steps:
            r = pending.pop(0)
            hs.append(client.submit(SessionRequest(
                prompt=r["prompt"], max_new_tokens=r["max_new"], eos_id=-1)))
        for at, what, arg in sc["events"]:
            if at != steps:
                continue
            if what == "swap":
                eng.swap_params(variants[arg], arg)
            elif what == "cancel":
                hs[arg].cancel()
        if eng.has_work():
            eng.step()
        else:
            clock.advance(STEP_COST_S)
        steps += 1
    return eng, [h.request for h in hs], rec


@pytest.mark.parametrize("name", SCENARIOS)
def test_dense_engine_matches_reference(reference, name):
    data, variants, ref_logits = reference
    ref = data["results"][name]
    sc = {s["name"]: s for s in _scenarios()}[name]
    eng, reqs, rec = _serve(variants, sc)
    assert ref["invariants"] == []
    assert [r.status for r in reqs] == ref["status"]
    assert rec.log() == ref["log"]
    assert eng.stats().to_wire() == ref["stats"]
    tie = _first_tie(ref["margins"], rec.margins)
    compared = sum(_tokens_by_margin(r.output, want,
                                     ref_logits[f"{name}/rows/{i}"])
                   for i, (r, want) in enumerate(zip(reqs, ref["output"]))
                   if want)
    print(f"{name}: first near-tie step {tie} of {len(ref['log'])}; "
          f"{compared} of {sum(len(o) for o in ref['output'])} tokens "
          "compared")
    assert compared > 0
    assert check_invariants(eng, reqs) == []


@pytest.mark.parametrize("name", SCENARIOS)
def test_dense_engine_logits_match_reference_teacher_forced(reference, name):
    data, variants, ref_logits = reference
    ref = data["results"][name]
    sc = {s["name"]: s for s in _scenarios()}[name]
    eng, reqs, rec = _serve(variants, sc, force=ref["output"])
    assert [r.output for r in reqs] == ref["output"]
    assert rec.log() == ref["log"]
    assert eng.stats().to_wire() == ref["stats"]
    assert check_invariants(eng, reqs) == []
    worst, n = 0.0, 0
    for i, r in enumerate(reqs):
        if not ref["output"][i]:
            continue
        got = np.stack(rec.rows[r.rid])
        want = ref_logits[f"{name}/rows/{i}"]
        toks = np.asarray(ref["output"][i])
        assert got.shape == want.shape
        err = np.abs(got - want).max(axis=-1)
        worst = max(worst, float(err.max()))
        n += len(err)
        assert (err < ENGINE_LOGIT_TOL).all(), (name, i, err.max())
        top2 = np.sort(want, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) >= MARGIN_BOUND
        assert (got.argmax(-1)[sure] == toks[sure]).all(), (name, i)
    print(f"{name}: max |logit diff| {worst:.4f} over {n} emissions")


def test_scenarios_exercise_the_paths(reference):
    """Each scenario reaches what it is named for, in the reference."""
    res = reference[0]["results"]
    for name in SCENARIOS:
        kinds = [row[0] for row in res[name]["log"]]
        chunked = {s["name"]: s["chunk"] for s in _scenarios()}[name]
        assert ("prefill_chunk" in kinds) == (chunked is not None), name
        if chunked:
            # residents decode between the windows of a later prompt
            first, last = kinds.index("prefill_chunk"), \
                len(kinds) - 1 - kinds[::-1].index("prefill_chunk")
            assert "decode" in kinds[first:last], name
    st = res["events_int8"]["stats"]
    assert st["cancelled"] == 1 and st["swap_count"] == 1
    assert st["chunk_drops"] >= 2
    # 64 prompt positions and 44 written tokens: past the 96-position stripe
    assert len(res["events_int8"]["output"][0]) == 45
    # a window of 10 stays 10 on the dense layout: 64 positions in 7
    st10 = res["mix_int8_chunk10"]["stats"]
    assert st10["chunk_steps"] == 3 * 6


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_dense_engine_matches_paged_engine(reference, kv):
    """In the port alone: the dense and the paged engine take the same
    steps on the same requests (the paged one serves the shared prefix from
    its cache, which only its prompt-token counts show) and emit the same
    tokens up to the first near-tie of the paged run."""
    _, variants, _ = reference
    for name in ("mix", "events_int8"):
        sc = dict({s["name"]: s for s in _scenarios()}[name], kv=kv)
        if name == "events_int8":
            sc = dict(sc, chunk=None, events=[])
        paged, p_reqs, p_rec = _serve(variants, sc, layout="paged")
        dense, d_reqs, _ = _serve(variants, sc)
        assert _steps(dense) == _steps(paged), name
        compared = sum(_tokens_by_margin(d.output, p.output,
                                         np.stack(p_rec.rows[p.rid]))
                       for d, p in zip(d_reqs, p_reqs))
        assert compared > 0, name
        assert check_invariants(dense, d_reqs) == []


def _steps(eng):
    return [[s["kind"], list(s["rids"]), s["tokens"], s["variant"]]
            for s in eng.step_log]
