"""The port's CarbonCall runtime against the JAX package's, on the CPU.

  * the framework-neutral modules, exactly: CI traces and forecasts, the
    governor's mode path, the variant switcher's decisions, the power model
    and the workload generator;
  * `run_week(backend="sim")` over a full week, for the carboncall policy and
    a baseline, run by both packages in this process: the query records are
    equal field for field (the analytic backend is pure Python and numpy);
  * `run_week(backend="engine")` on the reduced carboncall-qwen2-7b (paged)
    and on the reduced mamba2-370m (dense) over a carbon-intensity ramp that
    makes the switcher swap Q8 -> Q4. The reference runs in a subprocess (`sys.executable -c`, JAX_PLATFORMS=cpu):
    building a reference `ServingEngine` in this process would change what
    later tests in the same worker see. It writes its `init_encoder(0)`
    weights and its records as files; the port runs on the CPU with those
    encoder weights bridged in and its own engine weights. With `eos_id=-1`
    and a fixed token budget no compared quantity depends on token values,
    so served count, per-record variant / mode / tool count / success / tier,
    `swap_count` and the engine's step log must be equal, and latency,
    energy, carbon and TPS equal within ENGINE_REL_TOL;
  * the paper's other two models, hermes2-pro-8b and llama3.1-8b: the sim
    week under each one's profile against the reference, and each one's
    reduced model served by `make_executor("engine", ...)` in the port
    across a live swap;
  * the port's entry points run on the card by default and refuse what is
    not ported yet.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.core.fleet as RF
from repro.common.hardware import ORIN_AGX as REF_ORIN
from repro.data import workload as RW

import repro_torch.core as PC
import repro_torch.core.fleet as PF
from repro_torch.bridge import params_from_numpy
from repro_torch.common.hardware import ORIN_AGX, HardwareSpec
from repro_torch.data import workload as PW
from repro_torch.serving import (EngineConfig, SpecDecodeConfig,
                                 check_invariants)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# latency, energy, carbon and TPS: the same Python arithmetic on the same
# step log in both packages
ENGINE_REL_TOL = 1e-9
PROFILE = "qwen2-7b"
SIM_QPH = 2.0                   # a full week of arrivals: ~350 queries
# engine week: clean grid, then a dirty one; 12 queries an hour
RAMP_CLEAN, RAMP_DIRTY, RAMP_CI = 3, 4, (100.0, 900.0)
ENGINE_QPH = 12.0
# the paper's other two models: each is its own profile and its own arch
PAPER_ARCHS = ("hermes2-pro-8b", "llama3.1-8b")


def _ramp():
    return np.array([RAMP_CI[0]] * RAMP_CLEAN + [RAMP_CI[1]] * RAMP_DIRTY)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _query_key(q):
    tier = None if q.tier is None else (q.tier.name, q.tier.priority,
                                        q.tier.deadline_s, q.tier.share)
    return (q.text, q.sentences, q.true_tools, q.entities, q.difficulty, tier)


# ---------------------------------------------------------------------------
# framework-neutral modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("week", sorted(RC.WEEKS))
def test_ci_trace_and_forecast_exact(week):
    for seed in (0, 3):
        want = RC.ci_trace(week, seed=seed)
        got = PC.ci_trace(week, seed=seed)
        assert np.array_equal(got, want)
        assert np.array_equal(PC.forecast_trace(got, seed=seed + 1),
                              RC.forecast_trace(want, seed=seed + 1))
    short = want[:20]                  # shorter than the smoothing kernel
    assert np.array_equal(PC.forecast_trace(short), RC.forecast_trace(short))


def _mode_path(C, ci, steps_per_day=144):
    gov = C.CarbonGovernor(C.ORIN_MODES)
    fc = C.forecast_trace(ci, seed=1)
    state = gov.init(fc[:steps_per_day])
    path = []
    for i in range(len(ci)):
        if i % steps_per_day == 0:
            state = gov.update(state, float(ci[i]),
                               forecast_24h=fc[i:i + steps_per_day])
        else:
            state = gov.update(state, float(ci[i]))
        path.append((state.mode_idx, state.ci_min, state.ci_max,
                     state.last_ci))
    return path


@pytest.mark.parametrize("week", ["week1", "week3"])
def test_governor_mode_path_exact(week):
    ci = RC.ci_trace(week)
    want = _mode_path(RC, ci)
    assert _mode_path(PC, ci) == want
    assert len({p[0] for p in want}) >= 2           # the path moves
    for n in (1, 5):
        for idx in range(n):
            for ladder in ((), (0, 2, 4), (1,)):
                assert PC.CarbonGovernor.k_for_mode(idx, n, ladder) == \
                    RC.CarbonGovernor.k_for_mode(idx, n, ladder)


def test_switcher_decisions_exact():
    rng = np.random.default_rng(4)
    tps = np.concatenate([10 + rng.standard_normal(60),
                          6 + rng.standard_normal(80),
                          14 + rng.standard_normal(80)])
    out = []
    for C in (RC, PC):
        sw = C.VariantSwitcher()
        sw.set_reference(10.0)
        trace = []
        for i, v in enumerate(tps):
            t = 30.0 * i
            sw.observe(t, float(v))
            dec = sw.decide(t)
            sw.apply(t, dec)
            trace.append((dec.switch_to, dec.reason, dec.avg_tps, sw.variant))
        out.append(trace)
    assert out[0] == out[1]
    assert {v for *_, v in out[1]} == {"q8", "q4"}   # both ways switched


def test_power_model_exact():
    ref_pm, pm = RC.PowerModel(REF_ORIN), PC.PowerModel(ORIN_AGX)
    assert dataclasses.astuple(ORIN_AGX) == dataclasses.astuple(REF_ORIN)
    assert [dataclasses.astuple(m) for m in PC.ORIN_MODES] == \
        [dataclasses.astuple(m) for m in RC.ORIN_MODES]
    prof = PC.PAPER_MODELS[PROFILE]
    assert dataclasses.astuple(prof) == \
        dataclasses.astuple(RC.PAPER_MODELS[PROFILE])
    for rm, m in zip(RC.ORIN_MODES, PC.ORIN_MODES):
        for fmt in ("q8", "q4", "bf16"):
            b = prof.active_bytes(fmt)
            assert pm.decode_time_per_token(b, 28672.0, m) == \
                ref_pm.decode_time_per_token(b, 28672.0, rm)
            assert pm.model_load_time(prof.weight_bytes(fmt), m) == \
                ref_pm.model_load_time(prof.weight_bytes(fmt), rm)
        assert pm.prefill_time(210, prof.n_active * 2, m) == \
            ref_pm.prefill_time(210, prof.n_active * 2, rm)
        for util in (None, 0.25, 0.7, 0.95, 1.0):
            assert pm.power(m, util) == ref_pm.power(rm, util)
    assert PC.carbon_footprint(1234.5, 456.7) == \
        RC.carbon_footprint(1234.5, 456.7)
    other = dataclasses.replace(ORIN_AGX, name="h100")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        PC.modes_for(other)
    assert isinstance(other, HardwareSpec)


@pytest.mark.parametrize("tiers", [None, "default", "interactive:1,batch:3"])
def test_workload_samples_exact(tiers):
    def tier_arg(W):
        if tiers is None:
            return None
        return W.DEFAULT_TIERS if tiers == "default" else \
            W.parse_qos_mix(tiers)
    want = RW.FunctionCallWorkload(RW.build_catalog(240, seed=0), seed=7,
                                   tiers=tier_arg(RW)).stream(300)
    got = PW.FunctionCallWorkload(PW.build_catalog(240, seed=0), seed=7,
                                  tiers=tier_arg(PW)).stream(300)
    assert [_query_key(q) for q in got] == [_query_key(q) for q in want]
    assert [PW.diurnal_qph(30.0, 900.0 * i) for i in range(100)] == \
        [RW.diurnal_qph(30.0, 900.0 * i) for i in range(100)]


# ---------------------------------------------------------------------------
# run_week, analytic backend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def selectors():
    ref_sel = RC.ToolSelector(RW.build_catalog(240, seed=0))
    enc = _to_numpy(ref_sel.encoder_params)
    sel = PC.ToolSelector(PW.build_catalog(240, seed=0),
                          encoder_params=params_from_numpy(enc, "cpu"),
                          device="cpu")
    return ref_sel, sel


def _sim_week(C, W, sel, hw, policy, profile=PROFILE):
    rt = C.CarbonCallRuntime(
        selector=sel, executor=C.SimExecutor(C.PAPER_MODELS[profile], hw,
                                             seed=0),
        policy=C.POLICIES[policy], modes=C.ORIN_MODES, catalog_size=240,
        seed=0)
    wl = W.FunctionCallWorkload(sel.catalog, seed=3)
    return C.run_week(rt, wl, C.ci_trace("week4"),
                      queries_per_hour=SIM_QPH, seed=0)


@pytest.mark.parametrize("policy", ["carboncall", "gorilla"])
def test_run_week_sim_matches_reference(selectors, policy):
    ref_sel, sel = selectors
    want = _sim_week(RC, RW, ref_sel, REF_ORIN, policy)
    got = _sim_week(PC, PW, sel, ORIN_AGX, policy)
    assert len(want.records) > 300
    assert [dataclasses.astuple(r) for r in got.records] == \
        [dataclasses.astuple(r) for r in want.records]
    assert got.tier_summary() == want.tier_summary()
    assert {r.mode_idx for r in got.records} != {0}   # governor moved


@pytest.mark.parametrize("profile", PAPER_ARCHS)
def test_run_week_sim_under_paper_profiles_matches_reference(selectors,
                                                             profile):
    """The paper's Hermes and LLaMA weeks: the same week under each model's
    own profile, whose step prices differ from qwen2-7b's."""
    ref_sel, sel = selectors
    want = _sim_week(RC, RW, ref_sel, REF_ORIN, "carboncall", profile)
    got = _sim_week(PC, PW, sel, ORIN_AGX, "carboncall", profile)
    assert len(want.records) > 300
    assert [dataclasses.astuple(r) for r in got.records] == \
        [dataclasses.astuple(r) for r in want.records]
    assert got.tier_summary() == want.tier_summary()
    qwen = _sim_week(PC, PW, sel, ORIN_AGX, "carboncall")
    assert [r.energy_j for r in got.records] != \
        [r.energy_j for r in qwen.records]


# ---------------------------------------------------------------------------
# run_week, engine backend (reduced config)
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import json, sys
import numpy as np
import repro.core as C
from repro.common.hardware import ORIN_AGX
from repro.data.workload import FunctionCallWorkload, build_catalog

spec = json.loads(open(sys.argv[1]).read())
out_dir = sys.argv[2]
cat = build_catalog(240, seed=0)
sel = C.ToolSelector(cat)
arrays, meta = {}, {}
for k, v in sel.encoder_params.items():
    stack = [(k, v)]
    while stack:
        name, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((name + "/" + kk, vv) for kk, vv in node.items())
            continue
        a = np.asarray(node)
        meta[name] = a.dtype.name
        arrays[name] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
np.savez(out_dir + "/encoder.npz", **arrays)
rt = C.CarbonCallRuntime(
    selector=sel, executor=C.SimExecutor(C.PAPER_MODELS[spec["profile"]],
                                         ORIN_AGX, seed=0),
    policy=C.POLICIES["carboncall"], modes=C.ORIN_MODES, catalog_size=240,
    seed=0)
rt.use_backend("engine", arch=spec["arch"])
res = C.run_week(rt, FunctionCallWorkload(cat, seed=3), np.array(spec["ci"]),
                 queries_per_hour=spec["qph"], seed=0, backend="engine")
ex = rt.executor
json.dump({
    "meta": meta,
    "records": [r.__dict__ for r in res.records],
    "swap_count": ex.swap_count,
    "ref_tps": rt.switcher.ref_tps,
    "log": [[s["kind"], list(s["rids"]), s["tokens"], s["variant"],
             s["prompt_tokens"], s["cached_tokens"], s["dt"]]
            for s in ex.engine.step_log],
}, open(out_dir + "/results.json", "w"))
"""


def _engine_reference(tmp_path_factory, arch):
    out = tmp_path_factory.mktemp("ref_runtime")
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps({"profile": PROFILE, "qph": ENGINE_QPH,
                                     "ci": _ramp().tolist(), "arch": arch}))
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
    arrays = np.load(out / "encoder.npz")
    enc = {}
    for name, dtype in data["meta"].items():
        *head, last = name.split("/")
        node = enc
        for h in head:
            node = node.setdefault(h, {})
        node[last] = (arrays[name], dtype) if dtype == "bfloat16" \
            else arrays[name]
    return data, params_from_numpy(enc, "cpu")


@pytest.fixture(scope="module")
def engine_reference(tmp_path_factory):
    return _engine_reference(tmp_path_factory, "carboncall-qwen2-7b")


@pytest.fixture(scope="module")
def engine_reference_mamba2(tmp_path_factory):
    return _engine_reference(tmp_path_factory, "mamba2-370m")


def _rel_close(a, b):
    return abs(a - b) <= ENGINE_REL_TOL * max(abs(a), abs(b), 1e-30)


def _engine_week(data, encoder, arch):
    """The port's engine-backed week on `arch`, held to the reference's
    records, swap count and step log. Returns the executor."""
    want = data["records"]
    assert data["swap_count"] >= 1              # the ramp makes it swap
    assert {r["variant"] for r in want} == {"q8", "q4"}

    sel = PC.ToolSelector(PW.build_catalog(240, seed=0),
                          encoder_params=encoder, device="cpu")
    rt = PC.CarbonCallRuntime(
        selector=sel, executor=PC.SimExecutor(PC.PAPER_MODELS[PROFILE],
                                              ORIN_AGX, seed=0),
        policy=PC.POLICIES["carboncall"], modes=PC.ORIN_MODES,
        catalog_size=240, seed=0)
    rt.use_backend("engine", arch=arch, device="cpu")
    ex = rt.executor
    assert isinstance(ex, PC.EngineExecutor) and ex.engine.device.type == "cpu"
    requests, submit = [], ex.engine.submit

    def recorded_submit(req):
        requests.append(req)
        return submit(req)

    ex.engine.submit = recorded_submit
    assert rt.switcher.ref_tps == data["ref_tps"]
    res = PC.run_week(rt, PW.FunctionCallWorkload(sel.catalog, seed=3),
                      _ramp(), queries_per_hour=ENGINE_QPH, seed=0,
                      backend="engine")
    got = [r.__dict__ for r in res.records]

    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        for key in ("t", "variant", "mode_idx", "n_tools", "succeeded",
                    "tier"):
            assert g[key] == w[key], (key, g, w)
        for key in ("latency_s", "energy_j", "carbon_g", "tps"):
            assert _rel_close(g[key], w[key]), (key, g, w)
    assert ex.swap_count == data["swap_count"]
    log = [[s["kind"], list(s["rids"]), s["tokens"], s["variant"],
            s["prompt_tokens"], s["cached_tokens"]]
           for s in ex.engine.step_log]
    assert log == [s[:6] for s in data["log"]]
    assert all(_rel_close(s["dt"], w[6])
               for s, w in zip(ex.engine.step_log, data["log"]))
    assert {r["mode_idx"] for r in got} >= {0, 4}   # clean and dirty modes
    assert check_invariants(ex.engine, requests) == []
    return ex


def test_run_week_engine_matches_reference(engine_reference):
    ex = _engine_week(*engine_reference, "carboncall-qwen2-7b")
    assert ex.engine.kv_layout == "paged"
    assert ex.engine.kernel_fallbacks > 0           # plain versions on CPU


def test_run_week_engine_over_mamba2_matches_reference(
        engine_reference_mamba2):
    """The runtime over mamba2 on the dense layout: priced from the same
    profile, so only the step log's model changes."""
    ex = _engine_week(*engine_reference_mamba2, "mamba2-370m")
    assert ex.cfg.family == "mamba2" and ex.engine.kv_layout == "dense"
    assert {s["kind"] for s in ex.engine.step_log} == {"prefill", "decode"}
    assert ex.engine.kernel_fallbacks == 0          # no paged reads


@pytest.fixture(scope="module")
def paper_weeks(selectors):
    """Each paper model's engine-backed week on the port alone: its profile
    and its reduced arch through `make_executor`, over the ramp."""
    _, sel = selectors
    out = {}
    for name in PAPER_ARCHS:
        ex = PC.make_executor("engine", PC.PAPER_MODELS[name], ORIN_AGX,
                              arch=name, device="cpu")
        requests, submit = [], ex.engine.submit

        def recorded_submit(req, requests=requests, submit=submit):
            requests.append(req)
            return submit(req)

        ex.engine.submit = recorded_submit
        rt = PC.CarbonCallRuntime(
            selector=sel, executor=ex, policy=PC.POLICIES["carboncall"],
            modes=PC.ORIN_MODES, catalog_size=240, seed=0)
        res = PC.run_week(rt, PW.FunctionCallWorkload(sel.catalog, seed=3),
                          _ramp(), queries_per_hour=ENGINE_QPH, seed=0)
        out[name] = (ex, res.records, requests)
    return out


@pytest.mark.parametrize("name", PAPER_ARCHS)
def test_paper_model_executor_serves_with_a_swap(paper_weeks, name):
    """`make_executor("engine", PAPER_MODELS[name], ORIN_AGX, arch=name)`
    builds the reduced model (no qkv bias, 4 query heads a KV head) on the
    paged engine, prices its steps from its own profile, and serves the
    ramp's queries across a live Q8 -> Q4 swap. The two reduced models are
    one model under two names and their profiles the same constants, so
    LLaMA's week is Hermes's."""
    ex, recs, requests = paper_weeks[name]
    assert ex.profile is PC.PAPER_MODELS[name]
    assert ex.cfg.name == f"{name}-reduced" and not ex.cfg.qkv_bias
    assert ex.cfg.num_heads == 4 * ex.cfg.num_kv_heads
    assert ex.engine.kv_layout == "paged" and ex.engine.kernel_fallbacks > 0
    assert len(recs) > 10 and ex.swap_count >= 1
    assert {r.variant for r in recs} == {"q8", "q4"}
    assert {r.mode_idx for r in recs} >= {0, 4}
    assert all(r.tps > 0 for r in recs)
    assert check_invariants(ex.engine, requests) == []
    hermes = paper_weeks[PAPER_ARCHS[0]]
    assert [dataclasses.astuple(r) for r in recs] == \
        [dataclasses.astuple(r) for r in hermes[1]]
    assert [(s["kind"], s["rids"], s["tokens"], s["variant"])
            for s in ex.engine.step_log] == \
        [(s["kind"], s["rids"], s["tokens"], s["variant"])
         for s in hermes[0].engine.step_log]


# ---------------------------------------------------------------------------
# entry points: the card by default; what is not ported yet is refused
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    prof = PC.PAPER_MODELS[PROFILE]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PC.EngineExecutor(prof, ORIN_AGX)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PC.make_executor("engine", prof, ORIN_AGX)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PC.ToolSelector(PW.build_catalog(16, seed=0))


@pytest.mark.parametrize("config,item", [
    # spec decoding and chunked prefill are served; what stays refused is
    # what the JAX package refuses: a draft variant the executor has no
    # weights for, a window that is not positive
    pytest.param((EngineConfig(max_batch=2, spec_decode=SpecDecodeConfig(
        draft_variant="q2")), ValueError, "not in variants"),
        "Queue 1 item 4", id="config0-Queue 1 item 4"),
    pytest.param((EngineConfig(max_batch=2, data_shards=2),
                  NotImplementedError, "Queue 1 item 9"),
                 "Queue 1 item 9", id="config1-Queue 1 item 9"),
    pytest.param((EngineConfig(max_batch=2, prefill_chunk=0), ValueError,
                  "must be positive"),
                 "Queue 1 item 4", id="config2-Queue 1 item 4"),
])
def test_executor_refuses_unported_configs(config, item):
    config, exc, match = config
    with pytest.raises(exc, match=match):
        PC.EngineExecutor(PC.PAPER_MODELS[PROFILE], ORIN_AGX, config=config,
                          device="cpu")


# ---------------------------------------------------------------------------
# the fleet: sim-backed in this process, engine-backed against a subprocess
# ---------------------------------------------------------------------------


def _fleet_pods(C, F, sel, hw, weeks):
    """One sim pod a week in `weeks` (tests/test_fleet.py's `_pods`, on the
    Orin board: the port has no TPU spec)."""
    pods = []
    for i, week in enumerate(weeks):
        ex = C.SimExecutor(C.PAPER_MODELS[PROFILE], hw, seed=i)
        rt = C.CarbonCallRuntime(
            selector=sel, executor=ex, policy=C.POLICIES["carboncall"],
            modes=C.ORIN_MODES, catalog_size=len(sel.catalog.tools), seed=i)
        ci = C.ci_trace(week, seed=100 + i)
        pods.append(F.PodState(pod_id=i, runtime=rt, ci_trace=ci,
                               gov_state=rt.governor.init(ci[:144])))
    return pods


def _fleet_records(recs):
    return {pid: [dataclasses.astuple(r) for r in rs]
            for pid, rs in recs.items()}


def _fleet_scenario(name, C, F, W, sel, hw):
    """Run one of tests/test_fleet.py's topologies with one package's
    modules; returns what the two packages must agree on."""
    wl = W.FunctionCallWorkload(sel.catalog, seed=5)
    out = {}
    if name == "flat":
        pods = _fleet_pods(C, F, sel, hw, ["week1", "week2", "week3",
                                           "week4"])
        out["records"] = _fleet_records(F.run_fleet(
            pods, wl, n_steps=36, queries_per_hour=30.0))
    elif name == "hierarchical":
        spec = F.FleetSpec(regions=(
            F.RegionSpec("clean", week="week2", ci_scale=0.5,
                         pods=(("edge", 1), ("pod-dp4", 1))),
            F.RegionSpec("dirty", week="week1", pods=(("edge", 2),))))
        fleet = F.build_fleet(spec, catalog=sel.catalog, selector=sel,
                              seed=0)
        out["built"] = [p.pod_id for p in fleet.built_pods()]
        out["shards"] = [p.engine_cfg.data_shards for p in fleet.pods]
        out["records"] = _fleet_records(F.run_fleet(
            fleet, wl, n_steps=36, queries_per_hour=30.0))
        out["routed"] = [(r.name, r.routed) for r in fleet.regions]
        pods = fleet.pods
    elif name == "health":
        pods = _fleet_pods(C, F, sel, hw, ["week1", "week1"])
        sw = pods[0].runtime.switcher
        sw.set_reference(100.0)
        for t in range(0, 700, 60):
            sw.observe(float(t), 10.0)
        router = F.FleetRouter(pods)
        router.mark_health()
        out["healthy"] = [p.healthy for p in pods]
        out["first"] = router.route(0).pod_id
        out["records"] = _fleet_records(F.run_fleet(
            pods, wl, n_steps=12, queries_per_hour=30.0, router=router))
    elif name == "unhealthy":
        pods = _fleet_pods(C, F, sel, hw, ["week1", "week2"])
        for p in pods:
            p.healthy = False
        router = F.FleetRouter(pods)
        out["routes"] = [router.route(i).pod_id for i in range(0, 288, 12)]
    elif name == "diurnal":
        pods = _fleet_pods(C, F, sel, hw, ["week1", "week2"])
        out["records"] = _fleet_records(F.run_fleet(
            pods, wl, n_steps=36, seed=1,
            rate_fn=lambda t: W.diurnal_qph(60.0, t)))
    elif name == "backlog":
        pods = _fleet_pods(C, F, sel, hw, ["week1", "week2"])
        pods[0].queue_s, pods[1].queue_s = 1500.0, 100.0
        F.run_fleet(pods, wl, n_steps=2, queries_per_hour=0.0)
        out["after2"] = [p.queue_s for p in pods]
        F.run_fleet(pods, wl, n_steps=1, queries_per_hour=0.0)
        out["after3"] = [p.queue_s for p in pods]
    out["served"] = [p.served for p in pods]
    out["queue_s"] = [p.queue_s for p in pods]
    return out


def _close_records(got, want):
    """Per pod, the same records in the same order: every field equal, the
    floats within ENGINE_REL_TOL."""
    assert got.keys() == want.keys()
    for pid in want:
        assert len(got[pid]) == len(want[pid]), pid
        for g, w in zip(got[pid], want[pid]):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert _rel_close(a, b), (pid, g, w)
                else:
                    assert a == b, (pid, g, w)


FLEET_SCENARIOS = ("flat", "hierarchical", "health", "unhealthy", "diurnal",
                   "backlog")


@pytest.mark.parametrize("name", FLEET_SCENARIOS)
def test_run_fleet_sim_matches_reference(selectors, name):
    """`run_fleet` with sim pods in both packages, in this process: the
    topologies of tests/test_fleet.py (a flat router over four weeks, a
    FleetSpec of two regions under the hierarchical router with its
    sharded profile degraded, health gating, every pod unhealthy, a
    `diurnal_qph` rate, a backlog draining with no arrivals) give the same
    routing and per-pod records within ENGINE_REL_TOL."""
    ref_sel, sel = selectors
    want = _fleet_scenario(name, RC, RF, RW, ref_sel, REF_ORIN)
    got = _fleet_scenario(name, PC, PF, PW, sel, ORIN_AGX)
    assert got.keys() == want.keys()
    for key in want:
        if key == "records":
            _close_records(got[key], want[key])
        elif key in ("queue_s", "after2", "after3"):
            assert all(_rel_close(a, b) for a, b in zip(got[key], want[key]))
        else:
            assert got[key] == want[key], key
    if "records" in want:
        assert sum(len(r) for r in want["records"].values()) > 10
    if name == "hierarchical":
        assert got["shards"] == [1, 1, 1, 1] and got["built"] == []
    if name == "backlog":
        assert got["after2"] == [300.0, 0.0] and got["after3"] == [0.0, 0.0]
    if name == "health":
        assert got["healthy"] == [False, True] and got["first"] == 1


FLEET_REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import repro.core as C
from repro.core.fleet import FleetSpec, RegionSpec, build_fleet, run_fleet
from repro.data.workload import FunctionCallWorkload, build_catalog
from repro.serving import engine as E

spec = json.loads(open(sys.argv[1]).read())
out_dir = sys.argv[2]
# copy host arrays at the hand-over to jitted calls and wait for each
# jitted call's inputs and outputs (tests/test_torch_spec_chunk.py says why)
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

cat = build_catalog(240, seed=0)
sel = C.ToolSelector(cat)
arrays, meta = {}, {}
for k, v in sel.encoder_params.items():
    stack = [(k, v)]
    while stack:
        name, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((name + "/" + kk, vv) for kk, vv in node.items())
            continue
        a = np.asarray(node)
        meta[name] = a.dtype.name
        arrays[name] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
np.savez(out_dir + "/encoder.npz", **arrays)
fleet = build_fleet(FleetSpec(regions=tuple(
    RegionSpec(n, w, s, tuple((p, c) for p, c in pods))
    for n, w, s, pods in spec["regions"])), catalog=cat, selector=sel, seed=0)
recs = run_fleet(fleet, FunctionCallWorkload(cat, seed=3),
                 n_steps=spec["steps"], queries_per_hour=spec["qph"], seed=0,
                 backend="engine")
pods = []
for p in fleet.pods:
    built = p.client is not None
    eng = p.runtime.executor.engine if built else None
    pods.append({
        "records": [r.__dict__ for r in recs[p.pod_id]],
        "built": built,
        "swap_count": p.runtime.executor.swap_count if built else 0,
        "log": [[s["kind"], list(s["rids"]), s["tokens"], s["variant"],
                 s["prompt_tokens"], s["cached_tokens"], s["dt"]]
                for s in eng.step_log] if built else []})
json.dump({"meta": meta, "pods": pods,
           "routed": [[r.name, r.routed] for r in fleet.regions]},
          open(out_dir + "/results.json", "w"))
"""
# the chip's fleet phase at reduced width: a clean region with an edge pod,
# a dirty one with a pod
FLEET_REGIONS = (("clean", "week1", 0.5, (("edge", 1),)),
                 ("dirty", "week1", 1.5, (("pod", 1),)))
FLEET_STEPS, FLEET_QPH = 6, 12.0


@pytest.fixture(scope="module")
def fleet_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_fleet")
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps({"regions": FLEET_REGIONS,
                                     "steps": FLEET_STEPS,
                                     "qph": FLEET_QPH}))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", FLEET_REF_SCRIPT,
                           str(spec_path), str(out)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    data = json.loads((out / "results.json").read_text())
    arrays = np.load(out / "encoder.npz")
    enc = {}
    for name, dtype in data["meta"].items():
        *head, last = name.split("/")
        node = enc
        for h in head:
            node = node.setdefault(h, {})
        node[last] = (arrays[name], dtype) if dtype == "bfloat16" \
            else arrays[name]
    return data, params_from_numpy(enc, "cpu")


def test_run_fleet_engine_matches_reference(fleet_reference):
    """The engine-backed fleet at reduced width (the chip's fleet phase:
    two regions of one pod each, engines built lazily on the first routed
    query, on one fleet clock) against the reference's fleet run in a
    subprocess: the same pods built, the same region split, and per pod
    the same records (floats within ENGINE_REL_TOL), swaps and step log."""
    data, encoder = fleet_reference
    sel = PC.ToolSelector(PW.build_catalog(240, seed=0),
                          encoder_params=encoder, device="cpu")
    spec = PF.FleetSpec(regions=tuple(PF.RegionSpec(*r)
                                      for r in FLEET_REGIONS))
    fleet = PF.build_fleet(spec, catalog=sel.catalog, selector=sel, seed=0,
                           device="cpu")
    assert fleet.built_pods() == []
    recs = PF.run_fleet(fleet, PW.FunctionCallWorkload(sel.catalog, seed=3),
                        n_steps=FLEET_STEPS, queries_per_hour=FLEET_QPH,
                        seed=0, backend="engine")
    assert [[r.name, r.routed] for r in fleet.regions] == data["routed"]
    served = 0
    for pod, want in zip(fleet.pods, data["pods"]):
        built = pod.client is not None
        assert built == want["built"] == bool(want["records"]), pod.pod_id
        got = [r.__dict__ for r in recs[pod.pod_id]]
        _close_records({0: [tuple(r.values()) for r in got]},
                       {0: [tuple(r.values()) for r in want["records"]]})
        served += len(got)
        if not built:
            assert isinstance(pod.runtime.executor, PC.SimExecutor)
            continue
        ex = pod.runtime.executor
        assert isinstance(ex, PC.EngineExecutor)
        assert ex.engine.device.type == "cpu" and ex.clock is pod.fleet_clock
        assert ex.swap_count == want["swap_count"]
        log = [[s["kind"], list(s["rids"]), s["tokens"], s["variant"],
                s["prompt_tokens"], s["cached_tokens"]]
               for s in ex.engine.step_log]
        assert log == [s[:6] for s in want["log"]]
        assert all(_rel_close(s["dt"], w[6])
                   for s, w in zip(ex.engine.step_log, want["log"]))
    assert served > 5
