"""Chunked prefill and speculative decoding on the port's paged engine,
against the JAX package's, on the reduced carboncall-qwen2-7b.

The reference runs in one subprocess (`sys.executable -c`, JAX_PLATFORMS=cpu),
as in `tests/test_torch_engine.py`: it builds the Q8/Q4 weights from a seed,
serves the scenarios below, runs a short engine-backed `run_week` with a
chunked, speculative executor, and writes weights and results as files. No
reference engine is built in the pytest process.

Every decision either engine makes is logged: each greedy sample row of a
live slot, each draft round's and each verify window's argmax. A step is a
near-tie when one of its decisions has a top-2 margin below MARGIN_BOUND in
either engine. What must match:
  * free-running: statuses; the step log (kind, rids, tokens, variant,
    prompt and cached tokens, drafted / accepted / emitted, free blocks after
    the step) and tokens exactly up to the first near-tie step, the whole log
    and the EngineStats snapshot where there is none (chunked scenarios have
    no token-dependent scheduling: with `eos_id=-1` and a fixed
    `max_new_tokens` their whole log is compared); the invariant sweep
    clean in both;
  * teacher-forced: the port takes the reference's sampled tokens, draft
    tokens and verify argmaxes, so both follow one history; then the whole
    step log and EngineStats are equal, and every logits row behind a
    decision (samples, draft rounds, verify windows, live slots only) is
    within ENGINE_LOGIT_TOL, with the port's argmax equal to the reference's
    where the reference's margin is at least MARGIN_BOUND;
  * the engine-backed week: records, swap count and step log equal, and
    latency, energy, carbon and TPS within ENGINE_REL_TOL, up to the first
    near-tie step (the records of queries that finished before it).
Port-only: k = 0, missing draft weights, a non-greedy resident and a swap to
the draft variant stand spec down; cancel, expiry and a hot swap mid-draft
return the leases; cancel and expiry mid-chunk reconcile the refcounts;
PoolExhaustedError is typed; the configuration checks; block-multiple
rounding; the stats counters and `EngineStats.merge`.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core as PC
from repro_torch.bridge import params_from_numpy
from repro_torch.common.hardware import ORIN_AGX
from repro_torch.common.registry import get_arch
from repro_torch.config import RuntimeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.data import workload as PW
from repro_torch.serving import (EngineClient, EngineConfig, EngineStallError,
                                 EngineStats, PoolExhaustedError, Request,
                                 ServingEngine, SessionRequest,
                                 SpecDecodeConfig, VirtualClock,
                                 check_invariants)
# the engine test's bounds and weight bridge, same reasoning: on one history
# the two engines' logits agree within ENGINE_LOGIT_TOL (bf16 rounded at
# different places), so a decision can only flip where a top-2 margin is
# below MARGIN_BOUND, twice that
from test_torch_engine import ENGINE_LOGIT_TOL, MARGIN_BOUND, _port_variants

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
ENGINE_REL_TOL = 1e-9           # tests/test_torch_runtime.py's
STEP_COST_S = 0.001
# the week: clean grid, then a dirty one; a chunk below the 256 bucket and
# a draft-length ladder over the five Orin modes
RAMP_CLEAN, RAMP_DIRTY, RAMP_CI = 1, 2, (100.0, 900.0)
WEEK_QPH = 12.0
WEEK_CHUNK = 32
WEEK_LADDER = (1, 2, 4)

REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from repro.common.registry import get_arch
from repro.config import RuntimeConfig
from repro.configs.reduced import reduce_config
from repro.models import get_model
from repro.quant import QTensor, quantize_tree
from repro.serving import (EngineClient, EngineConfig, ServingEngine,
                           SessionRequest, SpecDecodeConfig, VirtualClock,
                           check_invariants)
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

# Copy host arrays at the hand-over to jitted calls (tests/test_torch_engine.py
# says why), and wait for each jitted call's inputs and outputs: without the
# wait, a request decoding while another one chunked read different logits
# (by up to 0.39) in two runs of this script out of three, with the copy,
# with synchronous dispatch and with one XLA thread alike; with it, five
# runs agreed. Log every argmax the speculative path takes.
CUR = [None]
class _CopyingJnp:
    def __getattr__(self, name):
        return getattr(E.jax.numpy, name)
    @staticmethod
    def asarray(x, *args, **kwargs):
        return E.jax.numpy.array(x, *args, **kwargs)
    @staticmethod
    def argmax(x, axis=None):
        out = E.jax.numpy.argmax(x, axis=axis)
        eng = CUR[0]
        if eng is not None:
            eng._decide(np.asarray(x, np.float32), np.asarray(out, np.int32))
        return out
E.jnp = _CopyingJnp()
orig_shared = E.ServingEngine._shared_exec
def _shared_exec(self, kind, build, *extra):
    fn = orig_shared(self, kind, build, *extra)
    def synced(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))
    return synced
E.ServingEngine._shared_exec = _shared_exec

def live(self):
    return [i for i, s in enumerate(self.slots) if s is not None]
def margin(rows):
    if rows.size == 0:
        return np.inf
    top2 = np.sort(rows, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())
def _decide(self, logits, out):
    rows = logits[live(self)]
    self._calls.append((logits, out, live(self)))
    self._step_margin = min(self._step_margin, margin(rows))
E.ServingEngine._decide = _decide

orig_sample, orig_emit = E.ServingEngine._sample, E.ServingEngine._emit
orig_spec = E.ServingEngine._spec_step
def _sample(self, logits, req):
    lg = np.asarray(logits, np.float32)
    self._logits_last = lg
    self._step_margin = min(self._step_margin,
                            margin(lg if len(lg) == 1 else lg[live(self)]))
    return orig_sample(self, logits, req)
def _emit(self, req, slot, tok):
    if self._in_spec:
        j = self._spec_j.get(slot, 0)
        self._spec_j[slot] = j + 1
        row = self._calls[-1][0][slot, j]
    else:
        lg = self._logits_last
        row = lg[0 if len(lg) == 1 else slot]
    self._rows.setdefault(req.rid, []).append(row)
    return orig_emit(self, req, slot, tok)
def _spec_step(self, completed):
    self._in_spec, self._spec_j = True, {}
    try:
        return orig_spec(self, completed)
    finally:
        self._in_spec = False
E.ServingEngine._sample, E.ServingEngine._emit = _sample, _emit
E.ServingEngine._spec_step = _spec_step

def instrument(eng):
    eng._calls, eng._rows, eng._in_spec = [], {}, False
    eng._step_margin, eng._margins, eng._free = np.inf, [], []
    orig_step = eng.step
    def step():
        CUR[0] = eng
        eng._step_margin = np.inf
        try:
            return orig_step()
        finally:
            eng._margins.append(eng._step_margin)
            eng._free.append(int(eng.block_pool.num_free))
    eng.step = step

def log_rows(eng):
    return [[s["kind"], list(s["rids"]), s["tokens"], s["variant"],
             s["prompt_tokens"], s["cached_tokens"], s.get("drafted", 0),
             s.get("accepted", 0),
             sorted([int(k), v] for k, v in s.get("emitted", {}).items()),
             f] for s, f in zip(eng.step_log, eng._free)]

results, saved = {}, {}
for sc in spec_in["scenarios"]:
    if not sc["reference"]:
        continue
    clock = VirtualClock()
    sd = None
    if sc["spec"] is not None:
        sd = SpecDecodeConfig("q4", k=sc["spec"])
    eng = ServingEngine(
        cfg, variants["q8"], RuntimeConfig(kv_cache_dtype=sc["kv"]),
        max_batch=sc["max_batch"], max_seq=sc["max_seq"], kv_layout="paged",
        num_blocks=sc["num_blocks"], prefill_chunk=sc["chunk"],
        spec_decode=sd, clock=clock,
        step_cost_fn=lambda kind, n, active: spec_in["cost"] * (1 + n))
    eng.variant_name = "q8"
    if sd is not None and sc["draft"]:
        eng.set_draft_params(variants["q4"], "q4")
    instrument(eng)
    client = EngineClient(eng)
    hs = []
    def submit(r):
        hs.append(client.submit(SessionRequest(
            prompt=r["prompt"], max_new_tokens=sc["max_new"], eos_id=-1,
            priority=r["priority"], deadline_s=r["deadline"],
            temperature=r["temperature"])))
    pending = sorted(sc["requests"], key=lambda r: r["at"])
    steps = 0
    while pending or eng.has_work():
        while pending and pending[0]["at"] <= steps:
            submit(pending.pop(0))
        for at, what, arg in sc["events"]:
            if at != steps:
                continue
            if what == "swap":
                eng.swap_params(variants[arg], arg)
            elif what == "draft_k":
                eng.set_draft_k(arg)
            elif what == "cancel":
                hs[arg].cancel()
        if eng.has_work():
            eng.step()
        else:
            clock.advance(spec_in["cost"])
        steps += 1
    reqs = [h.request for h in hs]
    name = sc["name"]
    for i, r in enumerate(reqs):
        if eng._rows.get(r.rid):
            saved[f"{name}/rows/{i}"] = np.stack(eng._rows[r.rid])
    for n, (lg, out, lv) in enumerate(eng._calls):
        saved[f"{name}/call/{n}/logits"] = lg
        saved[f"{name}/call/{n}/argmax"] = out
    results[name] = {
        "status": [r.status for r in reqs],
        "output": [[int(t) for t in r.output] for r in reqs],
        "log": log_rows(eng),
        "margins": [float(m) for m in eng._margins],
        "calls": [lv for _, _, lv in eng._calls],
        "stats": eng.stats().to_wire(),
        "invariants": check_invariants(eng, reqs),
    }

# the engine-backed week with a chunked, speculative executor
import repro.core as C
from repro.common.hardware import ORIN_AGX
from repro.data.workload import FunctionCallWorkload, build_catalog
wk = spec_in["week"]
cat = build_catalog(240, seed=0)
sel = C.ToolSelector(cat)
arrays = {}
emeta = {}
for k, v in sel.encoder_params.items():
    stack = [(k, v)]
    while stack:
        name, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((name + "/" + kk, vv) for kk, vv in node.items())
            continue
        a = np.asarray(node)
        emeta[name] = a.dtype.name
        arrays[name] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
np.savez(out_dir + "/encoder.npz", **arrays)
rt = C.CarbonCallRuntime(
    selector=sel, executor=C.SimExecutor(C.PAPER_MODELS["qwen2-7b"],
                                         ORIN_AGX, seed=0),
    policy=C.POLICIES["carboncall"], modes=C.ORIN_MODES, catalog_size=240,
    seed=0)
rt.use_backend("engine", config=EngineConfig(
    max_batch=4, prefill_chunk=wk["chunk"],
    spec_decode=SpecDecodeConfig("q4", k=2, k_ladder=tuple(wk["ladder"]))))
ex = rt.executor
instrument(ex.engine)
ks, set_k = [], ex.engine.set_draft_k
def recorded_k(k):
    ks.append(k)
    return set_k(k)
ex.engine.set_draft_k = recorded_k
requests, submit = [], ex.engine.submit
def recorded_submit(req):
    requests.append(req)
    return submit(req)
ex.engine.submit = recorded_submit
res = C.run_week(rt, FunctionCallWorkload(cat, seed=3), np.array(wk["ci"]),
                 queries_per_hour=wk["qph"], seed=0, backend="engine")
for n, (lg, out, lv) in enumerate(ex.engine._calls):
    saved[f"week/call/{n}/argmax"] = out
results["week"] = {
    "records": [r.__dict__ for r in res.records],
    "swap_count": ex.swap_count,
    "draft_ks": ks,
    "output": {str(r.rid): [int(t) for t in r.output] for r in requests},
    "log": log_rows(ex.engine),
    "dt": [s["dt"] for s in ex.engine.step_log],
    "stats": ex.engine.stats().to_wire(),
    "invariants": check_invariants(ex.engine, requests),
}
np.savez(out_dir + "/logits.npz", **saved)
json.dump({"meta": meta, "emeta": emeta, "results": results},
          open(out_dir + "/results.json", "w"))
"""


def _scenarios():
    rng = np.random.default_rng(SEED)

    def toks(n):
        return [int(t) for t in rng.integers(2, 512, size=n)]

    def req(prompt, at=0, priority=0, deadline=None, temperature=0.0):
        return {"prompt": prompt, "at": at, "priority": priority,
                "deadline": deadline, "temperature": temperature}

    # one engine shape (4 slots, 256 positions) for every scenario, so the
    # reference compiles each program once per KV type
    base = {"kv": "bf16", "max_batch": 4, "max_seq": 256, "num_blocks": None,
            "chunk": None, "spec": None, "draft": True, "max_new": 8,
            "events": [], "reference": True}
    long, short, tail = toks(60), toks(40), toks(28)
    # tests/test_chunked.py's mix: one bucket (64) for every prompt, so
    # chunked and monolithic admissions pad alike; the third shares the
    # second's first 32 tokens (a warm mid-prompt boundary)
    mix = [req(short), req(long), req(long[:32] + tail, at=40)]
    tool = toks(32)
    # four prompts share a 32-token tool prefix at one length, four do not
    spec_prompts = [p for pair in zip([tool + toks(16) for _ in range(4)],
                                      [toks(n) for n in (9, 20, 41, 27)])
                    for p in pair]
    spec_reqs = [req(p) for p in spec_prompts]
    big = [toks(n) for n in (150, 100, 200)]
    return [
        # the port's own plain baselines of the chunked and spec runs, and
        # tests/test_chunked.py's mix chunked (port only: the reference
        # scenarios below cover its paths)
        dict(base, name="plain_mix", requests=mix, reference=False),
        dict(base, name="spec_plain", max_new=12, requests=spec_reqs,
             reference=False),
        dict(base, name="chunk_mix", chunk=16, requests=mix, reference=False),
        # int8 KV, windows of 32 over 128- and 256-token buckets, a parked
        # chunk cancelled, one expiring between windows, a Q8 -> Q4 swap
        # that drops the parked chain of the head, and a prompt of the same
        # length sharing its first 96 tokens (a warm mid-prompt boundary)
        dict(base, name="chunk_int8_events", kv="int8", chunk=32, max_new=6,
             requests=[req(toks(20)), req(big[0]), req(big[1], at=2),
                       req(big[2], at=3, deadline=0.05),
                       req(big[0][:96] + toks(54), at=4)],
             events=[[6, "cancel", 2], [14, "swap", "q4"]]),
        # a tight pool: a low-priority chunk is parked when a high-priority
        # long prompt arrives, and yields its blocks to it
        dict(base, name="chunk_pressure", num_blocks=20,
             chunk=32, max_new=6,
             requests=[req(toks(30), priority=1), req(big[0]),
                       req(big[2], at=7, priority=2)]),
        # k 2, then 4 from step 6; a swap to the draft variant at step 12
        # stands spec down
        dict(base, name="spec_k2", max_new=16, spec=2, requests=spec_reqs,
             events=[[6, "draft_k", 4], [12, "swap", "q4"]]),
        # both at once, on int8 KV: residents draft while long prompts chunk
        dict(base, name="spec_chunk", kv="int8", chunk=32, max_new=10, spec=2,
             requests=[req(toks(24)), req(toks(30)), req(big[0], at=2),
                       req(big[1], at=3)]),
    ]


def _week_spec():
    ci = [RAMP_CI[0]] * RAMP_CLEAN + [RAMP_CI[1]] * RAMP_DIRTY
    return {"ci": ci, "qph": WEEK_QPH, "chunk": WEEK_CHUNK,
            "ladder": list(WEEK_LADDER)}


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_spec_chunk")
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps({
        "seed": SEED, "cost": STEP_COST_S, "scenarios": _scenarios(),
        "week": _week_spec()}))
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(spec_path),
                           str(out)], env=_env(), cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    data = json.loads((out / "results.json").read_text())
    return data, dict(np.load(out / "weights.npz")), \
        dict(np.load(out / "logits.npz")), dict(np.load(out / "encoder.npz"))


@pytest.fixture(scope="module")
def port_variants(reference):
    data, weights, _, _ = reference
    return _port_variants(data["meta"], weights)


def _margin(rows):
    if rows.size == 0:
        return np.inf
    top2 = np.sort(rows, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _live(eng):
    return [i for i, s in enumerate(eng.slots) if s is not None]


class _Recorder:
    """Hooks on one port engine: every decision's logits and margin, each
    emission's logits row, and the free blocks after each step (0 on the
    dense layout). With
    `force` (the reference's tokens by rid; both engines number requests
    alike) and `calls` (its argmax arrays in call order) every sample,
    draft round and verify takes the reference's outcome, so both engines
    follow one history."""

    def __init__(self, eng, force=None, calls=None):
        self.eng, self.force, self.ref_calls = eng, force, calls
        self.calls, self.rows, self.margins, self.free = [], {}, [], []
        self.in_spec, self.spec_j, self.step_margin = False, {}, np.inf
        sample, emit, greedy = eng._sample, eng._emit, eng._greedy
        spec_step, step = eng._spec_step, eng.step
        last = {}

        def rec_sample(logits, req):
            lg = torch.as_tensor(logits).float().numpy()
            last["logits"] = lg
            self.step_margin = min(self.step_margin, _margin(
                lg if len(lg) == 1 else lg[_live(eng)]))
            return sample(logits, req)

        def rec_greedy(logits):
            lg = torch.as_tensor(logits).float().numpy()
            n = len(self.calls)
            self.calls.append((lg, _live(eng)))
            self.step_margin = min(self.step_margin, _margin(lg[_live(eng)]))
            out = greedy(logits)
            if self.ref_calls is not None:
                out = self.ref_calls[n].copy()
            return out

        def rec_emit(req, slot, tok):
            if self.in_spec:
                j = self.spec_j.get(slot, 0)
                self.spec_j[slot] = j + 1
                row = self.calls[-1][0][slot, j]
            else:
                lg = last["logits"]
                row = lg[0 if len(lg) == 1 else slot]
            self.rows.setdefault(req.rid, []).append(row)
            if self.force is not None:
                tok = self.force[req.rid][len(req.output)]
            emit(req, slot, tok)

        def rec_spec_step(completed):
            self.in_spec, self.spec_j = True, {}
            try:
                return spec_step(completed)
            finally:
                self.in_spec = False

        def rec_step():
            self.step_margin = np.inf
            try:
                return step()
            finally:
                self.margins.append(self.step_margin)
                self.free.append(int(eng.block_pool.num_free)
                                 if eng.kv_layout == "paged" else 0)

        eng._sample, eng._emit, eng._greedy = rec_sample, rec_emit, rec_greedy
        eng._spec_step, eng.step = rec_spec_step, rec_step

    def log(self):
        return [[s["kind"], list(s["rids"]), s["tokens"], s["variant"],
                 s["prompt_tokens"], s["cached_tokens"], s.get("drafted", 0),
                 s.get("accepted", 0),
                 sorted([int(k), v] for k, v in s.get("emitted", {}).items()),
                 f] for s, f in zip(self.eng.step_log, self.free)]


CFG = reduce_config(get_arch("carboncall-qwen2-7b"))


def _serve(variants, sc, force=None, calls=None, spec_override=None):
    """Serve scenario `sc` on the port as the reference script does."""
    clock = VirtualClock()
    k = sc["spec"] if spec_override is None else spec_override
    sd = None if k is None else SpecDecodeConfig("q4", k=k)
    eng = ServingEngine(
        CFG, variants["q8"], RuntimeConfig(kv_cache_dtype=sc["kv"]),
        max_batch=sc["max_batch"], max_seq=sc["max_seq"], kv_layout="paged",
        num_blocks=sc["num_blocks"], prefill_chunk=sc["chunk"],
        spec_decode=sd, clock=clock, device="cpu",
        step_cost_fn=lambda kind, n, active: STEP_COST_S * (1 + n))
    eng.variant_name = "q8"
    if sd is not None and sc["draft"]:
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
                prompt=r["prompt"], max_new_tokens=sc["max_new"], eos_id=-1,
                priority=r["priority"], deadline_s=r["deadline"],
                temperature=r["temperature"])))
        for at, what, arg in sc["events"]:
            if at != steps:
                continue
            if what == "swap":
                eng.swap_params(variants[arg], arg)
            elif what == "draft_k":
                eng.set_draft_k(arg)
            elif what == "cancel":
                hs[arg].cancel()
        if eng.has_work():
            eng.step()
        else:
            clock.advance(STEP_COST_S)
        steps += 1
    return eng, [h.request for h in hs], rec


def _first_tie(ref_margins, port_margins):
    for n, (a, b) in enumerate(zip(ref_margins, port_margins)):
        if min(a, b) < MARGIN_BOUND:
            return n
    return min(len(ref_margins), len(port_margins))


SCENARIOS = [s["name"] for s in _scenarios() if s["reference"]]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_reference(reference, port_variants, name):
    data, _, ref_logits, _ = reference
    ref = data["results"][name]
    sc = {s["name"]: s for s in _scenarios()}[name]
    eng, reqs, rec = _serve(port_variants, sc)
    log = rec.log()
    assert ref["invariants"] == []
    assert [r.status for r in reqs] == ref["status"]
    if sc["spec"] is None:
        # nothing in a plain or chunked run's scheduling reads a token
        assert log == ref["log"]
        assert eng.stats().to_wire() == ref["stats"]
        tie = len(log)
    else:
        tie = _first_tie(ref["margins"], rec.margins)
        assert log[:tie] == ref["log"][:tie]
        if tie == len(log) == len(ref["log"]):
            assert eng.stats().to_wire() == ref["stats"]
    # tokens, by the margin rule of each request's own emissions: a
    # request's tokens do not depend on the other rows, only on the
    # admission that placed it, which is the same where it ran in a step
    # before the first near-tie (or in that step, logged alike)
    admitted = {}
    for n, row in enumerate(log):
        if row[0] == "prefill" and row[2] > 0:
            for rid in row[1]:
                admitted.setdefault(rid, n)
    compared = 0
    for i, (r, want) in enumerate(zip(reqs, ref["output"])):
        n = admitted.get(r.rid)
        if not want or n is None or n > tie or n >= len(ref["log"]) \
                or log[n] != ref["log"][n]:
            continue
        compared += _tokens_by_margin(r.output, want,
                                      ref_logits[f"{name}/rows/{i}"])
    print(f"{name}: first near-tie step {tie} of {len(log)}; {compared} of "
          f"{sum(len(o) for o in ref['output'])} tokens compared")
    assert compared > 0
    assert check_invariants(eng, reqs) == []


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_logits_match_reference_teacher_forced(reference,
                                                        port_variants, name):
    data, _, ref_logits, _ = reference
    ref = data["results"][name]
    sc = {s["name"]: s for s in _scenarios()}[name]
    calls = [ref_logits[f"{name}/call/{n}/argmax"]
             for n in range(len(ref["calls"]))]
    eng, reqs, rec = _serve(port_variants, sc, force=ref["output"],
                            calls=calls)
    assert [r.output for r in reqs] == ref["output"]
    assert rec.log() == ref["log"]
    assert eng.stats().to_wire() == ref["stats"]
    assert check_invariants(eng, reqs) == []
    worst = 0.0
    pairs = []
    for i, r in enumerate(reqs):
        if r.rid in rec.rows:
            pairs.append((np.stack(rec.rows[r.rid]),
                          ref_logits[f"{name}/rows/{i}"],
                          np.asarray(ref["output"][i])))
    assert len(rec.calls) == len(ref["calls"])
    for n, ((got, lv), want_lv) in enumerate(zip(rec.calls, ref["calls"])):
        assert lv == want_lv
        want = ref_logits[f"{name}/call/{n}/logits"]
        pairs.append((got[lv], want[lv],
                      ref_logits[f"{name}/call/{n}/argmax"][lv]))
    for got, want, toks in pairs:
        assert got.shape == want.shape
        err = np.abs(got - want).max(axis=-1)
        worst = max(worst, float(err.max()))
        assert (err < ENGINE_LOGIT_TOL).all(), (name, err.max())
        top2 = np.sort(want, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) >= MARGIN_BOUND
        assert (got.argmax(-1)[sure] == toks[sure]).all(), name
    print(f"{name}: max |logit diff| {worst:.4f} over {len(pairs)} arrays "
          "of decisions")


def test_scenarios_exercise_the_paths(reference):
    """Each scenario reaches what it is named for, in the reference."""
    res = reference[0]["results"]
    kinds = {n: [row[0] for row in res[n]["log"]] for n in SCENARIOS}
    for n in ("chunk_int8_events", "chunk_pressure", "spec_chunk"):
        assert res[n]["stats"]["chunk_steps"] > 0, n
    assert res["chunk_int8_events"]["stats"]["chunk_drops"] >= 2
    assert res["chunk_int8_events"]["stats"]["cancelled"] == 1
    assert res["chunk_int8_events"]["stats"]["expired"] == 1
    assert res["chunk_int8_events"]["stats"]["swap_count"] == 1
    assert res["chunk_pressure"]["stats"]["chunk_drops"] >= 1
    assert res["chunk_int8_events"]["stats"]["prefix_cache"][
        "prefill_tokens_saved"] > 0
    for n in ("spec_k2", "spec_chunk"):
        st = res[n]["stats"]
        assert st["spec_steps"] > 0 and 0 < st["accepted_tokens"] \
            <= st["draft_tokens"], n
    # k 4 from step 6, and plain decode after the swap to the draft variant
    assert {row[6] // len(row[1]) for row in res["spec_k2"]["log"]
            if row[0] == "spec_verify"} >= {2, 4}
    after = [row for row in res["spec_k2"]["log"] if row[3] == "q4"]
    assert after and all(row[0] != "spec_verify" for row in after)
    assert "prefill_chunk" in kinds["spec_chunk"] \
        and "spec_verify" in kinds["spec_chunk"]


def _tokens_by_margin(got, want, rows):
    """Tokens equal up to the first emission whose top-2 margin (in `rows`)
    is below MARGIN_BOUND; returns how many were compared."""
    n = 0
    for g, w, row in zip(got, want, rows):
        if _margin(row) < MARGIN_BOUND:
            break
        assert g == w
        n += 1
    return n


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_port_chunked_and_spec_streams_match_plain(port_variants, kv):
    """In the port itself: chunked admission and speculative decoding emit
    plain decode's tokens, up to the first near-tie of the plain run."""
    scs = {s["name"]: s for s in _scenarios()}
    for plain, other in (("plain_mix", "chunk_mix"),
                         ("spec_plain", "spec_k2")):
        sc = dict(scs[other], kv=kv,
                  events=[e for e in scs[other]["events"] if e[1] != "swap"])
        _, base, rec = _serve(port_variants, dict(scs[plain], kv=kv))
        _, reqs, _ = _serve(port_variants, sc)
        compared = sum(_tokens_by_margin(r.output, b.output,
                                         rec.rows[b.rid])
                       for r, b in zip(reqs, base))
        assert compared > 0, (plain, other)


def test_k0_steps_like_plain(port_variants):
    """k = 0: no spec_verify row, and step for step the plain engine's log
    and tokens."""
    sc = {s["name"]: s for s in _scenarios()}["spec_plain"]
    plain, reqs_p, rec_p = _serve(port_variants, sc)
    spec, reqs_s, rec_s = _serve(port_variants, sc, spec_override=0)
    assert spec.scheduler.spec_steps == 0
    assert rec_s.log() == rec_p.log()
    assert [r.output for r in reqs_s] == [r.output for r in reqs_p]


# ---------------------------------------------------------------------------
# port-only: stand-downs, leases, refcounts, errors, configuration
# ---------------------------------------------------------------------------


def _engine(variants, *, spec=None, draft=True, num_blocks=None, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", 128)
    kw.setdefault("clock", VirtualClock())
    eng = ServingEngine(CFG, variants["q8"], RuntimeConfig(),
                        kv_layout="paged", num_blocks=num_blocks,
                        spec_decode=spec, device="cpu", **kw)
    eng.variant_name = "q8"
    if spec is not None and draft:
        eng.set_draft_params(variants["q4"], "q4")
    return eng


def _prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 512, size=ln)]
            for ln in rng.integers(5, 40, size=n)]


def _drain(eng, prompts, **req_kw):
    reqs = [Request(rid=eng.next_rid(), prompt=list(p), max_new_tokens=10,
                    eos_id=-1, **req_kw) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return reqs


@pytest.mark.parametrize("case", ["no_draft", "nongreedy", "draft_resident"])
def test_spec_stands_down(port_variants, case):
    spec = SpecDecodeConfig("q4", k=2)
    eng = _engine(port_variants, spec=spec, draft=case != "no_draft")
    if case == "draft_resident":
        eng.swap_params(port_variants["q4"], "q4")
    reqs = _drain(eng, _prompts(2, 3),
                  temperature=0.8 if case == "nongreedy" else 0.0)
    assert eng.scheduler.spec_steps == 0
    assert all(len(r.output) == 10 for r in reqs)
    if case == "draft_resident":
        eng.swap_params(port_variants["q8"], "q8")
        reqs += _drain(eng, _prompts(3, 3))
        assert eng.scheduler.spec_steps > 0
    assert check_invariants(eng, reqs) == []


def _admit_one(eng, prompt):
    req = Request(rid=eng.next_rid(), prompt=list(prompt), max_new_tokens=30,
                  eos_id=-1)
    eng.submit(req)
    eng.step()
    return req, eng.slots.index(req)


@pytest.mark.parametrize("how", ["cancel", "expiry", "swap"])
def test_mid_draft_abandon_releases_leases(port_variants, how):
    eng = _engine(port_variants, spec=SpecDecodeConfig("q4", k=3))
    req, slot = _admit_one(eng, _prompts(6, 1)[0])
    free0 = eng.block_pool.num_free
    L = int(eng.lengths[slot])
    leases = eng._spec_acquire_leases(slot, L, 3)
    assert leases and eng.block_pool.num_free == free0 - len(leases)
    if how == "cancel":
        assert eng.cancel(req)
    elif how == "expiry":
        eng._free_slot(slot)             # the expiry / preemption path
        req.status = "cancelled"
        eng.scheduler.note_cancelled(req)
    else:
        eng.swap_params(port_variants["q4"], "q4")
        assert eng.block_pool.num_free == free0
        eng.cancel(req)
    assert eng._spec_leases[slot] == []
    eng.prefix_cache.clear()
    assert eng.block_pool.num_free == eng.block_pool.num_blocks - 1
    assert (eng.block_pool.refcount == 0).all()


LONG = [int(t) for t in np.random.default_rng(23).integers(2, 512, size=90)]


def test_cancel_mid_chunk_reconciles_refcounts(port_variants):
    eng = _engine(port_variants, max_batch=2, prefill_chunk=16)
    req = Request(rid=0, prompt=LONG[:60], max_new_tokens=4, eos_id=-1)
    eng.submit(req)
    eng.step()                       # cold window [0, 16)
    eng.step()                       # window [16, 32)
    assert req.status == "waiting" and req.chunk_done == 32
    b0, b1 = req.chunk_blocks
    # the request's ref + entry refs: row[:16] holds b0, row[:32] both
    assert eng.block_pool.refcount[b0] == 3
    assert eng.block_pool.refcount[b1] == 2
    assert eng.cancel(req)
    assert req.chunk_row is None and req.chunk_blocks == []
    assert eng.scheduler.stats()["chunk_drops"] == 1
    assert eng.block_pool.refcount[b0] == 2
    assert eng.block_pool.refcount[b1] == 1
    while eng.prefix_cache.evict_lru():
        pass
    assert eng.block_pool.num_free == eng.block_pool.num_blocks - 1


def test_expiry_mid_chunk_releases_chain(port_variants):
    clock = VirtualClock()
    eng = _engine(port_variants, max_batch=2, prefill_chunk=16, clock=clock,
                  step_cost_fn=lambda kind, tok, act: 1.0)
    req = Request(rid=0, prompt=LONG[:60], max_new_tokens=4, eos_id=-1,
                  deadline=1.5)
    eng.submit(req)
    eng.step()
    assert req.chunk_done == 16 and req.status == "waiting"
    eng.step()
    assert eng.step() == [] and req.status == "expired"
    assert req.chunk_row is None and req.chunk_blocks == []
    assert not eng.has_work()
    assert eng.scheduler.stats()["chunk_drops"] == 1
    while eng.prefix_cache.evict_lru():
        pass
    assert eng.block_pool.num_free == eng.block_pool.num_blocks - 1


@pytest.mark.parametrize("chunk,free_at_raise", [(None, 2), (16, 1)])
def test_pool_exhausted_error_is_typed(port_variants, chunk, free_at_raise):
    """Unchunked, the first step cannot admit; chunked, the first window
    lands in the 2 free blocks and the next one starves."""
    eng = _engine(port_variants, max_batch=2, num_blocks=3,
                  prefill_chunk=chunk)
    eng.submit(Request(rid=0, prompt=LONG[:60], max_new_tokens=4, eos_id=-1))
    with pytest.raises(PoolExhaustedError) as ei:
        eng.run_until_drained()
    assert isinstance(ei.value, EngineStallError)
    assert ei.value.waiting == 1 and ei.value.free_blocks == free_at_raise
    assert "waiting=1" in str(ei.value)


def test_configuration_checks(port_variants):
    v = port_variants
    with pytest.raises(ValueError, match="must be positive"):
        _engine(v, prefill_chunk=0)
    with pytest.raises(ValueError, match="must be positive"):
        ServingEngine(CFG, None, RuntimeConfig(), kv_layout="dense",
                      prefill_chunk=-16, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill contract"):
        ServingEngine(reduce_config(get_arch("mamba2-370m")), None,
                      RuntimeConfig(), prefill_chunk=16, device="cpu")
    # the transformer's dense layout takes chunked prefill, its window
    # unrounded (tests/test_chunked.py's dense case)
    eng = ServingEngine(CFG, None, RuntimeConfig(), kv_layout="dense",
                        prefill_chunk=10, device="cpu")
    assert eng.kv_layout == "dense" and eng.prefill_chunk == 10
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(CFG, None, RuntimeConfig(), kv_layout="dense",
                      spec_decode=SpecDecodeConfig(), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(reduce_config(get_arch("mamba2-370m")), None,
                      RuntimeConfig(), spec_decode=SpecDecodeConfig(),
                      device="cpu")
    for bad in (SpecDecodeConfig(k=-1), SpecDecodeConfig(k_ladder=(1, -2))):
        with pytest.raises(ValueError, match=">= 0"):
            _engine(v, spec=bad)
    with pytest.raises(ValueError, match="without spec_decode"):
        _engine(v).set_draft_params(v["q4"], "q4")
    with pytest.raises(ValueError, match=">= 0"):
        _engine(v, spec=SpecDecodeConfig()).set_draft_k(-1)
    with pytest.raises(ValueError, match="not in variants"):
        PC.EngineExecutor(PC.PAPER_MODELS["qwen2-7b"], ORIN_AGX,
                          config=EngineConfig(
                              spec_decode=SpecDecodeConfig("q2")),
                          device="cpu")


def test_paged_chunk_rounds_to_block_multiple(port_variants):
    assert _engine(port_variants, prefill_chunk=10).prefill_chunk == 16
    assert _engine(port_variants, prefill_chunk=33,
                   block_size=32).prefill_chunk == 64
    assert _engine(port_variants, prefill_chunk=48).prefill_chunk == 48


def test_stats_counters_and_merge(port_variants):
    eng = _engine(port_variants, spec=SpecDecodeConfig("q4", k=2),
                  prefill_chunk=16)
    reqs = _drain(eng, _prompts(9, 4) + [LONG[:90]])
    st = eng.stats()
    assert st.spec_steps == eng.scheduler.spec_steps > 0
    assert st.chunk_steps == eng.scheduler.chunk_steps > 0
    assert st.draft_tokens == eng.draft_tokens > 0
    assert st.accepted_tokens == eng.accepted_tokens
    assert st.accept_rate == pytest.approx(
        eng.accepted_tokens / max(eng.draft_tokens, 1))
    back = EngineStats.from_wire(st.to_wire())
    assert back == st
    merged = EngineStats.merge([st, st])
    assert merged.draft_tokens == 2 * st.draft_tokens
    assert merged.accepted_tokens == 2 * st.accepted_tokens
    assert merged.chunk_steps == 2 * st.chunk_steps
    assert merged.spec_steps == 2 * st.spec_steps
    assert merged.accept_rate == pytest.approx(st.accept_rate)
    assert check_invariants(eng, reqs) == []


# ---------------------------------------------------------------------------
# the engine-backed week with a chunked, speculative executor
# ---------------------------------------------------------------------------


def _rel_close(a, b):
    return abs(a - b) <= ENGINE_REL_TOL * max(abs(a), abs(b), 1e-30)


def test_run_week_spec_chunk_matches_reference(reference):
    """The week, teacher-forced onto the reference's decisions (the tokens
    and every draft and verify argmax): both runs follow one history, so
    the step log, the records, the swap count and the stats are equal, and
    seconds, joules and carbon agree within ENGINE_REL_TOL (the same
    arithmetic on the same step log)."""
    data, _, ref_logits, enc_arrays = reference
    want = data["results"]["week"]
    enc = {}
    for name, dtype in data["emeta"].items():
        *head, last = name.split("/")
        node = enc
        for h in head:
            node = node.setdefault(h, {})
        node[last] = (enc_arrays[name], dtype) if dtype == "bfloat16" \
            else enc_arrays[name]
    sel = PC.ToolSelector(PW.build_catalog(240, seed=0),
                          encoder_params=params_from_numpy(enc, "cpu"),
                          device="cpu")
    rt = PC.CarbonCallRuntime(
        selector=sel, executor=PC.SimExecutor(PC.PAPER_MODELS["qwen2-7b"],
                                              ORIN_AGX, seed=0),
        policy=PC.POLICIES["carboncall"], modes=PC.ORIN_MODES,
        catalog_size=240, seed=0)
    rt.use_backend("engine", device="cpu", config=EngineConfig(
        max_batch=4, prefill_chunk=WEEK_CHUNK,
        spec_decode=SpecDecodeConfig("q4", k=2, k_ladder=WEEK_LADDER)))
    ex = rt.executor
    n_calls = sum(1 for k in ref_logits if k.startswith("week/call/"))
    rec = _Recorder(ex.engine,
                    force={int(r): t for r, t in want["output"].items()},
                    calls=[ref_logits[f"week/call/{n}/argmax"]
                           for n in range(n_calls)])
    ks, set_k = [], ex.engine.set_draft_k
    ex.engine.set_draft_k = lambda k: (ks.append(k), set_k(k))[1]
    requests, submit = [], ex.engine.submit
    ex.engine.submit = lambda req: (requests.append(req), submit(req))[1]
    week = _week_spec()
    res = PC.run_week(rt, PW.FunctionCallWorkload(sel.catalog, seed=3),
                      np.array(week["ci"]), queries_per_hour=WEEK_QPH,
                      seed=0, backend="engine")
    got = [r.__dict__ for r in res.records]
    assert want["invariants"] == []
    # the week reaches both features and more than one draft length
    assert ks == want["draft_ks"] and len(set(ks)) >= 2
    assert want["stats"]["spec_steps"] > 0 and want["stats"]["chunk_steps"] > 0
    assert rec.log() == want["log"]
    assert len(rec.calls) == n_calls
    assert all(_rel_close(s["dt"], w)
               for s, w in zip(ex.engine.step_log, want["dt"]))
    assert len(got) == len(want["records"]) > 5
    for g, w in zip(got, want["records"]):
        for key in ("t", "variant", "mode_idx", "n_tools", "succeeded",
                    "tier"):
            assert g[key] == w[key], (key, g, w)
        for key in ("latency_s", "energy_j", "carbon_g", "tps"):
            assert _rel_close(g[key], w[key]), (key, g, w)
    assert ex.swap_count == want["swap_count"]
    assert ex.engine.stats().to_wire() == want["stats"]
    assert ex.engine.kernel_fallbacks > 0
    assert check_invariants(ex.engine, requests) == []
    print(f"week: {len(got)} records, draft ks {sorted(set(ks))}, "
          f"{want['stats']['spec_steps']} spec and "
          f"{want['stats']['chunk_steps']} chunk steps")
