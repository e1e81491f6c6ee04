"""Framework-free serving modules of the port against the JAX package's:
scheduler dequeue order, the block pool and prefix cache under one random
operation stream, the invariant sweep on the same corrupted states, and the
protocol codecs across packages (encode in one, decode in the other).

Then the port's worker processes (`repro_torch.launch.workers`, spawned on
the CPU) through tests/test_workers.py's cases, against an in-process port
twin token for token; the wire between a spawned worker of each package and
the other package's codecs; and the serve launcher against the reference
launcher, each in a subprocess. No reference engine is built in this
process (the reference worker and launcher build theirs in their own)."""
import dataclasses
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.serving import block_pool as ref_bp
from repro.serving import engine as ref_engine
from repro.serving import invariants as ref_inv
from repro.serving import protocol as ref_proto
from repro.config import ModelConfig as RefModelConfig
from repro.serving import scheduler as ref_sched

from repro_torch.serving import block_pool as bp
from repro_torch.serving import engine as engine
from repro_torch.serving import invariants as inv
from repro_torch.serving import protocol as proto
from repro_torch.serving import scheduler as sched
from repro_torch.config import ModelConfig, MoEConfig, RuntimeConfig
from repro_torch.launch import workers
from repro_torch.models import get_model
from repro_torch.quant.qtensor import init_quantized

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = [(ref_bp, ref_engine, ref_inv, ref_proto, ref_sched),
        (bp, engine, inv, proto, sched)]


def _scheduler_trace(engine_mod, sched_mod, seed):
    rng = np.random.default_rng(seed)
    s = sched_mod.Scheduler()
    reqs, trace = [], []
    now = 0.0
    for i in range(40):
        op = rng.integers(0, 5)
        now += float(rng.integers(0, 3))
        if op <= 1 or not s.has_waiting():
            dl = None if rng.random() < 0.5 else now + float(rng.integers(1, 9))
            r = engine_mod.Request(rid=i, prompt=[1], priority=int(rng.integers(0, 3)),
                                   deadline=dl, tier=str(rng.choice(["a", "b"])))
            s.enqueue(r, now)
            reqs.append(r)
        elif op == 2:
            head = s.head()
            s.note_admitted(head, now)
            if rng.random() < 0.5:
                s.note_preempted(head)
                s.requeue(head, now)
            else:
                s.note_done(head, now)
        elif op == 3:
            s.remove(s.waiting[int(rng.integers(0, len(s.waiting)))])
        else:
            s.expire_due(now)
        trace.append([r.rid for r in s.waiting])
    active = [(i, r) for i, r in enumerate(reqs[:6])]
    for i, r in active:
        r.admit_seq = int(rng.integers(0, 100))
    trace.append([sched_mod.Scheduler.pick_victim(active),
                  sched_mod.Scheduler.pick_victim(active, below=2)])
    return trace, s.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_same_order(seed):
    ref_trace, ref_stats = _scheduler_trace(ref_engine, ref_sched, seed)
    got_trace, got_stats = _scheduler_trace(engine, sched, seed)
    assert got_trace == ref_trace
    assert got_stats == ref_stats


def _pool_trace(bp_mod, seed):
    rng = np.random.default_rng(seed)
    pool = bp_mod.BlockPool(24, 4)
    cache = bp_mod.PrefixCache(pool)
    held, trace = [], []
    rows = [[int(t) for t in rng.integers(0, 5, size=n)] for n in (8, 10, 12)]
    for _ in range(120):
        op = rng.integers(0, 5)
        if op == 0:
            b = pool.alloc()
            if b is not None:
                held.append(b)
        elif op == 1 and held:
            pool.decref(held.pop(int(rng.integers(0, len(held)))))
        elif op == 2 and len(held) >= 3:
            row = rows[int(rng.integers(0, 3))]
            chain = held[:-(-len(row) // 4)]
            if len(chain) == -(-len(row) // 4):
                cache.insert(row, chain, salt=str(rng.integers(0, 2)))
        elif op == 3:
            e = cache.lookup(rows[int(rng.integers(0, 3))],
                             salt=str(rng.integers(0, 2)))
            trace.append(None if e is None else (e.cached_len, list(e.blocks)))
        else:
            trace.append(cache.evict_lru())
        trace.append((pool.num_free, pool.refcount.tolist(),
                      sorted(cache.entries)))
    return trace


@pytest.mark.parametrize("seed", [3, 4])
def test_block_pool_and_prefix_cache_same_behaviour(seed):
    assert _pool_trace(bp, seed) == _pool_trace(ref_bp, seed)


def _drained_engine(pkg, corrupt):
    """A drained 2-request paged engine's observable state, duck-typed, with
    one invariant broken by `corrupt`."""
    bp_mod, engine_mod, _, _, sched_mod = pkg
    s = sched_mod.Scheduler()
    reqs = [engine_mod.Request(rid=i, prompt=[1, 2], tier="t") for i in (0, 1)]
    for r in reqs:
        s.enqueue(r, 0.0)
    for r in reqs:
        s.note_admitted(r, 0.0)
        r.output = [5, 6, 7]
        r.status = sched_mod.DONE
        s.note_done(r, 1.0)
    pool = bp_mod.BlockPool(6, 4)
    cache = bp_mod.PrefixCache(pool)
    b = pool.alloc()
    cache.insert([1, 2, 3, 4], [b])
    pool.decref(b)
    log = [{"kind": "prefill", "tokens": 2, "rids": [0, 1]},
           {"kind": "decode", "tokens": 2, "rids": [0, 1]},
           {"kind": "decode", "tokens": 2, "rids": [0, 1]}]
    eng = types.SimpleNamespace(
        step_log=log, tokens_emitted=6, kv_layout="paged", block_pool=pool,
        prefix_cache=cache,
        scheduler_stats=lambda: {**s.stats(), "peak_active": 2})
    corrupt(eng, reqs, pool, s)
    return eng, reqs


CORRUPTIONS = {
    "clean": lambda e, r, p, s: None,
    "tokens": lambda e, r, p, s: setattr(e, "tokens_emitted", 7),
    "refcount_leak": lambda e, r, p, s: p.incref(1),
    "output": lambda e, r, p, s: r[0].output.append(9),
    "status": lambda e, r, p, s: setattr(r[1], "status", "running"),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_invariant_sweep_same_violations(name):
    out = []
    for pkg in PKGS:
        eng, reqs = _drained_engine(pkg, CORRUPTIONS[name])
        out.append(pkg[2].check_invariants(eng, reqs))
    assert out[0] == out[1]
    assert (out[1] == []) == (name == "clean")


def _payloads(p):
    return [
        p.EngineConfig(max_batch=3, prompt_buckets=(16, 64),
                       kv_cache_dtype="int8", num_blocks=40,
                       spec_decode=p.SpecDecodeConfig(k=3, k_ladder=(1, 2))),
        p.EngineStats(admitted=4, kernel_fallbacks=2, tiers={"a": {"done": 1}},
                      prefix_cache={"hits": 3}),
        p.QuerySpec(n_tools=3, variant="q4", deadline_s=2.5),
        p.RequestResult(rid=7, status="done", output=(1, 2, 3)),
        p.WorkerSpec(seed=5, label="w"),
    ]


def test_protocol_codecs_cross_packages():
    assert (ref_proto.PROTOCOL_VERSION, ref_proto.STATS_SCHEMA_VERSION) == \
        (proto.PROTOCOL_VERSION, proto.STATS_SCHEMA_VERSION)
    for a, b in zip(_payloads(ref_proto), _payloads(proto)):
        assert type(b).from_wire(a.to_wire()).to_wire() == a.to_wire()
        assert type(a).from_wire(b.to_wire()).to_wire() == b.to_wire()
    sreq = ref_sched.SessionRequest(prompt=[4, 5], priority=2, deadline_s=1.0)
    back = proto.session_request_from_wire(ref_proto.session_request_to_wire(sreq))
    assert ref_proto.session_request_to_wire(sreq) == \
        proto.session_request_to_wire(back)
    with pytest.raises(proto.ProtocolError):
        proto.EngineConfig.from_wire({"v": proto.PROTOCOL_VERSION + 1})


# ---------------------------------------------------------------------------
# the port's worker processes (tests/test_workers.py's cases), the wire
# across packages, and the serve launcher
# ---------------------------------------------------------------------------

W_CFG = ModelConfig(name="worker-tiny", family="transformer", num_layers=2,
                    d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                    vocab_size=256)
W_ECFG = proto.EngineConfig(max_batch=3, max_seq=64, kv_layout="paged",
                            block_size=8, num_blocks=16)
W_SPEC = proto.WorkerSpec(config=W_ECFG, seed=0,
                          model_cfg=dataclasses.asdict(W_CFG),
                          label="test-raw")
# block-aligned shared prefix + distinct tails: exercises the prefix cache
# and still makes every stream unique
W_PROMPTS = [[3] * 16 + [10 + i, 20 + i, 30 + i] for i in range(6)]


@pytest.fixture(scope="module")
def port_worker():
    ws = workers.launch_workers([W_SPEC], device="cpu")
    yield ws[0]
    workers.shutdown_workers(ws)


@pytest.fixture(scope="module")
def port_local():
    """In-process twin built from the SAME spec payload the worker got."""
    pspec = get_model(W_CFG).param_spec()
    variants = init_quantized(pspec, W_ECFG.variants,
                              torch.Generator().manual_seed(W_SPEC.seed),
                              "cpu")
    eng = engine.ServingEngine(W_CFG, variants[W_ECFG.variants[0]],
                               RuntimeConfig(), config=W_ECFG,
                               clock=engine.VirtualClock(), device="cpu")
    eng.variant_name = W_ECFG.variants[0]
    return eng


def _sreq(prompt, **kw):
    kw.setdefault("max_new_tokens", 5)
    kw.setdefault("eos_id", -1)
    return sched.SessionRequest(prompt=list(prompt), temperature=0.0, **kw)


def test_port_worker_submit_settle_matches_local(port_worker, port_local):
    """Token-for-token parity across the process boundary: a spawned port
    worker and an in-process port engine from the same spec."""
    reqs = [_sreq(p) for p in W_PROMPTS[:3]]
    results = port_worker.settle([port_worker.submit(r) for r in reqs])
    assert set(port_worker.ready_s) == {"spawn", "device", "build"}

    client = port_local.client()
    handles = [client.submit(r) for r in reqs]
    client.settle(handles)
    for rr, h in zip(results, handles):
        assert rr.status == "done" == h.poll()
        assert list(rr.output) == list(h.request.output)
        assert len(rr.output) == 5
        assert rr.queue_wait_s == pytest.approx(h.request.queue_wait_s)


def test_port_worker_poll_and_cancel(port_worker):
    rid = port_worker.submit(_sreq(W_PROMPTS[3], max_new_tokens=12))
    assert port_worker.call("poll", rid=rid)["status"] == "waiting"
    assert port_worker.call("cancel", rid=rid)["cancelled"] is True
    assert port_worker.call("poll", rid=rid)["status"] == "cancelled"
    port_worker.call("drain")            # cancelled stream leaves no work


def test_port_worker_error_reply_keeps_worker_alive(port_worker):
    """Protocol errors come back as replies; the process survives."""
    with pytest.raises(proto.ProtocolError, match="unknown op"):
        port_worker.call("frobnicate")
    with pytest.raises(proto.ProtocolError, match="unknown variant"):
        port_worker.call("swap", variant="fp64")
    with pytest.raises(proto.ProtocolError,
                       match="query ops need an executor"):
        port_worker.call("query", query={"v": 1})
    assert port_worker.call("clock")["t"] >= 0.0     # still serving


def test_port_worker_swap_and_clock_ops(port_worker):
    t0 = port_worker.call("clock")["t"]
    assert port_worker.call("advance", dt=2.5)["t"] == pytest.approx(t0 + 2.5)
    # rebase anchors forward only: never rewinds the worker's timeline
    t1 = port_worker.call("rebase", t=t0 + 10.0)["t"]
    assert t1 == pytest.approx(t0 + 10.0)
    assert port_worker.call("rebase", t=0.0)["t"] == pytest.approx(t1)
    out = port_worker.call("swap", variant="q4")
    assert out["variant"] == "q4" and out["swap_count"] >= 1
    port_worker.call("swap", variant="q8")   # back to boot weights


def test_port_worker_stats_schema_over_the_wire(port_worker):
    st = port_worker.stats()
    assert isinstance(st, proto.EngineStats)
    assert st.admitted >= 3              # the streams settled above
    assert st.cancelled >= 1             # (a waiting cancel never admits)
    assert st.tokens_emitted > 0
    assert st.swap_count >= 2
    assert st.prefix_cache.get("entries", 0) >= 1   # shared prefix cached
    assert "interactive" in st.tiers or "default" in st.tiers
    launches = port_worker.call("launches")["launches"]
    assert set(launches) == {"q8_matmul", "q4_matmul", "paged_attention",
                             "flash_attention", "sim_scores", "ssd_bshp"}
    assert not any(launches.values())    # plain versions on the CPU


@pytest.mark.parametrize("spec,match", [
    (proto.WorkerSpec(config=proto.EngineConfig(), hw="pdp11",
                      label="bad-hw"), "unknown hardware 'pdp11'"),
    (proto.WorkerSpec(config=proto.EngineConfig(), hw="tpu_v5e",
                      label="tpu"), "Queue 1 item 9"),
    (proto.WorkerSpec(config=proto.EngineConfig(), label="whisper",
                      model_cfg={**dataclasses.asdict(W_CFG),
                                 "encoder_layers": 2}),
     "fields the port does not serve: \\['encoder_layers'\\]"),
], ids=["unknown-hw", "tpu", "unported-field"])
def test_port_worker_build_failure_ships_error(spec, match):
    """A worker that cannot build ships the error in its ready reply, and
    `launch_workers` raises naming it: an unknown board, the TPU (not
    ported, ROADMAP item 9), a model config field the port lacks (whisper's
    encoder, ROADMAP Queue 1 item 7c)."""
    with pytest.raises(proto.ProtocolError, match="failed to build") as ei:
        workers.launch_workers([spec], timeout=120.0, device="cpu")
    assert re.search(match, str(ei.value)), str(ei.value)


def test_port_worker_builds_a_moe_model_config():
    """A raw worker's `model_cfg` carrying a `moe` dict (its wire form,
    `dataclasses.asdict`) builds the MoE model: the dict becomes a
    `MoEConfig`, the tree holds stacked experts, and requests settle."""
    cfg = dataclasses.replace(W_CFG, family="moe", moe=MoEConfig(
        num_experts=4, experts_per_token=2, d_ff=96, capacity_factor=1.25))
    spec = dataclasses.replace(W_SPEC, model_cfg=dataclasses.asdict(cfg),
                               label="test-moe")
    assert isinstance(spec.model_cfg["moe"], dict)
    actor = workers.EngineActor(spec, device="cpu")
    assert actor.engine.cfg == cfg and actor.engine.kv_layout == "paged"
    assert actor.engine.params["layers"]["moe"]["wg"].shape == (2, 4, 64, 96)
    rids = [actor.handle("submit", {"request": {
        "v": 1, "prompt": p, "max_new_tokens": 4, "eos_id": -1}})["rid"]
        for p in W_PROMPTS[:3]]
    out = actor.handle("settle", {"rids": rids})
    assert [r["status"] for r in out["results"]] == ["done"] * 3
    assert all(len(r["output"]) == 4 for r in out["results"])
    assert actor.handle("check", {"flush": False})["violations"] == []


def test_port_worker_actor_in_process_round_trip():
    """The worker-side dispatcher is drivable without a process: same ops,
    same wire payloads."""
    actor = workers.EngineActor(W_SPEC, device="cpu")
    rid = actor.handle("submit", {"request":
                                  {"v": 1, "prompt": W_PROMPTS[0],
                                   "max_new_tokens": 4, "eos_id": -1}})["rid"]
    out = actor.handle("settle", {"rids": [rid]})
    assert out["results"][0]["status"] == "done"
    assert len(out["results"][0]["output"]) == 4
    assert actor.handle("check", {"flush": False})["violations"] == []


def test_worker_wire_crosses_packages(port_worker):
    """Replies of a spawned port worker decode with the JAX package's
    protocol, and replies of a spawned reference worker (its engine in its
    own process) decode with the port's; each takes a request the other
    package encoded. Versions and wire keys are equal; tokens are not
    compared across packages (their weights come from different
    generators)."""
    from repro.launch import workers as ref_workers

    assert (ref_proto.PROTOCOL_VERSION, ref_proto.STATS_SCHEMA_VERSION) == \
        (proto.PROTOCOL_VERSION, proto.STATS_SCHEMA_VERSION)
    ref_spec = ref_proto.WorkerSpec.from_wire(W_SPEC.to_wire())
    ref_spec = ref_proto.WorkerSpec(
        config=ref_spec.config, seed=0, label="ref-raw",
        model_cfg=dataclasses.asdict(RefModelConfig(**{
            k: v for k, v in W_SPEC.model_cfg.items() if k != "ssm"})))
    ref_w = ref_workers.launch_workers([ref_spec])[0]
    try:
        wires = {}
        for who, w, encode in (
                ("port", port_worker, ref_proto.session_request_to_wire),
                ("ref", ref_w, proto.session_request_to_wire)):
            sreq = (ref_sched if who == "port" else sched).SessionRequest(
                prompt=W_PROMPTS[5], max_new_tokens=3, eos_id=-1,
                temperature=0.0)
            rid = w.call("submit", request=encode(sreq))["rid"]
            settled = w.call("settle", rids=[rid])
            wires[who] = (settled["results"][0], w.call("stats")["stats"])
    finally:
        ref_w.close()
    decode = {"port": ref_proto, "ref": proto}
    for who, (result, stats) in wires.items():
        p = decode[who]
        rr = p.RequestResult.from_wire(result)
        st = p.EngineStats.from_wire(stats)
        assert rr.status == "done" and len(rr.output) == 3
        assert rr.to_wire() == result
        assert st.to_wire() == stats and st.admitted >= 1
        assert stats["schema_version"] == proto.STATS_SCHEMA_VERSION
    assert wires["port"][0].keys() == wires["ref"][0].keys()
    assert wires["port"][1].keys() == wires["ref"][1].keys()


def test_port_worker_executor_mode_query_surface():
    """The CarbonCall query path over the wire on an executor-mode port
    worker (the reduced carboncall-qwen2-7b): energy and carbon attribution
    cross the boundary inside the execution record."""
    spec = proto.WorkerSpec(config=proto.EngineConfig(max_batch=2,
                                                      max_seq=128),
                            label="test-exec")
    ws = workers.launch_workers([spec], device="cpu")
    try:
        w = ws[0]
        qids = [w.query(proto.QuerySpec(n_tools=2, n_calls=1,
                                        tier="interactive")),
                w.query(proto.QuerySpec(n_tools=3, n_calls=2, variant="q4",
                                        tier="batch"))]
        rep = w.call("settle_queries", qids=qids)
        assert len(rep["executions"]) == 2
        for ex in rep["executions"]:
            assert ex["energy_j"] > 0.0
            assert ex["decode_tokens"] > 0
        st = proto.EngineStats.from_wire(rep["stats"])
        assert st.admitted >= 2
    finally:
        workers.shutdown_workers(ws)
    assert not ws[0].proc.is_alive()


def test_port_worker_check_invariants_clean(port_worker):
    """All streams terminal -> the worker's own invariant sweep is clean.
    Runs last of the worker's tests: `flush=True` clears the prefix cache
    as part of the refcount reconciliation."""
    port_worker.call("drain")
    assert port_worker.call("check", flush=True)["violations"] == []


SERVE_FLAGS = ["--queries", "3", "--minutes-per-query", "10",
               "--max-new-tokens", "4"]


def test_port_worker_fleet_attaches_executor_workers():
    """`launch_worker_fleet` over a built one-pod fleet on the CPU with a
    model config (a port-only spawn argument): the executor-mode worker
    builds its engine at that config (its tokens equal an in-process
    `EngineActor` given the pod's spec, the config and the seed, and differ
    from one at the default reduced arch), it is attached as `pod.worker`
    while no in-process engine is built, and the fleet reads it: the pod
    counts as built, the router predicts its wait from the `EngineStats`
    the worker shipped, and `engine_stats` merges them."""
    from repro_torch.common.registry import get_arch
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.fleet import FleetSpec, RegionSpec, build_fleet

    cfg = dataclasses.replace(reduce_config(get_arch("carboncall-qwen2-7b")),
                              num_layers=1)
    fleet = build_fleet(FleetSpec(regions=(
        RegionSpec("clean", "week1", 0.5, (("edge", 1),)),)),
        seed=0, device="cpu", model_cfg=cfg)
    pod = fleet.pods[0]
    reqs = [_sreq(p, max_new_tokens=4) for p in W_PROMPTS[:2]]
    ws = workers.launch_worker_fleet(fleet, device="cpu", model_cfg=cfg)
    try:
        assert pod.worker is ws[0] and pod.client is None
        assert fleet.built_pods() == [pod]
        assert ws[0].spec.config == pod.engine_cfg
        got = [list(r.output) for r in ws[0].settle(
            [ws[0].submit(r) for r in reqs])]
        pod.last_stats = ws[0].stats()
    finally:
        workers.shutdown_workers(ws)
    assert not ws[0].proc.is_alive()

    def twin_tokens(model_cfg):
        actor = workers.EngineActor(ws[0].spec, device="cpu",
                                    model_cfg=model_cfg)
        rids = [actor.handle("submit", {"request":
                                        proto.session_request_to_wire(r)})
                ["rid"] for r in reqs]
        out = actor.handle("settle", {"rids": rids})["results"]
        return actor.engine.cfg, [list(r["output"]) for r in out]

    twin_cfg, want = twin_tokens(cfg)
    assert twin_cfg == cfg and got == want
    assert all(len(t) == 4 for t in got)
    assert twin_tokens(None)[1] != got
    st = pod.last_stats
    assert st.admitted == 2 and st.waiting == 0
    assert fleet.engine_stats().to_wire() == \
        proto.EngineStats.merge([st]).to_wire()
    router = fleet.router
    pod.inflight = pod.slot_capacity + 2
    assert router.predicted_wait_s(pod) == pytest.approx(
        pod.queue_s + 2 * router.service_s)


def _serve_lines(out):
    return [ln.strip() for ln in out.splitlines()
            if ln.startswith("[serve] total carbon") or ">> variant switch"
            in ln]


def test_serve_launcher_matches_reference():
    """`python -m repro_torch.launch.serve --device cpu` with and without
    `--workers 1`, each in a subprocess beside the reference launcher on
    the same flags (all three at once): the same `total carbon` line and
    the same variant switches (at least one), which read no tokens. The
    reference's carbon lines do not depend on its `--workers` (the same
    loop over the same governor and switcher), so it runs once."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmds = {"ref": ["-m", "repro.launch.serve", *SERVE_FLAGS],
            "port": ["-m", "repro_torch.launch.serve", "--device", "cpu",
                     *SERVE_FLAGS],
            "port-workers": ["-m", "repro_torch.launch.serve", "--device",
                             "cpu", "--workers", "1", *SERVE_FLAGS]}
    procs = {k: subprocess.Popen([sys.executable, *c], env=env, cwd=REPO,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    outs = {}
    for k, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"{k}:\n{out}\n{err}"
        outs[k] = out
    want = _serve_lines(outs["ref"])
    assert any("variant switch" in ln for ln in want)
    assert want[-1].startswith("[serve] total carbon")
    assert _serve_lines(outs["port"]) == want
    assert _serve_lines(outs["port-workers"]) == want
    assert "1 worker process(es) ready" in outs["port-workers"]
    assert "fleet stats" in outs["port-workers"]
