"""Framework-free serving modules of the port against the JAX package's:
scheduler dequeue order, the block pool and prefix cache under one random
operation stream, the invariant sweep on the same corrupted states, and the
protocol codecs across packages (encode in one, decode in the other).
No engine is built here."""
import types

import numpy as np
import pytest

from repro.serving import block_pool as ref_bp
from repro.serving import engine as ref_engine
from repro.serving import invariants as ref_inv
from repro.serving import protocol as ref_proto
from repro.serving import scheduler as ref_sched

from repro_torch.serving import block_pool as bp
from repro_torch.serving import engine as engine
from repro_torch.serving import invariants as inv
from repro_torch.serving import protocol as proto
from repro_torch.serving import scheduler as sched

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
