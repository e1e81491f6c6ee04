"""Frozen, serializable engine control protocol.

The port's copy of `repro.serving.protocol`: the same dataclasses, versions
and wire codecs, so payloads cross packages (encode in one, decode in the
other) and the CC003 schema snapshot covers both files.

This module is the wire contract between a fleet and its worker processes
(`launch/workers.py`): every payload that crosses a process boundary is a
plain dataclass with a ``to_wire()``/``from_wire()`` pair producing
JSON/pickle-safe dicts of primitives — no jax arrays, no callables, no live
engine references. Three schemas:

  * `EngineConfig` — the engine's construction surface, replacing
    `ServingEngine.__init__`'s sprawling kwargs. A worker is constructed
    from a pickled/JSON config; in-process callers pass the same object
    (`ServingEngine(cfg, params, rcfg, config=...)`) so fleet specs,
    benchmarks and tests share ONE sizing vocabulary instead of duplicating
    keyword soup.
  * `EngineStats` — the versioned telemetry schema unifying the ad-hoc
    `scheduler_stats()` / `prefix_cache_stats()` dicts: scheduler counters,
    per-tier percentiles, prefix-cache stats, chunk counters, `peak_active`,
    `swap_count` and whole-run decode TPS under one `schema_version`.
    `EngineStats.merge` aggregates per-worker stats into fleet totals.
  * request/result payloads — `SessionRequest` codecs, `QuerySpec` (an
    executor-level query over the wire), `RequestResult` (a terminal
    engine request), and `WorkerSpec` (everything a spawned worker needs
    to build its engine: arch or raw model config + an `EngineConfig`).

Versioning: `PROTOCOL_VERSION` stamps control messages and `WorkerSpec`;
`STATS_SCHEMA_VERSION` stamps telemetry. Decoders ignore unknown keys
(forward compatible) and reject payloads from a NEWER major version than
they understand (a stale reader must fail loudly, not mis-parse).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.serving.scheduler import SessionRequest

PROTOCOL_VERSION = 3        # control messages, WorkerSpec, request payloads
STATS_SCHEMA_VERSION = 3    # EngineStats telemetry schema


class ProtocolError(ValueError):
    """A wire payload could not be decoded under this protocol version."""


def _check_version(wire: Mapping, key: str, mine: int, what: str) -> None:
    v = wire.get(key, mine)
    if int(v) > mine:
        raise ProtocolError(
            f"{what}: payload version {v} is newer than supported {mine} — "
            "upgrade the reader")


def _fields_from_wire(cls, wire: Mapping) -> Dict[str, Any]:
    """Known-field filter: unknown keys are ignored (forward compatible),
    missing keys fall back to the dataclass defaults."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in wire.items() if k in names}


# ---------------------------------------------------------------------------
# EngineConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Speculative decoding over the quantized variant ladder.

    `draft_variant` names the cheap variant that drafts `k` tokens per
    decode step; the engine's resident variant verifies all k+1 candidate
    positions in one batched forward. At temperature 0 the accepted stream
    is byte-identical to plain decode under the verify variant — draft
    quality only moves the acceptance rate, never the tokens. `k=0`
    degrades to plain decode. `k_ladder`, when non-empty, lets the
    executor's governor map carbon intensity onto a draft length (mode
    index → ladder entry; high CI picks longer drafts), overriding `k`
    per query."""
    draft_variant: str = "q4"
    k: int = 2
    k_ladder: Tuple[int, ...] = ()

    def to_wire(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["k_ladder"] = list(self.k_ladder)
        d["v"] = PROTOCOL_VERSION
        return d

    @classmethod
    def from_wire(cls, wire: Mapping) -> "SpecDecodeConfig":
        _check_version(wire, "v", PROTOCOL_VERSION, "SpecDecodeConfig")
        kw = _fields_from_wire(cls, wire)
        if "k_ladder" in kw:
            kw["k_ladder"] = tuple(kw["k_ladder"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serializable engine sizing — the whole `ServingEngine` construction
    surface minus live objects (params, clock, mesh, step_cost_fn).

    `data_shards` is the mesh *spec*: builders (fleet `ensure_client`,
    worker processes) materialize it into a `data`-axis mesh via
    `launch.mesh.make_data_mesh`; the engine itself takes the built mesh.
    `variants` names the quantized weight sets an executor pre-builds for
    hot swaps; the first entry is the boot variant.

    `kv_cache_dtype` selects the KV-pool element type: "int8" stores k/v
    as int8 with fp32 per-(position, head) scale stripes, roughly halving
    pool bytes — with `num_blocks=None` the pool auto-sizes to the SAME
    byte budget as the bf16 default, so an int8 engine fits ~2x the
    cacheable blocks (more residents, more prefix-cache entries, more
    spec-decode lease headroom).

    `block_size` is the pool's tokens per block. On a card, the paged
    decode-attention kernel takes a multiple of 16 up to 128; a CUDA
    engine built with any other size raises ValueError at construction.
    """
    max_batch: int = 4
    max_seq: int = 256
    prompt_buckets: Tuple[int, ...] = (32, 64, 128)
    kv_layout: str = "auto"              # auto | paged | dense
    kv_cache_dtype: str = "bf16"         # bf16 | int8
    block_size: int = 16
    num_blocks: Optional[int] = None     # None = auto-size from max_batch
    prefill_chunk: Optional[int] = None  # None = monolithic prefill
    data_shards: int = 1                 # >1 = data-parallel sharded engine
    variants: Tuple[str, ...] = ("q8", "q4")
    spec_decode: Optional[SpecDecodeConfig] = None  # None = plain decode

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    def to_wire(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["prompt_buckets"] = list(self.prompt_buckets)
        d["variants"] = list(self.variants)
        if self.spec_decode is not None:
            d["spec_decode"] = self.spec_decode.to_wire()
        d["v"] = PROTOCOL_VERSION
        return d

    @classmethod
    def from_wire(cls, wire: Mapping) -> "EngineConfig":
        _check_version(wire, "v", PROTOCOL_VERSION, "EngineConfig")
        kw = _fields_from_wire(cls, wire)
        if "prompt_buckets" in kw:
            kw["prompt_buckets"] = tuple(kw["prompt_buckets"])
        if "variants" in kw:
            kw["variants"] = tuple(kw["variants"])
        if kw.get("spec_decode") is not None:
            kw["spec_decode"] = SpecDecodeConfig.from_wire(kw["spec_decode"])
        return cls(**kw)


# ---------------------------------------------------------------------------
# EngineStats
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Versioned engine telemetry: one schema for what used to be the
    `scheduler_stats()` + `prefix_cache_stats()` dict pair.

    `tiers` maps tier name -> the scheduler's per-tier counters and
    latency percentiles; `prefix_cache` is empty for dense-layout engines.
    `decode_tps` is the whole-run decode throughput on the engine's own
    (virtual) clock — per-worker timelines stay independent, the fleet
    aggregates wall-aligned snapshots.
    """
    schema_version: int = STATS_SCHEMA_VERSION
    admitted: int = 0
    preemptions: int = 0
    requeues: int = 0
    expired: int = 0
    cancelled: int = 0
    chunk_steps: int = 0
    chunk_drops: int = 0
    queue_wait_s: float = 0.0
    waiting: int = 0
    peak_active: int = 0
    swap_count: int = 0
    tokens_emitted: int = 0
    decode_tps: float = 0.0
    spec_steps: int = 0
    draft_tokens: int = 0
    accepted_tokens: int = 0
    accept_rate: float = 0.0
    # paged decode steps that ran the gather reference path instead of the
    # Pallas kernel (CPU / use_pallas=False) — CI artifacts carry it so a
    # benchmark can never silently measure the fallback
    kernel_fallbacks: int = 0
    tiers: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    prefix_cache: Dict[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_engine(cls, engine) -> "EngineStats":
        """Snapshot a live `ServingEngine` (duck-typed; no engine import)."""
        sched = engine.scheduler_stats()
        return cls(
            admitted=int(sched["admitted"]),
            preemptions=int(sched["preemptions"]),
            requeues=int(sched["requeues"]),
            expired=int(sched["expired"]),
            cancelled=int(sched["cancelled"]),
            chunk_steps=int(sched["chunk_steps"]),
            chunk_drops=int(sched["chunk_drops"]),
            queue_wait_s=float(sched["queue_wait_s"]),
            waiting=int(sched["waiting"]),
            peak_active=int(sched["peak_active"]),
            swap_count=int(engine.swap_count),
            tokens_emitted=int(engine.tokens_emitted),
            decode_tps=float(engine.recent_tps(
                window=max(len(engine.step_log), 1))),
            spec_steps=int(sched.get("spec_steps", 0)),
            draft_tokens=int(getattr(engine, "draft_tokens", 0)),
            accepted_tokens=int(getattr(engine, "accepted_tokens", 0)),
            accept_rate=(int(getattr(engine, "accepted_tokens", 0))
                         / max(int(getattr(engine, "draft_tokens", 0)), 1)),
            kernel_fallbacks=int(getattr(engine, "kernel_fallbacks", 0)),
            tiers=sched["tiers"],
            prefix_cache=dict(engine.prefix_cache_stats()))

    @classmethod
    def merge(cls, stats: List["EngineStats"]) -> "EngineStats":
        """Fleet aggregate: counters/tokens sum, `peak_active` and tier
        percentiles take the per-worker max (percentiles cannot be merged
        exactly from summaries — max is the conservative bound), and
        `decode_tps` sums (workers decode concurrently on independent
        timelines, so aggregate throughput is additive)."""
        out = cls()
        if not stats:
            return out
        tiers: Dict[str, Dict[str, float]] = {}
        cache: Dict[str, int] = {}
        for s in stats:
            for name, t in s.tiers.items():
                agg = tiers.setdefault(name, {})
                for k, v in t.items():
                    if k.startswith("p") and k.endswith("_latency_s"):
                        agg[k] = max(agg.get(k, 0.0), v)
                    else:
                        agg[k] = agg.get(k, 0) + v
            for k, v in s.prefix_cache.items():
                cache[k] = cache.get(k, 0) + v
        return cls(
            admitted=sum(s.admitted for s in stats),
            preemptions=sum(s.preemptions for s in stats),
            requeues=sum(s.requeues for s in stats),
            expired=sum(s.expired for s in stats),
            cancelled=sum(s.cancelled for s in stats),
            chunk_steps=sum(s.chunk_steps for s in stats),
            chunk_drops=sum(s.chunk_drops for s in stats),
            queue_wait_s=sum(s.queue_wait_s for s in stats),
            waiting=sum(s.waiting for s in stats),
            peak_active=max(s.peak_active for s in stats),
            swap_count=sum(s.swap_count for s in stats),
            tokens_emitted=sum(s.tokens_emitted for s in stats),
            decode_tps=sum(s.decode_tps for s in stats),
            spec_steps=sum(s.spec_steps for s in stats),
            draft_tokens=sum(s.draft_tokens for s in stats),
            accepted_tokens=sum(s.accepted_tokens for s in stats),
            accept_rate=(sum(s.accepted_tokens for s in stats)
                         / max(sum(s.draft_tokens for s in stats), 1)),
            kernel_fallbacks=sum(s.kernel_fallbacks for s in stats),
            tiers=tiers, prefix_cache=cache)

    def to_wire(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, wire: Mapping) -> "EngineStats":
        _check_version(wire, "schema_version", STATS_SCHEMA_VERSION,
                       "EngineStats")
        kw = _fields_from_wire(cls, wire)
        kw["schema_version"] = STATS_SCHEMA_VERSION
        if "tiers" in kw:
            kw["tiers"] = {k: dict(v) for k, v in kw["tiers"].items()}
        if "prefix_cache" in kw:
            kw["prefix_cache"] = dict(kw["prefix_cache"])
        return cls(**kw)


# ---------------------------------------------------------------------------
# Request / result payloads
# ---------------------------------------------------------------------------


def session_request_to_wire(sreq: SessionRequest) -> Dict[str, Any]:
    return {"v": PROTOCOL_VERSION,
            "prompt": [int(t) for t in sreq.prompt],
            "max_new_tokens": sreq.max_new_tokens,
            "eos_id": sreq.eos_id,
            "temperature": sreq.temperature,
            "priority": sreq.priority,
            "deadline_s": sreq.deadline_s,
            "tier": sreq.tier}


def session_request_from_wire(wire: Mapping) -> SessionRequest:
    _check_version(wire, "v", PROTOCOL_VERSION, "SessionRequest")
    kw = _fields_from_wire(SessionRequest, wire)
    kw["prompt"] = [int(t) for t in kw.get("prompt", [])]
    return SessionRequest(**kw)


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One executor-level query (the `begin_query` surface) over the wire.
    `mode_index` indexes the worker's hardware mode ladder (`modes_for(hw)`)
    — operating modes are per-device LUT rows, so the index is the portable
    representation."""
    n_tools: int = 2
    n_calls: int = 1
    selection_correct: bool = True
    variant: str = "q8"
    mode_index: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None
    tier: str = "default"

    def to_wire(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["v"] = PROTOCOL_VERSION
        return d

    @classmethod
    def from_wire(cls, wire: Mapping) -> "QuerySpec":
        _check_version(wire, "v", PROTOCOL_VERSION, "QuerySpec")
        return cls(**_fields_from_wire(cls, wire))


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """A terminal engine request, flattened for the wire: the fields a
    fleet needs for parity checks and latency accounting, without the
    engine-side bookkeeping (`Request` carries resume/chunk state that
    never leaves the worker)."""
    rid: int
    status: str
    output: Tuple[int, ...] = ()
    submit_time: float = 0.0
    done_time: Optional[float] = None
    first_token_time: Optional[float] = None
    queue_wait_s: float = 0.0
    tier: str = "default"

    @classmethod
    def from_request(cls, req) -> "RequestResult":
        return cls(rid=req.rid, status=req.status,
                   output=tuple(int(t) for t in req.output),
                   submit_time=req.submit_time, done_time=req.done_time,
                   first_token_time=req.first_token_time,
                   queue_wait_s=req.queue_wait_s, tier=req.tier)

    def to_wire(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["output"] = list(self.output)
        d["v"] = PROTOCOL_VERSION
        return d

    @classmethod
    def from_wire(cls, wire: Mapping) -> "RequestResult":
        _check_version(wire, "v", PROTOCOL_VERSION, "RequestResult")
        kw = _fields_from_wire(cls, wire)
        kw["output"] = tuple(int(t) for t in kw.get("output", ()))
        return cls(**kw)


# ---------------------------------------------------------------------------
# WorkerSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Everything a spawned worker process needs to build its engine.

    Two construction modes:
      * executor mode (default): the worker builds an `EngineExecutor` for
        `profile` (a PAPER_MODELS name) on `hw` (a named HardwareSpec) with
        the reduced `arch` — the full CarbonCall query surface (energy and
        carbon attribution) is available over the wire.
      * raw mode (`model_cfg` set): the worker builds a bare `ServingEngine`
        from the serialized `ModelConfig` dict — engine-level ops only, used
        by the multi-process soak suite to drive tiny deterministic engines.
    """
    config: EngineConfig = EngineConfig()
    arch: str = "carboncall-qwen2-7b"
    profile: str = "qwen2-7b"
    hw: str = "orin_agx"
    seed: int = 0
    tokens_per_call: int = 8
    eval_tokens: int = 4
    model_cfg: Optional[Dict[str, Any]] = None   # raw engine mode
    label: str = ""

    def to_wire(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["config"] = self.config.to_wire()
        d["v"] = PROTOCOL_VERSION
        return d

    @classmethod
    def from_wire(cls, wire: Mapping) -> "WorkerSpec":
        _check_version(wire, "v", PROTOCOL_VERSION, "WorkerSpec")
        kw = _fields_from_wire(cls, wire)
        kw["config"] = EngineConfig.from_wire(kw.get("config", {}))
        if kw.get("model_cfg") is not None:
            kw["model_cfg"] = dict(kw["model_cfg"])
        return cls(**kw)
