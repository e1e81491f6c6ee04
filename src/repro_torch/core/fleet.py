"""Fleet-scale CarbonCall: carbon-aware routing across pods, on the port.

The port of `repro.core.fleet`, with the same scoring, health gating,
deadline penalty and lazy pod engines. The paper runs one edge board; at
fleet scale the same control knobs exist per pod (mode governor, variant
switcher), plus a knob the edge device does not have: WHERE a query runs.
Each pod sits in a grid region with its own CI trace; the router scores pods
by
    score = ci_pod * marginal_energy(pod)
          + queue_weight * latency_weight(tier) * predicted_wait(pod)
and sends the query to the argmin, subject to a TPS SLO (drain pods whose
10-min average TPS is degraded — straggler mitigation at the fleet level).

Routing is **deadline-aware**: `predicted_wait` reads the pod's LIVE
scheduler depth when it runs a shared engine (waiting queue + this step's
in-flight submissions, net of free decode slots), and the tier's
`latency_weight` decides how much that wait matters against carbon. A pod
whose predicted wait already exceeds the tier's deadline budget is
effectively excluded (huge additive penalty) unless every pod would blow it.

With `backend="engine"` every pod runs ONE shared `ServingEngine` behind an
`EngineClient`: all queries routed to a pod within an arrival step are
submitted as overlapping sessions and settled together. All pod engines
share a single `VirtualClock` — one fleet timeline — and each step rebases
every pod to the same start time before settling (pods run in parallel in
reality; the shared clock then advances to the slowest pod's finish).

Topology: a `FleetSpec` describes the fleet as regions (each with its own
CI trace, scaled clean/dirty) composed of pods drawn from named
`HardwareProfile`s. `build_fleet` materializes it into `RegionState`s +
`PodState`s and a `HierarchicalRouter` that picks a region from O(1)
aggregates before running the full pod scoring inside it.

Where the port departs from the reference:
  * a pod's engine serves on one device: the port refuses a mesh (ROADMAP
    Queue 1 item 9), so a profile with `data_shards > 1` degrades to
    unsharded, as the reference does in a process that lacks the devices;
  * `build_fleet` takes the `device` the pods' engines and the default tool
    selector run on (the card unless the caller asks for the CPU) and an
    optional full-width `model_cfg`; `PodState.ensure_client` hands both to
    `runtime.use_backend("engine", ...)`, the only place a pod's engine is
    built, on the first query routed to the pod.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.common.hardware import HardwareSpec, ORIN_AGX
from repro_torch.core.carbon import carbon_footprint, ci_trace
from repro_torch.core.governor import GovernorState
from repro_torch.core.runtime import CarbonCallRuntime, PendingQuery, QueryRecord
from repro_torch.config import ModelConfig
from repro_torch.data.workload import FunctionCallWorkload, QoSTier
from repro_torch.serving import (EngineClient, EngineConfig, EngineStats,
                                 VirtualClock)

# routing proxy for one not-yet-settled query's latency contribution
# (an in-step submission must repel further arrivals before its real
# latency exists; the sim path settles immediately, so it never applies)
INFLIGHT_COST_S = 30.0

# additive score for a pod whose predicted wait already blows the tier's
# deadline budget: dominates any carbon/queue term, so such a pod is chosen
# only when no pod can make the deadline
DEADLINE_MISS_PENALTY = 1e12

# devices one pod's engine serves on: the port's engine refuses a mesh
# (ROADMAP Queue 1 item 9), so sharded profiles degrade to unsharded
SERVABLE_DEVICES = 1


@dataclasses.dataclass
class PodState:
    pod_id: int
    runtime: CarbonCallRuntime
    ci_trace: np.ndarray
    gov_state: GovernorState
    queue_s: float = 0.0              # virtual backlog (seconds of work)
    healthy: bool = True
    served: int = 0
    inflight: int = 0                 # submitted, not yet settled (this step)
    client: Optional[EngineClient] = None   # shared-engine facade (engine bk.)
    region: str = ""                  # grid region this pod sits in
    profile: str = ""                 # hardware profile name (telemetry)
    engine_cfg: Optional[EngineConfig] = None   # serializable pod sizing —
    # the SAME payload a worker process is constructed from (launch/workers)
    fleet_clock: Optional[VirtualClock] = None   # set by run_fleet (engine)
    worker: Optional[object] = None   # WorkerHandle when out-of-process
    last_stats: Optional[EngineStats] = None  # latest stats shipped back
    # over the control protocol (worker pods; refreshed per settle round)
    device: str = "cuda"              # where the lazy engine is built
    model_cfg: Optional[ModelConfig] = None   # None: the reduced arch

    def ci_at(self, i: int) -> float:
        return float(self.ci_trace[i % len(self.ci_trace)])

    @property
    def slot_capacity(self) -> int:
        """Decode-slot count without forcing a lazy engine build."""
        if self.client is not None:
            return self.client.engine.max_batch
        if self.engine_cfg is not None:
            return self.engine_cfg.max_batch
        return 2

    def ensure_client(self):
        """Build the pod's shared engine on first routed query. Constructing
        an `EngineExecutor` (the quantized variants drawn on the pod's
        device) is the expensive part of a pod; deferring it means a 64-pod
        topology under light traffic only pays for the pods traffic actually
        reaches. No-op for sim-backed runs (no fleet clock) and already-built
        pods."""
        if self.fleet_clock is None or self.client is not None:
            return self.client
        # the EngineConfig carries the full sizing (build_fleet already
        # degraded shard counts the port cannot serve)
        self.runtime.use_backend("engine", clock=self.fleet_clock,
                                 config=self.engine_cfg, device=self.device,
                                 model_cfg=self.model_cfg)
        self.client = self.runtime.executor.client
        return self.client


class FleetRouter:
    """Deadline-aware greenest-pod routing with TPS-SLO health gating."""

    def __init__(self, pods: List[PodState], *, slo_tps_frac: float = 0.6,
                 queue_weight: float = 50.0,
                 service_s: float = INFLIGHT_COST_S):
        self.pods = pods
        self.slo_tps_frac = slo_tps_frac
        self.queue_weight = queue_weight
        self.service_s = service_s        # per queued request wait estimate

    def predicted_wait_s(self, pod: PodState) -> float:
        """Expected queue wait for a NEW arrival at this pod. Engine pods
        expose their live scheduler depth: requests waiting in the priority
        queue plus this step's in-flight submissions, minus free decode slots
        (an arrival that lands straight in a slot waits ~0); sim pods fall
        back to the flat per-in-flight proxy."""
        if pod.client is not None:
            eng = pod.client.engine
            depth = len(eng.pending) + pod.inflight
            free_slots = max(0, eng.max_batch - eng.active)
            return pod.queue_s + max(0, depth - free_slots) * self.service_s
        if pod.worker is not None:
            # out-of-process pod: the scheduler depth travels back as
            # EngineStats over the control protocol (a worker drains between
            # arrival steps, so every decode slot counts as free)
            st = pod.last_stats
            depth = (st.waiting if st is not None else 0) + pod.inflight
            return pod.queue_s + max(0, depth - pod.slot_capacity) \
                * self.service_s
        return pod.queue_s + pod.inflight * self.service_s

    def _score(self, pod: PodState, i: int,
               tier: Optional[QoSTier] = None) -> float:
        ci = pod.ci_at(i)
        mode = pod.runtime.modes[pod.gov_state.mode_idx]
        # marginal energy ~ power at current mode (J/s) -> gCO2/s proxy
        carbon_rate = carbon_footprint(pod.runtime.executor.power_model.power(mode),
                                       ci) * 3600.0
        wait = self.predicted_wait_s(pod)
        lw = tier.latency_weight if tier is not None else 1.0
        score = carbon_rate + self.queue_weight * lw * wait
        if tier is not None and tier.deadline_s is not None \
                and wait > tier.deadline_s:
            score += DEADLINE_MISS_PENALTY
        return score

    def route(self, i: int, tier: Optional[QoSTier] = None) -> PodState:
        healthy = [p for p in self.pods if p.healthy]
        if not healthy:
            healthy = self.pods                     # degraded but alive
        return min(healthy, key=lambda p: self._score(p, i, tier))

    def mark_health(self):
        """Drain pods whose variant switcher window shows degraded TPS
        (fleet-level straggler mitigation)."""
        for p in self.pods:
            sw = p.runtime.switcher
            if sw.ref_tps and sw.obs:
                p.healthy = sw.window_avg() >= self.slo_tps_frac * sw.ref_tps
            else:
                p.healthy = True

    def step_reset(self):
        """End-of-arrival-step hook (hierarchical routers decay their
        per-step region aggregates here)."""


# ---------------------------------------------------------------------------
# Sharded multi-host topology: FleetSpec -> regions of heterogeneous pods
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Named per-pod engine sizing for a fleet topology.

    `data_shards > 1` asks for a data-parallel sharded engine (dense KV
    layout). The port serves a pod on one device, so `build_fleet` degrades
    such a pod to an unsharded engine, as the reference does in a process
    with fewer devices than shards, and topologies stay runnable."""
    name: str
    hw: HardwareSpec = ORIN_AGX
    max_batch: int = 2
    max_seq: int = 256
    num_blocks: Optional[int] = None
    kv_layout: str = "auto"
    data_shards: int = 1

    def engine_config(self) -> EngineConfig:
        """The profile as a serializable `EngineConfig` — the one payload
        that sizes an in-process engine AND ships to a worker process over
        the control protocol."""
        if self.data_shards > 1 and self.kv_layout == "paged":
            raise ValueError(
                f"profile {self.name!r}: the paged block pool is per-pod "
                "state — a sharded profile (data_shards > 1) requires "
                "kv_layout 'dense' (or 'auto')")
        layout = "dense" if self.data_shards > 1 else self.kv_layout
        return EngineConfig(max_batch=self.max_batch, max_seq=self.max_seq,
                            kv_layout=layout, num_blocks=self.num_blocks,
                            data_shards=self.data_shards)


DEFAULT_PROFILES: Tuple[HardwareProfile, ...] = (
    HardwareProfile("edge", max_batch=2),
    HardwareProfile("pod", max_batch=4, num_blocks=96),
    HardwareProfile("pod-dp4", max_batch=4, data_shards=4),
)


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One grid region: a CI trace source (paper week x clean/dirty scale)
    and the region's pod composition as (profile name, count) pairs."""
    name: str
    week: str = "week1"
    ci_scale: float = 1.0
    pods: Tuple[Tuple[str, int], ...] = (("edge", 1),)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Declarative fleet topology: regions of heterogeneous pods."""
    regions: Tuple[RegionSpec, ...]
    profiles: Tuple[HardwareProfile, ...] = DEFAULT_PROFILES

    @property
    def n_pods(self) -> int:
        return sum(c for r in self.regions for _, c in r.pods)


@dataclasses.dataclass
class RegionState:
    """Live aggregates for one region — everything the hierarchical router's
    region stage reads is O(1) here (no per-pod scan)."""
    name: str
    ci_trace: np.ndarray
    pods: List[PodState]
    inflight: int = 0             # routed this arrival step (reset per step)
    routed: int = 0               # queries routed here (incl. later failures)
    capacity: int = 0             # static sum of pod decode slots
    # refreshed once per step by HierarchicalRouter.mark_health:
    any_healthy: bool = True
    backlog_s: float = 0.0        # mean pod queue_s carried over from earlier

    def __post_init__(self):
        self.capacity = sum(p.slot_capacity for p in self.pods)

    def ci_at(self, i: int) -> float:
        return float(self.ci_trace[i % len(self.ci_trace)])


# nominal per-pod power (W) for the region-stage carbon term: region choice
# is an argmin over regions only, so any monotone-in-CI proxy works
NOMINAL_POD_W = 30.0


class HierarchicalRouter(FleetRouter):
    """Region -> pod routing. Stage 1 scores every *region* from O(1)
    aggregates (regional CI, this step's routed count vs static slot
    capacity); stage 2 runs the full deadline-aware pod scoring only inside
    the winning region. Per-query cost is O(R + P/R) instead of the flat
    router's O(P) — the difference between 4 and 64+ pods."""

    def __init__(self, regions: List[RegionState], **kw):
        super().__init__([p for r in regions for p in r.pods], **kw)
        self.regions = regions

    def _region_score(self, r: RegionState, i: int,
                      tier: Optional[QoSTier] = None) -> float:
        carbon_rate = carbon_footprint(NOMINAL_POD_W, r.ci_at(i)) * 3600.0
        # queue overflow drains across every decode slot in parallel, so the
        # expected extra wait for a new arrival divides by slot capacity;
        # backlog_s carries the pods' persisted queues from earlier steps so
        # a region that ended the last step deep in work repels
        # deadline-bound traffic exactly like the flat router's pod scoring
        over = max(0, r.inflight - r.capacity)
        wait = r.backlog_s + over * self.service_s / max(r.capacity, 1)
        lw = tier.latency_weight if tier is not None else 1.0
        score = carbon_rate + self.queue_weight * lw * wait
        if tier is not None and tier.deadline_s is not None \
                and wait > tier.deadline_s:
            score += DEADLINE_MISS_PENALTY
        return score

    def mark_health(self):
        """Per-step refresh (run_fleet calls this after the queue decay):
        also rebuilds the O(1) region aggregates the route stage reads."""
        super().mark_health()
        for r in self.regions:
            r.any_healthy = any(p.healthy for p in r.pods)
            r.backlog_s = (sum(p.queue_s for p in r.pods) / len(r.pods)
                           if r.pods else 0.0)

    def route(self, i: int, tier: Optional[QoSTier] = None) -> PodState:
        # the region stage honors health gating from its O(1) aggregate: a
        # fully-degraded region is skipped while any other region still has
        # a healthy pod (all-degraded fleets stay routable, like the flat
        # router)
        candidates = [r for r in self.regions if r.pods and r.any_healthy]
        if not candidates:
            candidates = [r for r in self.regions if r.pods]
        region = min(candidates, key=lambda r: self._region_score(r, i, tier))
        healthy = [p for p in region.pods if p.healthy] or region.pods
        pod = min(healthy, key=lambda p: self._score(p, i, tier))
        region.inflight += 1
        region.routed += 1
        return pod

    def step_reset(self):
        for r in self.regions:
            r.inflight = 0


@dataclasses.dataclass
class Fleet:
    """A built FleetSpec: regions + flat pod list + hierarchical router."""
    spec: FleetSpec
    regions: List[RegionState]
    router: Optional[HierarchicalRouter] = None

    def __post_init__(self):
        if self.router is None:
            self.router = HierarchicalRouter(self.regions)

    @property
    def pods(self) -> List[PodState]:
        return [p for r in self.regions for p in r.pods]

    def built_pods(self) -> List[PodState]:
        """Pods whose engine was actually constructed (traffic reached them)."""
        return [p for p in self.pods
                if p.client is not None or p.worker is not None]

    def engine_stats(self) -> Optional[EngineStats]:
        """Fleet-wide telemetry: the `EngineStats.merge` of every built
        pod — live engines read fresh, worker pods contribute the latest
        stats shipped back over the control protocol. None until traffic
        has reached at least one pod."""
        stats: List[EngineStats] = []
        for p in self.pods:
            if p.worker is not None and p.last_stats is not None:
                stats.append(p.last_stats)
            elif p.client is not None:
                stats.append(p.client.engine.stats())
        return EngineStats.merge(stats) if stats else None


def build_fleet(spec: FleetSpec, *, catalog=None, selector=None,
                policy=None, seed: int = 0, device="cuda",
                model_cfg: Optional[ModelConfig] = None) -> Fleet:
    """Materialize a FleetSpec into live pods grouped by region.

    Pods are built with cheap sim executors; the expensive engine backend is
    constructed lazily per pod by `run_fleet(backend="engine")` when traffic
    first reaches it, on `device` (the card unless the caller asks for the
    CPU) and at `model_cfg` (None: the reduced carboncall-qwen2-7b). The
    default tool selector runs on `device` too. Sharded profiles degrade to
    unsharded (`SERVABLE_DEVICES`), so specs are portable."""
    from repro_torch.core.baselines import POLICIES
    from repro_torch.core.executor import PAPER_MODELS, SimExecutor
    from repro_torch.core.power import modes_for
    from repro_torch.core.tool_select import ToolSelector
    from repro_torch.data.workload import build_catalog

    if catalog is None:
        catalog = build_catalog(32, seed=seed)
    if selector is None:
        selector = ToolSelector(catalog, device=device)
    if policy is None:
        policy = POLICIES["carboncall"]
    profiles = {p.name: p for p in spec.profiles}
    n_devices = SERVABLE_DEVICES
    regions: List[RegionState] = []
    pod_id = 0
    for rs in spec.regions:
        ci = ci_trace(rs.week, seed=seed + 100) * rs.ci_scale
        pods: List[PodState] = []
        for prof_name, count in rs.pods:
            prof = profiles[prof_name]
            for _ in range(count):
                ex = SimExecutor(PAPER_MODELS["qwen2-7b"], prof.hw,
                                 seed=pod_id)
                rt = CarbonCallRuntime(
                    selector=selector, executor=ex, policy=policy,
                    modes=modes_for(prof.hw),
                    catalog_size=len(catalog.tools), seed=pod_id)
                cfg = prof.engine_config()
                if cfg.data_shards > n_devices:
                    # degrade to unsharded, restoring the profile's own
                    # declared layout (not the mesh-forced "dense")
                    cfg = cfg.replace(data_shards=1,
                                      kv_layout=prof.kv_layout)
                pods.append(PodState(
                    pod_id=pod_id, runtime=rt, ci_trace=ci,
                    gov_state=rt.governor.init(ci[:144]),
                    region=rs.name, profile=prof.name, engine_cfg=cfg,
                    device=str(device), model_cfg=model_cfg))
                pod_id += 1
        regions.append(RegionState(name=rs.name, ci_trace=ci, pods=pods))
    return Fleet(spec=spec, regions=regions)


def _prepare_engine_backend(pods: List[PodState]) -> VirtualClock:
    """Put every pod on ONE fleet-wide VirtualClock (cross-pod carbon
    accounting needs one timeline, not N drifting ones) WITHOUT building
    engines: sim-backed pods only record the clock for their lazy
    `ensure_client`; pods already engine-backed are rewired onto the fleet
    timeline up front (they are already paid for)."""
    from repro_torch.core.engine_executor import EngineExecutor

    clock = VirtualClock()
    for p in pods:
        p.fleet_clock = clock
        if isinstance(p.runtime.executor, EngineExecutor):
            ex = p.runtime.executor
            if ex.clock is not clock:
                clock.t = max(clock.t, ex.clock())
                ex.clock = clock
                ex.engine.clock = clock
            p.client = ex.client
    return clock


def run_fleet(pods, workload: FunctionCallWorkload, *,
              n_steps: int, step_minutes: int = 10,
              queries_per_hour: float = 60.0, seed: int = 0,
              backend: Optional[str] = None,
              router: Optional[FleetRouter] = None,
              rate_fn: Optional[Callable[[float], float]] = None
              ) -> Dict[int, List[QueryRecord]]:
    """Drive a fleet (a `Fleet` or a plain pod list) for `n_steps` arrival
    steps. With `backend="engine"` pods share one fleet-wide VirtualClock and
    each pod's engine is constructed lazily on its first routed query.
    `rate_fn(t_seconds) -> queries/hour` overrides the flat arrival rate
    (e.g. `diurnal_qph`); None keeps the pre-existing constant-rate stream
    bit-identical."""
    if isinstance(pods, Fleet):
        fleet, pods = pods, pods.pods
        if router is None:
            router = fleet.router
    clock: Optional[VirtualClock] = None
    if backend == "engine":
        clock = _prepare_engine_backend(pods)
    elif backend is not None:
        for p in pods:
            p.runtime.use_backend(backend)
    rng = np.random.default_rng(seed)
    if router is None:
        router = FleetRouter(pods)
    steps_per_day = 24 * 60 // step_minutes
    out: Dict[int, List[QueryRecord]] = {p.pod_id: [] for p in pods}
    lam = queries_per_hour * step_minutes / 60.0

    def settle_pod(pod: PodState, batch: List[PendingQuery]):
        for rec in pod.runtime.settle(batch):
            pod.queue_s += rec.latency_s
            pod.served += 1
            out[pod.pod_id].append(rec)
        pod.inflight = 0

    for i in range(n_steps):
        t = i * step_minutes * 60.0
        if clock is not None:
            clock.t = max(clock.t, t)    # anchor engine time to the schedule
        for p in pods:
            ci = p.ci_at(i)
            if i % steps_per_day == 0:
                day = [p.ci_at(j) for j in range(i, i + steps_per_day)]
                p.gov_state = p.runtime.governor.update(p.gov_state, ci,
                                                        forecast_24h=day)
            else:
                p.gov_state = p.runtime.governor.update(p.gov_state, ci)
            p.queue_s = max(0.0, p.queue_s - step_minutes * 60.0)
        router.mark_health()
        batches: Dict[int, List[PendingQuery]] = {}
        lam_i = lam if rate_fn is None else \
            max(0.0, rate_fn(t)) * step_minutes / 60.0
        for q in range(rng.poisson(lam_i)):
            query = workload.sample()
            pod = router.route(i, query.tier)     # deadline-aware placement
            pod.ensure_client()       # lazy engine build on first routed query
            pq = pod.runtime.submit_query(t + q, query, pod.ci_at(i),
                                          pod.gov_state)
            if getattr(pod.runtime.executor, "max_concurrency", 1) > 1:
                batches.setdefault(pod.pod_id, []).append(pq)
                pod.inflight += 1
            else:
                settle_pod(pod, [pq])
        if batches:
            # pods run in parallel: every pod's settle starts from the same
            # instant on the shared timeline, which then advances to the
            # slowest pod's finish
            by_id = {p.pod_id: p for p in pods}
            t_base = clock() if clock is not None else 0.0
            t_end = t_base
            for pod_id, batch in batches.items():
                if clock is not None:
                    clock.t = t_base
                settle_pod(by_id[pod_id], batch)
                if clock is not None:
                    t_end = max(t_end, clock())
            if clock is not None:
                clock.t = t_end
        router.step_reset()
    return out
