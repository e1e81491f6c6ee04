"""The CarbonCall runtime (paper Fig. 1): ties together tool selection,
carbon-aware operating modes, and mixed-quality variant switching.

The port of `repro.core.runtime`, line for line. `run_week` drives virtual
time against a CI trace with Poisson query arrivals — the experimental design
of §IV. Method behaviour is injected through `Policy`, so the paper's
baselines (Default/Gorilla/LiS/LiS*) are the same loop with features
disabled — see core/baselines.py.

Queries flow through an async two-phase API: `submit_query` opens a session
on the execution backend (selection, mode and variant are decided at submit),
`settle` resolves a batch of sessions and applies the TPS-switching decisions
in arrival order. Backends that can overlap work (`max_concurrency > 1`, i.e.
the engine) receive a whole arrival step's worth of sessions before settling,
so concurrent users share decode steps; the analytic backend settles each
session immediately. On the card, tool selection runs the `sim_scores`
kernel once per retrieval and the engine backend the model's kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.carbon import carbon_footprint, forecast_trace
from repro_torch.core.executor import QuerySession, SimExecutor
from repro_torch.core.governor import CarbonGovernor, GovernorState
from repro_torch.core.power import OperatingMode
from repro_torch.core.switching import VariantSwitcher
from repro_torch.core.tool_select import ToolSelector
from repro_torch.data.workload import FunctionCallWorkload, Query


@dataclasses.dataclass
class Policy:
    name: str
    use_selection: str = "carboncall"   # carboncall | gorilla | lis | all_tools
    carbon_modes: bool = True           # governor drives the mode?
    variant_switching: bool = True      # Q8<->Q4 TPS switching?
    fixed_variant: str = "q8"


@dataclasses.dataclass
class PendingQuery:
    """A submitted-but-unsettled query: everything `settle` needs to turn the
    backend session's `QueryExecution` into a `QueryRecord`."""
    t: float
    ci: float
    mode_idx: int
    mode: OperatingMode
    variant: str
    n_tools: int
    extra_inf: float
    session: QuerySession


@dataclasses.dataclass
class QueryRecord:
    t: float
    latency_s: float
    energy_j: float
    carbon_g: float
    tps: float
    variant: str
    mode_idx: int
    n_tools: int
    succeeded: bool
    tier: str = "default"            # QoS class ("default" = untiered)


@dataclasses.dataclass
class WeekResult:
    name: str
    records: List[QueryRecord]

    def _mean(self, f):
        return float(np.mean([f(r) for r in self.records])) if self.records else 0.0

    @property
    def avg_latency(self):
        return self._mean(lambda r: r.latency_s)

    @property
    def avg_power(self):
        return self._mean(lambda r: r.energy_j / max(r.latency_s, 1e-9))

    @property
    def avg_tps(self):
        return self._mean(lambda r: r.tps)

    @property
    def avg_carbon(self):
        return self._mean(lambda r: r.carbon_g)

    @property
    def success_rate(self):
        return self._mean(lambda r: 1.0 if r.succeeded else 0.0)

    def tier_summary(self) -> Dict[str, Dict[str, float]]:
        return tier_report(self.records)

    def q8_utilization_by_day(self) -> List[float]:
        out = []
        for d in range(7):
            day = [r for r in self.records if d * 86400 <= r.t < (d + 1) * 86400]
            if day:
                out.append(sum(r.variant == "q8" for r in day) / len(day))
            else:
                out.append(1.0)
        return out


def tier_report(records: List["QueryRecord"]) -> Dict[str, Dict[str, float]]:
    """Per-QoS-tier aggregate over query records: volume, success rate (an
    engine-backed expiry is a failed record, so for deadline-carrying tiers
    this IS the deadline-hit rate net of model failures), latency percentiles
    and carbon per query."""
    out: Dict[str, Dict[str, float]] = {}
    for tier in sorted({r.tier for r in records}):
        rs = [r for r in records if r.tier == tier]
        lats = np.sort([r.latency_s for r in rs])
        out[tier] = {
            "queries": len(rs),
            "success_rate": float(np.mean([r.succeeded for r in rs])),
            "p50_latency_s": float(np.percentile(lats, 50)),
            "p95_latency_s": float(np.percentile(lats, 95)),
            "carbon_g_per_query": float(np.mean([r.carbon_g for r in rs])),
        }
    return out


class CarbonCallRuntime:
    def __init__(self, *, selector: ToolSelector, executor: SimExecutor,
                 policy: Policy, modes: List[OperatingMode],
                 catalog_size: int, seed: int = 0):
        self.selector = selector
        self.executor = executor
        self.policy = policy
        self.modes = modes
        self.catalog_size = catalog_size
        self.governor = CarbonGovernor(modes)
        self.switcher = VariantSwitcher()
        # deployment-time calibration: the (m1, Q8) decode TPS reference the
        # 80% switching threshold is measured against — each backend knows its
        # own TPS model (sim: analytic pipeline; engine: roofline of the
        # virtual-clock request it actually runs)
        self.switcher.set_reference(executor.reference_tps(modes[0]))
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def use_backend(self, backend: str, **engine_kw):
        """Swap the execution backend in place ("sim" | "engine"), rebuilding
        the switcher's TPS reference against the new backend's timing model.
        `engine_kw` reaches the EngineExecutor (e.g. a shared fleet clock)."""
        from repro_torch.core.engine_executor import EngineExecutor, make_executor
        current = "engine" if isinstance(self.executor, EngineExecutor) else "sim"
        if backend == current:
            return self
        self.executor = make_executor(backend, self.executor.profile,
                                      self.executor.power_model.hw,
                                      seed=self.executor.seed, **engine_kw)
        self.switcher.set_reference(self.executor.reference_tps(self.modes[0]))
        return self

    # -- selection policies --------------------------------------------------

    def _select(self, query: Query):
        """-> (n_tools_in_prompt, selection_correct, extra_inference)."""
        p = self.policy
        if p.use_selection == "all_tools":
            return self.catalog_size, True, 0.0   # all tools: never "misses",
            # but success degrades with prompt size (handled below)
        if p.use_selection == "gorilla":
            cand, _ = self.selector.retrieve(query.text)
            chosen = cand[:2]
            return max(len(chosen), 1), all(t in chosen for t in query.true_tools), 0.0
        if p.use_selection == "lis":
            # LLM-recommender: good accuracy, costs an extra short inference
            sel = self.selector.select(query.text)
            correct = all(t in sel.tool_ids for t in query.true_tools)
            return max(len(sel.tool_ids), 1), correct, 1.0
        sel = self.selector.select(query.text)
        correct = all(t in sel.tool_ids for t in query.true_tools)
        return max(len(sel.tool_ids), 1), correct, 0.0

    def _all_tools_success(self, n_calls: int) -> bool:
        # small LLMs with the full catalog in-prompt mis-call often ([1]);
        # chains compound the exposure
        p1 = max(0.45, 0.97 - 0.06 * np.log(max(self.catalog_size, 1)))
        return bool(self.rng.random() < p1 ** n_calls)

    # -- main entry ------------------------------------------------------------

    def submit_query(self, t: float, query: Query, ci: float,
                     gov_state: GovernorState) -> PendingQuery:
        """Phase 1: decide mode/variant/selection and open a backend session.
        Nothing is resolved yet — overlapping submissions from many users
        share the engine's decode slots once `settle` runs."""
        p = self.policy
        mode = self.modes[gov_state.mode_idx] if p.carbon_modes else self.modes[0]
        variant = self.switcher.variant if p.variant_switching else p.fixed_variant

        n_tools, correct, extra_inf = self._select(query)
        if p.use_selection == "all_tools":
            correct = self._all_tools_success(len(query.true_tools))

        # QoS tier -> session scheduling class: an untiered query is exactly
        # the pre-tier contract (priority 0, no deadline)
        tier = getattr(query, "tier", None)
        session = self.executor.begin_query(
            n_tools_in_prompt=n_tools, n_calls=len(query.true_tools),
            selection_correct=correct, variant=variant, mode=mode,
            priority=tier.priority if tier else 0,
            deadline_s=tier.deadline_s if tier else None,
            tier=tier.name if tier else "default")
        return PendingQuery(t=t, ci=ci, mode_idx=gov_state.mode_idx, mode=mode,
                            variant=variant, n_tools=n_tools,
                            extra_inf=extra_inf, session=session)

    def settle(self, pending: List[PendingQuery]) -> List[QueryRecord]:
        """Phase 2: resolve a batch of sessions on the backend, then apply
        per-query post-processing (LiS extra inference, TPS observation and
        variant switching) in arrival order — switch decisions land between
        batches, never inside one."""
        self.executor.settle([pq.session for pq in pending])
        p = self.policy
        records: List[QueryRecord] = []
        for pq in pending:
            ex = pq.session.execution
            lat, en = ex.latency_s, ex.energy_j
            if pq.extra_inf:
                # LiS recommender pass: ~200-token prompt, 30-token generation
                pm = self.executor.power_model
                prof = self.executor.profile
                tpre = pm.prefill_time(200, prof.n_active * 2, pq.mode)
                tdec = 30 * pm.decode_time_per_token(
                    prof.active_bytes(pq.variant), prof.kv_bytes_per_token,
                    pq.mode)
                lat += tpre + tdec
                en += (tpre + tdec) * pm.power(pq.mode)

            # TPS monitoring + variant switching
            if p.variant_switching:
                self.switcher.observe(pq.t, ex.tps)
                dec = self.switcher.decide(pq.t)
                if dec.switch_to and dec.switch_to != self.switcher.variant:
                    sl, se = self.executor.variant_switch_cost(dec.switch_to,
                                                               pq.mode)
                    lat += sl
                    en += se
                    self.switcher.apply(pq.t, dec)

            records.append(QueryRecord(
                t=pq.t, latency_s=lat, energy_j=en,
                carbon_g=carbon_footprint(en, pq.ci), tps=ex.tps,
                variant=pq.variant, mode_idx=pq.mode_idx, n_tools=pq.n_tools,
                succeeded=ex.succeeded, tier=pq.session.tier))
        return records

def run_week(runtime: CarbonCallRuntime, workload: FunctionCallWorkload,
             ci: np.ndarray, *, step_minutes: int = 10,
             queries_per_hour: float = 30.0, seed: int = 0,
             backend: Optional[str] = None) -> WeekResult:
    """Virtual-time week: Poisson arrivals, 24h forecast refresh at midnight.

    `backend="sim"` (analytic) or `"engine"` (real ServingEngine decode under
    the calibrated virtual clock) selects the execution backend; None keeps
    whatever executor the runtime was built with.

    A concurrency-capable backend gets each step's arrivals submitted as one
    batch and settled together (overlapping sessions share decode steps); a
    blocking backend (sim) settles each query as it arrives, preserving the
    exact pre-session-API result stream.
    """
    if backend is not None:
        runtime.use_backend(backend)
    if len(ci) == 0:
        return WeekResult(name=runtime.policy.name, records=[])
    rng = np.random.default_rng(seed)
    forecast = forecast_trace(ci, seed=seed + 1)
    gov = runtime.governor
    steps_per_day = 24 * 60 // step_minutes
    state = gov.init(forecast[:steps_per_day])
    records: List[QueryRecord] = []
    lam = queries_per_hour * step_minutes / 60.0
    concurrent = getattr(runtime.executor, "max_concurrency", 1) > 1
    for i in range(len(ci)):
        t = i * step_minutes * 60.0
        if i % steps_per_day == 0:      # midnight: refresh the 24h forecast
            fc = forecast[i:i + steps_per_day]
            state = gov.update(state, float(ci[i]), forecast_24h=fc)
        else:
            state = gov.update(state, float(ci[i]))
        batch: List[PendingQuery] = []
        for q in range(rng.poisson(lam)):
            query = workload.sample()
            pq = runtime.submit_query(t + 30.0 * q, query, float(ci[i]), state)
            if concurrent:
                batch.append(pq)
            else:
                records.extend(runtime.settle([pq]))
        if batch:
            records.extend(runtime.settle(batch))
    return WeekResult(name=runtime.policy.name, records=records)
