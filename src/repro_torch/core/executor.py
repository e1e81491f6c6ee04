"""Query execution backends for the CarbonCall runtime.

The port of `repro.core.executor`, line for line: the runtime's numbers must
match the JAX package's, so nothing here depends on the framework.

SimExecutor — analytic virtual-time model calibrated from the roofline
constants in core/power.py (no power rails are read: seconds and joules are
those of the Orin power model). It models the full per-query pipeline the
paper times:
    select -> prefill(prompt w/ tools) -> decode(function call JSON)
           -> tool execution (external, stubbed latency)
           -> evaluation pass (prefill result + short decode)
with failure->retry loops whose probability comes from the *actual* selection
outcome plus a variant-dependent degradation (quantized models fail more,
§III-D last paragraph).

The engine-backed counterpart (EngineExecutor, core/engine_executor.py) runs
the same query pipeline on the port's ServingEngine; both share the
per-query retry scaffold defined here (`attempt_loop`).

Execution contract (`Executor` protocol): the runtime talks to backends
through an *async session* API — `begin_query(...) -> QuerySession` then
`settle(sessions)`. A backend that can overlap queries (the engine, whose
decode slots batch across users) receives a whole arrival batch before any
result is demanded. `SimExecutor` resolves sessions eagerly at
`begin_query`, which fixes its random-stream consumption, and therefore
every `run_week(backend="sim")` result, to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.common.hardware import HardwareSpec, bytes_per_param
from repro_torch.core.power import OperatingMode, PowerModel


TOKENS_PER_TOOL = 30          # prompt tokens to describe one tool
QUERY_TOKENS = 30             # base prompt
CALL_TOKENS = 50              # decoded tokens per structured function call
EVAL_PROMPT = 120             # tool result fed back for evaluation
EVAL_TOKENS = 25              # decoded evaluation summary
TOOL_EXEC_S = 0.20            # external API latency (stub)
SELECT_S = 0.008              # embedder+rerank latency (measured-on-CPU scale)
Q4_ACCURACY_FACTOR = 0.93     # quantization hurts structured calling slightly


@dataclasses.dataclass
class QueryExecution:
    latency_s: float
    energy_j: float
    decode_tokens: int
    decode_time_s: float
    exec_time_s: float            # latency minus external-tool wait
    failed_attempts: int
    succeeded: bool
    queue_wait_s: float = 0.0     # engine backend: total scheduler wait
    expired: bool = False         # engine backend: deadline lapsed waiting
    stall_s: float = 0.0          # engine backend: resident time stalled
                                  # behind other requests' prefill steps

    @property
    def tps(self) -> float:
        """Paper's TPS: generated tokens over on-device execution time
        (prefill + decode; the external API wait is not the LLM's throughput)."""
        return self.decode_tokens / max(self.exec_time_s, 1e-9)


@dataclasses.dataclass
class QuerySession:
    """One in-flight query on an execution backend.

    Created by `Executor.begin_query`; `execution` is populated no later than
    the `Executor.settle` call that includes it (eagerly at begin for the
    analytic backend). Backends subclass this to carry attempt state."""
    n_tools: int
    n_calls: int
    p_success: float
    variant: str
    mode: OperatingMode
    priority: int = 0
    deadline_s: Optional[float] = None
    tier: str = "default"            # QoS class label (telemetry/records)
    execution: Optional[QueryExecution] = None


@runtime_checkable
class Executor(Protocol):
    """What `CarbonCallRuntime` requires of an execution backend."""

    profile: "ModelProfile"
    power_model: PowerModel
    seed: int

    @property
    def max_concurrency(self) -> int:
        """How many sessions may usefully overlap (1 = blocking backend)."""
        ...

    def reference_tps(self, mode: OperatingMode) -> float:
        ...

    def begin_query(self, *, n_tools_in_prompt: int, n_calls: int,
                    selection_correct: bool, variant: str,
                    mode: OperatingMode, priority: int = 0,
                    deadline_s: Optional[float] = None,
                    tier: str = "default") -> QuerySession:
        ...

    def settle(self, sessions: List[QuerySession]) -> None:
        ...

    def variant_switch_cost(self, variant: str, mode: OperatingMode):
        ...


@dataclasses.dataclass
class ModelProfile:
    """Per-LLM-family constants the TPS/power model needs."""
    name: str
    n_params: float               # total
    n_active: float               # per-token active (MoE-aware)
    kv_bytes_per_token: float     # bytes appended to the KV cache per token

    def weight_bytes(self, variant: str) -> float:
        return self.n_params * bytes_per_param(variant)

    def active_bytes(self, variant: str) -> float:
        return self.n_active * bytes_per_param(variant)


# The paper's three model families (§IV), 8B/8B/7B class.
HERMES2_PRO_8B = ModelProfile("hermes2-pro-8b", 8.0e9, 8.0e9, 131072)
LLAMA31_8B = ModelProfile("llama3.1-8b", 8.0e9, 8.0e9, 131072)
QWEN2_7B = ModelProfile("qwen2-7b", 7.6e9, 7.6e9, 28672)

PAPER_MODELS = {m.name: m for m in (HERMES2_PRO_8B, LLAMA31_8B, QWEN2_7B)}


def success_probability(selection_correct: bool, variant: str) -> float:
    """A call only succeeds if selection put the right tool in the prompt;
    quantized variants degrade structured calling slightly (§III-D)."""
    p = 1.0 if selection_correct else 0.0
    if variant == "q4":
        p *= Q4_ACCURACY_FACTOR
    return p


def attempt_loop(rng, p_success: float, n_calls: int,
                 attempt) -> QueryExecution:
    """Shared per-query retry scaffold (one retry on failure), used by both
    execution backends. `attempt(calls)` performs one full pipeline pass and
    returns (latency, energy, decode_tokens, decode_time, external_wait);
    a failed attempt aborts its chain roughly halfway through."""
    lat = en = 0.0
    tok = 0
    dec_t = 0.0
    wait_t = 0.0
    failed = 0
    succeeded = False
    for _ in range(2):
        ok = rng.random() < p_success
        calls = n_calls if ok else max(1, n_calls // 2)
        la, e, d, dt, w = attempt(calls)
        lat += la
        en += e
        tok += d
        dec_t += dt
        wait_t += w
        if ok:
            succeeded = True
            break
        failed += 1
    return QueryExecution(latency_s=lat, energy_j=en, decode_tokens=tok,
                          decode_time_s=dec_t,
                          exec_time_s=lat - wait_t,
                          failed_attempts=failed, succeeded=succeeded)


class SimExecutor:
    def __init__(self, profile: ModelProfile, hw: HardwareSpec,
                 seed: int = 0):
        self.profile = profile
        self.power_model = PowerModel(hw)
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    @property
    def max_concurrency(self) -> int:
        return 1           # analytic model: queries cannot share any compute

    def begin_query(self, *, priority: int = 0,
                    deadline_s: Optional[float] = None,
                    tier: str = "default", **kw) -> QuerySession:
        """Sessions resolve eagerly: the analytic model has nothing to
        overlap, and computing at begin keeps rng consumption (and therefore
        whole-week results) bit-identical to the old blocking contract.
        Priority/deadline/tier are recorded but have no effect — the analytic
        backend has no queue for them to act on."""
        s = QuerySession(n_tools=kw["n_tools_in_prompt"],
                         n_calls=kw["n_calls"],
                         p_success=success_probability(
                             kw["selection_correct"], kw["variant"]),
                         variant=kw["variant"], mode=kw["mode"],
                         priority=priority, deadline_s=deadline_s, tier=tier)
        s.execution = self._execute(**kw)
        return s

    def settle(self, sessions: List[QuerySession]) -> None:
        pass               # resolved at begin_query

    def reference_tps(self, mode: OperatingMode) -> float:
        """Deployment-time calibration: the (mode, Q8) decode TPS the 80%
        switching threshold is measured against."""
        pm, prof = self.power_model, self.profile
        tok = CALL_TOKENS + EVAL_TOKENS
        t = (pm.prefill_time(200 + EVAL_PROMPT, prof.n_active * 2, mode)
             + tok * pm.decode_time_per_token(
                 prof.active_bytes("q8"), prof.kv_bytes_per_token, mode))
        return tok / t

    def _execute(self, *, n_tools_in_prompt: int, n_calls: int,
                 selection_correct: bool, variant: str,
                 mode: OperatingMode) -> QueryExecution:
        pm, prof = self.power_model, self.profile
        prompt = QUERY_TOKENS + n_tools_in_prompt * TOKENS_PER_TOOL
        # prefill is compute-bound (pulls toward the cap); decode is
        # memory-bound (cores partially idle); tool wait is near-idle
        p_prefill = pm.power(mode, util=0.95)
        p_decode = pm.power(mode, util=0.70)
        p_idle_wait = pm.power(mode, util=0.25)

        def one_attempt(calls: int):
            lat = SELECT_S
            en = SELECT_S * pm.power(mode, util=0.3)
            wait = 0.0
            dec_tok = 0
            dec_t = 0.0
            t = pm.prefill_time(prompt, prof.n_active * 2, mode)  # 2 FLOP/param/token
            lat += t
            en += t * p_prefill
            for _ in range(calls):
                dt = CALL_TOKENS * pm.decode_time_per_token(
                    prof.active_bytes(variant), prof.kv_bytes_per_token, mode)
                lat += dt
                en += dt * p_decode
                dec_tok += CALL_TOKENS
                dec_t += dt
                lat += TOOL_EXEC_S
                wait += TOOL_EXEC_S
                en += TOOL_EXEC_S * p_idle_wait
                # evaluation pass
                pe = pm.prefill_time(EVAL_PROMPT, prof.n_active * 2, mode)
                de = EVAL_TOKENS * pm.decode_time_per_token(
                    prof.active_bytes(variant), prof.kv_bytes_per_token, mode)
                lat += pe + de
                en += pe * p_prefill + de * p_decode
                dec_tok += EVAL_TOKENS
                dec_t += de
            return lat, en, dec_tok, dec_t, wait

        return attempt_loop(self.rng,
                            success_probability(selection_correct, variant),
                            n_calls, one_attempt)

    def variant_switch_cost(self, variant: str, mode: OperatingMode):
        """(latency, energy) to load the `variant` weights."""
        t = self.power_model.model_load_time(
            self.profile.weight_bytes(variant), mode)
        return t, t * self.power_model.power(mode, util=0.5)
