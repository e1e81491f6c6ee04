"""Engine-backed query execution: the CarbonCall control loop driving the
port's continuous-batching ServingEngine through the async session API.

The port of `repro.core.engine_executor`. `SimExecutor` (core/executor.py)
is purely analytic; this module closes the loop the paper runs: the
governor's mode and the switcher's variant decisions land on a live engine —
tool prompts become token prompts sized by `n_tools_in_prompt`, decode runs
through the batched slot loop, and Q8<->Q4 switches call
`engine.swap_params` with pre-built quantized weight trees. On the card
every linear layer runs the q8/q4 kernels; on the transformer's paged
layout every decode step runs the paged attention kernel, and on either
layout every cold admission the flash attention kernel; over mamba2 (the
dense layout) every admission runs the ssd kernel.

Sessions, not blocking calls: `begin_query` submits nothing — it records the
query and draws its attempt outcome lazily; `settle(sessions)` submits every
open attempt through one shared `EngineClient` and steps the engine until
they finish, so queries from many users occupy decode slots *together*
(retries are submitted in follow-up rounds). Per-session accounting reads the
engine step log: a step's virtual duration is charged in full to each
resident session's latency clock (they all waited through it) while its
energy is split evenly among the sessions resident that step.

Timing/energy: the engine runs on a `VirtualClock` whose per-step durations
come from the same roofline power model the simulator uses, evaluated at the
*profile* scale (8B-class bytes/FLOPs) and the current operating mode of the
Orin board. Token generation is real; seconds and joules are calibrated, not
measured on the card. The external tool wait and the evaluation-pass
re-prefill are charged analytically.

The model is the reduced config of `arch` unless `model_cfg` is given (the
full-width `get_arch(arch)` runs the same loop at full size on the card):
carboncall-qwen2-7b (paged, or `kv_layout="dense"`) or mamba2-370m (dense).
Step prices read the profile, never the model, so a model without a KV
cache changes the step log and not the pricing formula.
Weights are random from `seed`, drawn straight into the Q8/Q4 trees leaf by
leaf (`quant.init_quantized`), so no full-precision tree is ever whole.
`prefill_chunk` admits long tool prompts in windows between decode steps,
and `EngineConfig.spec_decode` drafts with its `draft_variant` tree (Q4) and
verifies with the resident one; with a `k_ladder`, each query's governor
mode sets the draft length (`CarbonGovernor.k_for_mode`: the dirtier the
grid, the lower the power mode and the longer the drafts). Draft rounds are
priced at the draft variant's decode cost, a verify window as a prefill of
its tokens. The data-parallel mesh is not ported yet: the executor refuses
it with a `NotImplementedError` naming the ROADMAP item, and what the JAX
package refuses (among it chunked prefill and speculative decoding over
mamba2) with its `ValueError`, before it makes any weights.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.hardware import HardwareSpec
from repro_torch.common.registry import get_arch
from repro_torch.config import ModelConfig, RuntimeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.core.executor import (
    EVAL_PROMPT, QUERY_TOKENS, QueryExecution, QuerySession, SELECT_S,
    TOKENS_PER_TOOL, TOOL_EXEC_S, ModelProfile, success_probability)
from repro_torch.core.governor import CarbonGovernor
from repro_torch.core.power import OperatingMode, PowerModel, modes_for
from repro_torch.models import get_model
from repro_torch.quant.qtensor import init_quantized
from repro_torch.serving import (EngineConfig, RequestHandle, ServingEngine,
                                 SessionRequest, VirtualClock)
from repro_torch.serving.engine import refuse_unported, resolve_layout


@dataclasses.dataclass
class EngineSession(QuerySession):
    """Per-query attempt state on the live engine."""
    handle: Optional[RequestHandle] = None
    attempt_no: int = 0
    attempt_ok: bool = False
    attempt_calls: int = 0
    submit_t: float = 0.0
    energy_j: float = 0.0          # attributed share of engine-step energy
    decode_t: float = 0.0          # engine decode time spent on this query
    stall_t: float = 0.0           # resident time stalled by others' prefill
    # totals across attempts
    tot_lat: float = 0.0
    tot_en: float = 0.0
    tot_tok: int = 0
    tot_dec_t: float = 0.0
    tot_wait: float = 0.0
    tot_qwait: float = 0.0         # scheduler queue wait across attempts
    tot_stall: float = 0.0         # prefill-stall time across attempts
    failed: int = 0
    expired: bool = False


class EngineExecutor:
    """Executes runtime queries on the port's ServingEngine."""

    def __init__(self, profile: ModelProfile, hw: HardwareSpec, *,
                 arch: str = "carboncall-qwen2-7b", seed: int = 0,
                 config: Optional[EngineConfig] = None,
                 max_batch: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 tokens_per_call: int = 8, eval_tokens: int = 4,
                 kv_layout: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 clock: Optional[VirtualClock] = None,
                 model_cfg: Optional[ModelConfig] = None, device="cuda"):
        # engine sizing flows through ONE serializable EngineConfig — the
        # same payload a worker process is constructed from; the explicit
        # kwargs remain as per-field overrides (None = no override). The
        # executor's historical default is a 2-slot engine.
        base = config if config is not None else EngineConfig(max_batch=2)
        over = {k: v for k, v in (("max_batch", max_batch),
                                  ("max_seq", max_seq),
                                  ("kv_layout", kv_layout),
                                  ("kv_cache_dtype", kv_cache_dtype),
                                  ("num_blocks", num_blocks),
                                  ("prefill_chunk", prefill_chunk))
                if v is not None}
        config = base.replace(**over) if over else base
        cfg = model_cfg if model_cfg is not None \
            else reduce_config(get_arch(arch))
        # refuse what the port does not serve, and what the engine would
        # refuse, before any weights are made
        refuse_unported(config)
        resolve_layout(cfg, config)
        sd = config.spec_decode
        if sd is not None and sd.draft_variant not in config.variants:
            raise ValueError(
                f"spec_decode.draft_variant {sd.draft_variant!r} is not "
                f"in variants {tuple(config.variants)}")
        self.profile = profile
        self.power_model = PowerModel(hw)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.tokens_per_call = tokens_per_call
        self.eval_tokens = eval_tokens

        device = resolve_device(device, "EngineExecutor")
        self.cfg = cfg
        rcfg = RuntimeConfig()
        spec = get_model(self.cfg).param_spec()
        gen = torch.Generator(device=device).manual_seed(seed)
        self.variants = init_quantized(spec, config.variants, gen, device)
        boot = config.variants[0]
        self.clock = clock if clock is not None else VirtualClock()
        self._mode: OperatingMode = modes_for(hw)[0]
        self.engine = ServingEngine(self.cfg, self.variants[boot], rcfg,
                                    config=config, clock=self.clock,
                                    step_cost_fn=self._step_cost,
                                    device=device)
        self.engine.variant_name = boot
        self.config = self.engine.config
        self._modes = modes_for(hw)
        if sd is not None:
            # the verify variant is whatever is resident, so the ladder stays
            # coherent across hot swaps (draft == resident stands spec down)
            self.engine.set_draft_params(self.variants[sd.draft_variant],
                                         sd.draft_variant)
        self.client = self.engine.client()
        # int8 KV halves the per-token cache bytes a decode step streams
        # (the fp32 scale stripes amortize over the head dim — the factor
        # the JAX package's launch/analytic.py prices), which is where the
        # carbon win beyond the capacity win comes from
        self._kv_byte_frac = (
            0.5 if self.engine.rcfg.kv_cache_dtype == "int8" else 1.0)
        self._log_pos = 0              # step_log watermark for attribution
        self._rid_sessions: Dict[int, EngineSession] = {}

    @property
    def swap_count(self) -> int:
        """Live engine.swap_params performed (the engine is the only counter;
        queries swap exclusively through it)."""
        return self.engine.swap_count

    @property
    def max_concurrency(self) -> int:
        return self.engine.max_batch

    # -- virtual-clock step costs -------------------------------------------

    def _step_cost(self, kind: str, tokens: int, active: int) -> float:
        """Roofline duration of one engine step at profile scale: prefill is
        compute-bound on the prompt tokens; batched decode streams the weights
        once per step plus one KV read per active slot (this is what makes
        batched TPS scale with occupancy under the virtual clock). A spec
        step is its draft rounds at the draft variant's weight bytes plus
        one verify forward priced as a prefill of the window tokens."""
        pm, prof, mode = self.power_model, self.profile, self._mode
        if kind == "spec_draft":
            # `tokens` is the drafted total (k * rows): k batched rounds
            rounds = max(1, -(-tokens // max(active, 1)))
            return rounds * pm.decode_time_per_token(
                prof.active_bytes(self.engine.draft_variant),
                prof.kv_bytes_per_token * self._kv_byte_frac * max(active, 1),
                mode)
        if kind == "spec_verify":
            return pm.prefill_time(max(tokens, 1), prof.n_active * 2, mode)
        if kind != "decode":     # "prefill" or a chunked "prefill_chunk"
            if tokens <= 0:
                return 0.0       # full prefix-cache hit: prefill was skipped
            return pm.prefill_time(tokens, prof.n_active * 2, mode)
        return pm.decode_time_per_token(
            prof.active_bytes(self.engine.variant_name),
            prof.kv_bytes_per_token * self._kv_byte_frac * max(active, 1),
            mode)

    # -- executor interface --------------------------------------------------

    def reference_tps(self, mode: OperatingMode) -> float:
        """Deployment-time calibration: TPS of a nominal single-call (3-tool)
        query at Q8 in `mode` — mirrors what a solo query measures so the 80%
        switching threshold is meaningful against engine telemetry."""
        pm, prof = self.power_model, self.profile
        tok = self.tokens_per_call + self.eval_tokens
        prompt = QUERY_TOKENS + 3 * TOKENS_PER_TOOL
        t = (SELECT_S
             + pm.prefill_time(prompt, prof.n_active * 2, mode)
             + pm.prefill_time(EVAL_PROMPT, prof.n_active * 2, mode)
             + tok * pm.decode_time_per_token(
                 prof.active_bytes("q8"), prof.kv_bytes_per_token, mode))
        return tok / t

    def begin_query(self, *, n_tools_in_prompt: int, n_calls: int,
                    selection_correct: bool, variant: str,
                    mode: OperatingMode, priority: int = 0,
                    deadline_s: Optional[float] = None,
                    tier: str = "default") -> EngineSession:
        """Open a session. The engine's weights follow the *latest* begin:
        queries batched into one settle share the switcher's variant (the
        switcher only flips between batches), so a batch is single-variant
        by construction."""
        self._mode = mode
        if variant != self.engine.variant_name:
            # live hot-swap: the switcher's decision lands on the engine
            self.engine.swap_params(self.variants[variant], variant)
        sd = self.config.spec_decode
        if sd is not None and sd.k_ladder:
            # carbon-modulated draft length: the mode's place on the ladder
            try:
                idx = self._modes.index(mode)
            except ValueError:
                idx = 0
            self.engine.set_draft_k(
                CarbonGovernor.k_for_mode(idx, len(self._modes),
                                          sd.k_ladder))
        return EngineSession(
            n_tools=n_tools_in_prompt, n_calls=n_calls,
            p_success=success_probability(selection_correct, variant),
            variant=variant, mode=mode, priority=priority,
            deadline_s=deadline_s, tier=tier)

    def settle(self, sessions: List[QuerySession]) -> None:
        """Run every open session to completion on the shared engine.
        Attempt 1 of all sessions is submitted together (overlapping
        prefill/decode); failed attempts re-submit in follow-up rounds."""
        open_s = [s for s in sessions if s.execution is None]
        if not open_s:
            return
        self._mode = open_s[-1].mode
        while open_s:
            for s in open_s:
                if s.handle is None:
                    self._start_attempt(s)
            self.client.settle([s.handle for s in open_s])
            self._attribute_steps()
            open_s = [s for s in open_s if not self._finish_attempt(s)]

    def variant_switch_cost(self, variant: str, mode: OperatingMode):
        """(latency, energy) to load the `variant` weights; the engine is
        stalled for the reload, so virtual time advances too."""
        t = self.power_model.model_load_time(
            self.profile.weight_bytes(variant), mode)
        self.clock.advance(t)
        return t, t * self.power_model.power(mode, util=0.5)

    # -- internals -----------------------------------------------------------

    def _start_attempt(self, s: EngineSession):
        """Draw the attempt outcome and submit one engine request covering
        every structured call plus its evaluation pass."""
        s.attempt_no += 1
        s.attempt_ok = self.rng.random() < s.p_success
        s.attempt_calls = (s.n_calls if s.attempt_ok
                           else max(1, s.n_calls // 2))
        new_toks = s.attempt_calls * (self.tokens_per_call + self.eval_tokens)
        s.handle = self.client.submit(SessionRequest(
            prompt=self._prompt_tokens(s.n_tools), max_new_tokens=new_toks,
            eos_id=-1, priority=s.priority, deadline_s=s.deadline_s,
            tier=s.tier))
        s.submit_t = self.clock()
        s.energy_j = 0.0
        s.decode_t = 0.0
        s.stall_t = 0.0
        self._rid_sessions[s.handle.rid] = s

    def _attribute_steps(self):
        """Split each new engine step across the sessions resident in it:
        full duration onto every resident session's decode clock, energy
        divided evenly (a shared step is one power draw serving N users).

        A prefill-kind step (fresh admission, resume re-prefill, or a chunk
        window) stalls every *already-resident* stream for its whole
        duration — `rids` lists only the admitted/advanced requests, so
        splitting over `rids` alone silently dropped the stalled residents'
        share: their latency already ran through the step on the engine
        clock, but their energy (and any stall telemetry) recorded zero.
        `resident_rids` (slot occupancy at step start) closes the gap: the
        stalled residents split the step's energy alongside its owners and
        accrue it as `stall_t`."""
        pm = self.power_model
        for entry in self.engine.step_log[self._log_pos:]:
            rids = entry.get("rids") or []
            owners = [self._rid_sessions[r] for r in rids
                      if r in self._rid_sessions]
            # a spec_verify step is a decode step here: every owner emitted
            decode_like = entry["kind"] in ("decode", "spec_verify")
            stalled = []
            if not decode_like:
                stalled = [self._rid_sessions[r]
                           for r in entry.get("resident_rids") or []
                           if r in self._rid_sessions and r not in rids]
            payers = owners + stalled
            if not payers:
                continue
            util = 0.70 if decode_like else 0.95
            e_share = (entry["dt"] * pm.power(self._mode, util=util)
                       / len(payers))
            for s in payers:
                s.energy_j += e_share
            for s in stalled:
                s.stall_t += entry["dt"]
            if decode_like:
                for s in owners:
                    s.decode_t += entry["dt"]
        self._log_pos = len(self.engine.step_log)

    def _finish_attempt(self, s: EngineSession) -> bool:
        """Fold the finished attempt into the session totals; returns True
        when the session is fully resolved (execution set)."""
        pm = self.power_model
        req = s.handle.request
        self._rid_sessions.pop(s.handle.rid, None)
        s.handle = None
        lat = SELECT_S
        en = SELECT_S * pm.power(s.mode, util=0.3)
        expired = req.status != "done"
        s.tot_qwait += req.queue_wait_s
        s.tot_stall += s.stall_t
        if expired:
            # the deadline lapsed while the query waited (either never
            # admitted, or preempted and its requeue outlived the budget);
            # elapsed latency runs to the deadline, while the final unserved
            # waiting stint (enqueue -> expiry) is added to the queue-wait
            # clock. Keep any energy the attribution pass already assigned.
            s.expired = True
            if s.deadline_s is not None:
                lat += s.deadline_s
            if req.deadline is not None:
                s.tot_qwait += max(0.0, req.deadline - req.enqueue_time)
            en += s.energy_j
        else:
            done_t = req.done_time if req.done_time is not None else \
                self.clock()
            lat += max(0.0, done_t - req.submit_time)
            en += s.energy_j
            s.tot_tok += len(req.output)
            s.tot_dec_t += s.decode_t
            # per call: external tool wait (near-idle) + evaluation re-prefill
            wait = s.attempt_calls * TOOL_EXEC_S
            lat += wait
            en += wait * pm.power(s.mode, util=0.25)
            pe = s.attempt_calls * pm.prefill_time(
                EVAL_PROMPT, self.profile.n_active * 2, s.mode)
            lat += pe
            en += pe * pm.power(s.mode, util=0.95)
            s.tot_wait += wait
        s.tot_lat += lat
        s.tot_en += en
        ok = s.attempt_ok and not expired
        if not ok:
            s.failed += 1
        if ok or s.attempt_no >= 2 or expired:
            # expired attempts fail cleanly and are not retried — the
            # deadline already passed on the engine clock
            s.execution = QueryExecution(
                latency_s=s.tot_lat, energy_j=s.tot_en,
                decode_tokens=s.tot_tok, decode_time_s=s.tot_dec_t,
                exec_time_s=s.tot_lat - s.tot_wait,
                failed_attempts=s.failed, succeeded=ok,
                queue_wait_s=s.tot_qwait, expired=s.expired,
                stall_s=s.tot_stall)
            return True
        return False

    def _prompt_tokens(self, n_tools: int):
        """Tool-description prefix + fresh query suffix. The prefix tokens are
        a pure function of the tool count (deterministic per-toolset rng), so
        repeated queries over the same tools re-send the same prompt prefix —
        the redundancy the engine's prefix cache exists to absorb. The query
        tail stays random per call, like real user queries."""
        V = self.cfg.vocab_size - 2
        prefix_rng = np.random.default_rng(10_000 + n_tools)
        prefix = 2 + prefix_rng.integers(0, V, size=n_tools * TOKENS_PER_TOOL)
        query = 2 + self.rng.integers(0, V, size=QUERY_TOKENS)
        return [int(i) for i in prefix] + [int(i) for i in query]


def make_executor(backend: str, profile: ModelProfile, hw: HardwareSpec, *,
                  seed: int = 0, **engine_kw):
    """Backend factory: "sim" -> analytic SimExecutor, "engine" -> the
    port's ServingEngine-backed executor (on the card unless `device` says
    otherwise)."""
    if backend == "sim":
        from repro_torch.core.executor import SimExecutor
        return SimExecutor(profile, hw, seed=seed)
    if backend == "engine":
        return EngineExecutor(profile, hw, seed=seed, **engine_kw)
    raise ValueError(f"unknown backend {backend!r}; expected 'sim' or 'engine'")
