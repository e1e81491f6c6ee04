"""Preemptive session scheduler for the serving engine.

The port's copy of `repro.serving.scheduler` (framework-free, kept line for
line so both engines admit, preempt and expire in the same order).

This module owns the *policy* side of the async session API: a priority
waiting queue, deadline expiry, and the preemption bookkeeping that replaced
PR 2's eager decode-growth block reserve. The `ServingEngine` owns slots and
blocks (the mechanism); it consults the scheduler for WHO runs next and WHO
gets evicted when the paged block pool is under pressure.

Lifecycle of a request::

    submit -> WAITING -> RUNNING -> DONE
                 ^          |
                 |          +--> CANCELLED   (handle.cancel() mid-stream)
                 +--- preempt (requeued with saved tokens; resumes with an
                 |    exact-position re-prefill, so temperature-0 streams are
                 |    identical to an unpreempted run)
                 +--> EXPIRED   (deadline passed while waiting — including a
                      preempted victim whose requeue outlived its budget)

Queue order is earliest-deadline-first *within* a priority class: priority
strictly dominates (a batch request never jumps an interactive one however
tight its deadline), and inside one class the request closest to expiry runs
next — the ordering that maximizes deadline-hit rate for tiered traffic.
Deadline-free requests sort last in their class, FIFO among themselves.

The deadline is an absolute engine-clock timestamp (submit + deadline_s):
a request found WAITING past it fails with a clean EXPIRED. Admission does
not clear it, so a preempted victim carries its original deadline back into
the queue and expires (saved tokens dropped, nothing decoded further) when
its requeue lands past the budget. A RUNNING request is never killed —
`expire_due` only scans the waiting queue — so a stream that stays admitted
finishes regardless of how long it decodes.

Preemption policy: the victim is the lowest-priority active slot, ties broken
toward the most recently admitted (LIFO, vLLM-style). Admission only preempts
*strictly* lower-priority victims on behalf of the queue head — equal-priority
work never preempts itself, so FIFO workloads behave exactly like a
non-preemptive queue. Mid-decode pool exhaustion may preempt any slot
(including the requester, when other slots can still make progress).

Per-tier telemetry: requests carry a `tier` label (QoS class name; "default"
when untiered); the scheduler keeps per-tier counters (submitted / admitted /
preempted / expired / cancelled / done) and completion-latency percentiles,
surfaced through `ServingEngine.scheduler_stats()["tiers"]`.

`RequestHandle` is the user-facing side: `poll()` (non-blocking status),
`result()` (step the engine until terminal), `cancel()`. Handles are created
by `EngineClient.submit` / `ServingEngine.submit`.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (engine -> scheduler)
    from repro_torch.serving.engine import Request, ServingEngine


# request lifecycle states
WAITING = "waiting"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
EXPIRED = "expired"
TERMINAL = (DONE, CANCELLED, EXPIRED)


class EngineStallError(RuntimeError):
    """`run_until_drained` exhausted its step budget with work still queued
    or resident — a silent partial result would masquerade as completion."""


class PoolExhaustedError(EngineStallError):
    """The paged KV block pool cannot make progress: no request can be
    admitted (idle engine) or grown (mid-decode) even after cache eviction
    and preemption. Carries the queue depth and pool occupancy at the point
    of failure so fleet/soak callers can report actionable sizing errors.
    Subclasses `EngineStallError` so both stall shapes are handled uniformly.
    """

    def __init__(self, msg: str, *, waiting: int = 0, free_blocks: int = 0):
        super().__init__(
            f"{msg} (waiting={waiting}, free_blocks={free_blocks})")
        self.waiting = waiting
        self.free_blocks = free_blocks


class DeadlineExpiredError(RuntimeError):
    """`result()` called on a request whose deadline passed while waiting."""


class RequestCancelledError(RuntimeError):
    """`result()` called on a cancelled request."""


@dataclasses.dataclass
class SessionRequest:
    """User-facing request spec for `EngineClient.submit`.

    `priority`: larger runs first (and may preempt strictly smaller).
    `deadline_s`: service-level budget in engine-clock seconds from submit;
    a request found *waiting* past it (never admitted, or preempted and
    requeued past the budget) fails cleanly with status EXPIRED. A running
    stream is never killed by its deadline.
    `tier`: QoS class label for per-tier scheduler telemetry.
    """
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: int = 1
    temperature: float = 0.0
    priority: int = 0
    deadline_s: Optional[float] = None
    tier: str = "default"


class RequestHandle:
    """Async handle onto one engine request: poll / result / cancel."""

    def __init__(self, engine: "ServingEngine", req: "Request"):
        self.engine = engine
        self.request = req

    @property
    def rid(self) -> int:
        return self.request.rid

    def poll(self) -> str:
        """Current lifecycle state (non-blocking)."""
        return self.request.status

    def done(self) -> bool:
        return self.request.status in TERMINAL

    def result(self, *, max_steps: int = 100_000) -> "Request":
        """Step the engine until this request is terminal, then return it.
        Raises DeadlineExpiredError / RequestCancelledError for requests that
        did not finish, and EngineStallError if the step budget runs out."""
        req = self.request
        for _ in range(max_steps):
            if req.status in TERMINAL:
                break
            self.engine.step()
        if req.status not in TERMINAL:
            raise EngineStallError(
                f"request {req.rid} not terminal after {max_steps} steps "
                f"(active={self.engine.active}, "
                f"waiting={len(self.engine.pending)})")
        if req.status == EXPIRED:
            raise DeadlineExpiredError(
                f"request {req.rid} expired after waiting past its deadline")
        if req.status == CANCELLED:
            raise RequestCancelledError(f"request {req.rid} was cancelled")
        return req

    def cancel(self) -> bool:
        """Cancel a waiting or running request; frees its slot and blocks.
        Returns False if the request already reached a terminal state."""
        return self.engine.cancel(self.request)


class Scheduler:
    """Priority waiting queue + preemption policy + counters for one engine.

    Queue order is (-priority, deadline, submission seq): priority strictly
    dominates, the earliest deadline runs first within a class (EDF), and
    deadline-free requests sort last in their class by submission order. A
    preempted request keeps its original seq, so among equally-deadlined
    same-priority peers it resumes before newer arrivals.
    """

    def __init__(self):
        self._order: List[Tuple[int, float, int]] = []   # sort keys
        self._queue: List["Request"] = []                # parallel to _order
        self._seq = 0
        # counters (surfaced via ServingEngine.scheduler_stats())
        self.admitted = 0
        self.preemptions = 0
        self.requeues = 0
        self.expired = 0
        self.cancelled = 0
        self.queue_wait_s = 0.0
        self.chunk_steps = 0        # non-final chunked-prefill steps run
        self.chunk_drops = 0        # partial prefills released un-admitted
        self.spec_steps = 0         # speculative draft+verify decode steps
        self._tiers: Dict[str, Dict] = {}

    # -- per-tier telemetry --------------------------------------------------

    def _tier(self, req: "Request") -> Dict:
        name = getattr(req, "tier", "default") or "default"
        t = self._tiers.get(name)
        if t is None:
            t = self._tiers[name] = {
                "submitted": 0, "admitted": 0, "preempted": 0, "expired": 0,
                "cancelled": 0, "done": 0, "latencies": []}
        return t

    def note_preempted(self, req: "Request"):
        """Count a preemption against the victim's tier (the engine calls
        this right before `requeue`)."""
        self.preemptions += 1
        self._tier(req)["preempted"] += 1

    def note_done(self, req: "Request", now: float):
        """Record a completion and its end-to-end latency for the tier's
        percentiles (now = the engine-clock instant the stream finished)."""
        t = self._tier(req)
        t["done"] += 1
        t["latencies"].append(max(0.0, now - req.submit_time))

    def note_cancelled(self, req: "Request"):
        self.cancelled += 1
        self._tier(req)["cancelled"] += 1

    def note_chunk_step(self, req: "Request"):
        """Count one non-final chunked-prefill step (the request stays
        WAITING at the queue head; its partial KV is parked in the pool)."""
        self.chunk_steps += 1

    def note_chunk_dropped(self, req: "Request"):
        """Count a partial prefill released before admission (cancel, expiry,
        hot swap, or pool pressure dropping a parked chain)."""
        self.chunk_drops += 1

    def note_spec_step(self):
        """Count one speculative decode step (k drafts + one batched verify
        — a single scheduler unit, like a plain decode step)."""
        self.spec_steps += 1

    # -- queue ---------------------------------------------------------------

    @property
    def waiting(self) -> List["Request"]:
        return list(self._queue)

    def has_waiting(self) -> bool:
        return bool(self._queue)

    def _push(self, req: "Request"):
        dl = req.deadline if req.deadline is not None else float("inf")
        key = (-req.priority, dl, req.seq)
        i = bisect.bisect_right(self._order, key)
        self._order.insert(i, key)
        self._queue.insert(i, req)

    def enqueue(self, req: "Request", now: float):
        """First submission: stamp times/seq and queue by priority/EDF."""
        req.status = WAITING
        req.submit_time = now
        req.enqueue_time = now
        req.seq = self._seq
        self._seq += 1
        self._tier(req)["submitted"] += 1
        self._push(req)

    def requeue(self, req: "Request", now: float):
        """Re-queue a preempted request (keeps its original seq and its
        deadline: the resume must still land inside the original budget)."""
        req.status = WAITING
        req.enqueue_time = now
        self.requeues += 1
        self._push(req)

    def head(self) -> Optional["Request"]:
        return self._queue[0] if self._queue else None

    def remove(self, req: "Request") -> bool:
        try:
            i = self._queue.index(req)
        except ValueError:
            return False
        self._queue.pop(i)
        self._order.pop(i)
        return True

    def note_admitted(self, req: "Request", now: float):
        self.remove(req)
        req.status = RUNNING
        # the deadline is NOT cleared: it stays as the absolute budget, so a
        # preempted request requeued past it expires instead of resuming. A
        # RUNNING stream can still never expire — expire_due only scans the
        # waiting queue.
        self.admitted += 1
        self._tier(req)["admitted"] += 1
        wait = max(0.0, now - req.enqueue_time)
        req.queue_wait_s += wait
        self.queue_wait_s += wait

    def expire_due(self, now: float) -> List["Request"]:
        """Fail (cleanly) every waiting request whose deadline has passed —
        including preempted victims, whose saved resume state is dropped."""
        due = [r for r in self._queue
               if r.deadline is not None and now > r.deadline]
        for req in due:
            self.remove(req)
            req.status = EXPIRED
            req.resume_row = None        # never decoded further
            self.expired += 1
            self._tier(req)["expired"] += 1
        return due

    # -- preemption policy ---------------------------------------------------

    @staticmethod
    def pick_victim(active: Sequence[Tuple[int, "Request"]], *,
                    below: Optional[int] = None) -> Optional[int]:
        """Choose the slot to preempt among `(slot, request)` pairs: lowest
        priority first, most recently admitted on ties. With `below`, only
        strictly-lower-priority victims qualify (admission preemption must
        never preempt an equal — that way FIFO traffic is never disturbed)."""
        pool = [(r.priority, -r.admit_seq, s) for s, r in active
                if below is None or r.priority < below]
        if not pool:
            return None
        return min(pool)[2]

    def tier_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tier counters + completion-latency percentiles."""
        out: Dict[str, Dict[str, float]] = {}
        for name, t in self._tiers.items():
            lats = sorted(t["latencies"])

            def pct(q):
                # ceil-based nearest-rank: the smallest sample >= the
                # requested quantile. `round` used banker's rounding, which
                # skewed small samples low (p50 of 2 returned the min).
                if not lats:
                    return 0.0
                return float(lats[min(len(lats) - 1,
                                      math.ceil(q * (len(lats) - 1)))])
            out[name] = {k: v for k, v in t.items() if k != "latencies"}
            out[name]["p50_latency_s"] = round(pct(0.50), 6)
            out[name]["p95_latency_s"] = round(pct(0.95), 6)
        return out

    def stats(self) -> Dict[str, float]:
        return {"admitted": self.admitted,
                "preemptions": self.preemptions,
                "requeues": self.requeues,
                "expired": self.expired,
                "cancelled": self.cancelled,
                "chunk_steps": self.chunk_steps,
                "chunk_drops": self.chunk_drops,
                "spec_steps": self.spec_steps,
                "queue_wait_s": round(self.queue_wait_s, 6),
                "waiting": len(self._queue),
                "tiers": self.tier_stats()}
