"""Mixed-quality variant switching (paper §III-D/E).

Start on Q8. Maintain a moving-average TPS over a 10-minute window; if the
average drops below 80% of the initial (reference) TPS, switch to Q4_K_M;
switch back to Q8 when the average recovers above the threshold with the Q8
projection. The windowed average is the paper's anti-"pendulum" mechanism —
a switch decision is only made from >= window-length evidence, and the switch
cost (weight reload) is charged to the runtime.

Pure logic over (timestamp, tps) observations; no wall clock inside.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional, Tuple

VARIANTS = ("q8", "q4")


@dataclasses.dataclass
class SwitchDecision:
    switch_to: Optional[str]        # None = stay
    reason: str
    avg_tps: float


class VariantSwitcher:
    def __init__(self, *, window_s: float = 600.0, threshold: float = 0.80,
                 q4_speedup: float = 1.9):
        """q4_speedup: expected TPS ratio q4/q8 (bytes ratio ~1.9 for
        weight-bound decode) — used to project recovery headroom."""
        self.window_s = window_s
        self.threshold = threshold
        self.q4_speedup = q4_speedup
        self.variant = "q8"
        self.ref_tps: Optional[float] = None      # initial Q8 TPS reference
        self.obs: Deque[Tuple[float, float]] = deque()
        self._last_switch_t: Optional[float] = None

    def set_reference(self, tps: float):
        """Deployment-time calibration: the initial (m1, Q8) TPS the 80%
        threshold is measured against (paper: 'the initial value')."""
        self.ref_tps = tps

    def observe(self, t: float, tps: float):
        self.obs.append((t, tps))
        while self.obs and self.obs[0][0] < t - self.window_s:
            self.obs.popleft()
        if self.ref_tps is None and self.variant == "q8":
            self.ref_tps = tps

    def window_avg(self) -> float:
        if not self.obs:
            return 0.0
        return sum(v for _, v in self.obs) / len(self.obs)

    def window_full(self, t: float) -> bool:
        return bool(self.obs) and (t - self.obs[0][0]) >= self.window_s * 0.95

    def decide(self, t: float) -> SwitchDecision:
        avg = self.window_avg()
        if self.ref_tps is None or not self.window_full(t):
            return SwitchDecision(None, "warmup", avg)
        floor = self.threshold * self.ref_tps
        if self.variant == "q8" and avg < floor:
            return SwitchDecision("q4", f"avg {avg:.1f} < {floor:.1f}", avg)
        if self.variant == "q4":
            # project what Q8 would deliver now; return when it clears the bar
            q8_proj = avg / self.q4_speedup
            if q8_proj >= floor:
                return SwitchDecision("q8", f"q8 proj {q8_proj:.1f} >= {floor:.1f}", avg)
        return SwitchDecision(None, "stable", avg)

    def apply(self, t: float, decision: SwitchDecision):
        if decision.switch_to and decision.switch_to != self.variant:
            self.variant = decision.switch_to
            self._last_switch_t = t
            self.obs.clear()            # restart evidence window post-switch
