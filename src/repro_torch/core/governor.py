"""Carbon-aware mode governor (paper §III-E).

From the 24h CI forecast take CI_min/CI_max; map the current CI linearly onto
the mode list (lowest CI -> m1 / highest power, highest CI -> m5 / lowest
power); only change mode when CI has moved >= 10% of the forecast range since
the last change (hysteresis — prevents mode thrash).

Pure logic: no time, no hardware — fully property-testable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.power import OperatingMode


@dataclasses.dataclass
class GovernorState:
    ci_min: float
    ci_max: float
    mode_idx: int                  # 0-based index into the mode list
    last_ci: float


class CarbonGovernor:
    def __init__(self, modes: Sequence[OperatingMode],
                 hysteresis_frac: float = 0.10):
        self.modes = list(modes)
        self.hysteresis_frac = hysteresis_frac

    def init(self, forecast_24h: Sequence[float]) -> GovernorState:
        ci_min = float(min(forecast_24h))
        ci_max = float(max(forecast_24h))
        mid = 0.5 * (ci_min + ci_max)
        return GovernorState(ci_min=ci_min, ci_max=ci_max,
                             mode_idx=self._map(mid, ci_min, ci_max),
                             last_ci=mid)

    def _map(self, ci: float, ci_min: float, ci_max: float) -> int:
        """Linear CI -> mode mapping over [ci_min, ci_max]."""
        n = len(self.modes)
        if ci_max <= ci_min:
            return 0
        frac = (ci - ci_min) / (ci_max - ci_min)
        frac = min(max(frac, 0.0), 1.0)
        idx = int(frac * n)
        return min(idx, n - 1)

    def update(self, state: GovernorState, ci: float,
               forecast_24h: Optional[Sequence[float]] = None) -> GovernorState:
        """Advance one observation. Refreshes the range if a new forecast is
        given; applies the 10%-of-range hysteresis before remapping."""
        ci_min, ci_max = state.ci_min, state.ci_max
        if forecast_24h is not None:
            ci_min = float(min(forecast_24h))
            ci_max = float(max(forecast_24h))
        band = self.hysteresis_frac * (ci_max - ci_min)
        if abs(ci - state.last_ci) < band and ci_min == state.ci_min \
                and ci_max == state.ci_max:
            return dataclasses.replace(state, ci_min=ci_min, ci_max=ci_max)
        return GovernorState(ci_min=ci_min, ci_max=ci_max,
                             mode_idx=self._map(ci, ci_min, ci_max),
                             last_ci=ci)

    def mode(self, state: GovernorState) -> OperatingMode:
        return self.modes[state.mode_idx]

    @staticmethod
    def k_for_mode(mode_idx: int, n_modes: int,
                   k_ladder: Sequence[int]) -> int:
        """Map an operating-mode index onto a speculative draft length.

        High carbon intensity maps to high mode_idx (low power), which maps
        to the *longer* end of the ladder: when the power budget tightens,
        longer Q4 drafts amortize more of the expensive Q8 verify forwards
        per emitted token. mode_idx 0 (clean grid, full power) takes
        k_ladder[0] — typically 0 or 1, since cheap energy removes the
        incentive to speculate. An empty ladder means "not governed" (the
        engine keeps its configured k)."""
        if not k_ladder:
            return 0
        frac = mode_idx / max(n_modes - 1, 1)
        frac = min(max(frac, 0.0), 1.0)
        return int(k_ladder[min(int(frac * len(k_ladder)),
                                len(k_ladder) - 1)])

    def draft_k(self, state: GovernorState, k_ladder: Sequence[int]) -> int:
        """Ladder lookup for the governor's current state (see
        `k_for_mode`)."""
        return self.k_for_mode(state.mode_idx, len(self.modes), k_ladder)
