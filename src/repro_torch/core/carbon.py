"""Carbon intensity traces, forecasts, and footprint accounting (paper §III-A).

CF = E x CI (Eq. 1). CI traces are synthesized to match the four experimental
weeks in §IV (the real traces are not redistributable):
  week1: 220–610 gCO2/kWh, moderate–high variability   (Fig. 2, Hermes2)
  week2:  70–230, moderate                              (Fig. 3, Llama3.1)
  week3: 350–520, low                                   (Fig. 4, Qwen2)
  week4: 200–620, high                                  (Fig. 5, Qwen2)
Shape: a diurnal solar dip (CI low midday), an evening ramp, weekday/weekend
modulation, plus band-limited noise — the structure CarbonCast [4] forecasts.
The "forecast" used by the governor is truth + noise with an error magnitude
matching multi-day grid forecasting (~5% MAPE).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

HOURS_PER_WEEK = 24 * 7


@dataclasses.dataclass(frozen=True)
class WeekSpec:
    name: str
    ci_min: float
    ci_max: float
    variability: str          # low | moderate | high


WEEKS = {
    "week1": WeekSpec("week1", 220.0, 610.0, "high"),
    "week2": WeekSpec("week2", 70.0, 230.0, "moderate"),
    "week3": WeekSpec("week3", 350.0, 520.0, "low"),
    "week4": WeekSpec("week4", 200.0, 620.0, "high"),
}

_VAR_NOISE = {"low": 0.03, "moderate": 0.08, "high": 0.16}


def _stable_week_seed(week: str) -> int:
    # NOT hash(): Python string hashing is PYTHONHASHSEED-randomized and would
    # make the "ground truth" grid trace differ between processes
    import hashlib
    return int.from_bytes(hashlib.md5(week.encode()).digest()[:2], "little")


def ci_trace(week: str, *, seed: int = 0, step_minutes: int = 10) -> np.ndarray:
    """Ground-truth CI for one week, sampled every `step_minutes`."""
    spec = WEEKS[week]
    rng = np.random.default_rng(seed + _stable_week_seed(week))
    n = HOURS_PER_WEEK * 60 // step_minutes
    t_hours = np.arange(n) * step_minutes / 60.0
    hod = t_hours % 24.0
    # diurnal: solar dip centered 13:00, evening peak ~19:00
    solar = -np.exp(-0.5 * ((hod - 13.0) / 3.0) ** 2)
    evening = 0.7 * np.exp(-0.5 * ((hod - 19.5) / 2.0) ** 2)
    day = np.floor(t_hours / 24.0)
    weekday = 0.15 * np.sin(2 * np.pi * day / 7.0)
    noise_amp = _VAR_NOISE[spec.variability]
    # band-limited noise: smooth random walk
    raw = rng.standard_normal(n)
    kernel = np.exp(-0.5 * (np.arange(-18, 19) / 6.0) ** 2)
    smooth = np.convolve(raw, kernel / kernel.sum(), mode="same")
    base = 0.55 * solar + evening + weekday + noise_amp * 3.0 * smooth
    lo, hi = base.min(), base.max()
    norm = (base - lo) / max(hi - lo, 1e-9)
    return spec.ci_min + norm * (spec.ci_max - spec.ci_min)


def forecast_trace(truth: np.ndarray, *, seed: int = 1,
                   mape: float = 0.05) -> np.ndarray:
    """CarbonCast-style 24h-ahead forecast: truth + smooth multiplicative error."""
    truth = np.asarray(truth, dtype=float)
    if len(truth) == 0:
        return truth.copy()
    rng = np.random.default_rng(seed)
    kernel = np.exp(-0.5 * (np.arange(-30, 31) / 10.0) ** 2)
    # pad so the smoothed error always matches len(truth) ("same" flips the
    # alignment when the trace is shorter than the kernel)
    pad = len(kernel) // 2
    raw = rng.standard_normal(len(truth) + 2 * pad)
    err = np.convolve(raw, kernel / kernel.sum(), mode="valid")
    err = err / (np.abs(err).mean() + 1e-9) * mape
    return truth * (1.0 + err)


def carbon_footprint(energy_joules: float, ci_g_per_kwh: float) -> float:
    """Eq. 1: CF [gCO2] = E [kWh] x CI [gCO2/kWh]."""
    kwh = energy_joules / 3.6e6
    return kwh * ci_g_per_kwh


@dataclasses.dataclass
class CarbonAccountant:
    """Integrates energy and carbon over a run."""
    energy_j: float = 0.0
    carbon_g: float = 0.0
    queries: int = 0

    def record(self, power_w: float, duration_s: float, ci: float):
        e = power_w * duration_s
        self.energy_j += e
        self.carbon_g += carbon_footprint(e, ci)

    def per_query(self) -> Tuple[float, float]:
        q = max(self.queries, 1)
        return self.energy_j / q, self.carbon_g / q
