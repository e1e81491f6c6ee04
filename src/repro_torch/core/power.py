"""Operating modes (paper Table I) and the power/TPS model.

`ORIN_MODES` is the paper's exact Table I: the runtime simulates the board
the paper measured, so its virtual seconds, joules and carbon are those of
the JAX package whatever card serves the model. The JAX package's TPU mode
ladder has no counterpart here; the H100's modes come with its spec
(ROADMAP Queue 1 item 9), and until then `modes_for` refuses any other
board.

TPS/power model (an analytic model: no watts are measured):
  decode is memory-bound:   t_tok = bytes_per_token / (bw_eff * mem_frac)
  prefill is compute-bound: t_tok = 2*N_active / (flops * clock_frac)
  P = P_idle + (P_cap - P_idle) * util, util ~0.9 while executing, bounded by
  the mode's cap.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.common.hardware import HardwareSpec, bytes_per_param


@dataclasses.dataclass(frozen=True)
class OperatingMode:
    index: int                 # m1..m5 (1-based, matches Table I)
    f_cpu: float               # GHz (informational for Orin)
    f_gpu: float               # GHz — scales compute-bound work
    f_mem: float               # GHz — scales memory-bound work
    p_max: float               # W cap


# Paper Table I — NVIDIA AGX Orin.
ORIN_MODES: List[OperatingMode] = [
    OperatingMode(1, 2.2, 1.3, 3.1, 45.0),
    OperatingMode(2, 2.1, 1.2, 3.1, 42.0),
    OperatingMode(3, 1.8, 1.0, 3.1, 37.0),
    OperatingMode(4, 1.6, 0.918, 3.1, 33.0),
    OperatingMode(5, 1.2, 0.714, 3.1, 28.0),
]


def modes_for(hw: HardwareSpec) -> List[OperatingMode]:
    if hw.name == "orin_agx":
        return ORIN_MODES
    raise NotImplementedError(
        f"no operating-mode ladder for {hw.name!r}: the port carries the "
        "Orin's Table I only; other boards' modes come with the launch tail "
        "(ROADMAP Queue 1 item 9)")


@dataclasses.dataclass(frozen=True)
class PowerModel:
    hw: HardwareSpec
    # fraction of peak HBM bandwidth LLM decode actually sustains
    mem_efficiency: float = 0.65
    # fraction of peak FLOPs prefill sustains
    compute_efficiency: float = 0.5
    util_active: float = 0.9

    def _mode_fracs(self, mode: OperatingMode):
        ref = modes_for(self.hw)[0]
        clock = mode.f_gpu / ref.f_gpu
        mem = mode.f_mem / ref.f_mem
        # Decode throughput on Orin-class devices couples substantially to the
        # core clock even though the working set streams from DRAM (dequant +
        # attention math + kernel launch overheads scale with f_GPU; the paper
        # reports "TPS can drop significantly" across Table I). Model the
        # effective decode bandwidth as 30% pure-mem + 70% clock-coupled.
        mem_eff = mem * (0.3 + 0.7 * clock)
        return clock, mem_eff

    def decode_time_per_token(self, active_param_bytes: float,
                              kv_bytes_per_token: float,
                              mode: OperatingMode) -> float:
        _, mem_frac = self._mode_fracs(mode)
        bw = self.hw.hbm_bandwidth * self.mem_efficiency * mem_frac
        return (active_param_bytes + kv_bytes_per_token) / bw

    def prefill_time(self, n_tokens: int, active_params: float,
                     mode: OperatingMode) -> float:
        clock, _ = self._mode_fracs(mode)
        flops = 2.0 * active_params * n_tokens
        return flops / (self.hw.peak_flops * self.compute_efficiency * clock)

    def power(self, mode: OperatingMode, util: float = None) -> float:
        u = self.util_active if util is None else util
        p = self.hw.idle_power + (mode.p_max - self.hw.idle_power) * u
        return min(p, mode.p_max)

    def model_load_time(self, model_bytes: float, mode: OperatingMode) -> float:
        """Variant-switch cost: reload weights through the storage/HBM path."""
        _, mem_frac = self._mode_fracs(mode)
        # loading streams from host/storage at a fraction of HBM bw
        return model_bytes / (0.25 * self.hw.hbm_bandwidth * mem_frac)


def variant_bytes(n_params: float, fmt: str) -> float:
    return n_params * bytes_per_param(fmt)
