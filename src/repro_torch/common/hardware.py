"""Hardware specifications for the power model and the virtual clock.

`ORIN_AGX` is the Jetson AGX Orin the paper measured: the runtime's power
model (`core/power.py`) and the engine executor's virtual clock price every
query on it, so the port's seconds, joules and carbon are the same
calibrated quantities as the JAX package's, whatever card runs the model.
The JAX package's TPU spec has no counterpart here; the H100's spec comes
with the launch tail (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    # Peak compute in FLOP/s for the "native" matmul dtype.
    peak_flops: float
    # Additional peak for int8 (Orin uses DLA/tensor cores).
    peak_flops_int8: float
    hbm_bandwidth: float        # bytes/s
    hbm_capacity: float         # bytes per chip
    ici_bandwidth: float        # bytes/s per link (intra-pod)
    dcn_bandwidth: float        # bytes/s per host (inter-pod)
    vmem_capacity: float        # bytes (on-chip memory / L2-equivalent)
    idle_power: float           # W per chip, clock-gated floor
    peak_power: float           # W per chip at 100% duty


# Jetson AGX Orin 64GB (paper's board). LLM decode on Orin is bound by the
# 204.8 GB/s LPDDR5 bus; ~85 TFLOP/s dense bf16-equivalent on the Ampere iGPU.
ORIN_AGX = HardwareSpec(
    name="orin_agx",
    peak_flops=85e12 / 2,          # fp16 tensor-core dense (sparse figure halved)
    peak_flops_int8=85e12,
    hbm_bandwidth=204.8e9,
    hbm_capacity=64e9,
    ici_bandwidth=0.0,
    dcn_bandwidth=10e9 / 8,
    vmem_capacity=4 * 2**20,
    idle_power=15.0,
    peak_power=45.0,               # MAXN power budget counterpart of Table I m1
)


def bytes_per_param(fmt: str) -> float:
    """Storage bytes per weight for each variant format.

    q4 matches Q4_K_M-style packing: 4-bit weights + per-group (g=128)
    fp16 scale and min -> 4/8 + 4/128 bytes overhead per weight.
    q8 is int8 + per-channel scale (amortized ~0).
    """
    return {
        "bf16": 2.0,
        "fp32": 4.0,
        "q8": 1.0 + 2.0 / 256.0,
        "q4": 0.5 + 4.0 / 128.0,
    }[fmt]
