"""Hand-written Hopper kernels (CUDA C++ under `csrc/`, built by
`kernels/build.py`) with their plain PyTorch versions beside them.

Every wrapper dispatches on the device of its inputs: a CUDA tensor launches
the kernel (or raises — there is no fallback), a CPU tensor takes the plain
version. `LAUNCHES` counts kernel launches per wrapper, raised only where a
kernel was actually launched, so a run can show that its main path went
through the kernels."""
from typing import Dict

KERNELS = ("q8_matmul", "q4_matmul", "paged_attention", "flash_attention",
           "sim_scores", "ssd_bshp")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
