"""Host cost of drawing a model's random weights on a CPU generator, against
drawing them on the card.

A CPU generator gives the same weights for a seed on the CPU and on the card;
a CUDA generator is faster but draws other numbers. This script times both
for one model's Q8 + Q4 trees (drawn leaf by leaf, quantized on the card, as
`quant.init_quantized` does) and scales both rates to a second, larger model
by the number of values its init draws. It needs one CUDA card.

    PYTHONPATH=src python3 tools/weight_draw_cost.py \
        [--arch mamba2-370m] [--scale-to carboncall-qwen2-7b]
"""
import argparse
import math
import subprocess
import sys
import time


def drawn_values(spec) -> int:
    """Random values a tree's init draws (zeros and ones are not drawn)."""
    from repro_torch.common.tree import tree_map
    counts = []
    tree_map(lambda d: counts.append(
        0 if d.init in ("zeros", "ones") else math.prod(d.shape)), spec)
    return sum(counts)


def timed_draw(spec, generator) -> float:
    import torch
    from repro_torch.quant.qtensor import init_quantized
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trees = init_quantized(spec, ("q8", "q4"), generator, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del trees
    torch.cuda.empty_cache()
    return seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--scale-to", default="carboncall-qwen2-7b")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("weight_draw_cost: needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    from repro_torch.common.registry import get_arch
    from repro_torch.models import get_model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    spec = get_model(get_arch(args.arch)).param_spec()
    n = drawn_values(spec)
    big = drawn_values(get_model(get_arch(args.scale_to)).param_spec())
    timed_draw(spec, torch.Generator(device="cuda"))     # warm-up
    cpu_s = timed_draw(spec, torch.Generator().manual_seed(0))
    card_s = timed_draw(spec, torch.Generator(device="cuda").manual_seed(0))
    print(f"{args.arch}: {n / 1e6:.1f} M values drawn, q8+q4 quantized on "
          f"the card; drawn on the CPU {cpu_s:.2f} s, on the card "
          f"{card_s:.2f} s (host clock, sync included)")
    print(f"{args.scale_to}: {big / 1e9:.2f} G values; at these rates "
          f"~{cpu_s * big / n:.0f} s from the CPU against "
          f"~{card_s * big / n:.0f} s on the card")


if __name__ == "__main__":
    main()
