"""How far the mamba2-370m prefill's logits move when the ssd kernel stands in
for the plain scan, over several weight and token seeds.

chip_smoke holds one Q8 prefill of 4 x 512 tokens through the kernel against
the same prefill through the plain f32 scan (`ssd_chunked`), at one seed,
within MAMBA_LOGIT_REL of the largest logit. This script makes that reading
at every (weight seed, token seed) pair given, and beside it the plain f32
scan in chunks of 64 against the same scan in chunks of 128: the same sums
in another f32 order, so the distance that rounding alone opens over the
model's 48 layers. With `--csrc DIR ...` it also reads the
kernel built from each directory's `ssd.cu` (this checkout's C entry), so
variants of its arithmetic can be told apart. It needs one CUDA card.

    PYTHONPATH=src python3 tools/ssd_logit_drift.py \
        [--weight-seeds 0 1 2] [--token-seeds 2 3 4] [--csrc DIR ...]

It reads only `repro_torch.kernels.ssd.ops.ssd`, so it also runs against an
older checkout's package (PYTHONPATH=<checkout>/src) without `--csrc`.
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import MAMBA_LOGIT_REL  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weight-seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--token-seeds", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--csrc", nargs="+", default=[], metavar="DIR",
                    help="directories, each with an ssd.cu of this "
                         "checkout's C entry, to read beside it")
    args = ap.parse_args()
    import torch
    from repro_torch.common.registry import get_arch
    from repro_torch.config import RuntimeConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.models import get_model
    from repro_torch.quant.qtensor import init_quantized
    if not torch.cuda.is_available():
        sys.exit("ssd_logit_drift: needs a CUDA card")
    cfg = get_arch("mamba2-370m")
    model = get_model(cfg)
    rcfg = RuntimeConfig()
    kernel = ops.ssd

    def plain(rows=None):
        def scan(x, dt, A, Bm, Cm, *, chunk):
            return ssd_chunked(x, dt, A, Bm, Cm, rows or chunk)
        return scan

    def lib_of(csrc):
        return lambda: build.load("ssd", ops.SIGNATURES, csrc=Path(csrc))

    def prefill(params, toks, scan, lib=None):
        ops.ssd = scan
        old_lib = getattr(ops, "_lib", None)
        if lib is not None:
            ops._lib = lib
        try:
            logits, _, _ = model.prefill(params, {"tokens": toks}, rcfg)
        finally:
            ops.ssd = kernel
            if lib is not None:
                ops._lib = old_lib
        return logits.float()

    def reading(name, got, want, scale):
        err = (got - want).abs().max().item()
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) >= 2 * MAMBA_LOGIT_REL * scale
        same = bool((got.argmax(-1) == want.argmax(-1))[sure].all().item())
        return (f"{name} {err:.4f} ({err / (MAMBA_LOGIT_REL * scale):.3f} of "
                f"the limit, greedy {'equal' if same else 'DIFFER'} on "
                f"{int(sure.sum())} rows)")

    print(f"{torch.cuda.get_device_name(0)}; mamba2-370m q8 prefill 4 x 512; "
          f"max |logit diff| against the plain f32 scan unless named; limit "
          f"{MAMBA_LOGIT_REL} of max |logit|", flush=True)
    for ws in args.weight_seeds:
        params = init_quantized(model.param_spec(), ("q8",),
                                torch.Generator().manual_seed(ws),
                                "cuda")["q8"]
        for ts in args.token_seeds:
            g = torch.Generator().manual_seed(ts)
            toks = torch.randint(2, cfg.vocab_size, (4, 512),
                                 generator=g).cuda()
            ref = prefill(params, toks, plain())
            scale = max(1.0, ref.abs().max().item())
            parts = [reading("plain in chunks of 64",
                             prefill(params, toks, plain(64)), ref, scale),
                     reading("kernel", prefill(params, toks, kernel), ref,
                             scale)]
            for d in args.csrc:
                parts.append(reading(os.path.basename(d.rstrip("/")),
                                     prefill(params, toks, kernel, lib_of(d)),
                                     ref, scale))
            print(f"weights {ws} tokens {ts}: max |logit| {scale:.2f}; "
                  + "; ".join(parts), flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
