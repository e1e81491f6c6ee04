"""How far a Mamba2 model's prefill logits move when the kernels stand in for
their plain versions, over several weight and token seeds: mamba2-370m
(the ssd kernel against the plain scan) or the hybrid zamba2-7b (the ssd and
flash-attention kernels against the plain scan and plain attention).

chip_smoke holds one Q8 prefill of 4 x 512 tokens through the kernels
against the same prefill through the plain f32 versions at one seed: within
MAMBA_LOGIT_REL of the batch's largest logit for mamba2-370m, within
HYBRID_LOGIT_REL of each row's for zamba2-7b. This script makes that reading
at every (weight seed, token seed) pair given, and beside it the plain f32
scan in chunks of 64 against the same scan in chunks of 128: the same sums
in another f32 order, so the distance that rounding alone opens over the
model's layers. With `--csrc DIR ...` it also reads the ssd
kernel built from each directory's `ssd.cu` (this checkout's C entry), so
variants of its arithmetic can be told apart. It needs one CUDA card.
mamba2-370m's weights are drawn on a CPU generator (as chip_smoke's phase
5), zamba2-7b's on the card's (as its phase 16).

    PYTHONPATH=src python3 tools/ssd_logit_drift.py [--arch zamba2-7b] \
        [--weight-seeds 0 1 2] [--token-seeds 2 3 4] [--csrc DIR ...]

It reads only `repro_torch.kernels.ssd.ops.ssd` and
`repro_torch.kernels.flash_attention.ops.flash_attention`, so it also runs
against an older checkout's package (PYTHONPATH=<checkout>/src) without
`--csrc`.
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import HYBRID_LOGIT_REL, MAMBA_LOGIT_REL  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-370m",
                    choices=["mamba2-370m", "zamba2-7b"])
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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.models import get_model
    from repro_torch.quant.qtensor import init_quantized
    if not torch.cuda.is_available():
        sys.exit("ssd_logit_drift: needs a CUDA card")
    cfg = get_arch(args.arch)
    hybrid = cfg.family == "hybrid"
    limit = HYBRID_LOGIT_REL if hybrid else MAMBA_LOGIT_REL
    model = get_model(cfg)
    rcfg = RuntimeConfig()
    kernel, flash = ops.ssd, fa_ops.flash_attention

    def plain(rows=None):
        def scan(x, dt, A, Bm, Cm, *, chunk):
            return ssd_chunked(x, dt, A, Bm, Cm, rows or chunk)
        return scan

    def lib_of(csrc):
        return lambda: build.load("ssd", ops.SIGNATURES, csrc=Path(csrc))

    def prefill(params, toks, scan, attn, lib=None):
        ops.ssd, fa_ops.flash_attention = scan, attn
        old_lib = getattr(ops, "_lib", None)
        if lib is not None:
            ops._lib = lib
        try:
            logits, _, _ = model.prefill(params, {"tokens": toks}, rcfg)
        finally:
            ops.ssd, fa_ops.flash_attention = kernel, flash
            if lib is not None:
                ops._lib = old_lib
        return logits.float()

    def reading(name, got, want, scale):
        err = ((got - want).abs().amax(-1, keepdim=True) / scale).max()
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) >= 2 * limit * scale[:, 0]
        same = bool((got.argmax(-1) == want.argmax(-1))[sure].all().item())
        return (f"{name} {err.item():.4f} ({err.item() / limit:.3f} of "
                f"the limit, greedy {'equal' if same else 'DIFFER'} on "
                f"{int(sure.sum())} rows)")

    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} q8 prefill 4 x 512; "
          f"max |logit diff| against the plain f32 scan"
          f"{' and plain attention' if hybrid else ''} unless named, over "
          f"the {'row' if hybrid else 'batch'}'s max |logit| (at least 1); "
          f"limit {limit}", flush=True)
    for ws in args.weight_seeds:
        gen = torch.Generator(device="cuda" if hybrid else "cpu")
        params = init_quantized(model.param_spec(), ("q8",),
                                gen.manual_seed(ws), "cuda")["q8"]
        for ts in args.token_seeds:
            g = torch.Generator().manual_seed(ts)
            toks = torch.randint(2, cfg.vocab_size, (4, 512),
                                 generator=g).cuda()
            ref = prefill(params, toks, plain(), flash_attention_ref)
            scale = ref.abs().amax(-1, keepdim=True).clamp_min(1.0)
            if not hybrid:
                scale = scale.max().expand_as(scale)
            parts = [reading("plain in chunks of 64",
                             prefill(params, toks, plain(64),
                                     flash_attention_ref), ref, scale),
                     reading("kernel", prefill(params, toks, kernel, flash),
                             ref, scale)]
            for d in args.csrc:
                parts.append(reading(os.path.basename(d.rstrip("/")),
                                     prefill(params, toks, kernel, flash,
                                             lib_of(d)), ref, scale))
            print(f"weights {ws} tokens {ts}: max |logit| "
                  f"{[round(v, 2) for v in scale[:, 0].tolist()]}; "
                  + "; ".join(parts), flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
