"""Serving launcher of the port: the CarbonCall runtime on a real model —
tool selection, CI-driven operating modes, and live Q8/Q4 hot-swap on the
serving engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 12
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --queries 3

The port of `repro.launch.serve`, with the same flags plus `--device`: on
the card (the default) it serves `get_arch(--arch)` at full width, its
weights random from seed 0 and drawn on the card; with `--device cpu` it
serves the reduced config on the kernels' plain versions, as the reference
does. With ``--workers N`` the same query stream is served by N worker
PROCESSES behind the engine control protocol (`launch/workers.py`), each
building its own engine from the serialized `EngineConfig` + model config
on the same device; queries go round-robin across them as `SessionRequest`
wire payloads, and telemetry comes back as versioned `EngineStats`.

The governor, the switcher and the carbon lines read no tokens, so for the
same flags the `total carbon` line and the variant switches are the
reference launcher's.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.hardware import ORIN_AGX
from repro_torch.common.registry import get_arch
from repro_torch.config import RuntimeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.core import (ORIN_MODES, CarbonGovernor, ToolSelector,
                              VariantSwitcher, carbon_footprint, ci_trace,
                              forecast_trace)
from repro_torch.core.power import PowerModel
from repro_torch.data.workload import FunctionCallWorkload, build_catalog
from repro_torch.serving import (EngineConfig, EngineStats, ServingEngine,
                                 SessionRequest, WorkerSpec)


def _prompt_for(text: str, vocab_size: int):
    return [2 + (int.from_bytes(hashlib.md5(w.encode()).digest()[:4],
                                'little') % (vocab_size - 2))
            for w in text.lower().split()][:24]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="carboncall-qwen2-7b")
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--minutes-per-query", type=float, default=30.0)
    ap.add_argument("--week", default="week1")
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--workers", type=int, default=0,
                    help="serve through N worker processes behind the "
                         "control protocol (0 = in-process engine)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: full width on the card; cpu: the reduced "
                         "config on the kernels' plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "serve")
    cfg = get_arch(args.arch)
    if device.type == "cpu":
        cfg = reduce_config(cfg)
    econfig = EngineConfig(max_batch=4, max_seq=128)
    workers = []
    client = None
    if args.workers > 0:
        from repro_torch.launch.workers import launch_workers
        specs = [WorkerSpec(config=econfig,
                            model_cfg=dataclasses.asdict(cfg), seed=w,
                            label=f"serve-w{w}")
                 for w in range(args.workers)]
        workers = launch_workers(specs, device=device)
        print(f"[serve] {len(workers)} worker process(es) ready")
    else:
        from repro_torch.models import get_model
        from repro_torch.quant.qtensor import init_quantized
        gen = torch.Generator(device=device).manual_seed(0)
        variants = init_quantized(get_model(cfg).param_spec(), ("q8", "q4"),
                                  gen, device)
        engine = ServingEngine(cfg, variants["q8"], RuntimeConfig(),
                               config=econfig, device=device)
        engine.variant_name = "q8"
        client = engine.client()

    cat = build_catalog(64, seed=0)
    selector = ToolSelector(cat, device=device)
    workload = FunctionCallWorkload(cat, seed=7)
    governor = CarbonGovernor(ORIN_MODES)
    switcher = VariantSwitcher(window_s=600.0)
    pm = PowerModel(ORIN_AGX)

    ci = ci_trace(args.week, seed=0)
    fc = forecast_trace(ci)
    state = governor.init(fc[:144])
    switcher.set_reference(20.0)

    total_cf = 0.0
    t_virtual = 0.0
    try:
        for qi in range(args.queries):
            idx = int(t_virtual // 600) % len(ci)
            state = governor.update(state, float(ci[idx]))
            mode = governor.mode(state)
            q = workload.sample()
            sel = selector.select(q.text)
            # serve a real request through the engine / a worker
            sreq = SessionRequest(prompt=_prompt_for(q.text, cfg.vocab_size),
                                  max_new_tokens=args.max_new_tokens,
                                  eos_id=-1)
            if workers:
                w = workers[qi % len(workers)]
                res = w.settle([w.submit(sreq)])[0]
                tokens = len(res.output)
                tps = w.stats().decode_tps
            else:
                h = client.submit(sreq)
                client.settle([h])
                tokens = len(h.request.output)
                tps = client.engine.recent_tps()
            # TPS model at this mode feeds the switcher (host time is not
            # Orin TPS; scale by the mode ladder)
            mode_tps = 20.0 * (0.3 + 0.7 * mode.f_gpu / ORIN_MODES[0].f_gpu) \
                * (1.9 if switcher.variant == "q4" else 1.0)
            switcher.observe(t_virtual, mode_tps)
            dec = switcher.decide(t_virtual)
            if dec.switch_to:
                switcher.apply(t_virtual, dec)
                if workers:
                    for w in workers:
                        w.call("swap", variant=switcher.variant)
                else:
                    client.engine.swap_params(variants[switcher.variant],
                                              switcher.variant)
                print(f"  >> variant switch -> {switcher.variant} "
                      f"({dec.reason})")
            exec_s = args.max_new_tokens / mode_tps
            energy = pm.power(mode) * exec_s
            cf = carbon_footprint(energy, float(ci[idx]))
            total_cf += cf
            print(f"[serve] q{qi:02d} ci={ci[idx]:.0f} mode=m{mode.index} "
                  f"variant={switcher.variant} tools={sel.tool_ids[:4]} "
                  f"tokens={tokens} engine_tps={tps:.1f} "
                  f"cf={cf*1000:.1f} mgCO2")
            t_virtual += args.minutes_per_query * 60.0
        print(f"[serve] total carbon: {total_cf*1000:.1f} mgCO2 over "
              f"{args.queries} queries")
        if workers:
            agg = EngineStats.merge([w.stats() for w in workers])
            print(f"[serve] fleet stats v{agg.schema_version}: "
                  f"admitted={agg.admitted} tokens={agg.tokens_emitted} "
                  f"swaps={agg.swap_count}")
    finally:
        for w in workers:
            w.close()


if __name__ == "__main__":
    main()
