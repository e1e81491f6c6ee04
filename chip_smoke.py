"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # build, check every kernel, serve, run
    python3 chip_smoke.py --flash-baseline DIR   # and time DIR's older
                                     # flash_attention.cu at the serve cases
    python3 chip_smoke.py --paged-baseline DIR [DIR ...]  # and time each
                                     # DIR's paged_attention.cu at its cases

Phases, each raising on its first fault (the script then exits non-zero):
  1. device  — the card's name and power limit (nvidia-smi), capability 9.0;
  2. build   — every CUDA source under src/repro_torch/csrc built at once
               with nvcc for sm_90a; the ptxas register/spill lines (the
               quant-matmul, flash-attention, paged-attention and ssd
               kernels must not spill) and the tensor-core instructions
               (HMMA, HGMMA) in each of their kernels' SASS;
  3. kernels — each hand-written kernel against its plain PyTorch version on
               the same inputs at the serving path's shapes, with its time
               (CUDA events; device time from the profiler where the host's
               launch path would set the events' number), its bound and a
               library call's time;
  4. serve   — full-width carboncall-qwen2-7b (random weights from a seed,
               quantized on the card leaf by leaf) served by the paged engine:
               8 temperature-0 requests, half sharing a 32-token prefix, a
               Q8 -> Q4 hot swap halfway, then the same requests on an int8-KV
               engine. Each engine's run is a main path of its own: the
               launch counters are set to 0 just before it and read just
               after, and every kernel that path runs must have launched; no
               step may fall back, and the invariant sweep must be clean.
               Then a decode step's time per variant and KV type (CUDA
               events, profiler breakdown with the paged kernel's launches
               and share) and a cold Q8 prefill of 4 x 64 and 4 x 256
               tokens with the flash kernel's share of its device time.
  5. serve_mamba2 — full-width mamba2-370m (random weights drawn from a seed
               on the CPU, quantized on the card leaf by leaf) served by the
               dense engine (`kv_layout="auto"`): 8 temperature-0 requests
               of 8 new tokens with prompts of 32-300 tokens (buckets up to
               512, so the scan crosses chunk boundaries) and a Q8 -> Q4 hot
               swap halfway. A main path of its own: counters set to 0 just
               before, read just after; ssd_bshp, q8_matmul and q4_matmul
               must launch, no step may fall back, every logits row must be
               finite and the invariant sweep clean. Then one decode step's
               time and one S = 512 prefill's time (CUDA events), and that
               prefill's logits through the kernel against the same prefill
               through the plain scan.
  6. runtime — the CarbonCall runtime end to end on the card: `run_week` over
               a carbon-intensity ramp (clean grid, then 900 gCO2/kWh) with
               the carboncall policy; tool selection (`ToolSelector`, its
               index on the card) retrieves through the sim_scores kernel,
               the governor drops into the low-power modes, the switcher
               swaps Q8 -> Q4 live, and `EngineExecutor` serves every query
               on full-width carboncall-qwen2-7b. Counters are set to 0 just
               before the run and read just after: sim_scores must launch
               once per retrieval and the four model kernels must launch; no
               step may fall back, the invariant sweep must be clean, every
               record must have tps > 0 and both variants must appear.
               Seconds, joules and carbon of the records come from the
               virtual clock and the Orin power model, not from the card.
  7. serve_spec_chunk — chunked prefill and speculative decoding at full
               width on carboncall-qwen2-7b (random weights from seed 0,
               quantized on the card), four main paths, each with its
               launch counters set to 0 just before it and read just after,
               and no step falling back:
               chunked — max_batch 4, max_seq 2048, buckets up to 1024,
               `prefill_chunk=256`: two 40-token requests decode while a
               700- and a 900-token request admit in windows, then one
               sharing the 900-token prompt's first 512 tokens hits the
               prefix cache; a Q8 -> Q4 swap once it has 8 tokens. The kinds
               must alternate (no prefill-kind step after a prefill-kind
               step while requests are resident), the four model kernels
               must launch, and the Q8 tokens must equal an unchunked
               engine's up to each stream's first top-2 margin below
               MARGIN_BOUND;
               spec bf16 / int8 KV — max_batch 4, max_seq 256, Q8 drafting
               with Q4 at k 2, k 4 from step SPEC_K4_AT, a swap to Q4 at
               SPEC_SWAP_AT after which no step may draft; 8 requests of 32
               tokens, half sharing a 32-token prefix. spec_steps, draft and
               accepted tokens, q8/q4/paged launches, the Q8 tokens against
               plain Q8 by the same rule;
               runtime spec+chunk — `run_week` over 4 ten-minute steps (100,
               then 900 gCO2/kWh) with `EngineConfig(max_batch=2,
               prefill_chunk=64, spec_decode=SpecDecodeConfig("q4", k=2,
               k_ladder=(1, 2, 4)))`: two draft lengths or more, spec and
               chunk steps, sim_scores once per retrieval.
               Times (CUDA events over whole steps, the card's name and
               limit from phase 1): the residents' longest gap between two
               tokens chunked against monolithic, a window step and one
               256-token window of the model alone (with its kernels' busy
               time), and tokens a second at batch 4 for plain Q8 against
               spec at k 2 and k 4, with the acceptance rate.
  8. serve_dense — full-width carboncall-qwen2-7b (random weights from seed
               0, quantized on the card) on `kv_layout="dense"`, three main
               paths, each with its counters set to 0 just before it and
               read just after, no step falling back and the invariant sweep
               clean: phase 4's 8 requests (8 new tokens) with a Q8 -> Q4
               swap at step DENSE_SWAP_AT on bf16 KV, then on int8 KV
               without a swap, each taking the paged engine's steps and,
               teacher-forced onto the paged engine's tokens on the same
               weights, every Q8 row within ENGINE_LOGIT_REL (Q8 tokens by
               the margin rule); then phase 7's chunked run on the dense
               layout against the dense monolithic one (windows of 256,
               max_seq 2048), with the residents' longest token gap both
               ways. The paged kernel must not launch on these paths. Then
               a decode step at batch 4 for Q8 and Q4 on bf16 KV, paged and
               dense at max_seq DENSE_STEP_SEQS: CUDA events, busy time and
               idle share by the profiler.
  9. runtime_mamba2 — phase 6's loop (the same workload and catalog over
               SHORT_RAMP) over full-width mamba2-370m on the dense engine, its
               weights drawn on the card's generator: queries served, swaps,
               host seconds, the mode and variant mix; ssd_bshp (one launch
               a layer a prefill step), q8_matmul, q4_matmul and sim_scores
               must launch, with a live Q8 -> Q4 swap.
 10. serve_paper_models — full-width hermes2-pro-8b, then llama3.1-8b (the
               paper's other two models: no qkv bias, 32 query heads over 8
               KV heads), each drawn on the card from seed 0 and freed
               before the next: phase 4's two paged paths (bf16 KV with a
               Q8 -> Q4 swap, int8 KV on Q8), then phase 8's dense path on
               bf16 KV, teacher-forced onto the paged engine's tokens with
               every Q8 row within ENGINE_LOGIT_REL and the paged kernel
               not launched; each path with its counters set to 0 just
               before it and read just after, no step falling back and the
               invariant sweep clean. Then a decode step at batch 4 for Q8
               and Q4 on bf16 KV (CUDA events, busy time, idle share and
               launches a step by the profiler).
 11. runtime_paper_models — phase 6's loop, over SHORT_RAMP, for each of
               the two at full width, priced from its own profile: a live Q8 -> Q4
               swap, a low-power mode, the four model kernels and sim_scores
               launched, each model a main path of its own.
 12. serve_qwen25_32b — full-width qwen2.5-32b (64 layers, d 5120, 40 query
               heads over 8 KV heads, d_ff 27648), its trees drawn on the
               card from seed 0 a layer slice at a time; the draw's peak
               may rise at most DRAW_PEAK_SLACK above the finished trees.
               Phase 10's paths: the two paged paths, the dense bf16 path
               teacher-forced onto the paged engine within
               ENGINE_LOGIT_REL, and Q8 / Q4 decode steps at batch 4.
 13. fleet   — `build_fleet` over a clean region (an edge pod) and a dirty
               one (a pod), their engines full-width carboncall-qwen2-7b
               built lazily on the card, and `run_fleet(backend="engine")`
               over FLEET_STEPS steps: every query served, an engine built
               exactly where queries were routed, q8, paged, flash and
               sim_scores launched (q4 wherever a pod swapped), no fallback.
 14. workers — two raw-mode worker processes of full-width
               carboncall-qwen2-7b on the card (`launch_workers`, spawned):
               six temperature-0 requests over the wire, a swap op,
               `EngineStats.merge`, each worker's ready seconds; after
               shutdown an in-process twin from the first worker's spec
               and seed must emit its tokens, token for token; a worker on
               a device ordinal the machine lacks must make
               `launch_workers` raise.
 15. serve_launcher — `repro_torch.launch.serve.main` as a user runs it
               (`python -m repro_torch.launch.serve` with LAUNCHER_FLAGS):
               in-process at full width on the card, then with
               `--workers 2`; each must serve every query with its token
               count, switch variants at least once, and print the same
               switch and `total carbon` lines as the launcher run
               in-process with `--device cpu` (the reduced config; those
               lines read no tokens). The in-process run is the main path:
               q8, q4, paged and flash attention and sim_scores must launch.
 16. serve_zamba2 — full-width zamba2-7b (81 block applications: 13 groups
               of 5 mamba blocks and a shared attention+MLP block over 2
               weight sets, then 3 mamba blocks; d 3584, 32 heads of 112),
               drawn on the card from seed 0 (DRAW_PEAK_SLACK), on the dense
               engine (`kv_layout="auto"`): phase 5's requests with a Q8 ->
               Q4 swap on bf16 KV, then on int8 KV, each a main path of its
               own (ssd_bshp once a mamba block and flash attention once a
               shared block a prefill step, q8 and q4 launched, the paged
               kernel not, no fallback, the invariants clean); one 4 x 512
               admission's logits through the kernels against the plain
               ssd scan and plain attention within HYBRID_LOGIT_REL of the
               row's max |logit|; Q8 / Q4 dense decode steps at batch 4 and
               a 4 x 512 prefill (CUDA events, profiler).
 17. serve_phi35_moe — full-width phi3.5-moe-42b-a6.6b (32 layers, 16
               experts of d_ff 6400, top 2, 32 / 8 heads; 61 GiB of Q8 + Q4
               trees drawn a (layer, expert) slice at a time, the draw's
               peak at most DRAW_PEAK_SLACK above them): phase 10's paths
               (the two paged paths, the dense bf16 path teacher-forced onto
               the paged engine within ENGINE_LOGIT_REL, on prompts that
               share no block, so both engines run the same MoE calls), a
               paged path with `prefill_chunk=CHUNK` drafting with Q4 at k 2
               (chunk and spec steps, drafted and accepted tokens; its
               tokens not compared: capacity drops depend on the window),
               and Q8 / Q4 decode steps at batch 4.
Every phase starts with at most PHASE_START_MAX of device memory allocated
(after a garbage collection), or the run fails naming the phase before it;
each phase's start and peak are printed.
The kernel check of phase 3 holds q8_matmul and q4_matmul to QM_TOL at
carboncall-qwen2-7b's five (K, N), hermes2-pro-8b / llama3.1-8b's six,
qwen2.5-32b's five and phi3.5-moe's head for M in QM_ROWS (both regimes and
their edge) and at mamba2-370m's four and zamba2-7b's seven (K, N) for M in
QM_MAMBA_ROWS, each launched twice with bit-identical results; it includes
sim_scores, at the runtime's index (N = 256: 240 tools and 16 zero rows,
d = 256, m = 1, 2, 3 and 8 sentences, and m = 33 and 64, one launch each),
at a ToolBench-sized catalog (N = 16640) and at N = 65536 up to m = 32,
held to 1e-5 with the same top 16 and top 32, and the fused retrieval (raw
queries to the top k in one launch) at k = 16, 32 and, at N = 256, k = N,
with indices equal to the plain version's, ties included, and bit-identical
repeats; and the SSD chunk scan at the shapes of mamba2-370m (H 32, P 64,
N 128) and zamba2-7b (H 112, P 64, N 64; its serve admissions too), held
to 0.05 on y and the final state with bit-identical repeats; decode
attention at PAGED_CASES,
bf16 and int8 pools, within PAGED_BF16_TOL / PAGED_INT8_TOL and, row by row,
PAGED_ROW_TOL at the planned split, one split and nb splits, with
bit-identical repeats, timed by device time against its byte bound and the
gathered-SDPA yardstick (two calls), and its bf16 cases over the seeds
PAGED_F64_SEEDS against their f64 evaluation correctly rounded to bf16 (the
kernel may miss no more outputs than the plain version, none by over one
bf16 ulp); and prefill attention, whose two
tensor-core products are first checked alone on one tile (PRODUCT_TOL),
then the kernel at FLASH_CASES within FLASH_TOL and FLASH_ROW_TOL with
bit-identical repeats,
timed by device time against the faster of two SDPA calls.
The line before the last is the `kernels` JSON record (launches summed over
the main paths of phases 4 to 17); the last line is
{"ok": true, "device": {...}}. Without a card, or run from a directory that
holds no `src/repro_torch`, it prints no result and exits 2.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
QM_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
             (3584, 152064)]    # (K, N): wq/wo, wk/wv, wg/wu, down, lm_head
# decode rows (1-16, the regime's edge), prefill rows (17 up)
QM_ROWS = (1, 4, 8, 16, 17, 64, 512)
# hermes2-pro-8b and llama3.1-8b: wq/wo, wk/wv, wg/wu, down, the two heads.
# 128288 = 2004 x 64 + 32: its last 64-column tile is half full
QM_PAPER_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                   (4096, 128288), (4096, 128256)]
# qwen2.5-32b: wq/wo, wk/wv, wg/wu, down (K 27648), lm_head
QM_QWEN25_SHAPES = [(5120, 5120), (5120, 1024), (5120, 27648), (27648, 5120),
                    (5120, 152064)]
QM_MAMBA_SHAPES = [(1024, 2048), (1024, 128), (1024, 32),
                   (2048, 1024)]  # mamba2-370m: wz/wx, wb/wc, wdt, out_proj
QM_MAMBA_ROWS = (4, 512, 2048)  # the serve path's decode and two admissions
# zamba2-7b: wz/wx, wb/wc, wdt, out_proj, the shared block's wg/wu and down,
# lm_head (its attention's (3584, 3584) is qwen2's wq), at its serve path's
# decode and two admissions; phi3.5-moe-42b-a6.6b's head (its attention's
# shapes are llama3.1-8b's; its batched experts never reach the kernel)
QM_ZAMBA_SHAPES = [(3584, 7168), (3584, 64), (3584, 112), (7168, 3584),
                   (3584, 14336), (14336, 3584), (3584, 32000)]
QM_PHI_SHAPES = [(4096, 32064)]
QM_TOL = 0.02                   # max |err| / max |plain|: one bf16 ulp is 0.4%
# max |err| of the attention outputs (bf16). Paged rows average 129-256
# positions, so |out| is ~0.1 and one bf16 ulp there is ~5e-4; int8 pools
# add the codes' rounding, which the plain version shares but applies in
# another order. Flash rows at the start of a prompt average few positions,
# so |out| reaches ~3, where one ulp is 0.016.
PAGED_BF16_TOL = 1e-3
PAGED_INT8_TOL = 1e-2
# Rows of long chains average thousands of positions, so |out| is ~0.02 and
# the absolute tolerances alone would miss a dropped pool block: each row
# (b, query head) is also held to its RMS error over its RMS value.
PAGED_ROW_TOL = 0.02
# The bf16 cases are also held, over these seeds, to their f64 evaluation
# correctly rounded to bf16 (check_paged_f64): the kernel may round no more
# outputs otherwise than the plain version, and none by over one bf16 ulp
# of the f64 value where f32 arithmetic can resolve it: where the output's
# terms sum_j p_j v_j cancel, an f32 evaluation errs by some f32 ulps of
# sum_j p_j |v_j|, many bf16 ulps of a small result (the plain version by
# up to 17.7, PERF.md §6, PR 27). At a condition sum_j p_j |v_j| /
# |sum_j p_j v_j| of at most PAGED_F64_COND, 128 f32 ulps of the terms
# (2^-17 of them) stay within half a bf16 ulp (at least 2^-9) of the result.
PAGED_F64_SEEDS = (2, 3, 4, 5, 6)
PAGED_F64_COND = 256
# (label, B, K, G, H, bs, nb, lengths, window, cap), each with bf16 and int8
# pools. A row of length 1 is the dead row, parked on the scratch block 0.
PAGED_SERVE = (4, 4, 7, 128, 16, 16, [1, 129, 200, 256])
PAGED_CASES = [
    ("serve", *PAGED_SERVE, 0, 0.0),
    ("serve", *PAGED_SERVE, 48, 0.0),
    ("window+cap", *PAGED_SERVE, 48, 50.0),
    ("bs32", 4, 4, 7, 128, 32, 8, [1, 129, 200, 256], 0, 0.0),
    ("llama", 4, 8, 4, 128, 16, 16, [1, 129, 200, 256], 0, 0.0),
    ("MQA", 4, 1, 8, 128, 16, 16, [1, 129, 200, 256], 0, 0.0),
    ("H64", 4, 4, 4, 64, 16, 16, [1, 129, 200, 256], 0, 0.0),
    ("H256", 4, 2, 4, 256, 16, 16, [1, 129, 200, 256], 0, 0.0),
    # head dims below their instantiation's 64 / 128: the reduced configs'
    # 16 and zamba2-7b's 112 (MHA, 32 kv heads)
    ("H16", 4, 1, 4, 16, 16, 16, [1, 129, 200, 256], 0, 0.0),
    ("H112", 4, 32, 1, 112, 16, 16, [1, 129, 200, 256], 0, 0.0),
    ("long", 8, 4, 7, 128, 16, 256,
     [4096, 4001, 3584, 4096, 3000, 4095, 3777, 4096], 0, 0.0),
    ("long", 32, 4, 7, 128, 16, 64,
     [1024 - (37 * i) % 300 for i in range(32)], 0, 0.0),
    # qwen2.5-32b: 40 query heads over 8 KV heads (G 5); last, so the
    # earlier cases draw the inputs they drew before it
    ("qwen2.5", 4, 8, 5, 128, 16, 16, [1, 129, 200, 256], 0, 0.0)]
FLASH_TOL = 0.03
# Rows late in a long prompt average thousands of positions, so their |out|
# is ~0.03 and FLASH_TOL alone would miss a dropped K/V tile there: each row
# (b, position, head) is also held to its RMS error over its RMS value. One
# bf16 ulp is 0.4% of a value; dropping one of 64 tiles moves a row ~12%.
FLASH_ROW_TOL = 0.02
# (label, B, Sq, Skv, N, K, H, causal, window, cap); q_offset = Skv - Sq
FLASH_CASES = [("serve", 4, S, S, 28, 4, 128, True, 0, 0.0)
               for S in (32, 64, 128, 256)] + [
    ("window+cap", 2, 256, 256, 28, 4, 128, True, 48, 50.0),
    ("q_offset", 2, 100, 228, 28, 4, 128, True, 0, 0.0),
    ("non-causal", 2, 77, 300, 28, 4, 128, False, 0, 0.0),
    ("H64", 2, 256, 256, 8, 2, 64, True, 0, 0.0),
    ("H256", 2, 200, 200, 8, 2, 256, True, 0, 0.0)] + [
    # hermes2-pro-8b / llama3.1-8b: 32 query heads over 8 KV heads (G 4)
    ("llama", 4, S, S, 32, 8, 128, True, 0, 0.0) for S in (64, 256)] + [
    # qwen2.5-32b: 40 query heads over 8 KV heads (G 5)
    ("qwen2.5", 4, S, S, 40, 8, 128, True, 0, 0.0) for S in (64, 256)] + [
    ("long", 1, 2048, 2048, 28, 4, 128, True, 0, 0.0),
    ("long", 1, 4096, 4096, 28, 4, 128, True, 0, 0.0)] + [
    # zamba2-7b's shared block: 32 heads of 112 over 32 KV heads (MHA, its
    # head padded to 128 in the kernel); last, so the earlier cases draw
    # the inputs they drew before
    ("zamba2", 4, S, S, 32, 32, 112, True, 0, 0.0) for S in (64, 256)]
FLASH_PRODUCT_HEADS = (16, 64, 112, 128, 256)   # every head_dim in configs/
PRODUCT_TOL = 1e-5              # max |err| / max |f32 product|
SIM_TOL = 1e-5                  # retrieval scores, f32 (ROADMAP tolerance)
# (N, m) at d = 256: N = 256 is the runtime's index, 16640 ToolBench's
# 16,464 RapidAPI tools padded to the index multiple of 256
SIM_SHAPES = [(256, 1), (256, 2), (256, 3), (256, 8), (256, 33), (256, 64),
              (16640, 3), (65536, 1), (65536, 3), (65536, 8), (65536, 32)]
SIM_KS = (16, 32)               # top k of the fused retrieval; and N at 256
SSD_TOL = 0.05                  # y and final state (tests/test_kernels.py)
# (label, B, S, H, P, G, N, chunk): mamba2-370m at B 1 S 2048, its serve
# admissions (4 x 128, 4 x 512), S 4096 (32 chunks in the state pass) and a
# chunk of 40 rows; zamba2-7b's heads at B 1 S 1024 and at its serve
# admissions
SSD_SHAPES = [("mamba2-370m", 1, 2048, 32, 64, 1, 128, 128),
              ("mamba2-370m", 4, 128, 32, 64, 1, 128, 128),
              ("mamba2-370m", 2, 512, 32, 64, 1, 128, 128),
              ("mamba2-370m", 4, 512, 32, 64, 1, 128, 128),
              ("mamba2-370m", 1, 4096, 32, 64, 1, 128, 128),
              ("mamba2-370m", 2, 120, 32, 64, 1, 128, 40),
              ("zamba2-7b", 1, 1024, 112, 64, 1, 64, 128),
              ("zamba2-7b", 4, 128, 112, 64, 1, 64, 128),
              ("zamba2-7b", 4, 512, 112, 64, 1, 64, 128)]
# the ssd kernel's f32 operands enter its bf16 products as hi + lo parts
SSD_SPLIT_PARTS = 2
MAMBA_LOGIT_REL = 0.02          # of max |logit| (tests/test_torch_mamba2.py)
# serve_zamba2: the hybrid's kernel prefill against the plain ssd scan and
# plain attention, of the row's max |logit| (at least 1). zamba2-7b's 81
# random layers carry a rounding difference further than mamba2's 48, and
# its untied head's rows peak at a few units where mamba2's tied head
# reaches ~50: the kernels read 0.042 at seed 0, against the plain scan's
# own drift between two chunkings read by tools/ssd_logit_drift.py --arch
# zamba2-7b (PERF.md §6, PR 29)
HYBRID_LOGIT_REL = 0.06
# runtime phase: a clean grid, then a dirty one, 10-minute steps
RAMP_CLEAN, RAMP_DIRTY, RAMP_CI = 4, 8, (100.0, 900.0)
# runtime_mamba2 and runtime_paper_models run a shorter ramp (15 queries,
# the swap at the 11th, a low-power mode): with phases 12-15 the full ramp
# would take the whole run past half its time limit (PERF.md §6, PR 28)
SHORT_RAMP = (2, 4)
RUNTIME_QPH = 18.0
# serve_spec_chunk: chunked windows of 256 over buckets up to 1024; spec at
# k 2, k 4 from step SPEC_K4_AT, a swap to the draft variant at
# SPEC_SWAP_AT; the runtime with windows of 64 (below its 128 and 256
# buckets) and a draft-length ladder, over 4 ten-minute steps
CHUNK = 256
CHUNK_BUCKETS = (64, 128, 256, 512, 1024)
SPEC_K4_AT, SPEC_SWAP_AT = 6, 14
RUNTIME_CHUNK = 64
RUNTIME_LADDER = (1, 2, 4)
RUNTIME_SPEC_CI = (100.0, 100.0, 900.0, 900.0)
# tokens are compared up to a stream's first emission whose top-2 logit
# margin is below this (tests/test_torch_engine.py's MARGIN_BOUND: twice
# the logit tolerance of two code paths on one history)
MARGIN_BOUND = 0.16
# teacher-forced logits of two code paths on one history (a chunk window's
# plain prefix attention and M = 1024 q8 tiles against the flash kernel at
# M = 4096; a verify window against the paged kernel and the q8 GEMV at
# M = 4), over the reference row's max |logit|: 0.017-0.019 on the card
# at full width (PERF.md §6, PR 23), where bf16 rounding differs at every
# one of 28 layers; 0.008 / 0.013 (int8 KV) at the CPU tests' width
ENGINE_LOGIT_REL = 0.03
# an MoE token whose neighbours among its k + 1 largest router logits lie
# closer than this may route otherwise in two runs that round the hidden
# state apart (RouteTape): phi's router logits spread ~0.064 a token (the
# init's std 1e-3 over d 4096), and the dense run's moved up to 3.08e-3
# from the paged run's over 32 layers (PERF.md §6, PR 29); a gap of 2x
# the drift cannot flip, and the replay fails above half the margin
ROUTE_MARGIN = 0.01
REPLACES = {
    "q8_matmul": "src/repro/kernels/quant_matmul/quant_matmul.py:56",
    "q4_matmul": "src/repro/kernels/quant_matmul/quant_matmul.py:108",
    "paged_attention": "src/repro/kernels/paged_attention/paged_attention.py:138",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:93",
    "sim_scores": "src/repro/kernels/topk_sim/topk_sim.py:34",
    "ssd_bshp": "src/repro/kernels/ssd/ssd.py:65",
}
SOURCES = {
    "q8_matmul": "src/repro_torch/csrc/quant_matmul.cu",
    "q4_matmul": "src/repro_torch/csrc/quant_matmul.cu",
    "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "sim_scores": "src/repro_torch/csrc/topk_sim.cu",
    "ssd_bshp": "src/repro_torch/csrc/ssd.cu",
}
MODEL_KERNELS = ("q8_matmul", "q4_matmul", "paged_attention",
                 "flash_attention")
# the transformer's dense layout: its decode reads the stripe through plain
# attention (the JAX package has no Pallas kernel there)
DENSE_KERNELS = ("q8_matmul", "q4_matmul", "flash_attention")
# serve_dense: the serve phase's requests and swap; dense decode steps timed
# at these stripe widths
DENSE_SWAP_AT = 12
DENSE_STEP_SEQS = (256, 2048)
# serve_paper_models / runtime_paper_models: the paper's other two models,
# each also the name of its profile in PAPER_MODELS
PAPER_ARCHS = ("hermes2-pro-8b", "llama3.1-8b")
# serve_qwen25_32b's model; every tree drawn on the card a layer slice at a
# time may peak at most DRAW_PEAK_SLACK above the finished trees
QWEN25_ARCH = "qwen2.5-32b"
# serve_zamba2 / serve_phi35_moe: the hybrid and MoE families at full width
ZAMBA_ARCH = "zamba2-7b"
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
DRAW_PEAK_SLACK = 2 * 2**30
# every phase must start with at most this much device memory allocated
# (the phase before it freed its trees; small per-device scratch stays)
PHASE_START_MAX = 2 * 2**30
# fleet: two regions of one pod each, 12 ten-minute steps at 12 queries an
# hour (lam 2 a step)
FLEET_STEPS, FLEET_QPH = 12, 12.0
# workers: the launcher's --workers engine, six temperature-0 requests
WORKER_COUNT, WORKER_REQUESTS, WORKER_NEW = 2, 6, 8
# serve_launcher: three queries 10 minutes apart switch variants once
LAUNCHER_FLAGS = ("--queries", "3", "--minutes-per-query", "10",
                  "--max-new-tokens", "4")
# sources whose every kernel must show tensor-core instructions and no spill
TENSOR_CORE_SOURCES = ("quant_matmul", "flash_attention", "paged_attention",
                       "ssd")


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, reps: int = 5, iters: int = 100) -> float:
    """The median of `reps` readings of `time_ms`: calls short enough that
    the host's launch path sets their time move with the host's load, and
    the median steadies them."""
    return sorted(time_ms(fn, iters=iters) for _ in range(reps))[reps // 2]


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class PhaseMemory:
    """Device memory at every phase's edges. `run(name, fn)` collects
    garbage first (engines sit in reference cycles: an executor's step-cost
    hook, the counting wrappers the phases install, `_StepClock`'s patched
    methods; only the cyclic collector frees them and so their trees),
    prints the bytes allocated and reserved, fails the run naming the phase
    before it if more than PHASE_START_MAX is still allocated, resets the
    peak, runs the phase and prints its peak."""

    def __init__(self):
        self.prev = "build"

    def run(self, name, fn, *args, **kw):
        import torch
        free_device("cuda")
        t0 = time.perf_counter()
        alloc = torch.cuda.memory_allocated()
        log(f"memory at the start of {name}: {alloc / 2**30:.3f} GiB "
            f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
            f"reserved")
        if alloc > PHASE_START_MAX:
            log_live_tensors()
            fail(f"{name} starts with {alloc / 2**30:.3f} GiB allocated "
                 f"(limit {PHASE_START_MAX / 2**30:.0f} GiB): "
                 f"{self.prev} did not free its device memory")
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kw)
        log(f"memory peak of {name}: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
            f"allocated; {time.perf_counter() - t0:.1f} s host clock")
        self.prev = name
        return out


def free_device(device):
    """Collect garbage, then hand the freed blocks back: engines sit in
    reference cycles, so `del` alone does not free their trees."""
    import gc
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()


def log_live_tensors(n: int = 8):
    """The largest CUDA tensors the collector can still reach, with the
    types of the objects that refer to them."""
    import gc
    import torch
    live = [o for o in gc.get_objects()
            if isinstance(o, torch.Tensor) and o.is_cuda]
    live.sort(key=lambda t: t.untyped_storage().nbytes(), reverse=True)
    for t in live[:n]:
        owners = sorted({type(r).__name__ for r in gc.get_referrers(t)})
        log(f"  live: {tuple(t.shape)} {t.dtype} "
            f"{t.untyped_storage().nbytes() / 2**20:.1f} MiB, referred to "
            f"by {owners}")


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])     # name, power limit
    cap = torch.cuda.get_device_capability(0)
    log(f"capability: {cap}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, count {torch.cuda.device_count()}")
    if cap != (9, 0):
        fail(f"need a Hopper card (capability 9.0), got {cap}")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} sources built in "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    for name in sorted(build.SOURCES):
        for line in build.ptxas_report(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "Performance")):
                log(f"  ptxas[{name}]: {line.strip()}")
    for name in TENSOR_CORE_SOURCES:
        report = build.ptxas_report(name)
        spills = [m.group(0) for m in re.finditer(
            r"[1-9][0-9]* bytes spill (stores|loads)", report)]
        if not report or spills:
            fail(f"{name} kernels: no ptxas report, or spills {spills}")
        counts = sass_mma_counts(build.library_path(name))
        for fn, n in sorted(counts.items()):
            log(f"  sass[{name}]: {n} HMMA/HGMMA in {fn}")
        idle = [fn for fn, n in counts.items() if n == 0]
        if not counts or idle:
            fail(f"{name} kernels without tensor-core instructions: "
                 f"{idle or 'no kernels found'}")


def sass_mma_counts(lib_path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per kernel in a built library's
    SASS, by cuobjdump from the toolkit that built it."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump failed: {res.stderr.strip()[:400]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


class KernelRecord:
    def __init__(self, name):
        self.name = name
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = None
        self.bound_by = "bytes"

    def to_json(self, launches):
        return {"name": self.name, "route": "cuda",
                "source": SOURCES[self.name], "replaces": REPLACES[self.name],
                "launches": launches, "max_abs_err": self.max_abs_err,
                "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": self.bound_by,
                "library_ms": self.library_ms}


def check_quant_matmul(records, timed_m: int = 4, prefill_m: int = 512):
    """q8 and q4 against their plain versions at carboncall-qwen2-7b's five
    (K, N), hermes2-pro-8b / llama3.1-8b's six and qwen2.5-32b's five (K
    27648 among them) for M in QM_ROWS (decode
    rows, both regimes' edges, prefill rows) and at mamba2-370m's four
    (K, N) for M in QM_MAMBA_ROWS (the serve path's decode and two
    admissions); every case is launched twice and the two results must be
    equal bit for bit. The kernels line reports the
    M = `timed_m` sums over the five qwen2 shapes; one log line per format
    gives the M = `prefill_m` sums beside them."""
    import torch
    from repro_torch.kernels.quant_matmul import ops as qm
    from repro_torch.quant.qtensor import dequantize, quantize
    g = torch.Generator(device="cuda").manual_seed(1)
    for fmt in ("q8", "q4"):
        rec = records[f"{fmt}_matmul"]
        sums = {M: [0.0, 0.0, 0.0, 0.0] for M in (timed_m, prefill_m)}
        for label, shapes, rows in (("qwen2", QM_SHAPES, QM_ROWS),
                                    ("hermes/llama", QM_PAPER_SHAPES,
                                     QM_ROWS),
                                    ("qwen2.5-32b", QM_QWEN25_SHAPES,
                                     QM_ROWS),
                                    ("mamba2", QM_MAMBA_SHAPES,
                                     QM_MAMBA_ROWS),
                                    ("zamba2-7b", QM_ZAMBA_SHAPES,
                                     QM_MAMBA_ROWS),
                                    ("phi3.5-moe", QM_PHI_SHAPES, QM_ROWS)):
            for K, N in shapes:
                w = torch.randn((K, N), generator=g, device="cuda") / math.sqrt(K)
                t = quantize(w.to(torch.bfloat16), fmt)
                del w
                wdq = dequantize(t, torch.bfloat16)
                for M in rows:
                    x = torch.randn((M, K), generator=g, device="cuda").to(
                        torch.bfloat16)
                    got = qm.launch(x, t)
                    again = qm.launch(x, t)
                    want = qm.plain(x, t)
                    torch.cuda.synchronize()
                    same = torch.equal(got, again)
                    err = (got.float() - want.float()).abs().max().item()
                    rel = err / max(want.float().abs().max().item(), 1e-6)
                    ok = bool(torch.isfinite(got).all().item()) \
                        and rel < QM_TOL and same
                    regime = qm.plan(M, K, N, fmt, t.group,
                                     qm._sm_count(x.device)).regime
                    line = (f"  {fmt}_matmul {label} M={M} K={K} N={N} "
                            f"{regime}: rel_err={rel:.2e} repeat "
                            f"{'bit-identical' if same else 'DIFFERS'}")
                    timed = label == "mamba2" or M in sums
                    if timed:
                        run = lambda: qm.launch(x, t)  # noqa: E731
                        ms = time_ms(run)
                        dev_ms = kernel_device_ms(run, "qmm_", n=20)
                        lms = time_ms(lambda: torch.matmul(x, wdq))
                        nbytes = M * K * 2 + t.nbytes() + M * N * 2
                        b, by = bound_ms(nbytes, 2.0 * M * K * N, BF16_FLOPS)
                        line += (f" ms={ms:.4f} device_ms={dev_ms:.4f} "
                                 f"matmul_bf16_ms={lms:.4f} "
                                 f"bound_ms={b:.4f} ({by})")
                        if label == "qwen2":
                            sums[M] = [a + v for a, v in
                                       zip(sums[M], (ms, dev_ms, b, lms))]
                        if label == "qwen2" and M == timed_m:
                            pms = time_ms(lambda: qm.plain(x, t), iters=3,
                                          warmup=1)
                            line += f" plain_ms={pms:.4f}"
                            rec.ms += ms
                            rec.plain_ms += pms
                            rec.library_ms = (rec.library_ms or 0.0) + lms
                            rec.bound_ms += b
                            rec.bound_by = by
                    log(f"{line} {'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        fail(f"{fmt}_matmul {label} M={M} K={K} N={N} rel err "
                             f"{rel}, repeat bit-identical {same}")
                    rec.max_abs_err = max(rec.max_abs_err, err)
                del t, wdq
                torch.cuda.empty_cache()
        log(f"  {fmt}_matmul sums over the five qwen2 shapes: " + "; ".join(
            f"M={M}: ms={v[0]:.4f} device_ms={v[1]:.4f} bound_ms={v[2]:.4f} "
            f"matmul_bf16_ms={v[3]:.4f}" for M, v in sums.items()))


def _paged_inputs(g, B, K, G, H, bs, nb, lengths, int8):
    import torch
    num_blocks = B * nb + 1
    q = torch.randn((B, K, G, H), generator=g, device="cuda").to(torch.bfloat16)
    kf = torch.randn((num_blocks, bs, K, H), generator=g, device="cuda")
    vf = torch.randn((num_blocks, bs, K, H), generator=g, device="cuda")
    perm = torch.randperm(num_blocks - 1, generator=g, device="cuda") + 1
    bt = torch.zeros((B, nb), dtype=torch.int32, device="cuda")
    for b, ln in enumerate(lengths):
        used = -(-ln // bs)
        bt[b, :used] = perm[b * nb:b * nb + used].to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if int8:
        from repro_torch.models.transformer import requant_cache
        enc = requant_cache({"k_scale": True}, kf, vf)
        return q, enc["k"], enc["v"], enc["k_scale"], enc["v_scale"], bt, lens
    return q, kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None, bt, lens


def _paged_errors(got, want):
    """max |err|, and the worst (row, head)'s RMS error over its RMS value."""
    diff = got.float() - want.float()
    rms = want.float().square().mean(-1).sqrt().clamp_min(1e-6)
    return (diff.abs().max().item(),
            (diff.square().mean(-1).sqrt() / rms).max().item())


def _gathered_sdpa(q, kp, vp, ks, vs, bt, lens, window):
    """The yardstick of two calls: gather the chains (and dequantize int8),
    then scaled_dot_product_attention with enable_gqa and a length/window
    mask (built outside the timed call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ref import gather_pool
    B, K, G, H = q.shape
    S = bt.shape[1] * kp.shape[1]
    pos = torch.arange(S, device=q.device)[None, :]
    ok = pos < lens[:, None]
    if window > 0:
        ok &= pos > lens[:, None] - 1 - window
    mask = ok[:, None, None, :]
    qt = q.reshape(B, K * G, 1, H)

    def run():
        k, v = gather_pool(kp, bt), gather_pool(vp, bt)
        if ks is not None:
            k = (k * gather_pool(ks, bt)[..., None]).to(torch.bfloat16)
            v = (v * gather_pool(vs, bt)[..., None]).to(torch.bfloat16)
        return F.scaled_dot_product_attention(
            qt, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)
    return run


def check_paged(records, baselines=()):
    """Decode attention against its plain version at PAGED_CASES, bf16 and
    int8 pools: carboncall-qwen2-7b's heads (K 4, G 7, H 128) at the serving
    shape (B 4, block size 16, 16-block chains, a dead row on scratch block
    0) with windows 0 and 48 and a softcap, block size 32, llama-3.1-8b's
    heads (K 8, G 4), MQA (K 1, G 8), head dims 64 and 256, the reduced
    configs' 16 and zamba2-7b's 112 (MHA, K 32), long chains
    (B 8 x ~4096 and B 32 x ~1024 positions) and qwen2.5-32b's heads (K 8,
    G 5) at the serving shape. Each case is held to
    PAGED_BF16_TOL / PAGED_INT8_TOL and, row by row, PAGED_ROW_TOL, at the
    planned split, at one split and at nb splits, and launched twice with
    bit-identical results. Times by device time (torch.profiler, the kernel
    alone) with CUDA events beside, the byte bound of the positions the
    call needs, and the gathered-SDPA yardstick (gather + SDPA: two calls,
    all their device kernels summed; not for softcaps). The kernels line
    keeps the serve case (bf16, window 0) by device time; no single PyTorch
    call computes paged attention, so its library_ms stays null.
    `baselines`, directories each holding a paged_attention.cu with this
    source's C entry or with the one from before its redesign (caller-owned
    split partials), time those sources too at every case they take, each
    before and after this one (device time)."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa
    rec = records["paged_attention"]
    old_libs = []
    if baselines:
        import ctypes
        from pathlib import Path
        from repro_torch.kernels import build
        P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for i, d in enumerate(baselines):
            d = Path(d).resolve()
            # this source's entry takes the split workspace and counters
            one_launch = "void* counters" in (d / "paged_attention.cu") \
                .read_text()
            sig = pa.SIGNATURES if one_launch else {
                "paged_attention": [P] * 11 + [I] * 7 + [F_, I, P]}
            old_libs.append((i, one_launch,
                             build.load("paged_attention", sig, csrc=d)))
            log(f"  paged baseline {i}: {d} "
                f"({'one-launch' if one_launch else 'pre-redesign'} entry)")
    # The kernel and its plain version each round an f32 result to bf16,
    # a few f32 ulps apart, so an output that close to a bf16 rounding
    # boundary rounds either way: one bf16 ulp, 1.95e-3 at |out| >= 0.25,
    # over PAGED_BF16_TOL. Seed 2's inputs hold such an output (1.0 f32 ulp
    # from the boundary, in the window+cap bf16 case) since q is scaled as
    # the JAX package scales it; these come from seed 3 (PERF.md §6 counts
    # such outputs over seeds 2-6).
    g = torch.Generator(device="cuda").manual_seed(3)
    for label, B, K, G, H, bs, nb, lengths, window, cap in PAGED_CASES:
        for int8 in (False, True):
            q, kp, vp, ks, vs, bt, lens = _paged_inputs(g, B, K, G, H, bs,
                                                        nb, lengths, int8)
            if lengths[0] == 1:
                bt[0] = 0                       # dead row on scratch block 0
            kw = dict(k_scale=ks, v_scale=vs, window=window, cap=cap)
            run = lambda: pa.launch(q, kp, vp, bt, lens, **kw)  # noqa: E731
            plain = lambda: pa.paged_attention_ref(  # noqa: E731
                q.reshape(B, 1, K * G, H), kp, vp, bt, lens, **kw)
            want = plain().reshape(q.shape)
            got, again = run(), run()
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            err, row_err = _paged_errors(got, want)
            forced = [_paged_errors(pa.launch(q, kp, vp, bt, lens,
                                              num_splits=s, **kw), want)
                      for s in (1, nb)]
            tol = PAGED_INT8_TOL if int8 else PAGED_BF16_TOL
            ok = bool(torch.isfinite(got).all().item()) and same and all(
                e < tol and r < PAGED_ROW_TOL for e, r in [(err, row_err)]
                + forced)
            p = pa.plan(B, K, G, H, bs, nb, pa._sm_count(q.device), int8)
            dev_ms = kernel_device_ms(run, "paged_decode_kernel", n=20)
            ms = time_ms(run, iters=50)
            live = sum(min(ln, window) if window else ln for ln in lengths)
            kv_bytes = live * K * (2 * H * (1 if int8 else 2)
                                   + (8 if int8 else 0))
            nbytes = q.numel() * 2 * 2 + kv_bytes + bt.numel() * 4 + B * 4
            b, by = bound_ms(nbytes, 4.0 * K * G * H * live, BF16_FLOPS)
            line = (f"  paged_attention {label} {'int8' if int8 else 'bf16'} "
                    f"B={B} K={K} G={G} H={H} bs={bs} nb={nb} "
                    f"window={window} cap={cap} splits={p.splits} "
                    f"warps={p.warps} grid={p.grid}: max_abs_err={err:.2e} "
                    f"(tol {tol}) row_rms_rel={row_err:.2e} (tol "
                    f"{PAGED_ROW_TOL}) forced splits 1/nb max_abs_err="
                    f"{forced[0][0]:.2e}/{forced[1][0]:.2e} row_rms_rel="
                    f"{forced[0][1]:.2e}/{forced[1][1]:.2e} repeat "
                    f"{'bit-identical' if same else 'DIFFERS'} "
                    f"device_ms={dev_ms:.4f} ms={ms:.4f} bound_ms={b:.5f} "
                    f"({by}) bound/device={b / dev_ms:.3f}")
            del got, again
            if cap == 0.0:
                yard = _gathered_sdpa(q, kp, vp, ks, vs, bt, lens, window)
                sd = kernel_device_ms(yard, "", n=20)
                line += (f" gathered_sdpa_device_ms={sd:.4f} (gather + SDPA, "
                         f"two calls) kernel/gathered_sdpa="
                         f"{dev_ms / sd:.3f}")
            for i, one_launch, old_lib in old_libs:
                line += f" baseline {i}: " + _paged_baseline(
                    old_lib, one_launch, run, q, kp, vp, ks, vs, bt, lens,
                    bs, nb, window, cap)
            if label == "serve" and not int8 and window == 0:
                pms = time_ms(plain, iters=10)
                line += f" plain_ms={pms:.4f}"
                rec.ms, rec.plain_ms, rec.bound_ms, rec.bound_by = \
                    dev_ms, pms, b, by
            log(f"{line} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"paged_attention {label} int8={int8} window={window} "
                     f"cap={cap}: err {err}, row err {row_err}, forced "
                     f"splits {forced}, repeat bit-identical {same}")
            rec.max_abs_err = max([rec.max_abs_err, err]
                                  + [e for e, _ in forced])
            del q, kp, vp, ks, vs, bt, lens, want
    torch.cuda.empty_cache()


def _bf16_rounded(x):
    """f64 values correctly rounded to bf16 (to nearest, ties to even):
    through f32, with an f32 result that sits on a bf16 midpoint without
    being x moved one f32 ulp toward x first, so the two roundings never
    round twice the wrong way."""
    import torch
    f = x.to(torch.float32)
    mid = ((f.view(torch.int32) & 0xFFFF) == 0x8000) & (f.double() != x)
    toward = torch.where(x > f.double(), math.inf, -math.inf).to(f.dtype)
    return torch.where(mid, torch.nextafter(f, toward), f).to(torch.bfloat16)


def _bf16_ulps(got, exact):
    """|got - exact| in bf16 ulps of the f64 value `exact`."""
    import torch
    _, ex = torch.frexp(exact)
    return (got.double() - exact).abs() / torch.ldexp(
        torch.ones_like(exact), ex - 8)


def _paged_f64(q, kp, vp, bt, lens, window, cap):
    """Decode attention over a bf16 pool in f64: the plain version's
    arithmetic (q scaled in bf16 as the JAX package scales it, then logits,
    softcap, mask, softmax and the V product) with every step after the
    scaling in torch.float64. Returns the (B, K, G, H) f64 outputs and
    their terms' magnitudes, sum_j p_j |v_j|."""
    import torch
    from repro_torch.kernels.paged_attention.ref import gather_pool
    from repro_torch.models.layers import _scale_q
    B, K, G, H = q.shape
    qr = _scale_q(q, H).double()
    k = gather_pool(kp, bt).double()
    v = gather_pool(vp, bt).double()
    s = torch.einsum("bkgh,bskh->bkgs", qr, k)
    if cap > 0.0:
        s = torch.tanh(s / cap) * cap
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = pos < lens[:, None]
    if window > 0:
        valid &= pos > lens[:, None] - 1 - window
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    return (torch.einsum("bkgs,bskh->bkgh", p, v),
            torch.einsum("bkgs,bskh->bkgh", p, v.abs()))


def check_paged_f64():
    """The bf16 PAGED_CASES over the seeds PAGED_F64_SEEDS, kernel and plain
    version each against the same inputs evaluated in f64 and correctly
    rounded to bf16: the outputs each one rounds otherwise, and each one's
    largest distance from the f64 value in bf16 ulps of it, over every
    output and over the outputs whose condition (sum_j p_j |v_j| over
    |sum_j p_j v_j|) is at most PAGED_F64_COND. Passes when, summed over
    the seeds and cases, the kernel misses no more outputs than the plain
    version, and no kernel output within that condition is more than one
    bf16 ulp from its f64 value. A seed's inputs are drawn as check_paged
    draws them (its int8 cases too, which are not evaluated here), so seed
    3's are that check's."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa
    per_case = {}
    for seed in PAGED_F64_SEEDS:
        g = torch.Generator(device="cuda").manual_seed(seed)
        for i, (label, B, K, G, H, bs, nb, lengths, window, cap) in \
                enumerate(PAGED_CASES):
            for int8 in (False, True):
                q, kp, vp, ks, vs, bt, lens = _paged_inputs(
                    g, B, K, G, H, bs, nb, lengths, int8)
                if int8:
                    continue
                if lengths[0] == 1:
                    bt[0] = 0                   # dead row on scratch block 0
                kw = dict(window=window, cap=cap)
                outs = {"kernel": pa.launch(q, kp, vp, bt, lens, **kw),
                        "plain": pa.paged_attention_ref(
                            q.reshape(B, 1, K * G, H), kp, vp, bt, lens,
                            **kw).reshape(q.shape)}
                exact, mag = _paged_f64(q, kp, vp, bt, lens, window, cap)
                rounded = _bf16_rounded(exact)
                sound = mag <= PAGED_F64_COND * exact.abs()
                row = per_case.setdefault(i, {
                    "ill": 0, **{w: [0, 0.0, 0.0] for w in outs}})
                row["ill"] += int((~sound).sum().item())
                for who, out in outs.items():
                    ulps = _bf16_ulps(out, exact)
                    row[who][0] += int((out != rounded).sum().item())
                    row[who][1] = max(row[who][1], ulps.max().item())
                    row[who][2] = max(row[who][2], ulps[sound].max().item())
                del q, kp, vp, bt, lens, outs, exact, mag, rounded, sound
    total = {w: [sum(r[w][0] for r in per_case.values()),
                 max(r[w][1] for r in per_case.values()),
                 max(r[w][2] for r in per_case.values())]
             for w in ("kernel", "plain")}
    total["ill"] = sum(r["ill"] for r in per_case.values())
    for i, r in sorted(per_case.items()) + [(None, total)]:
        head = "every bf16 case" if i is None else \
            "{} bf16 B={} K={} G={} H={} bs={} window={} cap={}".format(
                *[PAGED_CASES[i][j] for j in (0, 1, 2, 3, 4, 5, 8, 9)])
        k, pl = r["kernel"], r["plain"]
        log(f"  paged_attention f64 {head}, seeds {PAGED_F64_SEEDS[0]}-"
            f"{PAGED_F64_SEEDS[-1]}: outputs off the correctly rounded f64 "
            f"value kernel {k[0]} plain {pl[0]}; max bf16 ulps of the f64 "
            f"value kernel {k[1]:.3f} plain {pl[1]:.3f}; at condition <= "
            f"{PAGED_F64_COND} kernel {k[2]:.3f} plain {pl[2]:.3f} "
            f"({r['ill']} outputs above it)")
    k, pl = total["kernel"], total["plain"]
    ok = k[0] <= pl[0] and k[2] <= 1.0
    log(f"  paged_attention f64: kernel {k[0]} <= plain {pl[0]} outputs off, "
        f"kernel within 1 bf16 ulp at condition <= {PAGED_F64_COND} "
        f"({k[2]:.3f}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"paged_attention f64: kernel {k[0]} outputs off against plain "
             f"{pl[0]}, max ulps {k[2]} at condition <= {PAGED_F64_COND}")
    torch.cuda.empty_cache()


def _paged_baseline(old_lib, one_launch, run, q, kp, vp, ks, vs, bt, lens,
                    bs, nb, window, cap):
    """Device time of another paged_attention.cu before and after this
    source's kernel, at one case. `one_launch`: it has this source's C entry
    (run through the wrapper with its library in place of this one's);
    otherwise the entry from before the redesign (split partials from the
    caller, the JAX package's split count, a second merge kernel)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops as pa
    B, K, G, H = q.shape
    st = torch.cuda.current_stream().cuda_stream
    if one_launch:
        def old():
            this_lib = pa._lib
            pa._lib = lambda: old_lib
            try:
                pa.launch(q, kp, vp, bt, lens, k_scale=ks, v_scale=vs,
                          window=window, cap=cap)
            finally:
                pa._lib = this_lib
            return 0
    else:
        splits = min(pa.default_num_splits(nb), nb)
        out = torch.empty_like(q)
        m_part = torch.empty((B, K, splits, G), dtype=torch.float32,
                             device=q.device)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((B, K, splits, G, H), dtype=torch.float32,
                               device=q.device)

        def old():
            return old_lib.paged_attention(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                None if ks is None else ks.data_ptr(),
                None if vs is None else vs.data_ptr(), bt.data_ptr(),
                lens.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                acc_part.data_ptr(), out.data_ptr(), B, K, G, H, bs, nb,
                splits, float(cap), int(window), st)
    try:
        if old() != 0:
            return "refused"
    except (RuntimeError, ValueError):
        return "refused"
    before = kernel_device_ms(old, "paged_", n=20)
    now = kernel_device_ms(run, "paged_decode_kernel", n=20)
    after = kernel_device_ms(old, "paged_", n=20)
    build.check(old(), "baseline paged_attention")
    return (f"device_ms={before:.4f}/{after:.4f} (this source between: "
            f"{now:.4f})")


def _flash_pairs(Sq, Skv, causal, window, q_offset) -> int:
    """(query, key) pairs the mask keeps: the work this call's data needs."""
    import torch
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    return int(ok.sum())


def check_flash_products():
    """The flash kernel's two tensor-core products alone on one 64-row tile
    (`ops.products`, issued as the kernel issues them): S = Q K^T against
    the f32 product of the same bf16 values, and O = bf16(S) V against the
    f32 product, V read MN-major as one n = H product a k16 step, at every
    head dim the configs use (16, 64, 112, 128, 256)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    g = torch.Generator(device="cuda").manual_seed(6)
    for H in FLASH_PRODUCT_HEADS:
        q, k, v = (torch.randn((64, H), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        s, o = fa.products(q, k, v)
        torch.cuda.synchronize()
        s_ref = q.float() @ k.float().T
        o_ref = s.to(torch.bfloat16).float() @ v.float()
        es = ((s - s_ref).abs().max() / s_ref.abs().max()).item()
        eo = ((o - o_ref).abs().max() / o_ref.abs().max()).item()
        ok = es < PRODUCT_TOL and eo < PRODUCT_TOL
        log(f"  flash products H={H}: S rel_err={es:.2e} O rel_err={eo:.2e} "
            f"(tol {PRODUCT_TOL}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash products H={H}: {es} {eo}")


def check_flash(records, baseline=None):
    """Prefill attention against its plain version at FLASH_CASES: the
    serve path's cold prefills (carboncall-qwen2-7b's 28 x 128 heads over 4
    kv heads, B = 4 at the 32/64/128 prompt buckets and max_seq 256;
    hermes2-pro-8b / llama3.1-8b's 32 x 128 heads over 8 and qwen2.5-32b's
    40 x 128 over 8, each at 64 and 256), the
    kernel's other options (window + softcap, q_offset with Sq < Skv,
    non-causal with Sq != Skv, head dims 64 and 256, Skv not a multiple of
    the 64-key tile) and long prompts, within FLASH_TOL and, row by row,
    FLASH_ROW_TOL. Each case is launched twice with bit-identical results. Times by device time (torch.profiler, the
    kernel alone) with CUDA events beside; the library call is the faster
    of SDPA with enable_gqa and SDPA on K/V repeated to N heads outside the
    timed call, each summed over every device kernel it runs. The kernels
    line keeps the B = 4, S = 64 row. `baseline`, a directory holding an
    older flash_attention.cu with the same C entry, times that source too
    at the serve cases, before and after this one (device time)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    rec = records["flash_attention"]
    old_lib = None
    if baseline is not None:
        from pathlib import Path
        from repro_torch.kernels import build
        old_lib = build.load("flash_attention", {"flash_attention":
                             fa.SIGNATURES["flash_attention"]},
                             csrc=Path(baseline).resolve())
    g = torch.Generator(device="cuda").manual_seed(3)
    for label, B, Sq, Skv, N, K, H, causal, window, cap in FLASH_CASES:
        off = Skv - Sq
        q = torch.randn((B, Sq, N, H), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, Skv, K, H), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, Skv, K, H), generator=g, device="cuda").to(torch.bfloat16)
        kw = dict(causal=causal, window=window, cap=cap, q_offset=off)
        run = lambda: fa.launch(q, k, v, **kw)  # noqa: E731
        plain = lambda: fa.flash_attention_ref(q, k, v, **kw)  # noqa: E731
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        diff = got.float() - want.float()
        err = diff.abs().max().item()
        row_rms = want.float().square().mean(-1).sqrt()
        row_err = (diff.square().mean(-1).sqrt()
                   / row_rms.clamp_min(1e-6)).max().item()
        same = torch.equal(got, again)
        ok = bool(torch.isfinite(got).all().item()) and err < FLASH_TOL \
            and row_err < FLASH_ROW_TOL and same
        del got, again, want, diff, row_rms
        p = fa.plan(B, Sq, Skv, N, K, H)
        dev_ms = kernel_device_ms(run, "flash_kernel", n=20)
        ms = time_ms(run, iters=20)
        pairs = _flash_pairs(Sq, Skv, causal, window, off)
        flops = 4.0 * B * N * H * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b, by = bound_ms(nbytes, flops, BF16_FLOPS)
        line = (f"  flash_attention {label} B={B} Sq={Sq} Skv={Skv} N={N} "
                f"K={K} H={H} causal={int(causal)} window={window} cap={cap} "
                f"q_offset={off} grid={p.grid}: max_abs_err={err:.2e} "
                f"(tol {FLASH_TOL}) row_rms_rel={row_err:.2e} "
                f"(tol {FLASH_ROW_TOL}) "
                f"repeat {'bit-identical' if same else 'DIFFERS'} "
                f"device_ms={dev_ms:.4f} ms={ms:.4f} "
                f"tflops={flops / dev_ms / 1e9:.1f} bound_ms={b:.5f} ({by})")
        lib_dev = lib_ms = None
        if window == 0 and cap == 0.0 and (off == 0 or not causal):
            # SDPA's causal mask is the upper-left one: only q_offset 0
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            kr = kt.repeat_interleave(N // K, dim=1)
            vr = vt.repeat_interleave(N // K, dim=1)
            gqa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            rep = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kr, vr, is_causal=causal)
            dev = {n: kernel_device_ms(f, "", n=20)
                   for n, f in (("gqa", gqa), ("repeated", rep))}
            evs = {n: time_ms(f, iters=20)
                   for n, f in (("gqa", gqa), ("repeated", rep))}
            lib_dev = min(dev.values())
            lib_ms = min(evs.values())
            line += (f" sdpa_device_ms gqa={dev['gqa']:.4f} "
                     f"repeated={dev['repeated']:.4f} sdpa_ms "
                     f"gqa={evs['gqa']:.4f} repeated={evs['repeated']:.4f} "
                     f"kernel/sdpa={dev_ms / lib_dev:.3f} (device)")
            del qt, kt, vt, kr, vr
        if old_lib is not None and label == "serve":
            out = torch.empty_like(q)
            st = torch.cuda.current_stream().cuda_stream
            old = lambda: build.check(old_lib.flash_attention(  # noqa: E731
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Sq, Skv, N, K, H, int(causal), window, cap, off, st), "old")
            before = kernel_device_ms(old, "flash", n=20)
            now = kernel_device_ms(run, "flash_kernel", n=20)
            after = kernel_device_ms(old, "flash", n=20)
            line += (f" baseline_device_ms={before:.4f}/{after:.4f} "
                     f"(this source between: {now:.4f})")
        if label == "serve" and Sq == 64:   # the serving run's bucket
            pms = time_ms(plain, iters=10)
            line += f" plain_ms={pms:.4f}"
            rec.ms, rec.plain_ms, rec.library_ms = dev_ms, pms, lib_dev
            rec.bound_ms, rec.bound_by = b, by
        log(f"{line} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attention {label} B={B} Sq={Sq} Skv={Skv} H={H}: "
                 f"err {err}, row err {row_err}, repeat bit-identical {same}")
        rec.max_abs_err = max(rec.max_abs_err, err)
        del q, k, v
    torch.cuda.empty_cache()


def _sim_inputs(g, N, m, d=256, pad=16):
    """Unit tool rows with `pad` zero rows at the end (the index padding) and
    raw Gaussian query rows, none of them zero: the scores-only check, where
    every row's dot is real arithmetic."""
    import torch
    tools = torch.nn.functional.normalize(
        torch.randn((N, d), generator=g, device="cuda"), dim=-1)
    tools[N - pad:] = 0.0
    q = torch.randn((m, d), generator=g, device="cuda")
    return tools.contiguous(), q


def _topk_inputs(g, N, m, d=256, pad=16):
    """Unit tool rows and raw query rows for the fused top-k check. Nine rows
    in ten point away from the queries (they score below 0), so the `pad`
    zero rows at the end (the index padding, exact 0.0 ties) reach the top k
    at N = 256; from m = 3 on, query row 1 is zero, so every row that points
    away ties at exactly 0.0 too."""
    import torch
    F = torch.nn.functional
    q = torch.randn((m, d), generator=g, device="cuda")
    if m >= 3:
        q[1] = 0.0
    tools = F.normalize(torch.randn((N, d), generator=g, device="cuda"),
                        dim=-1)
    away = torch.rand((N,), generator=g, device="cuda") < 0.9
    noise = torch.randn((N, d), generator=g, device="cuda") * (0.5 / d ** 0.5)
    tools = torch.where(away[:, None],
                        F.normalize(-F.normalize(q, dim=-1).sum(0) + noise,
                                    dim=-1), tools)
    tools[N - pad:] = 0.0
    return tools.contiguous(), q


def kernel_device_ms(fn, key: str, n: int = 50):
    """Mean device time per launch of the kernels whose name holds `key`, from
    torch.profiler over `n` launches: unlike CUDA events around back-to-back
    launches, it leaves out the host's time to issue them, which bounds a
    kernel shorter than that."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):  # again if the trace holds no device time at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if key in e.key)
        if us > 0:
            return us / 1e3 / n
    return float("nan")


def check_sim_scores(records):
    """Both entries of csrc/topk_sim.cu at SIM_SHAPES (d = 256) against their
    plain versions: `sim_scores` (unit queries -> (N,) scores) within SIM_TOL
    with the same top 16 and top 32, and the fused `topk_tools` (raw queries
    -> top k) at SIM_KS and, at N = 256, k = N, with indices equal to
    `topk_tools_ref` on the normalised queries, ties included, and scores
    within SIM_TOL; every launch is repeated and the repeat must match bit
    for bit. Each gets its events time (the median of 5 readings of 100
    calls), its profiler device time, its bound and a library composition's
    time (`matmul` + `amax`; + `torch.topk`). The kernels line reports the
    fused retrieval at N = 256, m = 1, k = 16, the runtime's commonest."""
    import torch
    from repro_torch.kernels.topk_sim import ops as ts
    from repro_torch.kernels.topk_sim.ref import topk_tools_ref
    rec = records["sim_scores"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    as_bits = lambda t: t.view(torch.int32)  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(4)
    for N, m in SIM_SHAPES:
        tools, q_raw = _sim_inputs(g, N, m)
        d = tools.shape[1]
        qn = ts._normalize(q_raw)
        got, again = ts.launch(tools, qn), ts.launch(tools, qn)
        want = ts.sim_scores_ref(tools, qn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same = torch.equal(as_bits(got), as_bits(again))
        same_topk = all(ts.top_k(got, k)[1].tolist()
                        == ts.top_k(want, k)[1].tolist() for k in SIM_KS)
        ok = bool(torch.isfinite(got).all().item()) and err <= SIM_TOL \
            and same_topk and same
        pl = ts.plan(N, d, m, 0, sms)
        run = lambda: ts.launch(tools, qn)  # noqa: E731
        ms = median_ms(run)
        pms = median_ms(lambda: ts.sim_scores_ref(tools, qn))
        lib = lambda: torch.matmul(tools, qn.T).amax(1)  # noqa: E731
        lms = median_ms(lib)
        lib_dev = kernel_device_ms(lib, "")
        dev_ms = kernel_device_ms(run, "sim_scores_kernel")
        nbytes = 4 * (N * d + m * d + N)
        b, by = bound_ms(nbytes, 2.0 * N * d * m, F32_FLOPS)
        log(f"  sim_scores N={N} d={d} m={m} mq={pl.mq} groups={pl.groups} "
            f"grid={pl.grid}: max_abs_err={err:.2e} (tol {SIM_TOL}) top16/32 "
            f"{'equal' if same_topk else 'DIFFER'} "
            f"repeat {'bit-identical' if same else 'DIFFERS'} "
            f"ms={ms:.5f} device_ms={dev_ms:.5f} plain_ms={pms:.5f} "
            f"matmul_amax_ms={lms:.5f} matmul_amax_device_ms="
            f"{lib_dev:.5f} bound_ms={b:.6f} ({by}) "
            f"device/bound={dev_ms / b:.2f} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"sim_scores N={N} m={m} err {err} top-k equal {same_topk} "
                 f"repeat bit-identical {same}")
        rec.max_abs_err = max(rec.max_abs_err, err)
        tools, q_raw = _topk_inputs(g, N, m)
        qn = ts._normalize(q_raw)
        for k in SIM_KS + ((N,) if N == 256 else ()):
            s, i = ts.topk_tools(tools, q_raw, k=k)
            s2, i2 = ts.topk_tools(tools, q_raw, k=k)
            w_s, w_i = topk_tools_ref(tools, qn, k)
            torch.cuda.synchronize()
            k_err = (s - w_s).abs().max().item()
            k_same = torch.equal(as_bits(s), as_bits(s2)) and \
                torch.equal(i, i2)
            k_idx = i.tolist() == w_i.tolist()
            ties = int((w_s == 0).sum().item())
            k_ok = k_idx and k_same and k_err <= SIM_TOL
            fused = lambda: ts.topk_tools(tools, q_raw, k=k)  # noqa: E731
            kms = median_ms(fused)
            kdev = kernel_device_ms(fused, "topk_kernel")
            plain = lambda: ts.top_k(ts.sim_scores_ref(  # noqa: E731
                tools, ts._normalize(q_raw)), k)
            kpms = median_ms(plain)
            klib = lambda: torch.topk(  # noqa: E731
                torch.matmul(tools, qn.T).amax(1), k)
            klms = median_ms(klib)
            klib_dev = kernel_device_ms(klib, "")
            kb, kby = bound_ms(4 * (N * d + m * d) + 12 * k,
                               2.0 * N * d * m, F32_FLOPS)
            kplan = ts.plan(N, d, m, k, sms)
            log(f"  topk_tools N={N} d={d} m={m} k={k} mq={kplan.mq} "
                f"grid={kplan.grid} {'lists' if kplan.lists else 'sort'}: indices "
                f"{'equal' if k_idx else 'DIFFER'} ({ties} exact 0.0 "
                f"ties in the top k) max_abs_err={k_err:.2e} repeat "
                f"{'bit-identical' if k_same else 'DIFFERS'} "
                f"ms={kms:.5f} device_ms={kdev:.5f} plain_ms="
                f"{kpms:.5f} library_ms={klms:.5f} library_device_ms="
                f"{klib_dev:.5f} bound_ms={kb:.6f} ({kby}) "
                f"device-scores_device={kdev - dev_ms:.5f} "
                f"{'ok' if k_ok else 'MISMATCH'}")
            if not k_ok:
                fail(f"topk_tools N={N} m={m} k={k}: indices equal {k_idx}, "
                     f"err {k_err}, repeat bit-identical {k_same}")
            rec.max_abs_err = max(rec.max_abs_err, k_err)
            if (N, m, k) == (256, 1, 16):
                rec.ms, rec.plain_ms, rec.library_ms = kms, kpms, klms
                rec.bound_ms, rec.bound_by = kb, kby
        del tools, q_raw, qn
    torch.cuda.empty_cache()


def ssd_work(Bb, S, H, P, G, N, Q):
    """Bytes and flops of one scan: each input read once and each output
    written once (bf16 x, B, C; f32 dt, A, y, state), and the operations the
    chunked form needs per chunk and head. The two masked Q x Q products
    need only the Q(Q+1)/2 pairs on and below the diagonal: C B^T (2N flops
    a pair) and L (x dt) (2P); C state^T and the state update take 2QPN
    each. Returns (bytes, C B^T flops, the other products' flops)."""
    nbytes = (Bb * S * H * P * 2 + Bb * S * H * 4 + H * 4
              + 2 * Bb * S * G * N * 2 + Bb * S * H * P * 4
              + Bb * H * P * N * 4)
    q = min(Q, S)
    tiles = Bb * H * (S // q)
    tri = q * (q + 1) // 2
    return (nbytes, tiles * 2 * tri * N,
            tiles * (2 * tri * P + 4 * q * P * N))


def ssd_bound(Bb, S, H, P, G, N, Q=128):
    """Least time for one scan at the precision SSD_TOL accepts: C B^T has
    bf16 operands, exact on the bf16 tensor cores with f32 accumulation; the
    three products with an f32 operand need more than bf16 (bf16 operands
    miss SSD_TOL), priced at the route the kernel takes, two bf16 parts a
    product (989 / 2 TFLOP/s); the two times add."""
    nbytes, flops_bf16, flops_f32 = ssd_work(Bb, S, H, P, G, N, Q)
    return bound_ms(nbytes, flops_bf16 + SSD_SPLIT_PARTS * flops_f32,
                    BF16_FLOPS)


def ssd_bound_f32(Bb, S, H, P, G, N, Q=128):
    """The same with the f32-operand products at the f32 CUDA-core rate
    (how the bound was priced before the tensor-core kernel)."""
    nbytes, flops_bf16, flops_f32 = ssd_work(Bb, S, H, P, G, N, Q)
    return bound_ms(nbytes, flops_f32 + flops_bf16 * F32_FLOPS / BF16_FLOPS,
                    F32_FLOPS)


def check_ssd(records):
    """The SSD chunk scan on bf16 x, B, C (the model's dtypes) against the
    plain scan on the same values in f32, at SSD_SHAPES: the mamba2-370m
    shapes the serving run gives it (its two admissions pad to 4 x 128 and
    4 x 512), longer prompts, a chunk of 40 rows and zamba2-7b's heads. Each
    shape is launched twice with bit-identical results. Times by device
    time (the one kernel a call runs) with CUDA events beside, against the
    bound at the precision the tolerance accepts and the f32-priced one.
    The kernels line reports mamba2-370m at B = 1, S = 2048."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked
    rec = records["ssd_bshp"]
    g = torch.Generator(device="cuda").manual_seed(5)
    for label, Bb, S, H, P, G, N, Q in SSD_SHAPES:
        x = torch.randn((Bb, S, H, P), generator=g, device="cuda").bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn((Bb, S, H), generator=g, device="cuda"))
        A = -torch.exp(0.5 * torch.randn((H,), generator=g, device="cuda"))
        Bm = (0.3 * torch.randn((Bb, S, G, N), generator=g,
                                device="cuda")).bfloat16()
        Cm = (0.3 * torch.randn((Bb, S, G, N), generator=g,
                                device="cuda")).bfloat16()
        run = lambda: ssd_ops.launch(x, dt, A, Bm, Cm, chunk=Q)  # noqa: E731
        y, fs = run()
        y2, fs2 = run()
        y_ref, fs_ref = ssd_chunked(x.float(), dt, A, Bm.float(), Cm.float(),
                                    Q)
        torch.cuda.synchronize()
        same = torch.equal(y, y2) and torch.equal(fs, fs2)
        err_y = (y - y_ref).abs().max().item()
        err_fs = (fs - fs_ref).abs().max().item()
        err = max(err_y, err_fs)
        ok = bool(torch.isfinite(y).all().item()
                  and torch.isfinite(fs).all().item()) and err < SSD_TOL \
            and same
        ms = time_ms(run, iters=20)
        dev_ms = kernel_device_ms(run, "ssd_kernel", n=20)
        plain = lambda: ssd_chunked(x, dt, A, Bm, Cm, Q)  # noqa: E731
        pms = time_ms(plain, iters=5, warmup=1)
        b, by = ssd_bound(Bb, S, H, P, G, N, Q)
        b32, _ = ssd_bound_f32(Bb, S, H, P, G, N, Q)
        p = ssd_ops.plan(Bb, S, H, P, G, N, Q, ssd_ops._sm_count(x.device))
        log(f"  ssd_bshp {label} B={Bb} S={S} H={H} P={P} N={N} Q={Q} "
            f"grid={p.grid}: max_abs_err y={err_y:.2e} state={err_fs:.2e} "
            f"(tol {SSD_TOL}) max|y|={y_ref.abs().max().item():.2f} repeat "
            f"{'bit-identical' if same else 'DIFFERS'} ms={ms:.4f} "
            f"device_ms={dev_ms:.4f} plain_ms={pms:.4f} bound_ms={b:.5f} "
            f"({by}) bound/device={b / dev_ms:.3f} bound_f32_ms={b32:.5f} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"ssd_bshp {label} B={Bb} S={S} err {err} repeat "
                 f"bit-identical {same}")
        rec.max_abs_err = max(rec.max_abs_err, err)
        if (label, Bb, S) == ("mamba2-370m", 1, 2048):
            rec.ms, rec.plain_ms, rec.bound_ms, rec.bound_by = ms, pms, b, by
        del x, dt, Bm, Cm, y, fs, y2, fs2, y_ref, fs_ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4. serving at full width
# ---------------------------------------------------------------------------


def _requests(seed: int, vocab: int):
    """8 prompts: four share a 32-token tool prefix (at one length, so their
    left padding and the shared blocks line up), four are unrelated."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(2, vocab, size=32)]
    prompts = []
    for i in range(8):
        n = 16 if i % 2 == 0 else 9 + 5 * i
        tail = [int(t) for t in rng.integers(2, vocab, size=n)]
        prompts.append(prefix + tail if i % 2 == 0 else tail)
    return prompts


def _cold_requests(seed: int, vocab: int):
    """8 prompts of 64 random tokens, one bucket's length: no padding and
    no common block, so a paged engine admits every one of them cold."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, vocab, size=64)]
            for _ in range(8)]


def serve_once(cfg, variants, kv_cache_dtype, prompts, max_new, swap_at,
               label, expect, device="cuda"):
    """One engine, one main path: submit every prompt, step until drained
    (hot-swapping Q8 -> Q4 after `swap_at` steps when given), check and
    report. The launch counters are set to 0 just before the run and read
    just after it; every kernel named in `expect` must have launched.
    Returns this path's counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.config import RuntimeConfig
    from repro_torch.serving import (EngineClient, ServingEngine,
                                     SessionRequest, check_invariants)
    from repro_torch.serving.scheduler import DONE
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    eng = ServingEngine(cfg, variants["q8"],
                        RuntimeConfig(kv_cache_dtype=kv_cache_dtype),
                        max_batch=4, max_seq=256, block_size=16,
                        kv_layout="paged", device=device, seed=0)
    eng.variant_name = "q8"
    client = EngineClient(eng)
    kernels.reset_launch_counts()
    handles = [client.submit(SessionRequest(prompt=p, max_new_tokens=max_new,
                                            eos_id=-1)) for p in prompts]
    steps = 0
    decode_s, decode_tokens = {"q8": 0.0, "q4": 0.0}, {"q8": 0, "q4": 0}
    while eng.has_work():
        if swap_at is not None and steps == swap_at:
            eng.swap_params(variants["q4"], "q4")
        variant = eng.variant_name
        sync()
        t0 = time.perf_counter()
        eng.step()
        sync()
        dt = time.perf_counter() - t0
        rec = eng.step_log[-1]
        if rec["kind"] == "decode":
            decode_s[variant] += dt
            decode_tokens[variant] += rec["tokens"]
        steps += 1
        if steps > 10000:
            fail(f"{label}: engine did not drain")
    launches = kernels.launch_counts()
    reqs = [h.request for h in handles]
    bad = [r.rid for r in reqs if r.status != DONE
           or len(r.output) != max_new]
    if bad:
        fail(f"{label}: requests not DONE with {max_new} tokens: {bad}")
    stats = eng.stats()
    hits = stats.prefix_cache.get("hits", 0)
    saved = stats.prefix_cache.get("prefill_tokens_saved", 0)
    if hits <= 0 or saved <= 0:
        fail(f"{label}: no prefix-cache hits (hits={hits}, saved={saved})")
    if device == "cuda" and eng.kernel_fallbacks != 0:
        fail(f"{label}: kernel_fallbacks = {eng.kernel_fallbacks}")
    errs = check_invariants(eng, reqs)
    if errs:
        fail(f"{label}: invariant violations: {errs}")
    for r in reqs:
        if any(not (0 <= t < cfg.vocab_size) for t in r.output):
            fail(f"{label}: rid {r.rid} emitted an out-of-vocab token")
    for v in ("q8", "q4"):
        if decode_tokens[v]:
            log(f"  {label} decode[{v}]: {decode_tokens[v]} tokens in "
                f"{decode_s[v]:.3f} s host clock incl. sync -> "
                f"{decode_tokens[v] / decode_s[v]:.1f} tokens/s, "
                f"{1e3 * decode_s[v] / max(1, sum(1 for s in eng.step_log if s['kind'] == 'decode' and s['variant'] == v)):.2f} ms/step")
    log(f"  {label}: {len(reqs)} DONE, steps={steps}, prefix hits={hits} "
        f"({saved} prompt tokens from cache), "
        f"cow={stats.prefix_cache.get('cow', 0)}, swaps={eng.swap_count}, "
        f"kernel_fallbacks={eng.kernel_fallbacks}, invariants clean, "
        f"launches={launches}")
    idle = [k for k in expect if launches[k] <= 0]
    if device == "cuda" and idle:
        fail(f"{label}: kernels never launched on this path: {idle}")
    return launches


def decode_step_ms(cfg, params, kv_cache_dtype, label):
    """Device time of one full-width decode step at batch 4 (CUDA events)."""
    import torch
    from repro_torch.config import RuntimeConfig
    from repro_torch.models import get_model
    from repro_torch.sharding.param import init_params
    model = get_model(cfg)
    rcfg = RuntimeConfig(kv_cache_dtype=kv_cache_dtype)
    nb = 16
    pool = init_params(model.paged_cache_spec(rcfg, 4 * nb + 1, 16),
                       torch.Generator(device="cuda").manual_seed(0), "cuda")
    bt = (torch.arange(4 * nb, dtype=torch.int32, device="cuda")
          .reshape(4, nb) + 1)
    lens = torch.tensor([64, 96, 128, 160], dtype=torch.int32, device="cuda")
    toks = torch.ones((4, 1), dtype=torch.int32, device="cuda")
    step = lambda: model.decode_step_paged(params, pool, toks, lens, bt,  # noqa: E731
                                           rcfg, seq_cap=256)
    ms = time_ms(step, iters=5, warmup=1)
    log(f"  decode step {label}: {ms:.2f} ms on the device timeline (CUDA "
        f"events) at batch 4 -> {4e3 / ms:.1f} tokens/s")
    profile_window(step, label)
    return ms


def prefill_attention_share(cfg, params, label, B=4, S=64):
    """One cold prefill of B x S prompt tokens (the serve path's admission
    at its 64-token bucket): its time by CUDA events, its kernels' busy time
    and the flash kernel's part of it (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import RuntimeConfig
    from repro_torch.models import get_model
    model = get_model(cfg)
    toks = torch.randint(2, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(4)).cuda()
    pre = lambda: model.prefill(params, {"tokens": toks},  # noqa: E731
                                RuntimeConfig())
    ms = time_ms(pre, iters=3, warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pre()
        torch.cuda.synchronize()
    busy = flash = 0.0
    calls = 0
    for e in prof.key_averages():
        busy += e.self_device_time_total / 1e3
        if "flash_kernel" in e.key:
            flash += e.self_device_time_total / 1e3
            calls += e.count
    log(f"  cold prefill {label} {B} x {S}: {ms:.2f} ms (CUDA events), "
        f"kernels busy {busy:.3f} ms, flash_attention {flash:.4f} ms over "
        f"{calls} launches: {flash / busy:.4f} of busy time, "
        f"{flash / ms:.4f} of the prefill")


def profile_window(step, label, n: int = 3):
    """Where a step's time goes: device self time by kernel over `n` steps
    (torch.profiler), and the share of the window with no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            step()
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    # device rows only: a CPU op's row repeats the time of the kernels it
    # launched, which have rows of their own
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log(f"  profile {label}: the profiler saw no device time")
        return
    log(f"  profile {label}: {n} steps in {window_ms:.2f} ms, kernels busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / window_ms:.3f}, "
        f"{sum(r[1] for r in rows) // n} launches a step")
    for ms, count, key in rows[:8]:
        log(f"    {ms / n:8.3f} ms/step {100 * ms / busy_ms:5.1f}%  "
            f"x{count // n:<4d} {key[:90]}")
    paged = [r for r in rows if "paged" in r[2]]
    if paged:
        pms = sum(r[0] for r in paged)
        log(f"    paged attention: {len(paged)} kernel row(s), "
            f"{sum(r[1] for r in paged) // n} launches/step, "
            f"{pms / n:.4f} ms/step, {pms / busy_ms:.4f} of busy time")


def draw_variants(cfg, device, label):
    """Full-width Q8 and Q4 trees of `cfg`, random from seed 0 on a
    generator on `device` and quantized there a layer slice at a time; logs
    the host seconds, the device memory allocated after the draw and the
    draw's peak. On the card, fails if the peak rose more than
    DRAW_PEAK_SLACK above what the finished trees hold."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.quant.qtensor import init_quantized
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    variants = init_quantized(get_model(cfg).param_spec(), ("q8", "q4"), gen,
                              device)
    sync()
    mem = ""
    if cuda:
        after = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
        mem = (f"; {after / 2**30:.2f} GiB allocated after the draw, its "
               f"peak {peak / 2**30:.2f} GiB ({(peak - after) / 2**30:.2f} "
               f"GiB above the finished trees)")
    log(f"{label}: {cfg.name} ({cfg.num_layers} layers, d={cfg.d_model}) "
        f"q8+q4 weights made on {device} in {time.perf_counter() - t0:.1f} s "
        f"(host clock){mem}")
    if cuda and peak - after > DRAW_PEAK_SLACK:
        fail(f"{label}: the draw peaked {(peak - after) / 2**30:.2f} GiB "
             f"above the finished trees (limit "
             f"{DRAW_PEAK_SLACK / 2**30:.0f} GiB)")
    return variants


def serve_paged(cfg, variants, device, label):
    """Phase 4's two paged paths on `variants`: bf16 KV with a Q8 -> Q4 swap
    at step 12, then int8 KV on Q8, each a main path of its own. Returns
    their counts summed."""
    from repro_torch import kernels
    prompts = _requests(0, cfg.vocab_size)
    per_path = [
        serve_once(cfg, variants, "bf16", prompts, 8, swap_at=12,
                   label="bf16-KV q8->q4", expect=MODEL_KERNELS,
                   device=device),
        serve_once(cfg, variants, "int8", prompts, 8, swap_at=None,
                   label="int8-KV q8", expect=("q8_matmul", "paged_attention",
                                               "flash_attention"),
                   device=device),
    ]
    launches = {k: sum(p[k] for p in per_path) for k in kernels.KERNELS}
    log(f"{label}: main-path launches, both paths summed: {launches}")
    return launches


def phase_serve(device="cuda", model_cfg=None):
    """Full-width carboncall-qwen2-7b (unless `model_cfg` says otherwise) on
    the paged engine: `serve_paged`'s two paths, then decode steps for Q8 /
    Q4 on bf16 / int8 KV and cold prefills at 4 x 64 and 4 x 256 (on the
    card only). Returns the paths' counts summed and the step times."""
    from repro_torch.common.registry import get_arch
    cfg = model_cfg if model_cfg is not None \
        else get_arch("carboncall-qwen2-7b")
    variants = draw_variants(cfg, device, "serve")
    launches = serve_paged(cfg, variants, device, "serve")
    times = {}
    if device == "cuda":
        for kv in ("bf16", "int8"):
            for fmt in ("q8", "q4"):
                times[fmt, kv] = decode_step_ms(cfg, variants[fmt], kv,
                                                f"{fmt} {kv}-KV")
        for S in (64, 256):
            prefill_attention_share(cfg, variants["q8"], "q8", S=S)
    del variants
    free_device(device)
    return launches, times


# ---------------------------------------------------------------------------
# 5. mamba2-370m on the dense engine
# ---------------------------------------------------------------------------


def _mamba_prompts(seed: int, vocab: int):
    """8 prompts of 32-300 tokens: the first four pad to the 128 bucket (one
    chunk), the last four to 512 (four chunks)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, vocab, size=n)]
            for n in (32, 45, 77, 60, 300, 150, 200, 33)]


def serve_dense_swap(cfg, variants, device, label, kv_cache_dtype="bf16",
                     expect=("ssd_bshp", "q8_matmul", "q4_matmul")):
    """An attention-free or hybrid model on the dense engine
    (`kv_layout="auto"`), one main path: `_mamba_prompts` with 8 new tokens
    each, Q8 with a hot swap to Q4 after 8 steps. The launch counters are
    set to 0 just before the run and read just after; every kernel in
    `expect` must launch, ssd_bshp once a mamba block a prefill step and
    flash_attention once an attention block a prefill step, and the paged
    kernel never. Returns this path's counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.config import RuntimeConfig
    from repro_torch.serving import (EngineClient, ServingEngine,
                                     SessionRequest, check_invariants)
    from repro_torch.serving.scheduler import DONE
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    eng = ServingEngine(cfg, variants["q8"],
                        RuntimeConfig(kv_cache_dtype=kv_cache_dtype),
                        max_batch=4, max_seq=512, kv_layout="auto",
                        device=device, seed=0)
    if eng.kv_layout != "dense":
        fail(f"{label}: kv_layout resolved to {eng.kv_layout}")
    eng.variant_name = "q8"
    client = EngineClient(eng)
    nonfinite = []
    sample = eng._sample

    def checked_sample(logits, req):
        if not bool(torch.isfinite(logits).all()):
            nonfinite.append(req.rid)
        return sample(logits, req)

    eng._sample = checked_sample
    prompts = _mamba_prompts(1, cfg.vocab_size)
    max_new, swap_at = 8, 8
    sync()
    kernels.reset_launch_counts()
    handles = [client.submit(SessionRequest(prompt=p, max_new_tokens=max_new,
                                            eos_id=-1)) for p in prompts]
    steps = 0
    host_s = {"prefill": 0.0, "decode": 0.0}
    while eng.has_work():
        if steps == swap_at:
            eng.swap_params(variants["q4"], "q4")
        sync()
        t0 = time.perf_counter()
        eng.step()
        sync()
        host_s[eng.step_log[-1]["kind"]] += time.perf_counter() - t0
        steps += 1
        if steps > 1000:
            fail(f"{label}: engine did not drain")
    launches = kernels.launch_counts()
    reqs = [h.request for h in handles]
    bad = [r.rid for r in reqs if r.status != DONE
           or len(r.output) != max_new]
    if bad:
        fail(f"{label}: requests not DONE with {max_new} tokens: {bad}")
    if nonfinite:
        fail(f"{label}: non-finite logits for rids {nonfinite}")
    if device == "cuda" and eng.kernel_fallbacks != 0:
        fail(f"{label}: kernel_fallbacks = {eng.kernel_fallbacks}")
    errs = check_invariants(eng, reqs)
    if errs:
        fail(f"{label}: invariant violations: {errs}")
    if any(not (0 <= t < cfg.vocab_size) for r in reqs for t in r.output):
        fail(f"{label}: an out-of-vocab token")
    kinds = [(e["kind"], e["variant"], e["prompt_tokens"])
             for e in eng.step_log]
    prefills = sum(k == "prefill" for k, _, _ in kinds)
    variants_seen = {v for _, v, _ in kinds}
    log(f"  {label}: {len(reqs)} DONE, steps={steps} ({prefills} "
        f"prefill, {len(kinds) - prefills} decode), variants "
        f"{sorted(variants_seen)}, swaps={eng.swap_count}, "
        f"kernel_fallbacks={eng.kernel_fallbacks}, logits finite, "
        f"invariants clean, launches={launches}; host clock incl. sync: "
        f"prefill steps {host_s['prefill']:.3f} s, decode steps "
        f"{host_s['decode']:.3f} s")
    if variants_seen != {"q8", "q4"} or eng.swap_count != 1:
        fail(f"{label}: no live Q8 -> Q4 swap ({variants_seen})")
    if device == "cuda":
        idle = [k for k in expect if launches[k] <= 0]
        if idle:
            fail(f"{label}: kernels never launched on this path: {idle}")
        n_attn = cfg.num_attn_layers()
        for k, per in (("ssd_bshp", cfg.num_layers - n_attn),
                       ("flash_attention", n_attn),
                       ("paged_attention", 0)):
            if launches[k] != per * prefills:
                fail(f"{label}: {k} launched {launches[k]} times for "
                     f"{prefills} prefills of {per} blocks")
    return launches


def prefill_vs_plain(model, params, toks, rcfg, label, rel, by_row=True):
    """One prefill of `toks` through the kernels against the same prefill
    with the ssd scan and prefill attention swapped for their plain
    versions, on the same device: every logit within `rel` of the row's
    max |logit| (of the batch's without `by_row`, as the mamba2 check has
    read it since PR 16), at least 1, and the greedy token equal wherever
    the plain run's top-2 margin is at least twice that. Returns the worst
    |difference| over that scale."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked
    logits, _, _ = model.prefill(params, {"tokens": toks}, rcfg)
    launch_ssd, launch_fa = ssd_ops.ssd, fa_ops.flash_attention
    ssd_ops.ssd = lambda x, dt, A, Bm, Cm, *, chunk: ssd_chunked(  # noqa: E731
        x, dt, A, Bm, Cm, chunk)
    fa_ops.flash_attention = flash_attention_ref
    try:
        plain, _, _ = model.prefill(params, {"tokens": toks}, rcfg)
    finally:
        ssd_ops.ssd, fa_ops.flash_attention = launch_ssd, launch_fa
    scale = plain.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    if not by_row:
        scale = scale.max().expand_as(scale)
    worst = ((logits - plain).abs().amax(dim=-1, keepdim=True)
             / scale).max().item()
    top2 = plain.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) >= 2 * rel * scale[:, 0]
    same = bool((logits.argmax(-1) == plain.argmax(-1))[sure].all().item())
    ok = bool(torch.isfinite(logits).all().item()) and worst <= rel and same
    B, S = toks.shape
    log(f"  {label} prefill {B} x {S}, kernels vs plain ssd scan and "
        f"attention: max |logit diff| {worst:.4f} of the "
        f"{'row' if by_row else 'batch'}'s max |logit| "
        f"(tol {rel}), greedy tokens equal on {int(sure.sum())} of {B} "
        f"rows {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label}: kernel prefill differs from the plain one ({worst})")
    return worst


def phase_serve_mamba2(device="cuda", model_cfg=None):
    """Full-width mamba2-370m (unless `model_cfg` says otherwise) on the
    dense engine, Q8 then Q4 after a hot swap (`serve_dense_swap`, a main
    path); then decode and prefill times, the tied head's, and the kernel
    prefill against the plain scan. Returns the path's counts."""
    import torch
    from repro_torch.common.registry import get_arch
    from repro_torch.config import RuntimeConfig
    from repro_torch.models import get_model
    from repro_torch.models.transformer import unembed
    from repro_torch.quant.qtensor import init_quantized
    from repro_torch.sharding.param import init_params
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cfg = model_cfg if model_cfg is not None else get_arch("mamba2-370m")
    model = get_model(cfg)
    spec = model.param_spec()
    # the weights are drawn on a CPU generator, so a seed gives the same
    # model on the CPU and on the card
    sync()
    t0 = time.perf_counter()
    variants = init_quantized(spec, ("q8", "q4"), torch.Generator(), device)
    sync()
    log(f"serve_mamba2: {cfg.name} ({cfg.num_layers} layers, "
        f"d={cfg.d_model}) q8+q4 weights drawn on the CPU and quantized on "
        f"{device} in {time.perf_counter() - t0:.2f} s (host clock)")
    launches = serve_dense_swap(cfg, variants, device, "serve_mamba2")
    rcfg = RuntimeConfig()
    # device times of one decode step at batch 4 and one S = 512 prefill of
    # four rows (the engine's shapes), and that prefill through the kernel
    # against the same prefill through the plain scan
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(2, cfg.vocab_size, (4, 512), generator=g).to(device)
    timer = time_ms if device == "cuda" else (
        lambda fn, iters=1, warmup=0: float("nan"))
    for fmt in ("q8", "q4"):
        cache = init_params(model.cache_spec(rcfg, 4, 512), None, device)
        step = lambda: model.decode_step(  # noqa: E731
            variants[fmt], cache, toks[:, :1], None, rcfg)
        ms = timer(step, iters=5, warmup=1)
        pre = lambda: model.prefill(variants[fmt], {"tokens": toks}, rcfg)  # noqa: E731
        pms = timer(pre, iters=3, warmup=1)
        log(f"  mamba2 {fmt}: decode step {ms:.2f} ms at batch 4, prefill "
            f"{pms:.2f} ms at 4 x 512 tokens (device timeline, CUDA events)")
        if device == "cuda" and fmt == "q8":
            profile_window(step, "mamba2 decode q8")
            profile_window(pre, "mamba2 prefill q8 (4 x 512)", n=1)
            # the tied head of that step alone: the (vocab, d) embedding
            # table cast to f32, then an f32 product
            h = torch.randn((4, 1, cfg.d_model), generator=g).to(
                device, torch.bfloat16)
            head_ms = timer(lambda: unembed(variants[fmt], h, cfg),
                            iters=5, warmup=1)
            log(f"  mamba2 tied head (embed cast to f32 + f32 product) at "
                f"batch 4: {head_ms:.3f} ms of the decode step (CUDA events)")
    prefill_vs_plain(model, variants["q8"], toks, rcfg, "mamba2 q8",
                     MAMBA_LOGIT_REL, by_row=False)
    del variants
    free_device(device)
    return launches


# ---------------------------------------------------------------------------
# 6. the CarbonCall runtime end to end
# ---------------------------------------------------------------------------


def run_runtime(label, ci, device="cuda", model_cfg=None, config=None,
                profile="qwen2-7b"):
    """`run_week` with the carboncall policy over the CI trace `ci`, every
    query selected by `ToolSelector` and served by `EngineExecutor` (on
    full-width carboncall-qwen2-7b unless `model_cfg` says otherwise, sized
    by `config` when given, its steps priced from `PAPER_MODELS[profile]`). The launch counters are set to 0 just before
    the run and read just after. Checks what every runtime path must hold
    and returns (records, executor, this path's counts, the draft lengths
    the executor set)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.common.hardware import ORIN_AGX
    from repro_torch.common.registry import get_arch
    from repro_torch.core import (ORIN_MODES, PAPER_MODELS, POLICIES,
                                  CarbonCallRuntime, EngineExecutor,
                                  ToolSelector, run_week)
    from repro_torch.data.workload import FunctionCallWorkload, build_catalog
    from repro_torch.serving import check_invariants
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cfg = model_cfg if model_cfg is not None \
        else get_arch("carboncall-qwen2-7b")
    t0 = time.perf_counter()
    ex = EngineExecutor(PAPER_MODELS[profile], ORIN_AGX, model_cfg=cfg,
                        seed=0, device=device, config=config)
    catalog = build_catalog(240, seed=0)
    sel = ToolSelector(catalog, seed=0, device=device)
    rt = CarbonCallRuntime(selector=sel, executor=ex,
                           policy=POLICIES["carboncall"], modes=ORIN_MODES,
                           catalog_size=len(catalog.tools), seed=0)
    sync()
    log(f"{label}: {cfg.name} ({cfg.num_layers} layers, d={cfg.d_model}), "
        f"profile {profile}; q8+q4 weights and a {tuple(sel.index.shape)} "
        f"tool index made on "
        f"{device} in {time.perf_counter() - t0:.1f} s (host clock); "
        f"engine {ex.config}")
    # count what the path does, beside the kernels' own counters, and the
    # host time of tool selection (it ends in a copy to the host, so the
    # host clock around it includes its device work)
    retrievals, requests, select_s, ks = [0], [], [0.0], []
    retrieve, select, submit = sel.retrieve, sel.select, ex.engine.submit
    set_k = ex.engine.set_draft_k

    def counted_retrieve(query):
        retrievals[0] += 1
        return retrieve(query)

    def timed_select(query):
        t = time.perf_counter()
        out = select(query)
        select_s[0] += time.perf_counter() - t
        return out

    def recorded_submit(req):
        requests.append(req)
        return submit(req)

    def recorded_k(k):
        ks.append(k)
        return set_k(k)

    sel.retrieve, sel.select = counted_retrieve, timed_select
    ex.engine.submit, ex.engine.set_draft_k = recorded_submit, recorded_k
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_week(rt, FunctionCallWorkload(catalog, seed=3), np.asarray(ci),
                   queries_per_hour=RUNTIME_QPH, seed=0)
    sync()
    host_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    recs = res.records
    eng = ex.engine
    modes = {i + 1: sum(r.mode_idx == i for r in recs)
             for i in range(len(ORIN_MODES))}
    mix = {v: sum(r.variant == v for r in recs) for v in ("q8", "q4")}
    log(f"  {label}: {len(recs)} queries served in {host_s:.1f} s host "
        f"clock; mode residency (queries per mode) {modes}; variant mix "
        f"{mix}; swap_count={ex.swap_count}; {eng.tokens_emitted} tokens "
        f"decoded; {retrievals[0]} retrievals; {len(requests)} engine "
        f"requests; kernel_fallbacks={eng.kernel_fallbacks}; "
        f"launches={launches}")
    kinds = [e["kind"] for e in eng.step_log]
    log(f"  {label}, host clock: tool selection {select_s[0]:.3f} s "
        f"({1e3 * select_s[0] / max(len(recs), 1):.2f} ms per query), the "
        f"rest {host_s - select_s[0]:.1f} s over "
        f"{ {k: kinds.count(k) for k in sorted(set(kinds))} } steps")
    log(f"  {label}, virtual clock, Orin power model (not measured on the "
        f"card): mean latency {res.avg_latency:.3f} s, mean energy "
        f"{np.mean([r.energy_j for r in recs]):.2f} J, mean carbon "
        f"{1e3 * res.avg_carbon:.4f} mg per query, mean TPS "
        f"{res.avg_tps:.2f}, success {res.success_rate:.3f}")
    if not recs:
        fail(f"{label}: no query served")
    if any(not r.tps > 0 for r in recs):
        fail(f"{label}: a record has tps <= 0")
    errs = check_invariants(eng, requests)
    if errs:
        fail(f"{label}: invariant violations: {errs}")
    if device == "cuda":
        if eng.kernel_fallbacks != 0:
            fail(f"{label}: kernel_fallbacks = {eng.kernel_fallbacks}")
        if launches["sim_scores"] != retrievals[0] or retrievals[0] <= 0:
            fail(f"{label}: sim_scores launched {launches['sim_scores']} "
                 f"times for {retrievals[0]} retrievals")
    return recs, ex, launches, ks


def ramp_ci(clean: int, dirty: int):
    """`clean` ten-minute steps at RAMP_CI[0], then `dirty` at RAMP_CI[1]."""
    return [RAMP_CI[0]] * clean + [RAMP_CI[1]] * dirty


def phase_runtime(device="cuda", model_cfg=None, profile="qwen2-7b",
                  label="runtime", ramp=(RAMP_CLEAN, RAMP_DIRTY)):
    """The runtime over a clean-then-dirty CI ramp of `ramp` steps (priced
    from `PAPER_MODELS[profile]`): the governor must reach a low-power mode,
    the switcher must swap Q8 -> Q4 live, and the four model kernels must
    launch. Returns this path's counts."""
    from repro_torch.core import ORIN_MODES
    ci = ramp_ci(*ramp)
    recs, ex, launches, _ = run_runtime(label, ci, device, model_cfg,
                                        profile=profile)
    mix = {v: sum(r.variant == v for r in recs) for v in ("q8", "q4")}
    if mix["q8"] == 0 or mix["q4"] == 0 or ex.swap_count < 1:
        fail(f"{label}: no live Q8 -> Q4 swap (mix {mix}, "
             f"swap_count {ex.swap_count})")
    if max(r.mode_idx for r in recs) < len(ORIN_MODES) - 2:
        fail(f"{label}: the governor never reached a low-power mode")
    if device == "cuda":
        idle = [k for k in MODEL_KERNELS if launches[k] <= 0]
        if idle:
            fail(f"{label}: kernels never launched on this path: {idle}")
    del ex
    free_device(device)
    return launches


# ---------------------------------------------------------------------------
# 7. chunked prefill and speculative decoding
# ---------------------------------------------------------------------------


class _StepClock:
    """Per-step times of an engine by CUDA events (the host clock on the
    CPU), the emitting rids of each step, and the top-2 logit margin of
    every emission sampled through `_sample` (the margin rule's input).
    With `keep_rows` it keeps each emission's logits row (f32, on the
    device). With `ref` (another run's rows and tokens by rid) every
    emission, and every verify argmax, takes that run's token, so both
    follow one history, and each row emitted while the engine is on Q8
    and `ref` was too (`ref_q8[rid]` emissions) is compared with `ref`'s:
    `worst` is the largest |difference| over the reference row's max
    |logit|."""

    def __init__(self, eng, device, keep_rows=False, ref=None, ref_q8=None):
        import torch
        self.eng, self.device = eng, device
        self.ms, self.kinds, self.emitted, self.margins = [], [], [], {}
        self.rows, self.worst, self.compared = {}, 0.0, 0
        sample, emit, greedy = eng._sample, eng._emit, eng._greedy
        spec_step, last = eng._spec_step, {}

        def rec_sample(logits, req):
            lg = torch.as_tensor(logits).float()
            top = torch.topk(lg, 2, dim=-1).values
            last["lg"], last["m"] = lg, (top[:, 0] - top[:, 1]).cpu().numpy()
            return sample(logits, req)

        def rec_greedy(logits):
            out = greedy(logits)
            if logits.ndim == 3:             # the verify window
                last["verify"] = logits.float()
                for i, r in enumerate(eng.slots):
                    if r is None or ref is None:
                        continue
                    want = ref[1][r.rid]
                    for j in range(out.shape[1]):
                        if len(r.output) + j < len(want):
                            out[i, j] = want[len(r.output) + j]
            return out

        def rec_emit(req, slot, tok):
            n = len(req.output)
            if "j" in last:                  # inside a spec step
                j = last["j"].get(slot, 0)
                last["j"][slot] = j + 1
                row = last["verify"][slot, j]
            else:
                lg = last["lg"]
                row = lg[0 if len(lg) == 1 else slot]
                m = last["m"]
                self.margins.setdefault(req.rid, []).append(
                    float(m[0 if len(m) == 1 else slot]))
            if keep_rows:
                self.rows.setdefault(req.rid, []).append(row)
            if ref is not None:
                if eng.variant_name == "q8" and n < ref_q8[req.rid]:
                    want = ref[0][req.rid][n]
                    err = float((row - want).abs().max()
                                / want.abs().max().clamp_min(1e-30))
                    self.worst = max(self.worst, err)
                    self.compared += 1
                tok = ref[1][req.rid][n]
            emit(req, slot, tok)

        def rec_spec_step(completed):
            last["j"] = {}
            try:
                return spec_step(completed)
            finally:
                del last["j"]

        eng._sample, eng._emit, eng._greedy = rec_sample, rec_emit, rec_greedy
        eng._spec_step = rec_spec_step

    def step(self):
        import torch
        eng = self.eng
        if self.device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng.step()
            end.record()
            end.synchronize()
            self.ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            eng.step()
            self.ms.append(1e3 * (time.perf_counter() - t0))
        rec = eng.step_log[-1]
        self.kinds.append(rec["kind"])
        self.emitted.append([r for r in rec["rids"]
                             if rec["kind"] != "prefill" or rec["tokens"]]
                            if rec["kind"] != "prefill_chunk" else [])


def _forced_logits(label, clock):
    """Fail unless the teacher-forced run compared rows and every one was
    within ENGINE_LOGIT_REL of the reference run's."""
    log(f"  {label}, teacher-forced: {clock.compared} emissions compared, "
        f"worst |logit diff| {clock.worst:.5f} of the row's max |logit| "
        f"(limit {ENGINE_LOGIT_REL})")
    if clock.compared <= 0 or clock.worst > ENGINE_LOGIT_REL:
        fail(f"{label}: teacher-forced logits {clock.worst:.5f} over "
             f"{clock.compared} emissions")


def _margin_rule(label, got, want, margins, upto):
    """Tokens of `got` equal `want`'s (same rids, same prompts) among each
    rid's first `upto[rid]` emissions, up to the first emission whose top-2
    margin in the `want` run is below MARGIN_BOUND. Returns the count
    compared."""
    compared = total = 0
    for g, w in zip(got, want):
        n = upto[g.rid]
        total += n
        for a, b, m in zip(g.output[:n], w.output[:n],
                           margins.get(w.rid, [])):
            if m < MARGIN_BOUND:
                break
            if a != b:
                fail(f"{label}: rid {g.rid} emitted {a} where the plain run "
                     f"emitted {b} at a top-2 margin of {m:.4f}")
            compared += 1
    log(f"  {label}: tokens equal to the plain run's, {compared} of {total} "
        f"compared (up to each stream's first margin below {MARGIN_BOUND})")
    return compared


def _gaps_ms(clock, rids):
    """Longest time between two emissions of any of `rids`: the summed step
    times from one emitting step to the next."""
    worst = 0.0
    for rid in rids:
        steps = [i for i, e in enumerate(clock.emitted) if rid in e]
        for a, b in zip(steps, steps[1:]):
            worst = max(worst, sum(clock.ms[a + 1:b + 1]))
    return worst


def _serve_chunked(cfg, variants, chunk, device, layout="paged",
                   **clock_kw):
    """Two 40-token requests admit and decode; a 700- and a 900-token
    request arrive once they decode; a fifth, sharing the 900-token prompt's
    first 512 tokens at its length, arrives once that one runs (a prefix
    hit on the paged layout); once the fifth has emitted 8 tokens the
    engine swaps Q8 -> Q4. `clock_kw` goes to the step clock. Returns
    (engine, requests, step clock, tokens emitted before the swap per
    rid)."""
    import numpy as np
    from repro_torch.config import RuntimeConfig
    from repro_torch.serving import EngineClient, ServingEngine, SessionRequest
    from repro_torch.serving.scheduler import RUNNING
    rng = np.random.default_rng(7)

    def toks(n):
        return [int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]

    shorts, p700, p900 = [toks(40), toks(40)], toks(700), toks(900)
    shared = p900[:512] + toks(388)
    eng = ServingEngine(cfg, variants["q8"], RuntimeConfig(),
                        max_batch=4, max_seq=2048, block_size=16,
                        prompt_buckets=CHUNK_BUCKETS, kv_layout=layout,
                        prefill_chunk=chunk, device=device, seed=0)
    eng.variant_name = "q8"
    client = EngineClient(eng)
    clock = _StepClock(eng, device, **clock_kw)

    def submit(p):
        return client.submit(SessionRequest(prompt=p, max_new_tokens=32,
                                            eos_id=-1))

    hs = [submit(p) for p in shorts]
    pre_swap = None
    while eng.has_work():
        clock.step()
        if len(hs) == 2 and len(clock.ms) == 2:
            hs += [submit(p700), submit(p900)]
        if len(hs) == 4 and hs[3].request.status == RUNNING:
            hs.append(submit(shared))
        if pre_swap is None and len(hs) == 5 \
                and len(hs[4].request.output) >= 8:
            pre_swap = {h.rid: len(h.request.output) for h in hs}
            eng.swap_params(variants["q4"], "q4")
        if len(clock.ms) > 2000:
            fail("serve_spec_chunk: chunked engine did not drain")
    if pre_swap is None:
        fail("serve_spec_chunk: the chunked run never swapped to Q4")
    return eng, [h.request for h in hs], clock, pre_swap


def _serve_spec(cfg, variants, kv, k, prompts, device, *, draft_k_at=None,
                swap_at=None, profile_at=None, layout="paged", max_new=32,
                **clock_kw):
    """Temperature-0 requests of `max_new` new tokens on a Q8 engine
    drafting with Q4 (`k` None: plain Q8, on `layout`); `set_draft_k(4)`
    after `draft_k_at` steps and a swap to Q4 after `swap_at` steps when
    given; step `profile_at` under the profiler. `clock_kw` goes to the
    step clock. Returns (engine, requests, step clock, tokens emitted before
    the swap per rid)."""
    from repro_torch.config import RuntimeConfig
    from repro_torch.serving import (EngineClient, ServingEngine,
                                     SessionRequest, SpecDecodeConfig)
    eng = ServingEngine(cfg, variants["q8"],
                        RuntimeConfig(kv_cache_dtype=kv), max_batch=4,
                        max_seq=256, block_size=16, kv_layout=layout,
                        spec_decode=(None if k is None
                                     else SpecDecodeConfig("q4", k=k)),
                        device=device, seed=0)
    eng.variant_name = "q8"
    if k is not None:
        eng.set_draft_params(variants["q4"], "q4")
    client = EngineClient(eng)
    clock = _StepClock(eng, device, **clock_kw)
    hs = [client.submit(SessionRequest(prompt=p, max_new_tokens=max_new,
                                       eos_id=-1)) for p in prompts]
    pre_swap = None
    while eng.has_work():
        n = len(clock.ms)
        if draft_k_at is not None and n == draft_k_at:
            eng.set_draft_k(4)
        if swap_at is not None and n == swap_at:
            pre_swap = {h.rid: len(h.request.output) for h in hs}
            eng.swap_params(variants["q4"], "q4")
        if n == profile_at and device == "cuda":
            profile_window(clock.step, f"step {n}, "
                           f"{'plain' if k is None else f'spec k {k}'}", n=1)
        else:
            clock.step()
        if n > 2000:
            fail("serve_spec_chunk: spec engine did not drain")
    return eng, [h.request for h in hs], clock, pre_swap


def _check_engine(label, eng, reqs, max_new, device):
    from repro_torch.serving import check_invariants
    from repro_torch.serving.scheduler import DONE
    bad = [r.rid for r in reqs if r.status != DONE
           or len(r.output) != max_new]
    if bad:
        fail(f"{label}: requests not DONE with {max_new} tokens: {bad}")
    if device == "cuda" and eng.kernel_fallbacks != 0:
        fail(f"{label}: kernel_fallbacks = {eng.kernel_fallbacks}")
    st = eng.stats()
    errs = check_invariants(eng, reqs)
    if errs:
        fail(f"{label}: invariant violations: {errs}")
    return st


def _path_launches(label, launches, expect, device):
    if device == "cuda":
        idle = [k for k in expect if launches[k] <= 0]
        if idle:
            fail(f"{label}: kernels never launched on this path: {idle}")
    log(f"  {label}: launches={launches}")
    return launches


def chunk_window_ms(cfg, params, device, W=256, start=768, P=1024):
    """One middle chunk window as the engine runs it: W tokens after a
    `start`-token prefix gathered into P positions, the engine's max_batch
    of 4 rows (one real), no logits. CUDA events, and the kernels' busy
    time by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import RuntimeConfig
    from repro_torch.models import get_model
    model = get_model(cfg)
    g = torch.Generator(device=device).manual_seed(5)
    L, K, H = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    k_pre = torch.randn((L, 4, P, K, H), generator=g, device=device,
                        dtype=torch.float32).to(torch.bfloat16)
    v_pre = torch.randn_like(k_pre)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (4, W), generator=g,
                                     device=device, dtype=torch.int32),
             "positions": torch.arange(start, start + W, dtype=torch.int32,
                                       device=device)}
    plens = torch.tensor([start, 0, 0, 0], dtype=torch.int32, device=device)
    rcfg = RuntimeConfig()
    win = lambda: model.prefill_chunk(params, batch, k_pre, v_pre,  # noqa: E731
                                      plens, rcfg, need_logits=False)
    if device != "cuda":
        win()
        return None
    ms = time_ms(win, iters=3, warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        win()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    log(f"  chunk window q8 {W} tokens after {start} (P {P}, 4 rows): "
        f"{ms:.2f} ms (CUDA events), kernels busy {busy:.2f} ms")
    return ms


def chunked_vs_monolithic(cfg, variants, device, layout):
    """`_serve_chunked` on `layout` in windows of CHUNK against the same
    requests admitted whole: a main path of its own (counters set to 0 just
    before the chunked run, read just after), the kinds alternating, the Q8
    tokens by the margin rule, the teacher-forced logits within
    ENGINE_LOGIT_REL, and the residents' longest token gap both ways.
    Returns the chunked path's counts."""
    import numpy as np
    from repro_torch import kernels
    label = "chunked" if layout == "paged" else f"{layout} chunked"
    expect = MODEL_KERNELS if layout == "paged" else DENSE_KERNELS
    mono, mono_reqs, mono_clock, mono_pre = _serve_chunked(
        cfg, variants, None, device, layout, keep_rows=True)
    _check_engine(f"{label}: monolithic", mono, mono_reqs, 32, device)
    ref = (mono_clock.rows, {r.rid: r.output for r in mono_reqs})
    kernels.reset_launch_counts()
    eng, reqs, clock, pre = _serve_chunked(cfg, variants, CHUNK, device,
                                           layout)
    launches = _path_launches(label, kernels.launch_counts(), expect, device)
    st = _check_engine(label, eng, reqs, 32, device)
    log(f"  {label}: prefill_chunk {eng.prefill_chunk}, "
        f"chunk_steps={st.chunk_steps}, prefix hits "
        f"{st.prefix_cache.get('hits', 0)}, steps {len(clock.kinds)}")
    if st.chunk_steps <= 0 or eng.prefill_chunk != CHUNK:
        fail(f"{label}: no chunk window of {CHUNK}")
    if layout == "paged" and st.prefix_cache.get("prefill_tokens_saved",
                                                 0) <= 0:
        fail(f"{label}: no prefix hit")
    log_rows = eng.step_log
    for a, b in zip(log_rows, log_rows[1:]):
        if a["kind"] in ("prefill", "prefill_chunk") and b["resident_rids"] \
                and b["kind"] != "decode":
            fail(f"{label}: {a['kind']} followed by {b['kind']} while "
                 f"{b['resident_rids']} were resident")
    _margin_rule(f"{label} vs monolithic (Q8 tokens)", reqs, mono_reqs,
                 mono_clock.margins,
                 {rid: min(n, mono_pre[rid]) for rid, n in pre.items()})
    _, _, forced, _ = _serve_chunked(cfg, variants, CHUNK, device, layout,
                                     ref=ref, ref_q8=mono_pre)
    _forced_logits(f"{label} vs monolithic", forced)
    residents = [reqs[0].rid, reqs[1].rid]
    win = [m for m, k in zip(clock.ms, clock.kinds) if k == "prefill_chunk"]
    log(f"  {label} vs monolithic: the residents' longest gap between two "
        f"tokens {_gaps_ms(clock, residents):.1f} ms chunked, "
        f"{_gaps_ms(mono_clock, residents):.1f} ms monolithic (CUDA events "
        f"over whole steps); a {CHUNK}-token window step "
        f"{np.median(win):.1f} ms median of {len(win)}; monolithic "
        f"admission steps "
        f"{[round(m, 1) for m, k in zip(mono_clock.ms, mono_clock.kinds) if k == 'prefill']} ms")
    return launches


def phase_serve_spec_chunk(device="cuda", model_cfg=None):
    """Chunked prefill and speculative decoding on the paged engine, at full
    width (carboncall-qwen2-7b unless `model_cfg` says otherwise), then the
    runtime over an executor that uses both. Four main paths, each with its
    launch counters set to 0 just before it and read just after: the
    chunked engine, the spec engine on bf16 and on int8 KV, the runtime.
    Returns the paths' counts summed."""
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    from repro_torch.serving import EngineConfig, SpecDecodeConfig
    cfg = model_cfg if model_cfg is not None \
        else get_arch("carboncall-qwen2-7b")
    variants = draw_variants(cfg, device, "serve_spec_chunk")
    per_path = []

    # -- chunked prefill ----------------------------------------------------
    per_path.append(chunked_vs_monolithic(cfg, variants, device, "paged"))
    chunk_window_ms(cfg, variants["q8"], device)

    # -- speculative decoding ----------------------------------------------
    prompts = _requests(0, cfg.vocab_size)
    for kv in ("bf16", "int8"):
        label = f"spec {kv}-KV"
        plain, plain_reqs, plain_clock, _ = _serve_spec(
            cfg, variants, kv, None, prompts, device, keep_rows=True)
        ref = (plain_clock.rows, {r.rid: r.output for r in plain_reqs})
        kernels.reset_launch_counts()
        eng, reqs, clock, pre = _serve_spec(cfg, variants, kv, 2, prompts,
                                            device, draft_k_at=SPEC_K4_AT,
                                            swap_at=SPEC_SWAP_AT)
        per_path.append(_path_launches(
            label, kernels.launch_counts(),
            ("q8_matmul", "q4_matmul", "paged_attention"), device))
        st = _check_engine(label, eng, reqs, 32, device)
        kinds = [r["kind"] for r in eng.step_log]
        after = [r for r in eng.step_log[SPEC_SWAP_AT:]]
        ks = sorted({r["drafted"] // len(r["rids"]) for r in eng.step_log
                     if r["kind"] == "spec_verify"})
        log(f"  {label}: spec_steps={st.spec_steps}, draft_tokens="
            f"{st.draft_tokens}, accepted={st.accepted_tokens} (rate "
            f"{st.accept_rate:.3f}), draft lengths {ks}, steps "
            f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }")
        if st.spec_steps <= 0 or st.draft_tokens <= 0 \
                or st.accepted_tokens > st.draft_tokens or ks != [2, 4]:
            fail(f"{label}: spec counters or draft lengths wrong")
        if pre is None or any(r["kind"] == "spec_verify" for r in after):
            fail(f"{label}: spec did not stand down after the swap to Q4")
        _margin_rule(f"{label} vs plain Q8 (Q8 tokens)", reqs, plain_reqs,
                     plain_clock.margins, pre)
        forced = _serve_spec(cfg, variants, kv, 2, prompts, device,
                             draft_k_at=SPEC_K4_AT, swap_at=SPEC_SWAP_AT,
                             ref=ref, ref_q8={r.rid: 32 for r in reqs})[2]
        _forced_logits(f"{label} vs plain Q8", forced)
        del eng, plain, plain_clock, ref

    # -- times: plain Q8 against spec at k 2 and k 4, batch 4 --------------
    for k in (None, 2, 4):
        eng, reqs, clock, _ = _serve_spec(cfg, variants, "bf16", k,
                                          prompts[:4], device, profile_at=6)
        steps = [(m, r) for m, r in zip(clock.ms, eng.step_log)
                 if r["kind"] in ("decode", "spec_verify")]
        tokens = sum(r["tokens"] for _, r in steps)
        ms = sum(m for m, _ in steps)
        st = eng.stats()
        log(f"  spec times {'plain q8' if k is None else f'k {k}'}: "
            f"{tokens} tokens in {len(steps)} steps, {ms:.1f} ms (CUDA "
            f"events) -> {1e3 * tokens / ms:.1f} tokens/s at batch 4, "
            f"{ms / len(steps):.1f} ms a step, acceptance "
            f"{st.accept_rate:.3f}")
        del eng
    del variants
    free_device(device)

    # -- the runtime over a chunked, speculative executor -------------------
    config = EngineConfig(max_batch=2, prefill_chunk=RUNTIME_CHUNK,
                          spec_decode=SpecDecodeConfig(
                              "q4", k=2, k_ladder=RUNTIME_LADDER))
    recs, ex, launches, ks = run_runtime(
        "runtime spec+chunk", RUNTIME_SPEC_CI, device, model_cfg, config)
    per_path.append(_path_launches(
        "runtime spec+chunk", launches,
        ("q8_matmul", "q4_matmul", "paged_attention", "sim_scores"), device))
    st = ex.engine.stats()
    log(f"  runtime spec+chunk: draft lengths set {ks}, spec_steps="
        f"{st.spec_steps}, chunk_steps={st.chunk_steps}, accept rate "
        f"{st.accept_rate:.3f}")
    if len(set(ks)) < 2 or st.spec_steps <= 0 or st.chunk_steps <= 0:
        fail("runtime spec+chunk: fewer than two draft lengths, or no spec "
             "or chunk step")
    del ex
    free_device(device)
    return {k: sum(p[k] for p in per_path) for k in kernels.KERNELS}


# ---------------------------------------------------------------------------
# 8. the transformer's dense KV layout
# ---------------------------------------------------------------------------


def dense_decode_step_ms(cfg, params, kv_cache_dtype, label, max_seq):
    """Device time of one full-width dense decode step at batch 4 over
    stripes of `max_seq` positions, the rows at the paged timing's lengths
    (CUDA events), and where its time goes (profiler)."""
    import torch
    from repro_torch.config import RuntimeConfig
    from repro_torch.models import get_model
    from repro_torch.sharding.param import init_params
    model = get_model(cfg)
    rcfg = RuntimeConfig(kv_cache_dtype=kv_cache_dtype)
    cache = init_params(model.cache_spec(rcfg, 4, max_seq),
                        torch.Generator(device="cuda").manual_seed(0), "cuda")
    lens = torch.tensor([64, 96, 128, 160], dtype=torch.int32, device="cuda")
    toks = torch.ones((4, 1), dtype=torch.int32, device="cuda")
    step = lambda: model.decode_step(params, cache, toks, lens, rcfg)  # noqa: E731
    ms = time_ms(step, iters=5, warmup=1)
    log(f"  dense decode step {label}, max_seq {max_seq}: {ms:.2f} ms on the "
        f"device timeline (CUDA events) at batch 4 -> {4e3 / ms:.1f} "
        f"tokens/s")
    profile_window(step, f"dense {label} max_seq {max_seq}")
    return ms


class RouteTape:
    """The MoE routing of one engine run, call by call, and another run of
    the same calls made to take it: the MoE's counterpart of teacher-forcing
    tokens. Two runs round the hidden state apart in bf16 (the paged kernel
    against plain dense attention), which moves router logits by up to
    `drift`; a token whose neighbours among its k + 1 largest logits lie
    closer than ROUTE_MARGIN may then choose other experts and carry a
    different hidden state into every later layer. `record()` keeps every
    call's weights, experts and router logits; `replay(check)` hands them
    to the next run's calls in order, failing if a call routes another
    number of tokens, and with `check` counts how often that run's own
    choice is the recorded one where no near-tie allows a flip."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.calls = moe, moe._route, []

    def record(self):
        def route(x2d, router_w, cfg):
            w, i = self.route(x2d, router_w, cfg)
            self.calls.append((w, i, x2d.float() @ router_w.float()))
            return w, i
        self.moe._route = route

    def replay(self, check=False):
        self.n = self.total = self.sure = self.agree = 0
        self.drift = 0.0

        def route(x2d, router_w, cfg):
            if self.n >= len(self.calls):
                fail("route replay: more MoE calls than the recorded run's")
            w, i, lg = self.calls[self.n]
            self.n += 1
            if i.shape[0] != x2d.shape[0]:
                fail(f"route replay: call {self.n} routes {x2d.shape[0]} "
                     f"tokens, the recorded one {i.shape[0]}")
            if check:
                k = cfg.moe.experts_per_token
                _, own = self.route(x2d, router_w, cfg)
                mine = x2d.float() @ router_w.float()
                self.drift = max(self.drift, (mine - lg).abs().max().item())
                top = lg.topk(k + 1, dim=-1).values
                sure = (top[:, :-1] - top[:, 1:]).min(-1).values \
                    >= ROUTE_MARGIN
                self.total += len(sure)
                self.sure += int(sure.sum().item())
                self.agree += int(((own == i).all(-1) & sure).sum().item())
            return w, i
        self.moe._route = route

    def stop(self):
        self.moe._route = self.route

    def checked(self, label):
        """After a checked replay: every recorded call taken, and the run's
        own choice the recorded one for every token clear of a near-tie."""
        log(f"  {label}: MoE routing replayed over {self.n} calls, {self.total}"
            f" tokens; {self.sure} clear of a near-tie (ROUTE_MARGIN "
            f"{ROUTE_MARGIN}), its own choice the recorded one on "
            f"{self.agree}; router logit drift {self.drift:.2e}")
        if self.n != len(self.calls) or self.agree != self.sure \
                or self.drift >= ROUTE_MARGIN / 2:
            fail(f"{label}: MoE routing differs where no near-tie allows it")


def dense_vs_paged(cfg, variants, kv, device):
    """Phase 4's requests on the dense layout, a main path of its own
    (counters set to 0 just before it, read just after): on bf16 KV with a
    Q8 -> Q4 swap at step DENSE_SWAP_AT, on int8 KV without one. Its steps
    must be the paged engine's on the same weights, its Q8 tokens equal them
    by the margin rule, and, teacher-forced onto the paged engine's tokens,
    every Q8 row within ENGINE_LOGIT_REL. Returns the path's counts."""
    from repro_torch import kernels
    swap_at, expect = ((DENSE_SWAP_AT, DENSE_KERNELS) if kv == "bf16" else
                       (None, ("q8_matmul", "flash_attention")))
    # an MoE layer routes all the rows of one call together, under one
    # capacity: a prefix-cache hit (a shared prompt block, or blocks of
    # left padding) runs another call (the suffix alone) than the dense
    # engine's whole prompt and may drop other slots, so the MoE's prompts
    # share no block and both engines run the same calls
    prompts = (_cold_requests if cfg.family == "moe" else _requests)(
        0, cfg.vocab_size)
    label = f"dense {kv}-KV q8{'->q4' if swap_at else ''}"
    # and both dense runs take the paged run's routing (`RouteTape`)
    tape = RouteTape() if cfg.family == "moe" else None
    if tape:
        tape.record()
    paged, p_reqs, p_clock, p_pre = _serve_spec(
        cfg, variants, kv, None, prompts, device, swap_at=swap_at,
        max_new=8, keep_rows=True)
    _check_engine(f"{label}: paged", paged, p_reqs, 8, device)
    if tape:
        tape.replay()
    kernels.reset_launch_counts()
    eng, reqs, clock, pre = _serve_spec(
        cfg, variants, kv, None, prompts, device, swap_at=swap_at,
        layout="dense", max_new=8)
    launches = _path_launches(label, kernels.launch_counts(), expect, device)
    _check_engine(label, eng, reqs, 8, device)
    if eng.kv_layout != "dense":
        fail(f"{label}: kv_layout resolved to {eng.kv_layout}")
    steps = [(r["kind"], r["rids"], r["tokens"], r["variant"])
             for r in eng.step_log]
    if steps != [(r["kind"], r["rids"], r["tokens"], r["variant"])
                 for r in paged.step_log]:
        fail(f"{label}: the dense steps differ from the paged ones")
    q8 = pre if pre is not None else {r.rid: 8 for r in reqs}
    _margin_rule(f"{label} vs paged (Q8 tokens)", reqs, p_reqs,
                 p_clock.margins, q8)
    ref = (p_clock.rows, {r.rid: r.output for r in p_reqs})
    if tape:
        tape.replay(check=True)
    forced = _serve_spec(cfg, variants, kv, None, prompts, device,
                         swap_at=swap_at, layout="dense", max_new=8,
                         ref=ref, ref_q8=q8)[2]
    if tape:
        tape.stop()
        tape.checked(f"{label} vs paged")
    _forced_logits(f"{label} vs paged", forced)
    log(f"  {label}: {len(reqs)} DONE in {len(steps)} steps, "
        f"swaps={eng.swap_count}, step times (CUDA events) dense "
        f"{sum(clock.ms):.1f} ms, paged {sum(p_clock.ms):.1f} ms")
    if device == "cuda" and launches["paged_attention"] != 0:
        fail(f"{label}: the paged kernel ran on the dense layout")
    return launches


def phase_serve_dense(device="cuda", model_cfg=None):
    """Full-width carboncall-qwen2-7b (unless `model_cfg` says otherwise) on
    `kv_layout="dense"`. Three main paths, each with its launch counters set
    to 0 just before it and read just after: the serve phase's requests
    with a Q8 -> Q4 swap on bf16 KV, the same on int8 KV without a swap,
    each teacher-forced against the paged engine on the same weights; and
    the dense chunked engine against the dense monolithic one. Then dense
    and paged decode steps side by side. Returns the paths' counts
    summed."""
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    cfg = model_cfg if model_cfg is not None \
        else get_arch("carboncall-qwen2-7b")
    variants = draw_variants(cfg, device, "serve_dense")
    per_path = [dense_vs_paged(cfg, variants, kv, device)
                for kv in ("bf16", "int8")]
    per_path.append(chunked_vs_monolithic(cfg, variants, device, "dense"))
    launches = {k: sum(p[k] for p in per_path) for k in kernels.KERNELS}
    if device == "cuda" and launches["paged_attention"] != 0:
        fail("serve_dense: the paged kernel ran on the dense layout")
    log(f"serve_dense: main-path launches, three paths summed: {launches}")
    if device == "cuda":
        for fmt in ("q8", "q4"):
            decode_step_ms(cfg, variants[fmt], "bf16", f"{fmt} bf16-KV paged")
            for max_seq in DENSE_STEP_SEQS:
                dense_decode_step_ms(cfg, variants[fmt], "bf16",
                                     f"{fmt} bf16-KV", max_seq)
    del variants
    free_device(device)
    return launches


# ---------------------------------------------------------------------------
# 9. the CarbonCall runtime over mamba2
# ---------------------------------------------------------------------------


def phase_runtime_mamba2(device="cuda", model_cfg=None):
    """The runtime phase's loop over full-width mamba2-370m (unless
    `model_cfg` says otherwise) on the dense engine: the same workload and
    catalog over SHORT_RAMP; the executor's weights are drawn on a
    generator on `device`. A main path of its own: ssd_bshp (num_layers
    launches a prefill step), q8_matmul, q4_matmul and sim_scores must
    launch, with a live swap. Returns this path's counts."""
    from repro_torch.common.registry import get_arch
    cfg = model_cfg if model_cfg is not None else get_arch("mamba2-370m")
    ci = ramp_ci(*SHORT_RAMP)
    recs, ex, launches, _ = run_runtime("runtime_mamba2", ci, device, cfg)
    eng = ex.engine
    mix = {v: sum(r.variant == v for r in recs) for v in ("q8", "q4")}
    prefills = sum(e["kind"] == "prefill" for e in eng.step_log)
    log(f"  runtime_mamba2: kv_layout {eng.kv_layout}, {prefills} prefill "
        f"steps, variant mix {mix}, swaps {ex.swap_count}")
    if eng.kv_layout != "dense":
        fail(f"runtime_mamba2: kv_layout resolved to {eng.kv_layout}")
    if mix["q8"] == 0 or mix["q4"] == 0 or ex.swap_count < 1:
        fail(f"runtime_mamba2: no live Q8 -> Q4 swap (mix {mix}, "
             f"swap_count {ex.swap_count})")
    _path_launches("runtime_mamba2", launches,
                   ("ssd_bshp", "q8_matmul", "q4_matmul", "sim_scores"),
                   device)
    if device == "cuda" and launches["ssd_bshp"] != cfg.num_layers * prefills:
        fail(f"runtime_mamba2: ssd_bshp launched {launches['ssd_bshp']} "
             f"times for {prefills} prefills of {cfg.num_layers} layers")
    del ex, eng
    free_device(device)
    return launches


# ---------------------------------------------------------------------------
# 10-11. the paper's other two models: hermes2-pro-8b and llama3.1-8b
# ---------------------------------------------------------------------------


def serve_model(cfg, device, label, extra=None):
    """One full-width model, its trees drawn on `device` from seed 0
    (`draw_variants`) and freed at the end: phase
    4's two paged paths, one dense path on bf16 KV teacher-forced onto the
    paged engine's tokens, `extra(cfg, variants, device)`'s path where
    given, and (on the card) a decode step at batch 4 for Q8 and Q4 on
    bf16 KV. Returns the paths' counts, one dict a path."""
    variants = draw_variants(cfg, device, label)
    per_path = [serve_paged(cfg, variants, device, label),
                dense_vs_paged(cfg, variants, "bf16", device)]
    if extra is not None:
        per_path.append(extra(cfg, variants, device))
    if device == "cuda":
        for fmt in ("q8", "q4"):
            decode_step_ms(cfg, variants[fmt], "bf16",
                           f"{cfg.name} {fmt} bf16-KV")
    del variants
    free_device(device)
    return per_path


def phase_serve_paper_models(device="cuda", model_cfgs=None):
    """`serve_model` over each of PAPER_ARCHS (or `model_cfgs`), one at a
    time. Returns the paths' counts summed over both models."""
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    cfgs = model_cfgs or [get_arch(a) for a in PAPER_ARCHS]
    per_path = [p for cfg in cfgs for p in serve_model(
        cfg, device, f"serve_paper_models {cfg.name}")]
    launches = {k: sum(p[k] for p in per_path) for k in kernels.KERNELS}
    log(f"serve_paper_models: main-path launches, {len(per_path)} paths "
        f"summed: {launches}")
    return launches


def phase_runtime_paper_models(device="cuda", model_cfgs=None):
    """Phase 6's loop (the same workload and catalog, over SHORT_RAMP) over
    each of PAPER_ARCHS (or `model_cfgs`) at full width, priced from its
    own profile: each a main path of its own with a live Q8 -> Q4 swap, a
    low-power mode, and the four model kernels and sim_scores launched.
    Returns the paths' counts summed."""
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    cfgs = model_cfgs or [get_arch(a) for a in PAPER_ARCHS]
    per_path = []
    for arch, cfg in zip(PAPER_ARCHS, cfgs):
        label = f"runtime_paper_models {cfg.name}"
        per_path.append(_path_launches(
            label, phase_runtime(device, cfg, profile=arch, label=label,
                                 ramp=SHORT_RAMP),
            MODEL_KERNELS + ("sim_scores",), device))
    return {k: sum(p[k] for p in per_path) for k in kernels.KERNELS}


# ---------------------------------------------------------------------------
# 12. qwen2.5-32b at full width
# ---------------------------------------------------------------------------


def phase_serve_qwen25_32b(device="cuda", model_cfg=None):
    """`serve_model` over full-width qwen2.5-32b (unless `model_cfg` says
    otherwise), its trees drawn a layer slice at a time: on the card the
    draw may peak at most DRAW_PEAK_SLACK above the finished trees. Returns
    the paths' counts summed."""
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    cfg = model_cfg if model_cfg is not None else get_arch(QWEN25_ARCH)
    per_path = serve_model(cfg, device, f"serve_qwen25_32b {cfg.name}")
    launches = {k: sum(p[k] for p in per_path) for k in kernels.KERNELS}
    log(f"serve_qwen25_32b: main-path launches, {len(per_path)} paths "
        f"summed: {launches}")
    return launches


# ---------------------------------------------------------------------------
# 13. the carbon-aware fleet
# ---------------------------------------------------------------------------


def phase_fleet(device="cuda", model_cfg=None):
    """`build_fleet` over two regions of one pod each (a clean grid at half
    week 1's carbon intensity with an edge pod, a dirty one at 1.5x with a
    pod), engines at full-width carboncall-qwen2-7b (unless `model_cfg`
    says otherwise) on `device`, then `run_fleet(backend="engine")` over
    FLEET_STEPS ten-minute steps at FLEET_QPH queries an hour. A main path
    of its own: counters set to 0 just before the run, read just after.
    Every query must be served; a pod's engine must be built exactly when
    a query was routed to it; q8, paged and flash attention and sim_scores
    (once per retrieval) must launch, and q4 wherever a pod swapped; no
    step may fall back. Returns this path's counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    from repro_torch.core.fleet import (FleetSpec, RegionSpec, build_fleet,
                                        run_fleet)
    from repro_torch.data.workload import FunctionCallWorkload, build_catalog
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cfg = model_cfg if model_cfg is not None \
        else get_arch("carboncall-qwen2-7b")
    spec = FleetSpec(regions=(
        RegionSpec("clean", "week1", 0.5, (("edge", 1),)),
        RegionSpec("dirty", "week1", 1.5, (("pod", 1),))))
    catalog = build_catalog(32, seed=0)
    fleet = build_fleet(spec, catalog=catalog, seed=0, device=device,
                        model_cfg=cfg)
    sel = fleet.pods[0].runtime.selector
    workload = FunctionCallWorkload(catalog, seed=3)
    retrievals, arrivals = [0], [0]
    retrieve, sample = sel.retrieve, workload.sample

    def counted_retrieve(query):
        retrievals[0] += 1
        return retrieve(query)

    def counted_sample():
        arrivals[0] += 1
        return sample()

    sel.retrieve, workload.sample = counted_retrieve, counted_sample
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    recs = run_fleet(fleet, workload, n_steps=FLEET_STEPS,
                     queries_per_hour=FLEET_QPH, seed=0, backend="engine")
    sync()
    host_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    served = sum(len(r) for r in recs.values())
    log(f"fleet: {cfg.name} engines on {device}, {served} of {arrivals[0]} "
        f"queries served over {FLEET_STEPS} steps in {host_s:.1f} s host "
        f"clock (engine builds included); {retrievals[0]} retrievals; "
        f"region split (queries routed) "
        f"{ {r.name: r.routed for r in fleet.regions} }; launches={launches}")
    swapped = False
    for pod in fleet.pods:
        mine = recs[pod.pod_id]
        built = pod.client is not None
        ex = pod.runtime.executor
        swaps = ex.swap_count if built else 0
        swapped |= swaps > 0
        modes = {m: sum(r.mode_idx == m for r in mine)
                 for m in sorted({r.mode_idx for r in mine})}
        mix = {v: sum(r.variant == v for r in mine) for v in ("q8", "q4")}
        fallbacks = ex.engine.kernel_fallbacks if built else 0
        log(f"  fleet pod {pod.pod_id} ({pod.region}/{pod.profile}): "
            f"{len(mine)} queries served, engine built {built}, swaps "
            f"{swaps}, mode residency {modes}, variant mix {mix}, "
            f"kernel_fallbacks {fallbacks}")
        if built != bool(mine):
            fail(f"fleet pod {pod.pod_id}: engine built {built} with "
                 f"{len(mine)} queries routed to it")
        if device == "cuda" and fallbacks:
            fail(f"fleet pod {pod.pod_id}: kernel_fallbacks = {fallbacks}")
    if served != arrivals[0] or served <= 0:
        fail(f"fleet: {served} of {arrivals[0]} queries served")
    stats = fleet.engine_stats()
    log(f"  fleet EngineStats.merge: admitted={stats.admitted} "
        f"tokens={stats.tokens_emitted} swaps={stats.swap_count}")
    expect = ("q8_matmul", "paged_attention", "flash_attention",
              "sim_scores") + (("q4_matmul",) if swapped else ())
    _path_launches("fleet", launches, expect, device)
    if device == "cuda" and launches["sim_scores"] != retrievals[0]:
        fail(f"fleet: sim_scores launched {launches['sim_scores']} times "
             f"for {retrievals[0]} retrievals")
    del fleet, sel
    return launches


# ---------------------------------------------------------------------------
# 14. worker processes behind the control protocol
# ---------------------------------------------------------------------------


def phase_workers(device="cuda", model_cfg=None):
    """`launch_workers` with WORKER_COUNT raw-mode specs of full-width
    carboncall-qwen2-7b (unless `model_cfg` says otherwise) on `device`, the
    serve launcher's `--workers` shape: WORKER_REQUESTS temperature-0
    requests round-robin across them over the wire, a `swap` op, the
    workers' `EngineStats.merge`; then the workers shut down and an
    in-process `EngineActor` built from the first worker's spec and seed
    serves that worker's requests, whose tokens must equal the worker's,
    token for token. On the card, a worker given a device ordinal the
    machine lacks must make `launch_workers` raise. This path's counts are
    the workers' (over the wire) and the twin's, summed."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    from repro_torch.launch.workers import (EngineActor, launch_workers,
                                            shutdown_workers)
    from repro_torch.serving import (EngineConfig, EngineStats,
                                     ProtocolError, SessionRequest,
                                     WorkerSpec, session_request_to_wire)
    cfg = model_cfg if model_cfg is not None \
        else get_arch("carboncall-qwen2-7b")
    econfig = EngineConfig(max_batch=4, max_seq=128)
    specs = [WorkerSpec(config=econfig, model_cfg=dataclasses.asdict(cfg),
                        seed=w, label=f"serve-w{w}")
             for w in range(WORKER_COUNT)]
    prompts = _requests(0, cfg.vocab_size)[:WORKER_REQUESTS]
    mine = {w: [SessionRequest(prompt=p, max_new_tokens=WORKER_NEW,
                               eos_id=-1, temperature=0.0)
                for i, p in enumerate(prompts) if i % WORKER_COUNT == w]
            for w in range(WORKER_COUNT)}
    t0 = time.perf_counter()
    workers = launch_workers(specs, device=device)
    log(f"workers: {len(workers)} raw-mode workers of {cfg.name} on "
        f"{device} ready in {time.perf_counter() - t0:.1f} s host clock")
    try:
        for w in workers:
            r = w.ready_s
            log(f"  worker {w.label}: ready after spawn {r['spawn']:.1f} s, "
                f"device start-up {r['device']:.1f} s, engine build and "
                f"weight draw {r['build']:.1f} s (host clocks)")
        results = {}
        for k, w in enumerate(workers):
            results[k] = w.settle([w.submit(r) for r in mine[k]])
            bad = [r.rid for r in results[k] if r.status != "done"
                   or len(r.output) != WORKER_NEW]
            if bad:
                fail(f"workers: {w.label} requests not done with "
                     f"{WORKER_NEW} tokens: {bad}")
        swap = workers[-1].call("swap", variant="q4")
        stats = [w.stats() for w in workers]
        agg = EngineStats.merge(stats)
        counts = [w.call("launches")["launches"] for w in workers]
        log(f"  workers: swap over the wire -> {swap}; EngineStats.merge "
            f"v{agg.schema_version}: admitted={agg.admitted} "
            f"tokens={agg.tokens_emitted} swaps={agg.swap_count}; launches "
            f"by worker {counts}")
        if agg.admitted != len(prompts) or agg.swap_count != 1 or \
                agg.tokens_emitted != len(prompts) * WORKER_NEW:
            fail(f"workers: merged stats admitted={agg.admitted} "
                 f"tokens={agg.tokens_emitted} swaps={agg.swap_count}")
    finally:
        shutdown_workers(workers)
    if any(w.proc.is_alive() for w in workers):
        fail("workers: a worker process outlived its shutdown")
    kernels.reset_launch_counts()
    twin = EngineActor(specs[0], device=device)
    rids = [twin.handle("submit", {"request": session_request_to_wire(r)})
            ["rid"] for r in mine[0]]
    out = twin.handle("settle", {"rids": rids})["results"]
    twin_launches = kernels.launch_counts()
    got = [list(r.output) for r in results[0]]
    want = [list(r["output"]) for r in out]
    log(f"  workers: {specs[0].label}'s {len(got)} streams against an "
        f"in-process twin from its spec and seed: "
        f"{'equal, token for token' if got == want else 'DIFFER'}; twin "
        f"launches {twin_launches}")
    if got != want:
        fail(f"workers: worker tokens {got} differ from the twin's {want}")
    launches = {k: sum(c[k] for c in counts) + twin_launches[k]
                for k in kernels.KERNELS}
    _path_launches("workers", launches,
                   ("q8_matmul", "paged_attention", "flash_attention"),
                   device)
    del twin
    if device == "cuda":
        import torch
        bad = f"cuda:{torch.cuda.device_count()}"
        try:
            launch_workers(specs[:1], device=bad, timeout=300.0)
        except ProtocolError as e:
            log(f"  workers: a worker on {bad} makes launch_workers raise: "
                f"{str(e)[:160]}")
        else:
            fail(f"workers: a worker on {bad} came up")
    return launches


# ---------------------------------------------------------------------------
# 15. the serve launcher
# ---------------------------------------------------------------------------


def run_launcher(*flags):
    """`repro_torch.launch.serve.main` on LAUNCHER_FLAGS plus `flags`; logs
    and returns its printed lines."""
    import contextlib
    import io
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main([*LAUNCHER_FLAGS, *flags])
    lines = out.getvalue().splitlines()
    for ln in lines:
        log(f"  {ln}")
    return lines


def carbon_lines(lines):
    """The launcher's lines that read no tokens: its variant switches and
    its `total carbon` line."""
    return [ln.strip() for ln in lines
            if ">> variant switch" in ln or ln.startswith("[serve] total")]


def phase_serve_launcher(device="cuda"):
    """The serve launcher (`python -m repro_torch.launch.serve`) on
    `device` with LAUNCHER_FLAGS: in-process (the main path: counters set
    to 0 just before, read just after), then with `--workers 2`. Each run
    must give every query LAUNCHER_FLAGS' token count, switch variants at
    least once, and print the switch and `total carbon` lines of the
    launcher run in-process with `--device cpu`. Returns the in-process
    run's counts."""
    import re
    import torch
    from repro_torch import kernels
    want = carbon_lines(run_launcher("--device", "cpu"))
    new = LAUNCHER_FLAGS[LAUNCHER_FLAGS.index("--max-new-tokens") + 1]
    runs = {"in-process": (), "--workers 2": ("--workers", "2")}
    launches = None
    for label, flags in runs.items():
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        lines = run_launcher("--device", device, *flags)
        sync()
        counts = kernels.launch_counts()
        tokens = [m.group(1) for ln in lines
                  for m in [re.match(r"\[serve\] q\d+ .* tokens=(\d+) ", ln)]
                  if m]
        got = carbon_lines(lines)
        log(f"serve_launcher {label} on {device}: "
            f"{time.perf_counter() - t0:.1f} s host clock, tokens a query "
            f"{tokens}, launches in this process {counts}")
        if tokens != [new] * int(LAUNCHER_FLAGS[1]):
            fail(f"serve_launcher {label}: tokens a query {tokens}, want "
                 f"{new} for each of {LAUNCHER_FLAGS[1]} queries")
        if got != want or not any("switch" in ln for ln in got):
            fail(f"serve_launcher {label}: switch and carbon lines {got}, "
                 f"want those of --device cpu {want} with a switch")
        if launches is None:
            launches = _path_launches(
                "serve_launcher", counts, MODEL_KERNELS + ("sim_scores",),
                device)
    return launches


# ---------------------------------------------------------------------------
# 16. the hybrid family: zamba2-7b on the dense layout
# ---------------------------------------------------------------------------


def phase_serve_zamba2(device="cuda", model_cfg=None):
    """Full-width zamba2-7b (unless `model_cfg` says otherwise), drawn on
    the card from seed 0, on the dense engine: `serve_dense_swap` on bf16
    KV, then on int8 KV, each a main path of its own (ssd_bshp, flash,
    q8 and q4 launched, the paged kernel not); one 4 x 512 admission's
    prefill logits against the plain ssd scan and plain attention within
    HYBRID_LOGIT_REL of the row's max |logit|; then (on the card) a dense
    decode step at batch 4 for Q8 and Q4. Returns the paths' counts
    summed."""
    import torch
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    from repro_torch.config import RuntimeConfig
    from repro_torch.models import get_model
    from repro_torch.sharding.param import init_params
    cfg = model_cfg if model_cfg is not None else get_arch(ZAMBA_ARCH)
    model = get_model(cfg)
    variants = draw_variants(cfg, device, "serve_zamba2")
    expect = ("ssd_bshp", "flash_attention", "q8_matmul", "q4_matmul")
    per_path = [serve_dense_swap(cfg, variants, device,
                                 f"serve_zamba2 {kv}-KV q8->q4", kv, expect)
                for kv in ("bf16", "int8")]
    launches = {k: sum(p[k] for p in per_path) for k in kernels.KERNELS}
    log(f"serve_zamba2: main-path launches, both paths summed: {launches}")
    rcfg = RuntimeConfig()
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(2, cfg.vocab_size, (4, 512), generator=g).to(device)
    prefill_vs_plain(model, variants["q8"], toks, rcfg, "zamba2 q8",
                     HYBRID_LOGIT_REL)
    if device == "cuda":
        lens = torch.tensor([64, 96, 128, 160], dtype=torch.int32,
                            device=device)
        for fmt in ("q8", "q4"):
            cache = init_params(model.cache_spec(rcfg, 4, 512), None, device)
            step = lambda: model.decode_step(  # noqa: E731
                variants[fmt], cache, toks[:, :1], lens, rcfg)
            ms = time_ms(step, iters=5, warmup=1)
            log(f"  zamba2 {fmt}: dense decode step {ms:.2f} ms at batch 4 "
                f"(CUDA events) -> {4e3 / ms:.1f} tokens/s")
            profile_window(step, f"zamba2 decode {fmt}")
            del cache
        pre = lambda: model.prefill(variants["q8"], {"tokens": toks}, rcfg)  # noqa: E731
        log(f"  zamba2 q8: prefill {time_ms(pre, iters=2, warmup=1):.2f} ms "
            f"at 4 x 512 tokens (CUDA events)")
        profile_window(pre, "zamba2 prefill q8 (4 x 512)", n=1)
    del variants
    free_device(device)
    return launches


# ---------------------------------------------------------------------------
# 17. the MoE family: phi3.5-moe on both KV layouts
# ---------------------------------------------------------------------------


def spec_chunk_path(cfg, variants, device):
    """A paged engine with `prefill_chunk=CHUNK` drafting with Q4 at k 2, a
    main path of its own (counters set to 0 just before, read just after):
    two 40-token requests decode while a 300- and a 700-token one admit in
    windows, 16 new tokens each. All DONE, the invariants clean, chunk and
    spec steps taken, drafted and accepted tokens counted; the four model
    kernels launched. Its tokens are not held against an unchunked run's:
    a window is another MoE call than the whole prompt, so capacity drops
    may differ. Returns the path's counts."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.config import RuntimeConfig
    from repro_torch.serving import (EngineClient, ServingEngine,
                                     SessionRequest, SpecDecodeConfig)
    label = "paged chunk+spec"
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
               for n in (40, 40, 300, 700)]
    eng = ServingEngine(cfg, variants["q8"], RuntimeConfig(), max_batch=4,
                        max_seq=1024, block_size=16,
                        prompt_buckets=CHUNK_BUCKETS, kv_layout="paged",
                        prefill_chunk=CHUNK,
                        spec_decode=SpecDecodeConfig("q4", k=2),
                        device=device, seed=0)
    eng.variant_name = "q8"
    eng.set_draft_params(variants["q4"], "q4")
    client = EngineClient(eng)
    clock = _StepClock(eng, device)
    kernels.reset_launch_counts()
    hs = [client.submit(SessionRequest(prompt=p, max_new_tokens=16,
                                       eos_id=-1)) for p in prompts]
    while eng.has_work():
        clock.step()
        if len(clock.ms) > 2000:
            fail(f"{label}: engine did not drain")
    launches = _path_launches(label, kernels.launch_counts(), MODEL_KERNELS,
                              device)
    st = _check_engine(label, eng, [h.request for h in hs], 16, device)
    kinds = {k: clock.kinds.count(k) for k in sorted(set(clock.kinds))}
    log(f"  {label}: prefill_chunk {eng.prefill_chunk}, steps {kinds}, "
        f"chunk_steps={st.chunk_steps}, spec_steps={st.spec_steps}, "
        f"drafted {st.draft_tokens}, accepted {st.accepted_tokens}, "
        f"step times (CUDA events) {sum(clock.ms):.1f} ms")
    if st.chunk_steps <= 0 or st.spec_steps <= 0 or st.draft_tokens <= 0:
        fail(f"{label}: no chunk window or no drafting ({kinds})")
    return launches


def expert_dequant(cfg, variants, device):
    """Layer 0's stacked experts dequantized in one buffer (`quant.
    dequantize_experts`, what every MoE call runs) against each expert
    dequantized alone, bit for bit, for both trees; on the card, the time
    of one layer's three matrices (CUDA events) beside its byte bound."""
    import torch
    from repro_torch.quant.qtensor import dequantize, dequantize_experts
    for fmt in ("q8", "q4"):
        moe = variants[fmt]["layers"]["moe"]
        t = moe["wg"][0]
        got = dequantize_experts(t)
        want = torch.stack([dequantize(t[e]) for e in range(t.shape[0])])
        if not torch.equal(got, want):
            fail(f"expert dequant {fmt}: differs from dequantize")
        del got, want
        line = f"  expert dequant {fmt}: layer 0's {tuple(t.shape)} equal " \
            "to dequantize expert by expert"
        if device == "cuda":
            mats = [moe[k][0] for k in ("wg", "wu", "wo")]
            ms = time_ms(lambda: [dequantize_experts(m) for m in mats],
                         iters=3, warmup=1)
            nbytes = sum(m.nbytes() + 2 * math.prod(m.shape) for m in mats)
            b, _ = bound_ms(nbytes, 0.0, BF16_FLOPS)
            line += (f"; one layer's three matrices {ms:.3f} ms (CUDA "
                     f"events), bound {b:.3f} ms (bytes), x{cfg.num_layers} "
                     f"layers {ms * cfg.num_layers:.1f} ms a forward")
        log(line)


def moe_extra_path(cfg, variants, device):
    expert_dequant(cfg, variants, device)
    return spec_chunk_path(cfg, variants, device)


def phase_serve_phi35_moe(device="cuda", model_cfg=None):
    """`serve_model` over full-width phi3.5-moe-42b-a6.6b (unless
    `model_cfg` says otherwise), its trees drawn a (layer, expert) slice
    at a time (the draw's peak at most DRAW_PEAK_SLACK above them), with
    `expert_dequant`'s check and `spec_chunk_path` as its extra path.
    Returns the paths' counts summed."""
    from repro_torch import kernels
    from repro_torch.common.registry import get_arch
    cfg = model_cfg if model_cfg is not None else get_arch(PHI_ARCH)
    per_path = serve_model(cfg, device, f"serve_phi35_moe {cfg.name}",
                           extra=moe_extra_path)
    launches = {k: sum(p[k] for p in per_path) for k in kernels.KERNELS}
    log(f"serve_phi35_moe: main-path launches, {len(per_path)} paths "
        f"summed: {launches}")
    return launches


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash-baseline", metavar="DIR",
                    help="a csrc directory with an older flash_attention.cu "
                         "(same C entry) to time beside this one")
    ap.add_argument("--paged-baseline", metavar="DIR", nargs="+",
                    default=(),
                    help="csrc directories, each with a paged_attention.cu "
                         "(this source's C entry, or the one from before "
                         "its redesign) to time beside this one")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py", code=2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card", code=2)
    phase_device()
    phase_build()
    from repro_torch import kernels
    records = {k: KernelRecord(k) for k in kernels.KERNELS}
    memory = PhaseMemory()
    log("kernels: each against its plain version")
    for check in (lambda: check_quant_matmul(records),
                  lambda: check_paged(records, tuple(args.paged_baseline)),
                  check_paged_f64, check_flash_products,
                  lambda: check_flash(records, args.flash_baseline),
                  lambda: check_sim_scores(records),
                  lambda: check_ssd(records)):
        memory.run("kernels", check)
    per_phase = {
        "serve": memory.run("serve", phase_serve)[0],
        "serve_mamba2": memory.run("serve_mamba2", phase_serve_mamba2),
        "runtime": memory.run("runtime", phase_runtime),
        "serve_spec_chunk": memory.run("serve_spec_chunk",
                                       phase_serve_spec_chunk),
        "serve_dense": memory.run("serve_dense", phase_serve_dense),
        "runtime_mamba2": memory.run("runtime_mamba2", phase_runtime_mamba2),
        "serve_paper_models": memory.run("serve_paper_models",
                                         phase_serve_paper_models),
        "runtime_paper_models": memory.run("runtime_paper_models",
                                           phase_runtime_paper_models),
        "serve_qwen25_32b": memory.run("serve_qwen25_32b",
                                       phase_serve_qwen25_32b),
        "fleet": memory.run("fleet", phase_fleet),
        "workers": memory.run("workers", phase_workers),
        "serve_launcher": memory.run("serve_launcher", phase_serve_launcher),
        "serve_zamba2": memory.run("serve_zamba2", phase_serve_zamba2),
        "serve_phi35_moe": memory.run("serve_phi35_moe",
                                      phase_serve_phi35_moe),
    }
    memory.run("the end", lambda: None)
    launches = {k: sum(p[k] for p in per_phase.values())
                for k in kernels.KERNELS}
    for name, counts in per_phase.items():
        log(f"main-path launches of {name}: {counts}")
    log(f"main-path launches, {', '.join(per_phase)} summed: {launches}")
    log(json.dumps({"kernels": [records[k].to_json(launches[k])
                                for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
