"""The port's kernels on the card against their plain versions, at small
shapes. Marked `gpu`: without a CUDA card they skip (run them on the card
with `python -m pytest -q -m gpu tests/test_torch_gpu.py`). chip_smoke.py
holds every kernel against its plain version at the full-width shapes."""
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.quant_matmul import ops as qm_ops
from repro_torch.kernels.topk_sim import ops as ts_ops
from repro_torch.kernels.topk_sim.ref import topk_tools_ref
from repro_torch.quant.qtensor import quantize

pytestmark = pytest.mark.gpu
SIM_TOL = 1e-5                  # retrieval scores, f32 (ROADMAP tolerance)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _quant_case(gen, fmt, M, K, N):
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    t = quantize(w, fmt)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    return x, t


# both regimes and their edges: decode M <= 16 (one or two mma row tiles),
# prefill M >= 17 (ragged 128-row tiles); N = 32 and 128 (mamba2's narrow
# weights), N = 136 (N % 16 == 8: the 8-byte load path); K = 3584 and 2048
# with few column tiles, which split K across blocks
@pytest.mark.parametrize("fmt", ["q8", "q4"])
@pytest.mark.parametrize("M,K,N", [(1, 256, 64), (4, 512, 512),
                                   (37, 384, 1024), (1, 1024, 32),
                                   (16, 1024, 128), (17, 1024, 32),
                                   (16, 3584, 512), (4, 2048, 136),
                                   (37, 256, 136), (512, 1024, 128),
                                   (512, 512, 32)])
def test_quant_matmul_kernel(gen, fmt, M, K, N):
    x, t = _quant_case(gen, fmt, M, K, N)
    before = kernels.launch_counts()[f"{fmt}_matmul"]
    got = qm_ops.quant_matmul(x, t)
    want = qm_ops.plain(x, t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[f"{fmt}_matmul"] == before + 1
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel.item() < 0.02


@pytest.mark.parametrize("fmt", ["q8", "q4"])
@pytest.mark.parametrize("M,K,N", [(4, 3584, 512), (16, 2048, 1024),
                                   (512, 1024, 256)])
def test_quant_matmul_repeat_is_bit_identical(gen, fmt, M, K, N):
    """The split-K reduction sums in a fixed order: launches agree bit for
    bit, whichever block of a tile arrives last."""
    x, t = _quant_case(gen, fmt, M, K, N)
    first = qm_ops.quant_matmul(x, t)
    for _ in range(5):
        assert torch.equal(qm_ops.quant_matmul(x, t), first)


PAGED_TOL = 0.03                # max |err| of the bf16 outputs
PAGED_ROW_TOL = 0.02            # each (row, head)'s RMS err over its RMS
# (B, K, G, H, bs, nb, lengths); the first row parks on the scratch block:
# small heads, carboncall-qwen2-7b's heads at the serving shape, block size
# 32, head dim 256, long chains that split across many blocks, and head dims
# below their instantiation's 64 / 128 (steps skipped; int8 stripes of 1, 5
# and 7 16-byte chunks): the reduced configs' 16, 80, and zamba2-7b's 112
PAGED_KERNEL_CASES = [
    (3, 2, 4, 64, 16, 12, [1, 130, 192]),
    (4, 4, 7, 128, 16, 16, [1, 129, 200, 256]),
    (2, 4, 7, 128, 32, 8, [1, 250]),
    (2, 2, 4, 256, 16, 10, [1, 160]),
    (3, 4, 7, 128, 16, 256, [1, 4096, 2077]),
    (8, 8, 4, 128, 16, 64, [1, 1024, 1000, 513, 1024, 17, 999, 1024]),
    (3, 1, 4, 16, 16, 12, [1, 130, 192]),
    (2, 4, 7, 80, 16, 10, [1, 160]),
    (4, 8, 1, 112, 32, 8, [1, 129, 200, 256]),
]


def _paged_case(gen, B, K, G, H, bs, nb, lengths, int8):
    """q (B, 1, K * G, H) bf16, pools of B * nb + 1 blocks (bf16, or int8
    with scales) whose tables point at permuted blocks; row 0 on block 0."""
    from repro_torch.models.transformer import requant_cache
    q = torch.randn((B, 1, K * G, H), generator=gen, device="cuda").bfloat16()
    kf = torch.randn((B * nb + 1, bs, K, H), generator=gen, device="cuda")
    vf = torch.randn((B * nb + 1, bs, K, H), generator=gen, device="cuda")
    perm = torch.randperm(B * nb, generator=gen, device="cuda") + 1
    bt = perm.to(torch.int32).reshape(B, nb)
    bt[0] = 0                                       # dead row on scratch
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if int8:
        enc = requant_cache({"k_scale": True}, kf, vf)
        return q, enc["k"], enc["v"], bt, lens, dict(k_scale=enc["k_scale"],
                                                     v_scale=enc["v_scale"])
    return q, kf.bfloat16(), vf.bfloat16(), bt, lens, {}


def _paged_check(got, want):
    diff = got.float() - want.float()
    assert torch.isfinite(got).all()
    assert diff.abs().max().item() < PAGED_TOL
    rms = want.float().square().mean(-1).sqrt().clamp_min(1e-6)
    assert (diff.square().mean(-1).sqrt() / rms).max().item() < PAGED_ROW_TOL


@pytest.mark.parametrize("case", PAGED_KERNEL_CASES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (20, 30.0)])
def test_paged_attention_kernel(gen, case, int8, window, cap):
    q, kp, vp, bt, lens, kw = _paged_case(gen, *case, int8)
    before = kernels.launch_counts()["paged_attention"]
    got = pa_ops.paged_decode_attention(q, kp, vp, bt, lens, cap=cap,
                                        window=window, **kw)
    want = pa_ops.paged_attention_ref(q, kp, vp, bt, lens, cap=cap,
                                      window=window, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention"] == before + 1
    _paged_check(got, want)


@pytest.mark.parametrize("case", PAGED_KERNEL_CASES[1:3] + PAGED_KERNEL_CASES[4:])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_repeat_is_bit_identical(gen, case, int8):
    """The splits merge in split order and the warps in warp order, so
    launches agree bit for bit, whichever block of a row arrives last."""
    q, kp, vp, bt, lens, kw = _paged_case(gen, *case, int8)
    first = pa_ops.paged_decode_attention(q, kp, vp, bt, lens, window=48,
                                          **kw)
    for _ in range(3):
        assert torch.equal(pa_ops.paged_decode_attention(
            q, kp, vp, bt, lens, window=48, **kw), first)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_forced_splits(gen, int8):
    """Every split count from 1 to nb (split boundaries anywhere on the
    chain) within the same tolerance as the planned split."""
    B, K, G, H, bs, nb, lengths = PAGED_KERNEL_CASES[0]
    q, kp, vp, bt, lens, kw = _paged_case(gen, B, K, G, H, bs, nb, lengths,
                                          int8)
    want = pa_ops.paged_attention_ref(q, kp, vp, bt, lens, **kw)
    for splits in range(1, nb + 1):
        got = pa_ops.paged_decode_attention(q, kp, vp, bt, lens,
                                            num_splits=splits, **kw)
        torch.cuda.synchronize()
        _paged_check(got, want)


# (B, Sq, Skv, N, K, H, causal, window, cap), q_offset = Skv - Sq: GQA
# groups of 4 and 7, head dims 16-256, Skv not a multiple of the 64-key
# tile, window + cap + q_offset, non-causal, MHA
FLASH_KERNEL_CASES = [
    (2, 32, 32, 8, 2, 128, True, 0, 0.0),
    (2, 40, 100, 8, 2, 128, True, 24, 50.0),
    (4, 64, 64, 28, 4, 128, True, 0, 0.0),
    (1, 96, 150, 14, 2, 64, True, 0, 0.0),
    (2, 77, 77, 14, 2, 112, True, 0, 0.0),
    (1, 130, 130, 8, 2, 256, True, 0, 0.0),
    (1, 70, 200, 8, 2, 256, True, 40, 30.0),
    (2, 50, 50, 4, 1, 16, True, 0, 0.0),
    (2, 77, 130, 14, 2, 112, False, 0, 0.0),
    (1, 300, 300, 8, 8, 64, True, 48, 50.0),
    (1, 600, 600, 28, 4, 128, True, 0, 0.0)]


def _flash_case(gen, B, Sq, Skv, N, K, H):
    q = torch.randn((B, Sq, N, H), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Skv, K, H), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Skv, K, H), generator=gen, device="cuda").bfloat16()
    return q, k, v


@pytest.mark.parametrize("B,Sq,Skv,N,K,H,causal,window,cap",
                         FLASH_KERNEL_CASES)
def test_flash_attention_kernel(gen, B, Sq, Skv, N, K, H, causal, window,
                                cap):
    q, k, v = _flash_case(gen, B, Sq, Skv, N, K, H)
    kw = dict(causal=causal, window=window, cap=cap, q_offset=Skv - Sq)
    before = kernels.launch_counts()["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, **kw)
    want = fa_ops.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() < 0.03


@pytest.mark.parametrize("B,Sq,Skv,N,K,H,causal,window,cap",
                         FLASH_KERNEL_CASES[:3] + FLASH_KERNEL_CASES[5:7])
def test_flash_attention_repeat_is_bit_identical(gen, B, Sq, Skv, N, K, H,
                                                 causal, window, cap):
    """No split over keys and no atomics: launches agree bit for bit."""
    q, k, v = _flash_case(gen, B, Sq, Skv, N, K, H)
    kw = dict(causal=causal, window=window, cap=cap, q_offset=Skv - Sq)
    first = fa_ops.flash_attention(q, k, v, **kw)
    for _ in range(3):
        assert torch.equal(fa_ops.flash_attention(q, k, v, **kw), first)


@pytest.mark.parametrize("H", [16, 64, 112, 128, 256])
def test_flash_attention_products(gen, H):
    """The two tensor-core products alone, as the kernel issues them:
    S = Q K^T (K-major operands) and O = bf16(S) V (V read MN-major, one
    n = H product a k16 step) against f32 products of the same bf16
    values."""
    q, k, v = (torch.randn((64, H), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    s, o = fa_ops.products(q, k, v)
    torch.cuda.synchronize()
    s_ref = q.float() @ k.float().T
    o_ref = s.bfloat16().float() @ v.float()
    assert ((s - s_ref).abs().max() / s_ref.abs().max()).item() < 1e-5
    assert ((o - o_ref).abs().max() / o_ref.abs().max()).item() < 1e-5


@pytest.mark.parametrize("N,d,m,k", [(256, 256, 1, 16), (256, 256, 2, 16),
                                     (256, 256, 3, 32),
                                     (1024, 256, 8, 16), (512, 64, 5, 8),
                                     (65536, 256, 8, 32), (300, 63, 32, 16)])
def test_sim_scores_kernel(gen, N, d, m, k):
    """Scores within SIM_TOL and the same top k (ties by lower index) as the
    plain version; the last 16 rows are zero index padding, and most rows
    point away from the queries so those exact 0.0 scores reach the top k.
    d = 63 takes the scalar-load variant."""
    q = torch.nn.functional.normalize(
        torch.randn((m, d), generator=gen, device="cuda"), dim=-1)
    tools = torch.nn.functional.normalize(
        torch.randn((N, d), generator=gen, device="cuda"), dim=-1)
    away = torch.rand((N,), generator=gen, device="cuda") < 0.9
    tools[away] = torch.nn.functional.normalize(
        -q.sum(0) + 0.5 / math.sqrt(d) * torch.randn(
            (int(away.sum()), d), generator=gen, device="cuda"), dim=-1)
    tools[N - 16:] = 0.0
    before = kernels.launch_counts()["sim_scores"]
    got = ts_ops.sim_scores(tools, q)
    want = ts_ops.sim_scores_ref(tools, q)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sim_scores"] == before + 1
    assert (got - want).abs().max().item() <= SIM_TOL
    g_s, g_i = ts_ops.top_k(got, k)
    w_s, w_i = ts_ops.top_k(want, k)
    assert g_i.tolist() == w_i.tolist()
    s_raw, i_raw = ts_ops.topk_tools(tools, 3.0 * q, k=k)
    assert i_raw.tolist() == w_i.tolist()


@pytest.mark.parametrize("m", [33, 64])
def test_sim_scores_kernel_query_groups(gen, m):
    """More query rows than a lane holds: groups of 4 looped inside one
    launch, merged by max."""
    d = 256
    q = torch.nn.functional.normalize(
        torch.randn((m, d), generator=gen, device="cuda"), dim=-1)
    tools = torch.nn.functional.normalize(
        torch.randn((256, d), generator=gen, device="cuda"), dim=-1)
    before = kernels.launch_counts()["sim_scores"]
    got = ts_ops.sim_scores(tools, q)
    want = ts_ops.sim_scores_ref(tools, q)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sim_scores"] == before + 1
    assert (got - want).abs().max().item() <= SIM_TOL
    assert ts_ops.top_k(got, 16)[1].tolist() == ts_ops.top_k(want, 16)[1].tolist()


def _retrieval(gen, N, d, m):
    """Unit tools, nine in ten pointing away from the queries, 16 zero pad
    rows at the end, and raw queries with row 1 zero from m = 3 on: exact
    0.0 ties reach the top k."""
    F = torch.nn.functional
    q = torch.randn((m, d), generator=gen, device="cuda")
    if m >= 3:
        q[1] = 0.0
    tools = F.normalize(torch.randn((N, d), generator=gen, device="cuda"),
                        dim=-1)
    away = torch.rand((N,), generator=gen, device="cuda") < 0.9
    tools[away] = F.normalize(-F.normalize(q, dim=-1).sum(0) + 0.5 / math.sqrt(
        d) * torch.randn((int(away.sum()), d), generator=gen, device="cuda"),
        dim=-1)
    tools[N - 16:] = 0.0
    return tools, q


def _check_topk(tools, q, k):
    """One launch a call, indices equal to the plain version's (ties
    included), scores within SIM_TOL, bit-identical repeats, and the same
    pair through one buffer copied to the host."""
    before = kernels.launch_counts()["sim_scores"]
    s, i = ts_ops.topk_tools(tools, q, k=k)
    s2, i2 = ts_ops.topk_tools(tools, q, k=k)
    w_s, w_i = topk_tools_ref(tools, ts_ops._normalize(q), k)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sim_scores"] == before + 2
    assert s.shape == (k,) and i.dtype == torch.int64
    assert i.tolist() == w_i.tolist()
    assert (s - w_s).abs().max().item() <= SIM_TOL
    assert torch.equal(s.view(torch.int32), s2.view(torch.int32))
    assert torch.equal(i, i2)
    h_s, h_i = ts_ops.topk_tools(tools, q, k=k, host=True)  # one copy
    assert h_s.device.type == h_i.device.type == "cpu"
    assert torch.equal(h_s.view(torch.int32), s.cpu().view(torch.int32))
    assert torch.equal(h_i, i.cpu())
    assert kernels.launch_counts()["sim_scores"] == before + 3
    return w_s


# chip_smoke's SIM_SHAPES: the runtime's index, ToolBench's catalog, 65536
@pytest.mark.parametrize("N,m", [(256, 1), (256, 2), (256, 3), (256, 8),
                                 (256, 33), (256, 64), (16640, 3), (65536, 1),
                                 (65536, 8), (65536, 32)])
def test_topk_tools_kernel_one_launch(gen, N, m):
    tools, q = _retrieval(gen, N, 256, m)
    ties = 0
    for k in (16, 32) + ((N,) if N == 256 else ()):
        ties += int((_check_topk(tools, q, k) == 0).sum().item())
    if N == 256:
        assert ties > 0                 # exact 0.0 ties were ranked


def _dyadic(gen, N, d, m):
    """Unit tool rows with 16 entries of +-1/4 and raw query rows with 16
    entries of +-1 (norm 4), row 1 zero from m = 3 on: every product and
    partial sum is a multiple of 1/16 well inside f32, so each dot is exact
    whatever the order of its sums and the kernel's scores equal the plain
    version's bit for bit. The few distinct scores make long runs of exact
    ties. (On Gaussian rows, two scores closer than f32 rounding may swap
    places between two summation orders, which an exact comparison of the
    whole order, k up to N, would count against the kernel.)"""
    def rows(n, value):
        pos = torch.rand((n, d), generator=gen, device="cuda").argsort(1)
        sign = torch.randint(0, 2, (n, 16), generator=gen, device="cuda")
        out = torch.zeros((n, d), device="cuda")
        out.scatter_(1, pos[:, :16], value * (2.0 * sign - 1.0))
        return out
    tools, q = rows(N, 0.25), rows(m, 1.0)
    if m >= 3:
        q[1] = 0.0
    return tools, q


# the list path at k 33-64, the sort path above 64 (in shared memory up to
# 8192 keys, in device memory past it), the scalar-load rows (d = 63), more
# than one column slab (d 384, 512), query groups looped, one to many blocks
@pytest.mark.parametrize("N,d,m,k", [(1, 256, 1, 1), (300, 63, 5, 48),
                                     (700, 512, 9, 33), (5000, 64, 8, 64),
                                     (1000, 256, 2, 1000), (1000, 256, 1, 300),
                                     (20000, 256, 3, 100),
                                     (40000, 384, 12, 70)])
def test_topk_tools_kernel_any_k(gen, N, d, m, k):
    tools, q = _dyadic(gen, N, d, m)
    w_s = _check_topk(tools, q, k)
    if N > 1:
        assert len(set(w_s.tolist())) < k     # ties inside the top k
    qn = ts_ops._normalize(q)
    got, want = ts_ops.sim_scores(tools, qn), ts_ops.sim_scores_ref(tools, qn)
    assert torch.equal(got, want)


def test_topk_tools_kernel_refuses_bad_k(gen):
    tools, q = _retrieval(gen, 256, 256, 1)
    for k in (0, 257):
        with pytest.raises(ValueError):
            ts_ops.topk_tools(tools, q, k=k)


SSD_TOL = 0.05                  # y and final state (tests/test_kernels.py)


def _ssd_inputs(gen, B, S, H, P, G, N):
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device="cuda"))
    Bm = (0.3 * torch.randn((B, S, G, N), generator=gen, device="cuda")).bfloat16()
    Cm = (0.3 * torch.randn((B, S, G, N), generator=gen, device="cuda")).bfloat16()
    return x, dt, A, Bm, Cm


# small shapes with chunks shorter than 128 rows (20, and 24 = S), G 2 and
# N 16-128; then mamba2-370m at B 1 S 2048 and its 4 x 512 admission, and
# zamba2-7b's heads (H 112, N 64)
SSD_KERNEL_CASES = [
    (2, 256, 4, 64, 1, 128, 128), (1, 128, 8, 32, 2, 64, 64),
    (2, 64, 4, 16, 1, 32, 32), (1, 256, 2, 64, 1, 16, 64),
    (1, 40, 2, 16, 1, 16, 20), (2, 24, 4, 64, 2, 128, 128),
    (1, 2048, 32, 64, 1, 128, 128), (4, 512, 32, 64, 1, 128, 128),
    (1, 1024, 112, 64, 1, 64, 128)]


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SSD_KERNEL_CASES)
def test_ssd_kernel(gen, B, S, H, P, G, N, Q):
    """The SSD kernel on bf16 x, B, C against the plain scan on the same
    values in f32; chunks shorter than 128 rows (20, and 24 = S) included."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, G, N)
    before = kernels.launch_counts()["ssd_bshp"]
    y, fs = ssd_ops.launch(x, dt, A, Bm, Cm, chunk=Q)
    y_ref, fs_ref = ssd_chunked(x.float(), dt, A, Bm.float(), Cm.float(), Q)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_bshp"] == before + 1
    assert torch.isfinite(y).all() and torch.isfinite(fs).all()
    assert (y - y_ref).abs().max().item() < SSD_TOL
    assert (fs - fs_ref).abs().max().item() < SSD_TOL


@pytest.mark.parametrize("B,S,H,P,G,N,Q", [
    (2, 256, 4, 64, 1, 128, 128), (1, 40, 2, 16, 1, 16, 20),
    (4, 512, 32, 64, 1, 128, 128), (1, 1024, 112, 64, 1, 64, 128)])
def test_ssd_repeat_is_bit_identical(gen, B, S, H, P, G, N, Q):
    """Every sum of the three phases has a fixed order: a repeat launch on
    the same inputs gives equal bits, y and the final state."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    ins = _ssd_inputs(gen, B, S, H, P, G, N)
    y, fs = ssd_ops.launch(*ins, chunk=Q)
    y2, fs2 = ssd_ops.launch(*ins, chunk=Q)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(fs, fs2)


# ---------------------------------------------------------------------------
# chunked prefill and speculative decoding on a CUDA paged engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feature", ["spec", "chunked", "dense"])
def test_engine_feature_runs_the_kernels(gen, feature):
    """The reduced carboncall-qwen2-7b on a CUDA paged engine, drafting with
    Q4 (k 2) or admitting 100-170-token prompts in 32-token windows beside
    decoding residents, or on the dense layout with the same windows (its
    decode reads the stripe through plain attention, no paged kernel): no
    step falls back, the model kernels launch and the invariant sweep is
    clean."""
    import numpy as np
    from repro_torch.common.registry import get_arch
    from repro_torch.config import RuntimeConfig
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.models import get_model
    from repro_torch.quant.qtensor import init_quantized
    from repro_torch.serving import (EngineClient, ServingEngine,
                                     SessionRequest, SpecDecodeConfig,
                                     check_invariants)
    cfg = reduce_config(get_arch("carboncall-qwen2-7b"))
    v = init_quantized(get_model(cfg).param_spec(), ("q8", "q4"), gen,
                       "cuda")
    spec = feature == "spec"
    layout = "dense" if feature == "dense" else "paged"
    eng = ServingEngine(cfg, v["q8"], RuntimeConfig(), max_batch=4,
                        max_seq=256, kv_layout=layout,
                        prefill_chunk=None if spec else 32,
                        spec_decode=SpecDecodeConfig("q4", k=2)
                        if spec else None, device="cuda")
    eng.variant_name = "q8"
    if spec:
        eng.set_draft_params(v["q4"], "q4")
    rng = np.random.default_rng(0)
    lens = (12, 20, 30, 9) if spec else (20, 30, 100, 170)
    client = EngineClient(eng)
    kernels.reset_launch_counts()
    hs = [client.submit(SessionRequest(
        prompt=[int(t) for t in rng.integers(2, 512, size=n)],
        max_new_tokens=12, eos_id=-1)) for n in lens]
    eng.run_until_drained()
    launches = kernels.launch_counts()
    st = eng.stats()
    assert eng.kernel_fallbacks == 0
    assert all(len(h.request.output) == 12 for h in hs)
    if spec:
        assert st.spec_steps > 0 and st.draft_tokens > 0
        assert launches["q4_matmul"] > 0
    else:
        assert st.chunk_steps > 0
        assert launches["flash_attention"] > 0
    assert launches["q8_matmul"] > 0
    assert (launches["paged_attention"] > 0) == (layout == "paged")
    assert check_invariants(eng, [h.request for h in hs]) == []
