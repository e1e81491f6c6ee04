"""Each kernel's plain PyTorch version (what a CPU tensor takes in the port's
wrappers) against the JAX package's oracle (`kernels/*/ref.py`) and its
Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances are those of tests/test_kernels.py: quant-matmul relative < 0.02,
flash < 0.03, paged f32 pools < 2e-5, paged int8 pools < 0.02.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa_ref
from repro.kernels.paged_attention import ops as ref_pa_ops
from repro.kernels.paged_attention import ref as ref_pa_ref
from repro.kernels.quant_matmul import ops as ref_qm_ops
from repro.kernels.quant_matmul import ref as ref_qm_ref
from repro.quant import quantize as ref_quantize

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.quant_matmul import ops as qm_ops
from repro_torch.quant.qtensor import QTensor


def _rel(got, want):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-6))


def _bf16_pair(a):
    """The same bf16 values on both sides."""
    t = torch.as_tensor(a, dtype=torch.float32).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("fmt", ["q8", "q4"])
@pytest.mark.parametrize("M,K,N", [(8, 256, 256), (128, 384, 128)])
def test_quant_matmul_plain(fmt, M, K, N):
    rng = np.random.default_rng(M * 7 + K + N + (fmt == "q4"))
    x_t, x_j = _bf16_pair(rng.standard_normal((M, K)))
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    qt = ref_quantize(jnp.asarray(w), fmt)
    pt = QTensor(q=torch.tensor(np.asarray(qt.q)),
                 scale=torch.tensor(np.asarray(qt.scale)),
                 zero=None if qt.zero is None
                 else torch.tensor(np.asarray(qt.zero)),
                 fmt=qt.fmt, group=qt.group)
    got = qm_ops.quant_matmul(x_t, pt)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    got = got.float().numpy()
    assert _rel(got, ref_qm_ref.qtensor_matmul_ref(x_j, qt)) < 0.02
    assert _rel(got, ref_qm_ops.quant_matmul(x_j, qt, interpret=True)) < 0.02


@pytest.mark.parametrize(
    "B,Sq,Skv,N,K,H,causal,window,cap",
    [
        (1, 128, 128, 8, 8, 32, True, 48, 50.0),    # window + softcap
        (2, 64, 128, 4, 1, 32, True, 0, 0.0),       # q_offset, MQA
        (1, 32, 32, 14, 2, 64, True, 0, 0.0),       # G = 7, as qwen2-7b
        (2, 24, 24, 4, 2, 16, True, 0, 0.0),        # H = 16
        (1, 40, 40, 4, 1, 112, True, 0, 0.0),       # H = 112
        (2, 24, 56, 4, 2, 32, False, 0, 0.0),       # non-causal, Sq != Skv
    ])
def test_flash_attention_plain(B, Sq, Skv, N, K, H, causal, window, cap):
    rng = np.random.default_rng(Sq * Skv + N)
    q_t, q_j = _bf16_pair(rng.standard_normal((B, Sq, N, H)))
    k_t, k_j = _bf16_pair(rng.standard_normal((B, Skv, K, H)))
    v_t, v_j = _bf16_pair(rng.standard_normal((B, Skv, K, H)))
    off = Skv - Sq
    got = fa_ops.flash_attention(q_t, k_t, v_t, causal=causal, window=window,
                                 cap=cap, q_offset=off).float().numpy()
    want = ref_fa_ref.flash_attention_ref(q_j, k_j, v_j, causal=causal,
                                          window=window, cap=cap, q_offset=off)
    pallas = ref_fa_ops.flash_attention(q_j, k_j, v_j, causal=causal,
                                        window=window, cap=cap, q_offset=off,
                                        interpret=True)
    for other in (want, pallas):
        assert float(np.max(np.abs(got - np.asarray(other, np.float32)))) < 0.03


def _paged_case(B, N, K, H, bs, nb, seed, lengths):
    """f32 pools, permuted block tables; unused table slots point at the
    scratch block 0."""
    rng = np.random.default_rng(seed)
    num_blocks = nb * B + 2
    q = rng.standard_normal((B, 1, N, H)).astype(np.float32)
    kp = rng.standard_normal((num_blocks, bs, K, H)).astype(np.float32)
    vp = rng.standard_normal((num_blocks, bs, K, H)).astype(np.float32)
    bt = np.zeros((B, nb), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        bt[b, :used] = perm[b * nb:b * nb + used]
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _int8(pool):
    """Symmetric per-(block, pos, head) int8, as requant_cache encodes."""
    s = np.maximum(np.max(np.abs(pool), axis=-1), 1e-8) / 127.0
    return np.round(pool / s[..., None]).astype(np.int8), s.astype(np.float32)


# lengths cross the 8-block split boundary (bs * 8 = 128) and include a row
# parked on the scratch block (length 1)
PAGED = [
    (4, 4, 2, 64, 16, 16, [1, 100, 129, 256], 0.0, 0),
    (3, 8, 2, 32, 16, 9, [144, 17, 140], 30.0, 24),  # softcap, window,
                                                     # ragged last split
    (2, 32, 8, 32, 16, 6, [1, 90], 0.0, 0),          # G 4 over K 8
    (2, 8, 1, 64, 16, 8, [100, 37], 0.0, 0),         # MQA: G 8 over K 1
    (2, 4, 2, 256, 16, 4, [50, 64], 0.0, 0),         # H 256
    (2, 4, 2, 32, 32, 5, [150, 33], 0.0, 0),         # block size 32
    (2, 4, 2, 32, 16, 8, [128, 100], 0.0, 20),       # window skips blocks
    (2, 8, 2, 32, 16, 6, [96, 70], 50.0, 0),         # softcap 50
]


@pytest.mark.parametrize("B,N,K,H,bs,nb,lengths,cap,window", PAGED)
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_plain(B, N, K, H, bs, nb, lengths, cap, window,
                               int8):
    q, kp, vp, bt, lens = _paged_case(B, N, K, H, bs, nb, B * 31 + nb,
                                      lengths)
    kw_ref, kw = {}, {}
    if int8:
        kp, ks = _int8(kp)
        vp, vs = _int8(vp)
        kw_ref = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw = dict(k_scale=torch.as_tensor(ks), v_scale=torch.as_tensor(vs))
    splits = pa_ops.default_num_splits(nb)
    got = pa_ops.paged_decode_attention(
        torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp),
        torch.as_tensor(bt), torch.as_tensor(lens), cap=cap, window=window,
        num_splits=splits, **kw).numpy()
    want = ref_pa_ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), cap=cap, window=window, **kw_ref)
    pallas = ref_pa_ops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), cap=cap, window=window, num_splits=splits,
        interpret=True, **kw_ref)
    tol = 0.02 if int8 else 2e-5
    assert np.all(np.isfinite(got))
    for other in (want, pallas):
        assert float(np.max(np.abs(got - np.asarray(other)))) < tol


def test_split_counts_and_fallback_predicate():
    assert [pa_ops.default_num_splits(n) for n in (1, 8, 9, 16, 17)] == \
        [ref_pa_ops.default_num_splits(n) for n in (1, 8, 9, 16, 17)]
    assert pa_ops.paged_attention_uses_fallback("cpu")
    assert not pa_ops.paged_attention_uses_fallback("cuda")


# (B, K, G, H, bs, nb, int8): the serving shape (qwen2-7b heads, max_seq
# 256, block size 16) in both pool types, the runtime's (max_batch 2), long
# chains, llama-3.1-8b's heads at block size 32, MQA, H 256 with block
# sizes 128 and 16, many short rows, one very long chain, and the head dims
# of the reduced configs (16) and zamba2-7b (112, MHA)
PAGED_PLAN_CASES = [
    (4, 4, 7, 128, 16, 16, False), (4, 4, 7, 128, 16, 16, True),
    (2, 4, 7, 128, 16, 16, False), (8, 4, 7, 128, 16, 256, False),
    (32, 4, 7, 128, 16, 64, True), (4, 8, 4, 128, 32, 8, False),
    (1, 1, 8, 64, 16, 9, False), (2, 2, 4, 256, 128, 4, False),
    (2, 2, 4, 256, 16, 512, False), (64, 8, 8, 128, 16, 2, False),
    (1, 4, 7, 128, 16, 2048, True), (4, 1, 4, 16, 16, 16, True),
    (4, 32, 1, 112, 16, 16, False), (4, 32, 1, 112, 128, 2, True)]


def _chunks_cover_chain(p, nb):
    """Each row's chain blocks [0, nb) fall into exactly one split's chunk,
    in whole pool blocks, in order, none of them empty."""
    seen = np.zeros(nb, np.int64)
    for s in range(p.splits):
        lo, hi = s * p.blocks_per_split, min(nb, (s + 1) * p.blocks_per_split)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,K,G,H,bs,nb,int8", PAGED_PLAN_CASES)
def test_paged_attention_plan(B, K, G, H, bs, nb, int8):
    """The planned split covers every chain block once in whole pool
    blocks; a block's rings and table entries fit in shared memory; the
    grid, warps and workspace follow the split; the serving shape fills at
    least one wave of 132 SMs; an explicit split count cuts the chain as
    the JAX package does."""
    for num_splits in (None, 1, 3, nb):
        p = pa_ops.plan(B, K, G, H, bs, nb, 132, int8, num_splits)
        _chunks_cover_chain(p, nb)
        if num_splits is not None:
            assert p.blocks_per_split == -(-nb // min(num_splits, nb))
        assert p.grid == (p.splits, K, B)
        assert 1 <= p.warps <= pa_ops.MAX_WARPS
        assert p.warps * pa_ops.TILE <= p.blocks_per_split * bs
        assert p.smem == pa_ops.smem_bytes(H, int8, p.warps,
                                           p.blocks_per_split)
        assert p.smem <= pa_ops.SMEM_MAX
        # the warps' states meet over the rings after the chain
        assert p.warps * G * H * 4 <= p.warps * pa_ops.STAGES * \
            pa_ops.stage_bytes(H, int8)
        if p.splits > 1:
            assert p.ws_floats == B * K * p.splits * G * (H + 2)
            assert p.counters == B * K
        else:
            assert p.ws_floats == p.counters == 0
    p = pa_ops.plan(B, K, G, H, bs, nb, 132, int8)
    if B * K * nb >= 132:
        assert B * K * p.splits >= 132
    if (B, K, G, H, bs, nb) == (4, 4, 7, 128, 16, 16):
        assert p.grid == (16, 4, 4) and p.warps == 1


def _fake_paged_lib(monkeypatch, calls):
    class FakeLib:
        def paged_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(pa_ops, "_lib", FakeLib)
    monkeypatch.setattr(pa_ops, "_stream", lambda device: 0)
    monkeypatch.setattr(pa_ops, "_sm_count", lambda device: 132)
    monkeypatch.setattr(pa_ops, "_WORKSPACE", {})


def _paged_zeros(B, K, G, H, bs, nb, int8, q_dtype=torch.bfloat16):
    q = torch.zeros((B, K, G, H), dtype=q_dtype)
    pool = torch.zeros((B * nb + 1, bs, K, H),
                       dtype=torch.int8 if int8 else torch.bfloat16)
    kw = {}
    if int8:
        kw = dict(k_scale=torch.ones((B * nb + 1, bs, K)),
                  v_scale=torch.ones((B * nb + 1, bs, K)))
    bt = torch.zeros((B, nb), dtype=torch.int32)
    lens = torch.ones((B,), dtype=torch.int32)
    return q, pool, pool.clone(), bt, lens, kw


@pytest.mark.parametrize("B,K,G,H,bs,nb,int8,num_splits", [
    (4, 4, 7, 128, 16, 16, False, None), (4, 4, 7, 128, 16, 16, True, None),
    (2, 8, 4, 64, 32, 8, False, 1), (3, 2, 8, 256, 16, 12, True, 5)])
def test_paged_attention_one_launch(monkeypatch, B, K, G, H, bs, nb, int8,
                                    num_splits):
    """One call of the wrapper is one call of the library's launcher with
    the call's shapes and the plan's split and warps, and one count on the
    launch counter; a workspace only with more than one split, which a
    second call does not grow."""
    calls = []
    _fake_paged_lib(monkeypatch, calls)
    q, kp, vp, bt, lens, kw = _paged_zeros(B, K, G, H, bs, nb, int8)
    before = kernels.launch_counts()["paged_attention"]
    out = pa_ops.launch(q, kp, vp, bt, lens, cap=50.0, window=48,
                        num_splits=num_splits, **kw)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert kernels.launch_counts()["paged_attention"] == before + 1
    assert len(calls) == 1
    args = calls[0]
    p = pa_ops.plan(B, K, G, H, bs, nb, 132, int8, num_splits)
    assert args[10:18] == (B, K, G, H, bs, nb, p.blocks_per_split, p.warps)
    assert args[18:] == (50.0, 48, 0)
    assert args[9] == out.data_ptr()
    assert (args[3] is None) == (not int8)
    assert (args[7] is None) == (args[8] is None) == (p.splits == 1)
    if p.splits > 1:
        ws, counters = pa_ops._WORKSPACE[q.device]
        assert ws.numel() >= p.ws_floats
        assert counters.numel() >= p.counters and not counters.any()
        pa_ops.launch(q, kp, vp, bt, lens, num_splits=num_splits, **kw)
        again = pa_ops._WORKSPACE[q.device]
        assert again[0] is ws and again[1] is counters
        assert len(calls) == 2


@pytest.mark.parametrize("case", ["G9", "H72", "H272", "bs8", "f16",
                                  "pool_dtype", "build"])
def test_paged_attention_refuses(monkeypatch, case):
    """The kernel path raises for what the kernel does not take, and when
    the library does not build: it counts no launch, calls no launcher and
    never reaches the plain version."""
    calls, plain = [], []
    _fake_paged_lib(monkeypatch, calls)
    monkeypatch.setattr(pa_ops, "paged_attention_uses_fallback",
                        lambda device: False)
    monkeypatch.setattr(pa_ops, "paged_attention_ref",
                        lambda *a, **k: plain.append(a))
    K, G, H, bs = 2, 4, 64, 16
    if case == "G9":
        K, G = 1, 9
    elif case in ("H72", "H272"):
        H = int(case[1:])
    elif case == "bs8":
        bs = 8
    q, kp, vp, bt, lens, kw = _paged_zeros(
        2, K, G, H, bs, 4, False,
        torch.float16 if case == "f16" else torch.bfloat16)
    if case == "pool_dtype":
        vp = vp.to(torch.float16)
    if case == "build":
        def broken():
            raise build.KernelBuildError("nvcc failed")
        monkeypatch.setattr(pa_ops, "_lib", broken)
    want = {"f16": TypeError, "pool_dtype": TypeError,
            "build": build.KernelBuildError}.get(case, ValueError)
    before = kernels.launch_counts()["paged_attention"]
    with pytest.raises(want):
        pa_ops.paged_decode_attention(q.reshape(2, 1, K * G, H), kp, vp, bt,
                                      lens, **kw)
    assert kernels.launch_counts()["paged_attention"] == before
    assert not calls and not plain


PLAN_CASES = [(M, K, N, fmt) for fmt in ("q8", "q4") for M, K, N in [
    (1, 3584, 512), (4, 3584, 3584), (4, 18944, 3584), (4, 3584, 152064),
    (8, 1024, 32), (16, 1024, 128), (16, 18944, 3584), (17, 2048, 1024),
    (512, 3584, 18944), (2048, 1024, 2048), (4, 256, 136), (37, 384, 1024)]]


@pytest.mark.parametrize("M,K,N,fmt", PLAN_CASES)
def test_quant_matmul_plan(M, K, N, fmt):
    """The regime follows the row count; the tiles cover N and K; a decode
    block's K chunk is a multiple of the q4 group and no split is empty; the
    staged x rows fit; small-N weights are split for enough blocks."""
    group = 128 if fmt == "q4" else 0
    p = qm_ops.plan(M, K, N, fmt, group, sms=132)
    assert p.regime == ("decode" if M <= qm_ops.DECODE_MAX_M else "prefill")
    if p.regime == "prefill":
        assert p.splits == 1 and p.k_chunk == K
        rows = 64 if M <= 64 else 128
        assert p.grid == (-(-M // rows), -(-N // 128))
        if fmt == "q4":
            assert group % qm_ops.PF_BK == 0
    else:
        tiles, splits = p.grid
        assert (tiles - 1) * qm_ops.DEC_COLS < N <= tiles * qm_ops.DEC_COLS
        assert splits == p.splits
        assert (splits - 1) * p.k_chunk < K <= splits * p.k_chunk
        assert p.k_chunk % (group or qm_ops.DEC_UNIT) == 0
        rows = 8 if M <= 8 else 16
        assert rows * p.k_chunk * 2 <= qm_ops.DEC_X_BYTES
        if tiles < 132 and K >= 2 * qm_ops.DEC_MIN_CHUNK:
            assert splits > 1


@pytest.mark.parametrize("fmt", ["q8", "q4"])
@pytest.mark.parametrize("M,K,N", [(4, 3584, 512), (4, 3584, 152064),
                                   (512, 1024, 256)])
def test_quant_matmul_one_launch(monkeypatch, fmt, M, K, N):
    """One call of the wrapper is one call of the library's launcher, with
    the plan's regime and split, a workspace only when K is split, and one
    count on the format's launch counter."""
    from repro_torch import kernels
    from repro_torch.quant.qtensor import quantize
    calls = []

    class FakeLib:
        def quant_matmul(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(qm_ops, "_lib", FakeLib)
    monkeypatch.setattr(qm_ops, "_stream", lambda device: 0)
    monkeypatch.setattr(qm_ops, "_sm_count", lambda device: 132)
    monkeypatch.setattr(qm_ops, "_WORKSPACE", {})
    t = quantize(torch.zeros((K, N)), fmt)
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    before = kernels.launch_counts()[f"{fmt}_matmul"]
    out = qm_ops.launch(x, t)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert kernels.launch_counts()[f"{fmt}_matmul"] == before + 1
    assert len(calls) == 1
    args = calls[0]
    p = qm_ops.plan(M, K, N, fmt, t.group, 132)
    assert args[0] == qm_ops.FMT_CODES[fmt]
    assert args[8:11] == (M, K, N)
    assert args[12:15] == (int(p.regime == "decode"), p.splits, p.k_chunk)
    assert (args[5] is None) == (p.splits == 1)
    if p.splits > 1:
        ws, counters = qm_ops._WORKSPACE[x.device]
        assert ws.numel() >= p.splits * M * N
        assert counters.numel() >= p.grid[0] and not counters.any()


# the serve path's cold prefills (qwen2-7b heads, prompt buckets and
# max_seq), long prompts, and the other families' head dims and groups
FLASH_PLAN_CASES = [
    (4, 32, 32, 28, 4, 128, True, 0), (4, 64, 64, 28, 4, 128, True, 0),
    (4, 128, 128, 28, 4, 128, True, 0), (4, 256, 256, 28, 4, 128, True, 0),
    (1, 2048, 2048, 28, 4, 128, True, 0), (1, 4096, 4096, 28, 4, 128, True, 0),
    (2, 40, 100, 8, 2, 128, True, 24), (2, 100, 100, 8, 8, 64, True, 48),
    (2, 77, 130, 14, 2, 112, False, 0), (1, 300, 300, 8, 2, 256, True, 0),
    (1, 50, 50, 4, 1, 16, True, 0), (3, 1500, 1500, 20, 20, 64, False, 0)]


@pytest.mark.parametrize("B,Sq,Skv,N,K,H,causal,window", FLASH_PLAN_CASES)
def test_flash_attention_plan(B, Sq, Skv, N, K, H, causal, window):
    """The grid covers every (batch, position, head) exactly once, as the
    kernel maps its 1-D block index (head fastest, then batch, then row
    tiles from the last); a block's tiles fit in shared memory, two blocks
    an SM where the head dim is at most 128."""
    p = fa_ops.plan(B, Sq, Skv, N, K, H)
    tiles, heads, batch = p.grid
    assert (heads, batch) == (N, B)
    assert p.smem == fa_ops.smem_bytes(H) <= fa_ops.SMEM_MAX
    assert H > 128 or 2 * p.smem <= 228 * 1024
    seen = np.zeros((B, Sq, N), np.int64)
    for blk in range(tiles * heads * batch):
        n, rest = blk % N, blk // N
        b, r0 = rest % B, (tiles - 1 - rest // B) * fa_ops.ROW_TILE
        rows = np.arange(r0, min(r0 + fa_ops.ROW_TILE, Sq))
        np.add.at(seen, (b, rows, n), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("B,S,want", [(4, 32, (1, 28, 4)),
                                      (4, 64, (1, 28, 4)),
                                      (4, 128, (2, 28, 4)),
                                      (4, 256, (4, 28, 4)),
                                      (1, 4096, (64, 28, 1))])
def test_flash_attention_plan_at_serve_shapes(B, S, want):
    """carboncall-qwen2-7b's cold prefills: one head's 64 positions a
    block, 112 blocks at B 4 up to the 64-token bucket (under one wave of
    132 SMs), 448 at max_seq 256; 112 KB of shared memory a block."""
    p = fa_ops.plan(B, S, S, 28, 4, 128)
    assert p.grid == want and p.smem == 112 * 1024


def _fake_flash_lib(monkeypatch, calls):
    class FakeLib:
        def flash_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fa_ops, "_lib", FakeLib)
    monkeypatch.setattr(fa_ops, "_stream", lambda device: 0)


@pytest.mark.parametrize("B,Sq,Skv,N,K,H,causal,window,cap,off", [
    (4, 64, 64, 28, 4, 128, True, 0, 0.0, 0),
    (2, 40, 100, 8, 2, 64, True, 24, 50.0, 60),
    (1, 30, 70, 6, 6, 256, False, 0, 0.0, 0)])
def test_flash_attention_one_launch(monkeypatch, B, Sq, Skv, N, K, H, causal,
                                    window, cap, off):
    """One call of the wrapper is one call of the library's launcher with
    the call's shapes and options, and one count on the launch counter."""
    calls = []
    _fake_flash_lib(monkeypatch, calls)
    q = torch.zeros((B, Sq, N, H), dtype=torch.bfloat16)
    k = torch.zeros((B, Skv, K, H), dtype=torch.bfloat16)
    before = kernels.launch_counts()["flash_attention"]
    out = fa_ops.launch(q, k, k.clone(), causal=causal, window=window,
                        cap=cap, q_offset=off)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert kernels.launch_counts()["flash_attention"] == before + 1
    assert len(calls) == 1
    args = calls[0]
    assert args[4:12] == (B, Sq, Skv, N, K, H, int(causal), window)
    assert args[12:] == (cap, off, 0)
    assert args[3] == out.data_ptr()


@pytest.mark.parametrize("case", ["H72", "H272", "f16", "build"])
def test_flash_attention_refuses(monkeypatch, case):
    """The kernel path raises for what the kernel does not take, and when
    the library does not build; it never falls back to the plain version
    and counts no launch."""
    calls = []
    _fake_flash_lib(monkeypatch, calls)
    H = {"H72": 72, "H272": 272}.get(case, 128)
    dt = torch.float16 if case == "f16" else torch.bfloat16
    q = torch.zeros((1, 16, 4, H), dtype=dt)
    k = torch.zeros((1, 16, 2, H), dtype=dt)
    if case == "build":
        def broken():
            raise build.KernelBuildError("nvcc failed")
        monkeypatch.setattr(fa_ops, "_lib", broken)
    want = {"f16": TypeError, "build": build.KernelBuildError}.get(
        case, ValueError)
    before = kernels.launch_counts()["flash_attention"]
    with pytest.raises(want):
        fa_ops.launch(q, k, k)
    assert kernels.launch_counts()["flash_attention"] == before
    assert not calls


def test_library_path_hashes_headers(tmp_path):
    """A library's name follows the headers its source includes: a changed
    header gives a new path, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    header = csrc / "wgmma.cuh"
    names = [p.name for p in build.source_files("flash_attention", csrc)]
    assert names == ["flash_attention.cu", "wgmma.cuh"]
    before = {n: build.library_path(n, csrc) for n in build.SOURCES}
    assert before["flash_attention"] == build.library_path("flash_attention")
    header.write_text(header.read_text() + "\n// changed\n")
    after = {n: build.library_path(n, csrc) for n in build.SOURCES}
    for n in build.SOURCES:
        uses = header in build.source_files(n, csrc)
        assert (after[n] != before[n]) == uses, n
    assert after["flash_attention"] != before["flash_attention"]
    assert after["quant_matmul"] != before["quant_matmul"]
