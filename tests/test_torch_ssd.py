"""The port's SSD chunk scan (the plain version every CPU tensor takes) and
the Mamba2 decode step against the JAX package's.

Oracles: `repro.models.mamba2.ssd_chunked` and the Pallas `ssd_bshp` in
interpret mode (`repro.kernels.ssd.ops.ssd(..., interpret=True)`), at the
four shapes of `tests/test_kernels.py::test_ssd`, with inputs drawn by numpy
from a seed (x ~ N(0,1), dt = softplus(N(0,1)), A = -exp(0.5 N(0,1)),
B, C ~ 0.3 N(0,1)).

Tolerances: SSD_TOL = 0.05 on y and on the final state is the kernel
tolerance of `tests/test_kernels.py`. With f32 inputs both sides do the same
f32 arithmetic in another order, so they agree far tighter: F32_TOL = 1e-4,
relative to max(1, max |want|) (measured <= 5.8e-6; 1.1e-4 absolute). bf16
inputs (the model's) hold y to one bf16 step of its magnitude: BF16_REL =
1e-2 of max(1, max |want|), with the f32 state at F32_TOL. `ssd_decode` is a handful
of f32 products: DECODE_TOL = 1e-5 relative.

The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py); here
its plan is checked (every tile of each phase taken once by the persistent
grid, the shared memory and the workspace) and its wrapper is driven through
a stand-in library.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as ref_ssd_ops
from repro.models import mamba2 as RM

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.models import mamba2 as PM

SSD_TOL = 0.05
F32_TOL = 1e-4
BF16_REL = 1e-2
DECODE_TOL = 1e-5

SHAPES = [(2, 256, 4, 64, 1, 128, 128), (1, 128, 8, 32, 2, 64, 64),
          (2, 64, 4, 16, 1, 32, 32), (1, 256, 2, 64, 1, 16, 64)]


def _softplus(v):
    return np.log1p(np.exp(-np.abs(v))) + np.maximum(v, 0.0)


def _inputs(seed, B, S, H, P, G, N):
    g = np.random.default_rng(seed)
    x = g.standard_normal((B, S, H, P)).astype(np.float32)
    dt = _softplus(g.standard_normal((B, S, H))).astype(np.float32)
    A = (-np.exp(g.standard_normal((H,)) * 0.5)).astype(np.float32)
    Bm = (g.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (g.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _err(want, got):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert want.shape == got.shape
    return float(np.max(np.abs(want - got)))


def _scale(want):
    return max(1.0, float(np.max(np.abs(np.asarray(want, np.float32)))))


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SHAPES)
def test_plain_ssd_matches_reference_and_pallas(B, S, H, P, G, N, Q):
    ins = _inputs(S * H + N, B, S, H, P, G, N)
    y, fs = ssd_ops.ssd(*(torch.from_numpy(a) for a in ins), chunk=Q)
    jins = [jnp.asarray(a) for a in ins]
    y_ref, fs_ref = RM.ssd_chunked(*jins, Q)
    y_pl, fs_pl = ref_ssd_ops.ssd(*jins, chunk=Q, interpret=True)
    errs = []
    for want_y, want_fs in ((y_ref, fs_ref), (y_pl, fs_pl)):
        ey, efs = _err(want_y, y), _err(want_fs, fs)
        assert ey < SSD_TOL and efs < SSD_TOL, (ey, efs)
        assert ey < F32_TOL * _scale(want_y), ey
        assert efs < F32_TOL * _scale(want_fs), efs
        errs += [ey, efs]
    print(f"ssd {B, S, H, P, G, N, Q}: max |err| y/state vs ssd_chunked "
          f"{errs[0]:.2e}/{errs[1]:.2e}, vs ssd_bshp {errs[2]:.2e}/{errs[3]:.2e}")


def test_plain_ssd_chunk_fallback_and_initial_state():
    """S % chunk != 0 falls back to one chunk of S (as `ssd_chunked` does);
    an initial state is carried into the first chunk."""
    B, S, H, P, G, N = 2, 40, 4, 16, 2, 32
    ins = _inputs(7, B, S, H, P, G, N)
    h0 = np.random.default_rng(8).standard_normal((B, H, P, N)).astype(
        np.float32)
    for chunk, init in ((16, None), (8, h0), (16, h0)):
        y, fs = ssd_chunked(*(torch.from_numpy(a) for a in ins), chunk,
                            initial_state=None if init is None
                            else torch.from_numpy(init))
        y_ref, fs_ref = RM.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk,
                                       initial_state=None if init is None
                                       else jnp.asarray(init))
        assert _err(y_ref, y) < F32_TOL * _scale(y_ref)
        assert _err(fs_ref, fs) < F32_TOL * _scale(fs_ref)


def test_plain_ssd_bf16_inputs():
    """The model's dtypes: bf16 x, B and C, f32 dt and A; y comes back in
    bf16, the state in f32."""
    B, S, H, P, G, N = 2, 64, 4, 16, 1, 16
    x, dt, A, Bm, Cm = _inputs(9, B, S, H, P, G, N)
    tx, tB, tC = (torch.from_numpy(a).bfloat16() for a in (x, Bm, Cm))
    y, fs = ssd_ops.ssd(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                        chunk=8)
    assert y.dtype == torch.bfloat16 and fs.dtype == torch.float32
    jx, jB, jC = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tx, tB, tC))
    y_ref, fs_ref = RM.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB,
                                   jC, 8)
    assert y_ref.dtype == jnp.bfloat16
    assert _err(y_ref, y) < BF16_REL * _scale(y_ref)
    assert _err(fs_ref, fs) < F32_TOL * _scale(fs_ref)


def test_ssd_decode_matches_reference():
    g = np.random.default_rng(10)
    B, H, P, G, N = 3, 8, 16, 2, 32
    state = g.standard_normal((B, H, P, N)).astype(np.float32)
    x = g.standard_normal((B, H, P)).astype(np.float32)
    dt = _softplus(g.standard_normal((B, H))).astype(np.float32)
    A = (-np.exp(g.standard_normal((H,)) * 0.5)).astype(np.float32)
    Bv = (g.standard_normal((B, G, N)) * 0.3).astype(np.float32)
    Cv = (g.standard_normal((B, G, N)) * 0.3).astype(np.float32)
    ins = (state, x, dt, A, Bv, Cv)
    st, y = PM.ssd_decode(*(torch.from_numpy(a) for a in ins))
    st_ref, y_ref = RM.ssd_decode(*(jnp.asarray(a) for a in ins))
    assert _err(st_ref, st) < DECODE_TOL * _scale(st_ref)
    assert _err(y_ref, y) < DECODE_TOL * _scale(y_ref)


def test_kernel_refuses_what_it_does_not_take(monkeypatch):
    """The CUDA wrapper's checks run before any build: an S that is not a
    multiple of the chunk (as `ssd_bshp` asserts), f32 x, and a chunk past
    the kernel's 128 rows all raise; so does a library that does not
    build, with no launch counted and no plain scan run in its place."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        _inputs(1, 1, 40, 2, 16, 1, 16))
    bf = (x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16())
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.launch(*bf, chunk=16)
    with pytest.raises(TypeError, match="bf16"):
        ssd_ops.launch(x, dt, A, Bm, Cm, chunk=8)
    x2, dt2, A2, B2, C2 = (torch.from_numpy(a) for a in
                           _inputs(2, 1, 256, 2, 16, 1, 16))
    with pytest.raises(ValueError, match="chunk <= 128"):
        ssd_ops.launch(x2.bfloat16(), dt2, A2, B2.bfloat16(), C2.bfloat16(),
                       chunk=256)
    plain = []
    monkeypatch.setattr(ssd_ops, "_sm_count", lambda device: 132)
    monkeypatch.setattr(ssd_ops, "ssd_chunked", lambda *a: plain.append(a))

    def broken():
        raise build.KernelBuildError("nvcc failed")
    monkeypatch.setattr(ssd_ops, "_lib", broken)
    before = kernels.launch_counts()["ssd_bshp"]
    with pytest.raises(build.KernelBuildError):
        ssd_ops.launch(*bf, chunk=8)
    assert kernels.launch_counts()["ssd_bshp"] == before and not plain


# (B, S, H, P, G, N, Q): chip_smoke.py's SSD_SHAPES (mamba2-370m at its
# serve admissions and longer prompts, zamba2-7b's heads, a chunk of 40),
# then the card tests' shapes (chunks of 20 and 24 rows, G 2, N 16-128)
PLAN_SHAPES = [(1, 2048, 32, 64, 1, 128, 128), (4, 128, 32, 64, 1, 128, 128),
               (2, 512, 32, 64, 1, 128, 128), (4, 512, 32, 64, 1, 128, 128),
               (1, 1024, 112, 64, 1, 64, 128), (1, 4096, 32, 64, 1, 128, 128),
               (2, 120, 32, 64, 1, 128, 40), (2, 256, 4, 64, 1, 128, 128),
               (1, 128, 8, 32, 2, 64, 64), (2, 64, 4, 16, 1, 32, 32),
               (1, 256, 2, 64, 1, 16, 64), (1, 40, 2, 16, 1, 16, 20),
               (2, 24, 4, 64, 2, 128, 24)]


# The kernel's work orders (csrc/ssd.cu, ssd_kernel), spelled out so that
# test_ssd_plan can check that a plan's blocks cover every tile once.
def _item(p, H, t):
    """Item t of phases 1 and 3 -> (b, chunk, first head h0): the loops over
    t in ssd_kernel."""
    per_bc = H // p.heads
    return t // (per_bc * p.chunks), (t // per_bc) % p.chunks, \
        (t % per_bc) * p.heads


def _item_heads(p, phase, warpgroup):
    """Head offsets k (head h0 + k) that a warpgroup takes in an item: in
    phase 1 every other head (chunk_states), in phase 3 every head for its
    64 rows (chunk_outputs)."""
    if phase == 1:
        return range(warpgroup, p.heads, 2)
    return range(p.heads)


def _state_runs(p, grid, thread):
    """Phase 2 float4s of global thread `thread` (of grid x THREADS), in the
    order of pass_states: 4 float4s a stride apart at a time up to 4 chunks,
    else 1."""
    stride = grid * ssd_ops.THREADS
    runs = 4 if p.chunks <= 4 else 1
    for u0 in range(thread, p.units, runs * stride):
        for k in range(runs):
            if u0 + k * stride < p.units:
                yield u0 + k * stride


def _state_unit(P, N, H, u):
    """Phase 2 float4 u -> (b, h, float4 of the (P, N) state)."""
    pn4 = P * N // 4
    return u // pn4 // H, u // pn4 % H, u % pn4


@pytest.mark.parametrize("B,S,H,P,G,N,Q", PLAN_SHAPES)
def test_ssd_plan(B, S, H, P, G, N, Q):
    """The persistent grid covers every (b, chunk, h) tile once in phase 1
    (each warpgroup of an item every other head) and once in phase 3 for
    each 64-row tile of the chunk (one warpgroup each), and every float4 of
    every (b, h) state once in phase 2 (a float4 and its neighbour, which
    trade halves, on neighbouring lanes of one warp), at the planned grid and
    at a smaller one (fewer resident blocks); an item's heads share one
    group, the items fill one wave where the heads allow, the tiles fit in
    shared memory, and the workspace holds a state and a total per tile."""
    p = ssd_ops.plan(B, S, H, P, G, N, Q, 132)
    nc = S // Q
    assert (H // G) % p.heads == 0 and p.heads <= ssd_ops.HG_MAX
    assert p.chunks == nc and p.items == B * nc * H // p.heads
    counts = [d for d in range(1, ssd_ops.HG_MAX + 1) if (H // G) % d == 0]
    # the fewest heads that leave one wave of items, or the most there are
    assert p.items <= 132 or p.heads == counts[-1]
    assert all(B * nc * H // d > 132 for d in counts if d < p.heads)
    assert p.ws_floats == B * nc * H * (P * N + 1)
    assert p.smem <= ssd_ops.SMEM_MAX
    assert 0 < p.grid <= 132
    tiles = {(b, c, h) for b in range(B) for c in range(nc) for h in range(H)}
    units = {(b, h, e) for b in range(B) for h in range(H)
             for e in range(P * N // 4)}
    for grid in (p.grid, 7):
        items = [_item(p, H, t) for blk in range(grid)
                 for t in range(blk, p.items, grid)]
        assert all(h0 // (H // G) == (h0 + p.heads - 1) // (H // G)
                   for _, _, h0 in items)
        one = Counter((b, c, h0 + k) for b, c, h0 in items
                      for w in (0, 1) for k in _item_heads(p, 1, w))
        assert set(one) == tiles and set(one.values()) == {1}
        three = Counter((b, c, h0 + k, w) for b, c, h0 in items
                        for w in (0, 1) for k in _item_heads(p, 3, w))
        assert set(three) == {t + (w,) for t in tiles for w in (0, 1)}
        assert set(three.values()) == {1}
        two = Counter(_state_unit(P, N, H, u)
                      for th in range(grid * ssd_ops.THREADS)
                      for u in _state_runs(p, grid, th))
        assert set(two) == units and set(two.values()) == {1}
        # float4 u and u ^ 1 belong to lanes t and t ^ 1 of one warp
        assert all(u1 ^ 1 == u2 for th in range(0, 64, 2) for u1, u2 in zip(
            _state_runs(p, grid, th),
            _state_runs(p, grid, th + 1)))


def _fake_ssd_lib(monkeypatch, calls):
    class FakeLib:
        def ssd_bshp(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ssd_ops, "_lib", FakeLib)
    monkeypatch.setattr(ssd_ops, "_stream", lambda device: 0)
    monkeypatch.setattr(ssd_ops, "_sm_count", lambda device: 132)
    monkeypatch.setattr(ssd_ops, "_WORKSPACE", {})


@pytest.mark.parametrize("B,S,H,P,G,N,Q", [
    (2, 256, 4, 64, 1, 128, 128), (1, 40, 2, 16, 1, 16, 20),
    (2, 24, 4, 64, 2, 128, 128)])
def test_ssd_one_launch(monkeypatch, B, S, H, P, G, N, Q):
    """One call of the wrapper is one call of the library's launcher with
    the call's shapes, the plan's grid and the device's workspace, and one
    count on the launch counter; a second call reuses the workspace, and a
    smaller call does not grow it."""
    calls = []
    _fake_ssd_lib(monkeypatch, calls)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        _inputs(3, B, S, H, P, G, N))
    ins = (x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16())
    before = kernels.launch_counts()["ssd_bshp"]
    y, fs = ssd_ops.launch(*ins, chunk=Q)
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert fs.shape == (B, H, P, N) and fs.dtype == torch.float32
    assert kernels.launch_counts()["ssd_bshp"] == before + 1
    assert len(calls) == 1
    args = calls[0]
    p = ssd_ops.plan(B, S, H, P, G, N, min(Q, S), 132)
    assert args[8:17] == (B, S, H, P, G, N, min(Q, S), p.heads, p.grid)
    assert args[5] == y.data_ptr() and args[6] == fs.data_ptr()
    ws = ssd_ops._WORKSPACE[x.device]
    assert args[7] == ws.data_ptr() and ws.numel() >= p.ws_floats
    ssd_ops.launch(*ins, chunk=Q)
    half = tuple(t[:, :S // 2] if t.dim() > 1 else t for t in ins)
    ssd_ops.launch(*half, chunk=min(Q, S // 2))
    assert len(calls) == 3 and ssd_ops._WORKSPACE[x.device] is ws
    assert calls[1][7] == calls[2][7] == ws.data_ptr()
    assert kernels.launch_counts()["ssd_bshp"] == before + 3
