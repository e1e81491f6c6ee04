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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as ref_ssd_ops
from repro.models import mamba2 as RM

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


def test_kernel_refuses_what_it_does_not_take():
    """The CUDA wrapper's checks run before any build: an S that is not a
    multiple of the chunk (as `ssd_bshp` asserts), f32 x, and a chunk past
    the kernel's 128 rows all raise."""
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
