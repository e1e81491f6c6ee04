"""Entry point of the SSD chunk scan (Mamba2 prefill).

`ssd(x, dt, A, Bm, Cm, chunk=...)` runs `csrc/ssd.cu` for CUDA inputs
(replacing the Pallas `ssd_bshp` of `repro.kernels.ssd`) and the plain
version in `ref.py` for CPU inputs. Like the Pallas kernel, the CUDA kernel
takes chunks of Q = min(chunk, S) tokens and needs S % Q == 0 (the plain
version falls back to one chunk of S instead, as `ssd_chunked` does). It
takes bf16 x, B and C (what the model hands over), f32 dt and A, head dims
P in HEAD_DIMS and state dims N in STATE_DIMS; anything else raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import ssd_chunked

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"ssd_bshp": [_P] * 7 + [_I] * 7 + [_P]}
MAX_CHUNK = 128                     # chunk rows the kernel holds on chip
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)


def launch(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Run the CUDA kernel. Returns (y (B,S,H,P) f32, final (B,H,P,N) f32)."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.dtype != torch.bfloat16 or Bm.dtype != torch.bfloat16 \
            or Cm.dtype != torch.bfloat16:
        raise TypeError("ssd kernel takes bf16 x, B and C, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd kernel takes f32 dt and A, got {dt.dtype}, "
                        f"{A.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd kernel: inputs on different devices")
    if tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != (Bb, S, G, N) or Cm.shape != Bm.shape \
            or H % G:
        raise ValueError(f"ssd kernel: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd kernel: sequence {S} is not a multiple of the "
                         f"chunk {Q}")
    if Q > MAX_CHUNK or P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd kernel takes chunk <= {MAX_CHUNK}, P in "
                         f"{HEAD_DIMS}, N in {STATE_DIMS}; got chunk {Q}, "
                         f"P {P}, N {N}")
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    fs = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    lib = build.load("ssd", SIGNATURES)
    err = lib.ssd_bshp(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                       fs.data_ptr(), Bb, S, H, P, G, N, Q,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_bshp")
    kernels.LAUNCHES["ssd_bshp"] += 1
    return y, fs


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """-> (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    if x.device.type == "cuda":
        y, fs = launch(x, dt, A, Bm, Cm, chunk=chunk)
        return y.to(x.dtype), fs
    if x.device.type != "cpu":
        raise ValueError(f"ssd: unsupported device {x.device}")
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)
