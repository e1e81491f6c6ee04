"""Plain version of the Mamba2 SSD chunk scan: the port of
`repro.models.mamba2.ssd_chunked`, the oracle of the JAX package's Pallas
`ssd_bshp`. CPU tensors take it in `ops`; on the card it is what the kernel
is held against."""
from __future__ import annotations

import torch


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """xh: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) negative;
    Bm/Cm: (B,S,G,N), head h reading group h // (H/G). Returns
    (y (B,S,H,P) in xh's dtype, final_state (B,H,P,N) f32).

    The sequence runs in chunks of `chunk` tokens (the whole sequence when S
    is not a multiple of it); within a chunk the recurrence is the masked
    quadratic form, across chunks a carried (P, N) state per head. Inputs are
    read in their own dtype and every product and sum is f32."""
    Bb, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if S % chunk != 0:
        chunk = S
    f32 = torch.float32
    Bh = Bm.repeat_interleave(rep, dim=2)                    # (B,S,H,N)
    Ch = Cm.repeat_interleave(rep, dim=2)
    dtf = dt.to(f32)
    dA = dtf * A.to(f32)                                     # (B,S,H) negative
    state = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((Bb, H, Pd, N), dtype=f32, device=xh.device))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        x_c = xh[:, sl].to(f32)
        B_c = Bh[:, sl].to(f32)
        C_c = Ch[:, sl].to(f32)
        cs = torch.cumsum(dA[:, sl], dim=1)                  # (B,Q,H) inclusive
        # intra-chunk decay L[q,k] = exp(cs_q - cs_k) for q >= k, else 0;
        # the exponent is masked before the exp, so the upper triangle (which
        # can overflow) never exists
        diff = cs[:, :, None, :] - cs[:, None, :, :]         # (B,Q,K,H)
        Lmat = torch.exp(diff.masked_fill(~mask, float("-inf")))
        scores = torch.einsum("bqhn,bkhn->bqkh", C_c, B_c)
        xdt = x_c * dtf[:, sl, :, None]                      # (B,Q,H,P)
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores * Lmat, xdt)
        # inter-chunk: read the carried state
        y_off = torch.einsum("bqhn,bhpn->bqhp", C_c, state) \
            * torch.exp(cs)[..., None]
        total = cs[:, -1, :]                                 # (B,H)
        w = torch.exp(total[:, None, :] - cs)                # (B,Q,H)
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bkhn,bkhp->bhpn", B_c * w[..., None], xdt)
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)
    return y.to(xh.dtype), state
