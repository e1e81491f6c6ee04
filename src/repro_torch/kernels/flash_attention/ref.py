"""Plain version of the flash attention kernel: the naive O(S^2) attention
of models/layers (f32 logits, softcap, additive mask, softmax), model layout."""
from __future__ import annotations

from repro_torch.models.layers import naive_attention


def flash_attention_ref(q, k, v, *, causal=True, window=0, cap=0.0,
                        q_offset=0):
    """q: (B, Sq, N, H); k/v: (B, Skv, K, H) — model layout."""
    return naive_attention(q, k, v, causal=causal, window=window, cap=cap,
                           q_offset=q_offset)
