"""Token sampling: greedy or temperature.

Temperature 0 is argmax (first maximum on ties, as `jnp.argmax`). Above 0
the draw comes from the caller's `torch.Generator` — the engine's own, seeded
at construction — so a run is reproducible; it cannot reproduce
`jax.random.categorical`'s bits, only its distribution."""
from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  *, temperature: float = 0.0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
