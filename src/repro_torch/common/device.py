"""Device resolution shared by the port's entry points: they run on the card
unless the caller asks for the CPU, and never fall back to it quietly."""
from __future__ import annotations

import torch


def resolve_device(device, owner: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}: device='cuda' but no CUDA card is visible; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev
