"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device(device); raises when a CUDA device is asked for and no
    card is present (nothing moves to the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device
