"""Float32 arithmetic that rounds as the JAX package's compiled programs do."""

from __future__ import annotations

import numpy as np
import torch


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a constant c, rounded as XLA rounds it: XLA compiles a
    division by a constant into a multiply by the float32 reciprocal
    f32(1 / f32(c)), and so does this, on the CPU and on the card alike.
    (PyTorch itself divides on the CPU, and on the card multiplies by that
    reciprocal when c is a Python number: the two round apart by an ulp.)"""
    return x * float(np.float32(1.0) / np.float32(c))

