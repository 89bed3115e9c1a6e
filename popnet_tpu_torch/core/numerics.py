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


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c for float32 a, a float32 b and float32 c (each of b and c a
    tensor that broadcasts against a, or a number), rounded once, as XLA's
    CPU compiler contracts a multiply and an add into a fused multiply-add.

    Computed in float64, where a * b is exact: the sum s = a * b + c is
    rounded to float64 with its error e kept (Knuth's two-sum), and s
    rounded to float32 is the fused result but where s lies exactly halfway
    between two float32 values and e breaks the tie."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else float(np.float32(b)))
    c64 = c.double() if isinstance(c, torch.Tensor) else float(np.float32(c))
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)
    f = s.float()
    d = s - f.double()                              # exact: s rounded to float32 and back
    other = f.double() + 2.0 * d                    # the far neighbour when s is a tie
    tie = (d != 0) & (other.float().double() == other)
    return torch.where(tie & (e != 0) & ((e > 0) == (d > 0)), other.float(), f)
