"""Greedy person assembly on the device.

The JAX package runs this as two XLA scans, or as one Pallas kernel
(popnet_tpu/decode/assemble_device.py, assemble_pallas.py). Here it is
`ops/kernels.assemble_ids`: on a CUDA tensor one kernel launch for the
batch (csrc/assemble.cu, one block per frame, the slot table in shared
memory), on a CPU tensor the plain version, whose Python loops run about
45 small ops in each of L*M merge steps. On the card those loops are bound
by launch latency, not by the card, which is why the kernel is the default
there.
"""

from __future__ import annotations

import torch

from popnet_tpu_torch.core.skeleton import LIMBS
from popnet_tpu_torch.ops import kernels


def assemble_batched(peaks: torch.Tensor, peak_valid: torch.Tensor,
                     scores: torch.Tensor, ok: torch.Tensor, limbs: tuple = LIMBS,
                     max_people: int = 16, min_parts: int = 3,
                     min_score: float = 0.2, method: str | None = None):
    """peaks (B, K, M, 3), peak_valid (B, K, M), scores and ok (B, L, M, M)
    -> (joints (B, max_people, K, 3), counts (B,) int32). Holes are
    (-1, -1, 0).

    method: "kernel" is the CUDA kernel (the plain version on CPU tensors),
    "scan" the plain loops on any device; None takes the kernel on CUDA
    tensors and the scan on CPU ones."""
    if method is None:
        method = "kernel" if peaks.is_cuda else "scan"
    if method not in ("kernel", "scan"):
        raise ValueError(f"unknown method {method!r}")
    peaks = peaks.float()
    fn = kernels.assemble_ids if method == "kernel" else kernels.assemble_ids_plain
    out_ids, counts = fn(*assemble_inputs(peaks, scores, ok), limbs, max_people, min_parts,
                         min_score)
    return _emit_joints(peaks, out_ids, counts)


def assemble_inputs(peaks: torch.Tensor, scores: torch.Tensor, ok: torch.Tensor):
    """What `assemble_ids` receives: the peak scores (B, K, M), contiguous,
    and the pair scores (B, L, M, M) with -inf at non-candidates."""
    ninf = torch.full((), float("-inf"), device=peaks.device)
    return peaks[..., 2].float().contiguous(), torch.where(ok, scores.float(), ninf)


def _emit_joints(peaks: torch.Tensor, out_ids: torch.Tensor, counts: torch.Tensor):
    """Packed peak-id table -> (joints (B, Pout, K, 3), counts)."""
    B, K, M, _ = peaks.shape
    idx = out_ids.long().clamp(0, M - 1)                         # (B, Pout, K)
    g = peaks[torch.arange(B, device=peaks.device)[:, None, None],
              torch.arange(K, device=peaks.device)[None, None, :], idx]
    hole = torch.tensor([-1.0, -1.0, 0.0], device=peaks.device)
    return torch.where(out_ids[..., None] >= 0, g, hole), counts
