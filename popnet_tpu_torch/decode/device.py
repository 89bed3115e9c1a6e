"""Batched peak detection, subpixel refinement and PAF pair scoring.

Maps keep the JAX layout at these public functions: (B, H, W, C) in,
peaks (B, K, M, 3) of (x, y, score) in upsampled-image coordinates out.
The work runs in the kernels of `ops/kernels.py` (`find_peaks`,
`find_peaks_row` or `find_peaks_plane`, `paf_score`) on a CUDA tensor, and
in their plain versions on a CPU one.
The refine's bicubic upsample matrix (`_cubic_kernel`, `_upsample_matrix`)
lives with the kernels.
"""

from __future__ import annotations

import torch

from popnet_tpu_torch.core.skeleton import LIMBS
from popnet_tpu_torch.ops import kernels


def peak_planes(heat: torch.Tensor, num_joints: int = 15) -> torch.Tensor:
    """(B, H, W, C >= num_joints) maps -> the (B, K, H, W) float32 view of
    the joint heat planes that the find_peaks kernel reads (no copy)."""
    return heat[..., :num_joints].float().permute(0, 3, 1, 2)


def find_peaks_batched(heat: torch.Tensor, max_peaks: int = 16, thresh: float = 0.1,
                       factor: int = 8, win_size: int = 2, num_joints: int = 15,
                       refine: str | None = None):
    """Top-M peaks per joint with windowed bicubic subpixel refinement.

    heat: (B, H, W, C >= num_joints). Returns peaks (B, K, M, 3) of
    (x, y, score) and valid (B, K, M).

    refine: "kernel" (None takes it) is `find_peaks`, one block of 16 warps
    per frame where a frame's planes fit it, else `find_peaks_plane` (the
    COCO evaluation canvas of an image that is not square: each plane's
    rows over a cluster of CTAs; `kernels.find_peaks_route`); "kernel_row"
    is `find_peaks_row`, a cluster of 2 CTAs per frame, each owning every
    other plane. All give the same result bit for bit."""
    if refine not in (None, "kernel", "kernel_row"):
        raise ValueError(f"unknown refine {refine!r}")
    fn = kernels.find_peaks_row if refine == "kernel_row" else kernels.find_peaks
    px, py, loc, peak_score, valid = fn(
        peak_planes(heat, num_joints), max_peaks=max_peaks, thresh=thresh, factor=factor,
        win_size=win_size)
    S = (2 * win_size + 1) * factor
    center = (win_size + 0.5) * factor - 0.5
    out_x = (px + 0.5) * factor - 0.5 + ((loc % S).float() - center)
    out_y = (py + 0.5) * factor - 0.5 + ((loc // S).float() - center)
    return torch.stack([out_x, out_y, peak_score], dim=-1), valid


def score_limb_pairs_batched(pafs: torch.Tensor, peaks: torch.Tensor,
                             peak_valid: torch.Tensor, num_intermed_pts: int = 10,
                             thresh_paf: float = 0.05, factor: int = 8,
                             limbs: tuple = LIMBS):
    """All src x dst pair scores per limb: (scores, ok), each (B, L, M, M).

    ok combines the PAF-sample criterion, a positive penalized score and
    the validity of both peaks."""
    return kernels.paf_score(pafs.float(), peaks.float().contiguous(),
                             peak_valid.contiguous(), limbs, num_pts=num_intermed_pts,
                             factor=factor, thresh=thresh_paf)
