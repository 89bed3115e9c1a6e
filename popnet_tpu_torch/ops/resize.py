"""cv2 INTER_LINEAR resize (half-pixel source, edge clamp, no antialias).

`F.interpolate(mode="bilinear", antialias=True)` filters on downsampling
and cv2 does not, so the resize samples directly, as the JAX package does.
"""

from __future__ import annotations

import torch


def _axis_weights(in_size: int, out_size: int, device):
    """cv2 INTER_LINEAR source coords: (o + 0.5) * in/out - 0.5, clamped.

    The product and difference round once to float32 (exact in float64,
    then cast), as XLA's fused multiply-add computes them in the JAX
    package."""
    scale = torch.tensor(in_size / out_size, dtype=torch.float32).double()
    o = torch.arange(out_size, dtype=torch.float64, device=device) + 0.5
    src = (o * scale.to(device) - 0.5).float()
    i0 = torch.floor(src)
    frac = src - i0
    i0c = i0.to(torch.int64).clamp(0, in_size - 1)
    i1c = (i0.to(torch.int64) + 1).clamp(0, in_size - 1)
    return i0c, i1c, frac


def resize_bilinear_cv2(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two dims of (..., H, W) with cv2.INTER_LINEAR semantics."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    y0, y1, fy = _axis_weights(in_h, out_h, img.device)
    x0, x1, fx = _axis_weights(in_w, out_w, img.device)
    fy = fy[:, None]
    rows = img[..., y0, :] * (1.0 - fy) + img[..., y1, :] * fy
    return rows[..., x0] * (1.0 - fx) + rows[..., x1] * fx
