"""A2J crops for serving: person boxes -> fixed 288x288 normalized depth.

A box may reach past the image: taps out of bounds read zero. The crop is a
nearest-neighbour resize to CROP x CROP, then (d - mean) / std. The whole
batch of boxes is one gather.
"""

from __future__ import annotations

import torch

from popnet_tpu_torch.core.numerics import div_const

CROP = 288


def crop_resize_batch(images: torch.Tensor, image_idx: torch.Tensor, boxes: torch.Tensor,
                      mean: float = 3.0, std: float = 2.0) -> torch.Tensor:
    """images (B, H, W) raw depth, image_idx (N,) which image each box
    crops, boxes (N, 4) [xmin, ymin, xmax, ymax] that may exceed the image
    -> (N, CROP, CROP) normalized crops, zero out of bounds.

    The source tap of output pixel u is floor(u * extent / CROP) + origin
    in float32, the division rounded as the JAX package's compiled
    crop rounds it (`core.numerics.div_const`), on the CPU and on the card.
    f32(1 / 288) lies above 1 / 288, so where u * extent / 288 is an exact
    integer k the tap is k; cv2's double arithmetic takes k - 1 there, and
    this crop follows the float32 arithmetic."""
    B, H, W = images.shape
    dev = images.device
    boxes = boxes.float()
    # std divides as a value, not a constant, in the JAX crop: a true division
    std_t = torch.full((), float(std), device=dev)
    u = torch.arange(CROP, dtype=torch.float32, device=dev)
    x0, y0 = boxes[:, 0:1], boxes[:, 1:2]
    sx = torch.floor(div_const(u * (boxes[:, 2:3] - x0), CROP)) + x0     # (N, CROP)
    sy = torch.floor(div_const(u * (boxes[:, 3:4] - y0), CROP)) + y0
    gx, gy = sx[:, None, :], sy[:, :, None]
    inside = (gx >= 0) & (gx < W) & (gy >= 0) & (gy < H)         # (N, CROP, CROP)
    xi = gx.clamp(0, W - 1).long()
    yi = gy.clamp(0, H - 1).long()
    crop = images[image_idx.long()[:, None, None], yi, xi]
    crop = torch.where(inside, crop, torch.zeros((), dtype=crop.dtype, device=dev))
    return (crop - mean) / std_t
