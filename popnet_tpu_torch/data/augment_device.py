"""The evaluation's share of the JAX package's on-device augmentation
(`popnet_tpu/data/augment_device.py`): the inverse map of a plain resize,
the only augmentation the evaluation draws (`resize_inv_mat`, NumPy,
composed as the JAX package's `sample_augment_params` composes it), and the
batched inverse-affine bilinear warp (`warp_depth_batch`, torch, on the
device the frames lie on). Training's random rotation, render scale, crop
and flip wait for the training dataset.

The JAX package compiles the warp with XLA, whose CPU compiler contracts a
multiply and the add after it into one fused multiply-add; the warp here
rounds its sum of four weighted taps the same way (`core.numerics.fma_f32`),
on the CPU and on the card alike, so its images equal the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.numerics import fma_f32


def resize_inv_mat(h: int, w: int, out_h: int = 224, out_w: int = 224) -> np.ndarray:
    """(2, 3) float32 inverse map of resizing (h, w) to (out_h, out_w):
    output px -> source px with cv2.resize's half-pixel convention
    ((u + 0.5) * scale - 0.5)."""
    wr = float(out_w) / w
    hr = float(out_h) / h
    return np.array([[1 / wr, 0, 0.5 / wr - 0.5], [0, 1 / hr, 0.5 / hr - 0.5]], np.float32)


def warp_depth_batch(images: torch.Tensor, inv_mat: np.ndarray, out_h: int = 224,
                     out_w: int = 224) -> torch.Tensor:
    """Batched inverse-affine bilinear warp with zero fill: images (B, H, W)
    float32, inv_mat (2, 3) float32 output px -> source px, one map for the
    whole batch -> (B, out_h, out_w)."""
    B, H, W = images.shape
    dev = images.device
    img = images.reshape(B, H * W)
    (m00, m01, m02), (m10, m11, m12) = np.asarray(inv_mat, np.float32).tolist()
    vv, uu = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    # the source coordinates and the sum of the four weighted taps, each
    # multiply-add rounded as XLA's contraction rounds it
    sx = fma_f32(uu, m00, m01 * vv) + m02                                    # (out_h, out_w)
    sy = fma_f32(uu, m10, m11 * vv) + m12
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        flat = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        v = img[:, flat.reshape(-1)].reshape(B, out_h, out_w)
        return torch.where(inside, v, torch.zeros((), device=dev))

    gx, gy = 1 - fx, 1 - fy
    out = fma_f32(tap(x0, y0) * gx, gy, (tap(x0 + 1, y0) * fx) * gy)
    out = fma_f32(tap(x0, y0 + 1) * gx, fy, out)
    return fma_f32(tap(x0 + 1, y0 + 1) * fx, fy, out)
