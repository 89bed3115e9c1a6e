"""A2J anchor-vote decoding: softmax-weighted anchor aggregation, batched."""

from __future__ import annotations

import torch


def a2j_post_process(heads, all_anchors: torch.Tensor) -> torch.Tensor:
    """(cls (B, N, K), reg (B, N, K, 2), depth (B, N, K)) and anchors (N, 2)
    in (h, w) order -> keypoints (B, K, 3) as (y, x, z). The weights are a
    softmax over the N anchors."""
    cls, reg, dep = heads
    w = torch.softmax(cls, dim=1)
    pos = all_anchors[None, :, None, :] + reg                 # (B, N, K, 2)
    yx = (w[..., None] * pos).sum(dim=1)                      # (B, K, 2)
    z = (w * dep).sum(dim=1)                                  # (B, K)
    return torch.cat([yx, z[..., None]], dim=-1)
