"""The anchor-pose (prior map) output casting shared by PoP-Net and
Yolo-Pose+. Per anchor, of the `naf` channels:

    dx, dy        (sigmoid - 0.5) * 2     in (-1, 1)
    w, h          sigmoid * 2             in (0, 2)   (ratio to anchor)
    conf          sigmoid                 in (0, 1)
    x, y, z, ...  (sigmoid - 0.5) * 4     in (-2, 2)  (anchor-normalized)
"""

from __future__ import annotations

import torch


def cast_prior_map(raw: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """Cast a raw (B, A*naf, H, W) head; naf is inferred from the channel
    count, so a head with visibility channels casts them too."""
    B, C, H, W = raw.shape
    s = torch.sigmoid(raw.reshape(B, num_anchors, C // num_anchors, H, W))
    out = torch.cat([(s[:, :, 0:2] - 0.5) * 2.0, s[:, :, 2:4] * 2.0, s[:, :, 4:5],
                     (s[:, :, 5:] - 0.5) * 4.0], dim=2)
    return out.reshape(B, C, H, W)
