"""Yolo-Pose+, a single-shot anchor-based person and pose detector, and the
anchor-pose (prior map) output casting that it shares with PoP-Net. Per
anchor, of the `naf` channels:

    dx, dy        (sigmoid - 0.5) * 2     in (-1, 1)
    w, h          sigmoid * 2             in (0, 2)   (ratio to anchor)
    conf          sigmoid                 in (0, 1)
    x, y, z, ...  (sigmoid - 0.5) * 4     in (-2, 2)  (anchor-normalized)
"""

from __future__ import annotations

import torch
from torch import nn

from popnet_tpu_torch.models.layers import ConvBN, ResNet34Stem, init_flax_like, max_pool_2x2


def cast_prior_map(raw: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """Cast a raw (B, A*naf, H, W) head; naf is inferred from the channel
    count, so a head with visibility channels casts them too."""
    B, C, H, W = raw.shape
    s = torch.sigmoid(raw.reshape(B, num_anchors, C // num_anchors, H, W))
    out = torch.cat([(s[:, :, 0:2] - 0.5) * 2.0, s[:, :, 2:4] * 2.0, s[:, :, 4:5],
                     (s[:, :, 5:] - 0.5) * 4.0], dim=2)
    return out.reshape(B, C, H, W)


class YoloPoseNet(nn.Module):
    """ResNet-34 layer1-2 stem (stride 8, 128 ch) -> tower0-3 ConvBN @256 ->
    bare 3x3 conv `tower4` -> head0 -> 2x2 max pool (stride 16) -> head1
    @256, head2 @128 (ConvBNs without conv bias) -> bare 3x3 conv `head3`
    without bias to A * (5 + 3K) channels, cast per anchor. Returns the
    (B, A*(5+3K), H/16, W/16) prior map, NCHW."""

    def __init__(self, num_parts: int = 15,
                 anchors: tuple[tuple[float, float], ...] = ((6.0, 3.0), (12.0, 6.0))):
        super().__init__()
        self.num_anchors = len(anchors)
        self.stem = ResNet34Stem()
        in_ch = 128
        for i in range(4):
            self.add_module(f"tower{i}", ConvBN(in_ch, 256, 3))
            in_ch = 256
        self.tower4 = nn.Conv2d(256, 256, 3, padding=1)
        self.head0 = ConvBN(256, 256, 3, use_bias=False)
        self.head1 = ConvBN(256, 256, 3, use_bias=False)
        self.head2 = ConvBN(256, 128, 3, use_bias=False)
        self.head3 = nn.Conv2d(128, self.num_anchors * (5 + 3 * num_parts), 3, padding=1,
                               bias=False)

    def forward(self, x):
        x = self.stem(x)
        for i in range(4):
            x = getattr(self, f"tower{i}")(x)
        x = max_pool_2x2(self.head0(self.tower4(x)))
        x = self.head3(self.head2(self.head1(x)))
        return cast_prior_map(x, self.num_anchors)

    def init_seeded(self, seed: int) -> "YoloPoseNet":
        """Initialise from a generator seeded with `seed`, with the Flax
        initialisers' distributions (`layers.init_flax_like`)."""
        return init_flax_like(self, seed)
