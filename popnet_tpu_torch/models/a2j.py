"""A2J: anchor-to-joint regression on single-person depth crops.

A ResNet-50 trunk on depth (1 channel broadcast to 3) whose layer4 runs at
stride 1 with dilation 2, so the classification head (on layer3, 1024 ch)
and the regression and depth heads (on layer4, 2048 ch) share the stride-16
grid. Each head is 4 x (3x3 conv + BN + ReLU @256) and a 3x3 output conv.

Anchor and keypoint coordinates are in (h, w) = (y, x) order, and the
anchor list is flattened w-major: (W, H, A).

Outputs:
    classification (B, W*H*A, K)      anchor-vote logits
    regression     (B, W*H*A, K, 2)   in-plane (y, x) offsets from the anchor
    depth          (B, W*H*A, K)      per-anchor joint depth

Submodule names are the Flax auto-names (`backbone/DilatedBottleneck_15`,
`classification/Conv_4`, ...), so Flax variables load by name
(`interop/from_jax.py`). Every BatchNorm is `models.layers.BatchNorm`, so
in train mode the running statistics move as Flax's (momentum 0.99, biased
variance).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from popnet_tpu_torch.models.layers import BatchNorm, max_pool_3x3_s2


class DilatedBottleneck(nn.Module):
    """ResNet Bottleneck (1x1 -> 3x3 -> 1x1 x4), the 3x3 conv optionally
    dilated and padded by its dilation (torch-symmetric at stride 2). The
    1x1 projection exists when the stride or the channel count changes."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        out = features * 4
        self.Conv_0 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, stride=stride, padding=dilation,
                                dilation=dilation, bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = nn.Conv2d(features, out, 1, bias=False)
        self.BatchNorm_2 = BatchNorm(out)
        self.project = stride != 1 or in_ch != out
        if self.project:
            self.Conv_3 = nn.Conv2d(in_ch, out, 1, stride=stride, bias=False)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        identity = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + identity)


# (features, stride, dilation) of each bottleneck: layer1-3, then layer4
# at stride 1 (its first block projects 1024 -> 2048, the rest dilate by 2)
_BLOCKS = ([(64, 1, 1)] * 3 + [(128, 2, 1)] + [(128, 1, 1)] * 3 + [(256, 2, 1)]
           + [(256, 1, 1)] * 5 + [(512, 1, 1)] + [(512, 1, 2)] * 2)
_LAYER3_END = 13    # blocks 0-12 are layer1-3


class ResNet50DepthBackbone(nn.Module):
    """ResNet-50 trunk returning (layer3, layer4) features, both stride 16."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        in_ch = 64
        for n, (feats, stride, dilation) in enumerate(_BLOCKS):
            self.add_module(f"DilatedBottleneck_{n}",
                            DilatedBottleneck(in_ch, feats, stride, dilation))
            in_ch = feats * 4

    def forward(self, x):
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        x = max_pool_3x3_s2(F.relu(self.BatchNorm_0(self.Conv_0(x))))
        x3 = None
        for n in range(len(_BLOCKS)):
            if n == _LAYER3_END:
                x3 = x
            x = getattr(self, f"DilatedBottleneck_{n}")(x)
        return x3, x


class A2JHead(nn.Module):
    """4 x (3x3 conv + BN + ReLU @256) -> 3x3 output conv."""

    def __init__(self, in_ch: int, out_channels: int, feature_size: int = 256):
        super().__init__()
        for n in range(4):
            self.add_module(f"Conv_{n}", nn.Conv2d(in_ch, feature_size, 3, padding=1))
            self.add_module(f"BatchNorm_{n}", BatchNorm(feature_size))
            in_ch = feature_size
        self.Conv_4 = nn.Conv2d(feature_size, out_channels, 3, padding=1)

    def forward(self, x):
        for n in range(4):
            x = F.relu(getattr(self, f"BatchNorm_{n}")(getattr(self, f"Conv_{n}")(x)))
        return self.Conv_4(x)


def _flatten_wha(x: torch.Tensor, num_anchors: int, trailing: tuple[int, ...]):
    """(B, A*prod(trailing), H, W) NCHW -> (B, W*H*A, *trailing), w-major."""
    b, _, h, w = x.shape
    x = x.permute(0, 3, 2, 1)                      # (B, W, H, C)
    return x.reshape(b, w * h * num_anchors, *trailing)


class A2J(nn.Module):
    """A2J on (B, 1, S, S) normalized depth crops; returns (cls, reg, dep).

    depth_prior: the initial bias of the depth head's output conv (the
    reference zeroes it; a dataset depth prior such as 3.0 m starts the
    anchor vote at the prior). Loaded weights overwrite it."""

    def __init__(self, num_joints: int = 15, num_anchors: int = 16, depth_prior: float = 0.0):
        super().__init__()
        self.num_joints, self.num_anchors = num_joints, num_anchors
        self.depth_prior = depth_prior
        A, K = num_anchors, num_joints
        self.backbone = ResNet50DepthBackbone()
        self.classification = A2JHead(1024, A * K)
        self.regression = A2JHead(2048, A * K * 2)
        self.depth = A2JHead(2048, A * K)

    def forward(self, x):
        x3, x4 = self.backbone(x)
        A, K = self.num_anchors, self.num_joints
        return (_flatten_wha(self.classification(x3), A, (K,)),
                _flatten_wha(self.regression(x4), A, (K, 2)),
                _flatten_wha(self.depth(x4), A, (K,)))

    def init_seeded(self, seed: int) -> A2J:
        """Initialise every parameter from a `torch.Generator` seeded with
        `seed`, with the Flax initialisers' distributions: He-normal
        (truncated, fan-in) convs in the trunk, Glorot-normal (truncated,
        fan-average) convs in the heads, zero conv biases but the depth
        head's output (`depth_prior`), unit BatchNorm. The values differ
        from a Flax init with any PRNG key."""
        g = torch.Generator().manual_seed(seed)

        def trunc_normal(w, var):
            std = math.sqrt(var) / 0.87962566103423978     # the unit truncated normal's std
            with torch.no_grad():
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)

        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d):
                rf = m.kernel_size[0] * m.kernel_size[1]
                fan_in, fan_out = rf * m.in_channels, rf * m.out_channels
                if name.startswith("backbone"):
                    trunc_normal(m.weight, 2.0 / fan_in)
                else:
                    trunc_normal(m.weight, 2.0 / (fan_in + fan_out))
                    nn.init.constant_(m.bias, self.depth_prior if name == "depth.Conv_4" else 0.0)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
        return self


def generate_anchors() -> np.ndarray:
    """(16, 2) in-cell anchor offsets in (h, w) order: the 4x4 grid of
    {2, 6, 10, 14}, h-major."""
    p = np.array([2.0, 6.0, 10.0, 14.0])
    return np.stack(np.meshgrid(p, p, indexing="ij"), axis=-1).reshape(-1, 2)


def shift_anchors(shape, stride, anchors) -> np.ndarray:
    """Dense (W*H*A, 2) anchor positions for a (H, W) grid of `stride`,
    w-major to match the heads' flattening."""
    shift_h = np.arange(0, shape[0]) * stride
    shift_w = np.arange(0, shape[1]) * stride
    hh, ww = np.meshgrid(shift_h, shift_w)  # (n_w, n_h)
    shifts = np.stack([hh.ravel(), ww.ravel()], axis=1)
    all_anchors = anchors.reshape(1, -1, 2) + shifts.reshape(-1, 1, 2)
    return all_anchors.reshape(-1, 2)
