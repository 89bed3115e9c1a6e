"""Building blocks of the depth-pose CNN (NCHW `nn.Module`s).

Submodule attribute names mirror the Flax auto-names (`Conv_0`,
`BatchNorm_0`, `ConvBN_1`, `BasicBlock_2`, ...), so a '/'-joined Flax
variable path maps onto a state-dict key by name
(`interop/from_jax.py`). BatchNorm eps is 1e-5 in both frameworks.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch.nn.functional as F
from torch import nn


def _same_pad(kernel: int) -> int:
    """Flax "SAME" at stride 1 for an odd kernel; 1x1 convs are "VALID"."""
    return kernel // 2


class ConvBN(nn.Module):
    """conv -> [BatchNorm] -> activation, the CPM layer: LeakyReLU(0.1) by
    default, ReLU with `act="relu"`. Open-Pose+ normalizes every
    layer; PoP-Net's heat branches (and RTPoseAlign3D's PAF branches) pass
    `norm=False` and carry no BatchNorm_0; RTPoseVGG's branches are
    `act="relu", norm=False`."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, norm: bool = True,
                 use_bias: bool = True, act: str = "leaky_relu"):
        super().__init__()
        if act not in ("leaky_relu", "relu"):
            raise ValueError(f"unknown act {act!r}")
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel, padding=_same_pad(kernel),
                                bias=use_bias)
        self.norm = norm
        self.act = act
        if norm:
            self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        x = self.Conv_0(x)
        if self.norm:
            x = self.BatchNorm_0(x)
        return F.leaky_relu(x, 0.1) if self.act == "leaky_relu" else F.relu(x)


class CPMBranch(nn.Module):
    """N x ConvBN, then a bare conv with `out_features` channels."""

    def __init__(self, in_ch: int, spec: Sequence[tuple[int, int]],
                 out_features: int, out_kernel: int = 1, norm: bool = True,
                 act: str = "leaky_relu"):
        super().__init__()
        for n, (feats, k) in enumerate(spec):
            self.add_module(f"ConvBN_{n}", ConvBN(in_ch, feats, k, norm=norm, act=act))
            in_ch = feats
        self.n_hidden = len(spec)
        self.Conv_0 = nn.Conv2d(in_ch, out_features, out_kernel,
                                padding=_same_pad(out_kernel))

    def forward(self, x):
        for n in range(self.n_hidden):
            x = getattr(self, f"ConvBN_{n}")(x)
        return self.Conv_0(x)


class BasicBlock(nn.Module):
    """torchvision-style residual block; no conv has a bias. The 1x1
    projection exists only when the stride or the channel count changes;
    the stride-2 3x3 conv pads (1, 1), torch-symmetric."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm2d(features, eps=1e-5)
        self.project = stride != 1 or in_ch != features
        if self.project:
            self.Conv_2 = nn.Conv2d(in_ch, features, 1, stride=stride, bias=False)
            self.BatchNorm_2 = nn.BatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        identity = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + identity)


def avg_pool_3x3_s2(x):
    """3x3 stride-2 average pool, pad 1, zero padding counted."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def max_pool_3x3_s2(x):
    """3x3 stride-2 max pool, pad 1 (padding never wins the max)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def max_pool_2x2(x):
    """2x2 stride-2 max pool, no padding."""
    return F.max_pool2d(x, 2, stride=2)


class ResPreprocessStem(nn.Module):
    """7x7/2 conv -> BasicBlock x2 @64 -> avgpool/2 -> BasicBlock @128 ->
    1x1 conv -> avgpool/2: stride 8, 128 channels. The stride-2 pads are
    explicit and symmetric (TF-SAME would shift the grid)."""

    def __init__(self, in_ch: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(64, eps=1e-5)
        self.BasicBlock_0 = BasicBlock(64, 64)
        self.BasicBlock_1 = BasicBlock(64, 64)
        self.BasicBlock_2 = BasicBlock(64, 128)
        self.Conv_1 = nn.Conv2d(128, 128, 1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm2d(128, eps=1e-5)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = self.BasicBlock_1(self.BasicBlock_0(x))
        x = self.BasicBlock_2(avg_pool_3x3_s2(x))
        x = F.relu(self.BatchNorm_1(self.Conv_1(x)))
        return avg_pool_3x3_s2(x)


class ResNet34Stem(nn.Module):
    """ResNet-34 layer1-2: 7x7/2 conv -> 3x3/2 max pool -> BasicBlock x3
    @64 -> BasicBlock/2 and x3 @128: stride 8, 128 channels."""

    def __init__(self, in_ch: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(64, eps=1e-5)
        chans = [(64, 64, 1)] * 3 + [(64, 128, 2)] + [(128, 128, 1)] * 3
        for n, (cin, cout, stride) in enumerate(chans):
            self.add_module(f"BasicBlock_{n}", BasicBlock(cin, cout, stride))
        self.n_blocks = len(chans)

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.BatchNorm_0(self.Conv_0(x))))
        for n in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{n}")(x)
        return x


def keep_batchnorm_float32(module: nn.Module) -> nn.Module:
    """After `module.to(bfloat16)`: BatchNorm parameters and statistics go
    back to float32 while activations stay in the low type, as Flax keeps
    them."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return module
