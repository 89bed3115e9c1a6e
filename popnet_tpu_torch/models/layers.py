"""Building blocks of the depth-pose CNN (NCHW `nn.Module`s).

Submodule attribute names mirror the Flax auto-names (`Conv_0`,
`BatchNorm_0`, `ConvBN_1`, `BasicBlock_2`, ...), so a '/'-joined Flax
variable path maps onto a state-dict key by name
(`interop/from_jax.py`). BatchNorm eps is 1e-5 in both frameworks, and in
train mode `BatchNorm` keeps Flax's statistics (`BatchNorm`'s docstring).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-5, the same state-dict keys) with Flax's
    train-mode semantics: the batch is normalized by its own mean and
    biased variance, and the running statistics move as Flax's do,
    `ra = 0.99 * ra + 0.01 * batch`, the variance taken as
    max(E[x^2] - E[x]^2, 0) in float32 at least. (`nn.BatchNorm2d` weighs the old
    value by 0.9 and moves the running variance by the unbiased one.)
    In eval mode it is `nn.BatchNorm2d` on the running statistics.

    `group` (a process group, None by default) makes the batch one logical
    tensor across its ranks, as a sharded array is in JAX: the sums of x
    and x^2 and the count are all-reduced over the group, with autograd,
    and the layer normalizes by those statistics and moves its running
    ones by them (`parallel.mesh.DataParallel.attach` sets it). A group of
    one rank reduces nothing, and the layer computes as without one."""

    MOMENTUM = 0.99     # Flax's: the weight of the old running value

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)
        self.group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None and torch.distributed.get_world_size(self.group) > 1:
            return self._group_forward(x)
        with torch.no_grad():
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _group_forward(self, x):
        from popnet_tpu_torch.parallel.mesh import all_reduce_sum

        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        total = all_reduce_sum(local, self.group)
        count = total[2 * c]
        mean = total[:c] / count
        var = (total[c:2 * c] / count - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def init_flax_like(model: nn.Module, seed: int, kaiming_prefix: str = "stem.") -> nn.Module:
    """Initialise `model` from a `torch.Generator` seeded with `seed`, with
    the distributions of the Flax depth models' initialisers: the residual
    stem's convs (names under `kaiming_prefix`) He-normal, truncated at two
    standard deviations, fan-in (Flax's `kaiming_normal`); every other conv
    normal(0.01); zero biases; unit BatchNorm with fresh statistics. The
    values differ from a Flax init with any PRNG key."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Conv2d):
                if name.startswith(kaiming_prefix):
                    fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=g)
                else:
                    m.weight.normal_(0.0, 0.01, generator=g)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
    return model


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
            self.BatchNorm_0 = BatchNorm(features)

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
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        self.project = stride != 1 or in_ch != features
        if self.project:
            self.Conv_2 = nn.Conv2d(in_ch, features, 1, stride=stride, bias=False)
            self.BatchNorm_2 = BatchNorm(features)

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
        self.BatchNorm_0 = BatchNorm(64)
        self.BasicBlock_0 = BasicBlock(64, 64)
        self.BasicBlock_1 = BasicBlock(64, 64)
        self.BasicBlock_2 = BasicBlock(64, 128)
        self.Conv_1 = nn.Conv2d(128, 128, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(128)

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
        self.BatchNorm_0 = BatchNorm(64)
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
    them. A folded BatchNorm that was fused (`ops.fold_bn.fuse_folded`) is
    an `nn.Identity` by then: its bias is the conv's and is added in the
    conv's type. An `ops.quant.Int8Conv2d` is never cast: its weight,
    scales and bias stay float32 and its epilogue runs in float32."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return module
