"""RTPoseVGG: the 6-stage CPM of the COCO RGB path (NCHW `nn.Module`s).

- trunk, stride 8, 128 channels: `vgg19` (conv1_1 ... conv4_2 with three
  2x2 max pools, then conv4_3_CPM @256 and conv4_4_CPM @128, every conv
  3x3 + ReLU, no BatchNorm) or `mobilenet` (conv+BN+ReLU @32 at stride 2,
  four depthwise-separable blocks 64/s1, 128/s2, 128/s1, 256/s2, then the
  two CPM convs);
- 6 stages x 2 branches (PAF 2L = 38 and heat K+1 = 19 channels), conv +
  ReLU without BatchNorm: stage 1 [128x3 conv3, 512 conv1], stages 2-6
  [128x5 conv7, 128 conv1] over cat(paf, heat, trunk) = 185 channels; each
  branch ends in a bare 1x1 conv.

Returns ((paf, heat), saved) with saved = [paf1, heat1, ..., paf6, heat6],
like the Flax model (`popnet_tpu/models/rtpose_vgg.py`). Attribute names
are the Flax names (`trunk/conv1_1`, `trunk/Conv_3`, `trunk/BatchNorm_3`,
`stage2_paf/ConvBN_0/Conv_0`, ...), so Flax variables load by name
(`interop/from_jax.py`); a depthwise conv's HWIO (3, 3, 1, c) kernel lands
as the (c, 1, 3, 3) weight of a conv with `groups=c`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from popnet_tpu_torch.models.layers import BatchNorm, CPMBranch, max_pool_2x2

_VGG19 = (("conv1_1", 64), ("conv1_2", 64), "pool", ("conv2_1", 128), ("conv2_2", 128), "pool",
          ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), "pool",
          ("conv4_1", 512), ("conv4_2", 512), ("conv4_3_CPM", 256), ("conv4_4_CPM", 128))


class VGG19Trunk(nn.Module):
    """VGG19 conv1_1..conv4_2 and the two CPM convs: 3x3 "SAME" convs with
    biases, each followed by ReLU; 2x2 max pools."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        for item in _VGG19:
            if item != "pool":
                name, feats = item
                self.add_module(name, nn.Conv2d(in_ch, feats, 3, padding=1))
                in_ch = feats

    def forward(self, x):
        for item in _VGG19:
            x = max_pool_2x2(x) if item == "pool" else F.relu(getattr(self, item[0])(x))
        return x


# (output channels, stride) of the depthwise-separable blocks
_MOBILENET_DW = ((64, 1), (128, 2), (128, 1), (256, 2))


class MobileNetTrunk(nn.Module):
    """conv_bn(32, s2), four MobileNet-v1 conv_dw blocks (depthwise 3x3 + BN +
    ReLU, pointwise 1x1 + BN + ReLU), then conv4_3_CPM @256 and conv4_4_CPM
    @128 (3x3 with biases, ReLU). The stride-2 convs pad (1, 1),
    torch-symmetric; no conv before the CPM ones has a bias. The BatchNorms
    are `layers.BatchNorm`: in train mode their running statistics move as
    Flax's do."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, 32, 3, stride=2, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(32)
        c = 32
        for i, (feats, stride) in enumerate(_MOBILENET_DW):
            n = 2 * i + 1
            self.add_module(f"Conv_{n}", nn.Conv2d(c, c, 3, stride=stride, padding=1,
                                                   groups=c, bias=False))
            self.add_module(f"BatchNorm_{n}", BatchNorm(c))
            self.add_module(f"Conv_{n + 1}", nn.Conv2d(c, feats, 1, bias=False))
            self.add_module(f"BatchNorm_{n + 1}", BatchNorm(feats))
            c = feats
        self.n_convs = 2 * len(_MOBILENET_DW) + 1
        self.conv4_3_CPM = nn.Conv2d(c, 256, 3, padding=1)
        self.conv4_4_CPM = nn.Conv2d(256, 128, 3, padding=1)

    def forward(self, x):
        for n in range(self.n_convs):
            x = F.relu(getattr(self, f"BatchNorm_{n}")(getattr(self, f"Conv_{n}")(x)))
        x = F.relu(self.conv4_3_CPM(x))
        return F.relu(self.conv4_4_CPM(x))


class RTPoseVGG(nn.Module):
    def __init__(self, num_parts: int = 18, num_limbs: int = 19, num_stages: int = 6,
                 trunk: str = "vgg19"):
        super().__init__()
        trunks = {"vgg19": VGG19Trunk, "mobilenet": MobileNetTrunk}
        if trunk not in trunks:
            raise ValueError(f"unknown trunk {trunk!r}")
        self.num_stages = num_stages
        self.trunk = trunks[trunk]()
        feat_ch = 128
        for i in range(1, num_stages + 1):
            if i == 1:
                in_ch, spec = feat_ch, ((128, 3), (128, 3), (128, 3), (512, 1))
            else:
                in_ch, spec = feat_ch + 2 * num_limbs + num_parts + 1, ((128, 7),) * 5 + ((128, 1),)
            self.add_module(f"stage{i}_paf", CPMBranch(in_ch, spec, 2 * num_limbs, 1,
                                                       norm=False, act="relu"))
            self.add_module(f"stage{i}_heat", CPMBranch(in_ch, spec, num_parts + 1, 1,
                                                        norm=False, act="relu"))

    def forward(self, x):
        feat = self.trunk(x)
        saved = []
        inp = feat
        paf = heat = None
        for i in range(1, self.num_stages + 1):
            paf = getattr(self, f"stage{i}_paf")(inp)
            heat = getattr(self, f"stage{i}_heat")(inp)
            saved += [paf, heat]
            inp = torch.cat([paf, heat, feat], dim=1)
        return (paf, heat), saved

    def init_seeded(self, seed: int) -> RTPoseVGG:
        """Initialise every parameter from a `torch.Generator` seeded with
        `seed`, with the Flax initialisers' distributions: normal(0.01)
        kernels for the VGG19 trunk and every branch conv; LeCun-normal
        (truncated, fan-in) kernels for the MobileNet trunk; zero biases;
        unit BatchNorm. The values differ from a Flax init with any PRNG
        key."""
        g = torch.Generator().manual_seed(seed)
        mobilenet = isinstance(self.trunk, MobileNetTrunk)
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, nn.Conv2d):
                    if mobilenet and name.startswith("trunk."):
                        fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
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
        return self
