"""Dense-head twin of PoP-Net: PAF + heatmap + depth + 2D-align branches.

Raw conv outputs (no casting in forward); the PAF and heat branches carry
no BatchNorm; stage 2's PAF branch uses 7x7 convs for limb-scale context;
stage-2 input = cat(paf, heat, z, align, stem) on channels.

Returns ((paf, heat, z, align), saved) with saved the four outputs of each
stage in that order, like the Flax model. Tensors are NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from popnet_tpu_torch.models.layers import CPMBranch, ResPreprocessStem

_STAGE1 = {"paf": ((128, 3), (128, 3), (128, 3), (512, 1)),
           "heat": ((128, 3), (128, 3), (128, 3), (512, 1)),
           "z": ((64, 3), (32, 3), (32, 1)),
           "align": ((256, 3), (256, 3), (256, 3), (128, 1))}
_STAGE2 = {"paf": ((128, 7),) * 5 + ((128, 1),),
           "heat": ((128, 3),) * 5 + ((128, 1),),
           "z": ((128, 3), (64, 3), (32, 3), (32, 1)),
           "align": ((128, 3), (256, 3), (256, 3), (256, 3), (128, 1))}


class RTPoseAlign3D(nn.Module):
    def __init__(self, num_parts: int = 15, num_limbs: int = 14, num_stages: int = 2):
        super().__init__()
        self.num_stages = num_stages
        self.stem = ResPreprocessStem()
        stem_ch = 128
        outs = {"paf": 2 * num_limbs, "heat": num_parts + 1, "z": num_parts,
                "align": 2 * num_parts}
        for i in range(1, num_stages + 1):
            in_ch = stem_ch if i == 1 else stem_ch + sum(outs.values())
            for name, spec in (_STAGE1 if i == 1 else _STAGE2).items():
                self.add_module(f"stage{i}_{name}", CPMBranch(
                    in_ch, spec, out_features=outs[name], out_kernel=1,
                    norm=name in ("z", "align")))

    def forward(self, x):
        stem = self.stem(x)
        saved = []
        inp = stem
        outs = None
        for i in range(1, self.num_stages + 1):
            outs = tuple(getattr(self, f"stage{i}_{name}")(inp)
                         for name in ("paf", "heat", "z", "align"))
            saved += list(outs)
            inp = torch.cat([*outs, stem], dim=1)
        return outs, saved
