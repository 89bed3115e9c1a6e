"""Open-Pose+: the light 2-stage CPM with PAF, heatmap and z branches.

- stem: ResPreprocessStem (stride 8, 128 ch);
- per stage: paf [256x3 conv3, 128 conv1] -> 2L, heat [128x4 conv3] ->
  K+1 (conv3), z [128, 64x3 conv3] -> L+1 (conv3);
- stage-2 input = cat(stage-1 paf, heat, z, stem) on channels;
- head casting: paf and z (sigmoid - 0.5) * 4, heat sigmoid.

Returns ((paf, heat, z), saved) with saved = [paf1, heat1, z1, paf2, heat2,
z2] after casting, like the Flax model. Tensors are NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from popnet_tpu_torch.models.layers import CPMBranch, ResPreprocessStem, init_flax_like


class RTPoseLight3D(nn.Module):
    def __init__(self, num_parts: int = 15, num_limbs: int = 14, num_stages: int = 2):
        super().__init__()
        self.num_stages = num_stages
        self.stem = ResPreprocessStem()
        stem_ch = 128
        out_ch = 2 * num_limbs + (num_parts + 1) + (num_limbs + 1)
        for i in range(1, num_stages + 1):
            in_ch = stem_ch if i == 1 else stem_ch + out_ch
            self.add_module(f"stage{i}_paf", CPMBranch(
                in_ch, ((256, 3), (256, 3), (256, 3), (128, 1)),
                out_features=2 * num_limbs, out_kernel=1))
            self.add_module(f"stage{i}_heat", CPMBranch(
                in_ch, ((128, 3),) * 4, out_features=num_parts + 1, out_kernel=3))
            self.add_module(f"stage{i}_z", CPMBranch(
                in_ch, ((128, 3), (64, 3), (64, 3), (64, 3)),
                out_features=num_limbs + 1, out_kernel=3))

    def forward(self, x):
        stem = self.stem(x)
        saved = []
        inp = stem
        paf = heat = z = None
        for i in range(1, self.num_stages + 1):
            paf = (torch.sigmoid(getattr(self, f"stage{i}_paf")(inp)) - 0.5) * 4.0
            heat = torch.sigmoid(getattr(self, f"stage{i}_heat")(inp))
            z = (torch.sigmoid(getattr(self, f"stage{i}_z")(inp)) - 0.5) * 4.0
            saved += [paf, heat, z]
            inp = torch.cat([paf, heat, z, stem], dim=1)
        return (paf, heat, z), saved

    def init_seeded(self, seed: int) -> "RTPoseLight3D":
        """Initialise from a generator seeded with `seed`, with the Flax
        initialisers' distributions (`layers.init_flax_like`)."""
        return init_flax_like(self, seed)
