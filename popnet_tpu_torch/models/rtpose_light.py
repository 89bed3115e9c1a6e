"""RTPoseLight: the 2D-only light CPM (PAF and heatmap branches), the
ablation baseline of the JAX package's `popnet_tpu/models/rtpose_light.py`.

- stem: ResPreprocessStem (stride 8, 128 ch) over `in_ch` input channels;
- per stage, conv + ReLU without BatchNorm: stage 1 [128x3 conv3, 512
  conv1], later stages [128x5 conv7, 128 conv1], each branch ending in a
  bare 1x1 conv to 2L (PAF) and K+1 (heat) channels; stage-2 input =
  cat(paf, heat, stem). No output casting.

Returns ((paf, heat), saved) with saved = [paf1, heat1, paf2, heat2], like
the Flax model. Tensors are NCHW; attribute names are the Flax names.
A library model: no command line trains it.
"""

from __future__ import annotations

import torch
from torch import nn

from popnet_tpu_torch.models.layers import CPMBranch, ResPreprocessStem, init_flax_like

_STAGE1 = ((128, 3), (128, 3), (128, 3), (512, 1))
_STAGE2 = ((128, 7),) * 5 + ((128, 1),)


class RTPoseLight(nn.Module):
    def __init__(self, num_parts: int = 15, num_limbs: int = 14, num_stages: int = 2,
                 in_ch: int = 1):
        super().__init__()
        self.num_stages = num_stages
        self.stem = ResPreprocessStem(in_ch=in_ch)
        stem_ch = 128
        for i in range(1, num_stages + 1):
            in_c = stem_ch if i == 1 else stem_ch + 2 * num_limbs + num_parts + 1
            spec = _STAGE1 if i == 1 else _STAGE2
            self.add_module(f"stage{i}_paf", CPMBranch(in_c, spec, 2 * num_limbs, 1, norm=False,
                                                       act="relu"))
            self.add_module(f"stage{i}_heat", CPMBranch(in_c, spec, num_parts + 1, 1,
                                                        norm=False, act="relu"))

    def forward(self, x):
        stem = self.stem(x)
        saved = []
        inp = stem
        paf = heat = None
        for i in range(1, self.num_stages + 1):
            paf = getattr(self, f"stage{i}_paf")(inp)
            heat = getattr(self, f"stage{i}_heat")(inp)
            saved += [paf, heat]
            inp = torch.cat([paf, heat, stem], dim=1)
        return (paf, heat), saved

    def init_seeded(self, seed: int) -> "RTPoseLight":
        """Initialise from a generator seeded with `seed`, with the Flax
        initialisers' distributions (`layers.init_flax_like`)."""
        return init_flax_like(self, seed)
