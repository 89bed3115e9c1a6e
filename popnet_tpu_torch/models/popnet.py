"""PoP-Net: dense heat / z / 2D-align heads plus an anchor-pose prior subnet.

- stem: ResPreprocessStem (stride 8, 128 ch), shared by all heads;
- prior subnet: 3 x ConvBN 256 on the stem -> 2x2 max pool (stride 16) ->
  ConvBN 256, ConvBN 128 -> 3x3 conv without bias to A * (5 + 3K) channels
  (A * (5 + 4K) with `pred_vis`: a visibility per joint too), cast per
  anchor (`cast_prior_map`);
- per stage: heat (no BatchNorm) -> K+1, z -> K, align -> 2K, all with a
  1x1 output conv; stage-2 input = cat(heat, z, align, stem) on channels;
- head casting: heat sigmoid, z and align (sigmoid - 0.5) * 4.

Returns ((heat, z, align, prior), saved) with saved = [heat1, z1, align1,
heat2, z2, align2, prior], like the Flax model. Tensors are NCHW.

`PopNetRGB` is the RGB variant that MPII trains: a 3-channel stem, the
same prior subnet with A * (5 + 3K) channels (box, confidence, K x, K y,
K visibilities), and heat and align heads only (no z): saved = [heat1,
align1, heat2, align2, prior], stage-2 input cat(heat, align, stem).
"""

from __future__ import annotations

import torch
from torch import nn

from popnet_tpu_torch.models.layers import (ConvBN, CPMBranch, ResPreprocessStem,
                                            init_flax_like, max_pool_2x2)
from popnet_tpu_torch.models.yolo_posenet import cast_prior_map

_STAGE1 = {"heat": ((128, 3), (128, 3), (128, 3), (512, 1)),
           "z": ((64, 3), (32, 3), (32, 1)),
           "align": ((256, 3), (256, 3), (256, 3), (128, 1))}
_STAGE2 = {"heat": ((128, 3),) * 5 + ((128, 1),),
           "z": ((128, 3), (64, 3), (32, 3), (32, 1)),
           "align": ((128, 3), (256, 3), (256, 3), (256, 3), (128, 1))}


def _prior_subnet(model: nn.Module, stem_ch: int, n_out: int) -> None:
    """The prior subnet's modules on `model`, Flax-named."""
    in_ch = stem_ch
    for i in range(3):
        model.add_module(f"prior_tower{i}", ConvBN(in_ch, 256, 3))
        in_ch = 256
    model.prior_head0 = ConvBN(256, 256, 3)
    model.prior_head1 = ConvBN(256, 128, 3)
    model.prior_out = nn.Conv2d(128, n_out, 3, padding=1, bias=False)


def _prior(model: nn.Module, stem: torch.Tensor) -> torch.Tensor:
    p = stem
    for i in range(3):
        p = getattr(model, f"prior_tower{i}")(p)
    p = model.prior_head1(model.prior_head0(max_pool_2x2(p)))
    return cast_prior_map(model.prior_out(p), model.num_anchors)


class PopNet(nn.Module):
    def __init__(self, num_parts: int = 15, num_stages: int = 2,
                 anchors: tuple[tuple[float, float], ...] = ((6.0, 3.0), (12.0, 6.0)),
                 pred_vis: bool = False):
        super().__init__()
        self.num_stages = num_stages
        self.num_anchors = len(anchors)
        self.stem = ResPreprocessStem()
        stem_ch = 128
        n_joint_feats = 4 if pred_vis else 3
        _prior_subnet(self, stem_ch, self.num_anchors * (5 + n_joint_feats * num_parts))
        outs = {"heat": num_parts + 1, "z": num_parts, "align": 2 * num_parts}
        for i in range(1, num_stages + 1):
            in_ch = stem_ch if i == 1 else stem_ch + sum(outs.values())
            for name, spec in (_STAGE1 if i == 1 else _STAGE2).items():
                self.add_module(f"stage{i}_{name}", CPMBranch(
                    in_ch, spec, out_features=outs[name], out_kernel=1,
                    norm=name != "heat"))

    def forward(self, x):
        stem = self.stem(x)
        prior = _prior(self, stem)

        saved = []
        inp = stem
        heat = z = align = None
        for i in range(1, self.num_stages + 1):
            heat = torch.sigmoid(getattr(self, f"stage{i}_heat")(inp))
            z = (torch.sigmoid(getattr(self, f"stage{i}_z")(inp)) - 0.5) * 4.0
            align = (torch.sigmoid(getattr(self, f"stage{i}_align")(inp)) - 0.5) * 4.0
            saved += [heat, z, align]
            inp = torch.cat([heat, z, align, stem], dim=1)
        saved.append(prior)
        return (heat, z, align, prior), saved

    def init_seeded(self, seed: int) -> "PopNet":
        """Initialise from a generator seeded with `seed`, with the Flax
        initialisers' distributions (`layers.init_flax_like`)."""
        return init_flax_like(self, seed)


class PopNetRGB(nn.Module):
    """The RGB PoP-Net (see the module docstring); MPII's 16 parts by
    default."""

    def __init__(self, num_parts: int = 16, num_stages: int = 2,
                 anchors: tuple[tuple[float, float], ...] = ((6.0, 3.0), (12.0, 6.0))):
        super().__init__()
        self.num_stages = num_stages
        self.num_anchors = len(anchors)
        self.stem = ResPreprocessStem(in_ch=3)
        stem_ch = 128
        _prior_subnet(self, stem_ch, self.num_anchors * (5 + 3 * num_parts))
        outs = {"heat": num_parts + 1, "align": 2 * num_parts}
        for i in range(1, num_stages + 1):
            in_ch = stem_ch if i == 1 else stem_ch + sum(outs.values())
            for name in ("heat", "align"):
                spec = (_STAGE1 if i == 1 else _STAGE2)[name]
                self.add_module(f"stage{i}_{name}", CPMBranch(
                    in_ch, spec, out_features=outs[name], out_kernel=1, norm=name != "heat"))

    def forward(self, x):
        stem = self.stem(x)
        prior = _prior(self, stem)
        saved = []
        inp = stem
        heat = align = None
        for i in range(1, self.num_stages + 1):
            heat = torch.sigmoid(getattr(self, f"stage{i}_heat")(inp))
            align = (torch.sigmoid(getattr(self, f"stage{i}_align")(inp)) - 0.5) * 4.0
            saved += [heat, align]
            inp = torch.cat([heat, align, stem], dim=1)
        saved.append(prior)
        return (heat, align, prior), saved

    def init_seeded(self, seed: int) -> "PopNetRGB":
        """Initialise from a generator seeded with `seed`, with the Flax
        initialisers' distributions (`layers.init_flax_like`)."""
        return init_flax_like(self, seed)
