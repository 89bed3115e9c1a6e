"""Flip-averaged inference for heat maps and PAFs (the COCO evaluation
trick), driven by the skeleton tables.

The port's copy of `popnet_tpu/decode/flip_average.py`: average the maps
of the image with those of its horizontal mirror, brought back by flipping
the width axis, swapping left and right channels, and negating the PAF
x-components. Maps are (B, H, W, C).
"""

from __future__ import annotations

import numpy as np
import torch


def paf_swap_table(limbs, swap_indices) -> np.ndarray:
    """Channel permutation of a mirrored PAF stack: limb (a, b) takes the
    channels of the limb joining (swap[a], swap[b]), or its own where no
    limb does; channels are (x, y) interleaved."""
    limbs = [tuple(limb) for limb in limbs]
    swap = list(swap_indices)
    table = np.zeros(2 * len(limbs), dtype=np.int64)
    for l, (a, b) in enumerate(limbs):
        target = (swap[a], swap[b])
        m = limbs.index(target) if target in limbs else l
        table[2 * l] = 2 * m
        table[2 * l + 1] = 2 * m + 1
    return table


def unflip_maps(heat_f: torch.Tensor, paf_f: torch.Tensor, limbs, swap_indices):
    """Maps computed on a mirrored image -> (heat, paf) of the image: width
    flip, channel swaps, PAF x negated."""
    K = len(swap_indices)
    dev = heat_f.device
    heat_perm = torch.tensor(list(swap_indices) + list(range(K, heat_f.shape[-1])), device=dev)
    heat = heat_f.flip(2)[..., heat_perm]
    paf = paf_f.flip(2)[..., torch.as_tensor(paf_swap_table(limbs, swap_indices), device=dev)]
    sign = torch.ones(2 * len(limbs), dtype=torch.float32, device=dev)
    sign[0::2] = -1.0                   # x components change direction under mirroring
    return heat, paf * sign


def flip_average_infer(infer, images: torch.Tensor, limbs, swap_indices):
    """Run `infer(images) -> (paf, heat, ...)` on the (B, H, W, C) images and
    on their mirror; return the flip-averaged (paf, heat) followed by the
    normal pass's further outputs unchanged."""
    out_n = infer(images)
    out_f = infer(images.flip(2))
    heat_u, paf_u = unflip_maps(out_f[1], out_f[0], limbs, swap_indices)
    heat = (out_n[1] + heat_u) / 2.0
    paf = (out_n[0] + paf_u) / 2.0
    return (paf, heat) + tuple(out_n[2:])
