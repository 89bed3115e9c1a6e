"""Depth-map compositing of the background and multi-person augmentations
(the port's copy of `popnet_tpu/data/compositing.py`), batched over a
leading axis:

- `bg_composite`: a person's depth where its mask covers, the background
  elsewhere, `depth * fg + bg * (1 - fg)`;
- `mp_composite`: the z-buffer merge of several single-person layers into
  one multi-person frame, then the background where no person covers.

For {0, 1} masks, the masks the benchmark ships, every term is an exact
float32 operation, so a composite equals the JAX package's bit for bit on
every device, however the compiler fuses the multiply-adds.
"""

from __future__ import annotations

import torch


def bg_composite(depth: torch.Tensor, fg_mask: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """depth * fg + bg * (1 - fg), elementwise on broadcastable tensors."""
    return depth * fg_mask + bg * (1.0 - fg_mask)


def mp_composite(person_depths: torch.Tensor, person_masks: torch.Tensor,
                 person_keep: torch.Tensor, bg: torch.Tensor, far: float = 12.0):
    """Z-buffer composite of the kept person layers over a background:
    person_depths and person_masks (B, L, H, W), person_keep (B, L) bool,
    bg (B, H, W) -> (image (B, H, W), fg_union (B, H, W)). A pixel takes the
    nearest masked depth * mask of a kept layer (`far`, twice the depth
    clip, where none covers) and the background where the union of the
    kept masks is 0."""
    keep = person_keep[:, :, None, None]
    cand = torch.where(keep & (person_masks > 0), person_depths * person_masks,
                       torch.full((), far, dtype=person_depths.dtype,
                                  device=person_depths.device))
    zmin = cand.amin(1)
    fg_union = torch.where(keep, person_masks, torch.zeros((), dtype=person_masks.dtype,
                                                           device=person_masks.device)).amax(1)
    return zmin * fg_union + bg * (1.0 - fg_union), fg_union
