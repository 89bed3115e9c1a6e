"""Skeleton and depth visualizers: the GT and prediction viewers.

The port of `popnet_tpu/viz/draw.py`, with its names and its arithmetic:

- `depth_to_gray` and `overlay_seg` run on the device of the tensor they
  are given (a NumPy array is taken as a CPU tensor), in float64 as the
  JAX package's NumPy does, and return a uint8 tensor there; IEEE float64
  gives the same bytes on the card as on the host;
- `draw_humans` and `draw_humans_visibility` copy the image to the host
  once (a NumPy array is drawn in place) and draw with cv2's rasterizer
  (`viz.raster`: the joints' circles of radius 3 and thickness 2, the
  limbs' lines of thickness 2), truncating each joint to integers as
  `int()` does;
- `visualize_gt` and `visualize_pred` compose them and return the host
  image, an (H, W, 3) uint8 BGR array.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.skeleton import JOINT_COLORS, LIMBS
from popnet_tpu_torch.viz.raster import circle, line

JOINT_RED = (0, 0, 255)
JOINT_HIDDEN = (0, 0, 0)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def depth_to_gray(depth, depth_max: float = 6.0) -> torch.Tensor:
    """Clip to [0, depth_max] and map to a 3-channel uint8 greyscale image
    on the depth's device: (H, W) -> (H, W, 3) uint8."""
    d = _tensor(depth).to(torch.float64).clamp(0, depth_max)
    g = (d / depth_max * 255).to(torch.uint8)
    return g[..., None].expand(*g.shape, 3).contiguous()


def overlay_seg(img, seg, color=(0, 0, 255), alpha=0.5) -> torch.Tensor:
    """Blend `color` into the pixels where `seg` > 0, in float64, truncated
    to uint8, on the image's device (seg is moved there)."""
    out = _tensor(img).clone()
    m = _tensor(seg).to(out.device) > 0
    c = torch.tensor(color, dtype=torch.float64, device=out.device)
    out[m] = (out[m].to(torch.float64) * (1 - alpha) + c * alpha).to(torch.uint8)
    return out


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().to("cpu", copy=True).numpy()
    return img


def _point(joint) -> tuple[int, int]:
    return tuple(int(v) for v in joint[:2])


def draw_humans(img, humans, limbs=LIMBS, colors=JOINT_COLORS, visibilities=None) -> np.ndarray:
    """Draw skeletons on the host copy of `img` (a NumPy image in place);
    a limb whose start joint has visibility < 0.5 is skipped, and its line
    and end circle where its end joint has."""
    img = _host(img)
    for i, human in enumerate(humans):
        h = np.asarray(human)
        for k, (a, b) in enumerate(limbs):
            if visibilities is not None and visibilities[i][a] < 0.5:
                continue
            c1 = _point(h[a])
            circle(img, c1, 3, JOINT_RED, 2)
            if visibilities is not None and visibilities[i][b] < 0.5:
                continue
            c2 = _point(h[b])
            line(img, c1, c2, colors[k % len(colors)], 2)
            circle(img, c2, 3, JOINT_RED, 2)
    return img


def draw_humans_visibility(img, humans, limbs=LIMBS, colors=JOINT_COLORS,
                           visibilities=None) -> np.ndarray:
    """Like `draw_humans`, but every limb is drawn and joints with
    visibility < 0.5 are marked in black."""
    img = _host(img)
    for i, human in enumerate(humans):
        h = np.asarray(human)
        for k, (a, b) in enumerate(limbs):
            ca = JOINT_HIDDEN if visibilities is not None and visibilities[i][a] < 0.5 else JOINT_RED
            c1 = _point(h[a])
            circle(img, c1, 3, ca, 2)
            cb = JOINT_HIDDEN if visibilities is not None and visibilities[i][b] < 0.5 else JOINT_RED
            c2 = _point(h[b])
            line(img, c1, c2, colors[k % len(colors)], 2)
            circle(img, c2, 3, cb, 2)
    return img


def visualize_gt(depth, anns, seg=None, depth_max: float = 6.0) -> np.ndarray:
    """Depth -> greyscale with the segmentation in red (when given) on the
    depth's device, then the GT skeletons (`anns`' "2d_joints") on the host."""
    img = depth_to_gray(depth, depth_max)
    if seg is not None:
        img = overlay_seg(img, seg)
    humans = [np.asarray(a["2d_joints"]).reshape(-1, 2) for a in anns]
    return draw_humans(img, humans)


def visualize_pred(depth, humans, visibilities=None, depth_max: float = 6.0) -> np.ndarray:
    """Depth -> greyscale on the depth's device, then the predicted
    skeletons on the host."""
    img = depth_to_gray(depth, depth_max)
    return draw_humans_visibility(img, humans, visibilities=visibilities)
