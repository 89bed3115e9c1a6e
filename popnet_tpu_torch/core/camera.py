"""Pinhole camera intrinsics (the port's copy of the Kinect Azure rig)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from popnet_tpu_torch.core.numerics import div_const


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float


# Kinect Azure intrinsics of the MP-3DHP capture rig.
KDH3D_INTRINSICS = CameraIntrinsics(
    fx=504.1189880371094, fy=504.042724609375, cx=231.7421875, cy=320.62640380859375
)


def back_project(x, y, z, cam: CameraIntrinsics):
    """Pinhole back-projection of pixel coords (x, y) at depth z to (..., 3)
    camera-frame (X, Y, Z) = ((x - cx) / fx * z, (y - cy) / fy * z, z), the
    focal lengths divided as the JAX package's compiled decode divides by
    them (`numerics.div_const`), on the CPU and on the card alike."""
    return torch.stack([div_const(x - cam.cx, cam.fx) * z, div_const(y - cam.cy, cam.fy) * z, z],
                       dim=-1)


def back_project_np(x, y, z, cam: CameraIntrinsics) -> np.ndarray:
    """The host's back-projection, in float64 NumPy: (..., 3) stack of
    ((x - cx) / fx * z, (y - cy) / fy * z, z), true divisions, as the
    evaluation drivers of the JAX package back-project Python lists."""
    x, y, z = (np.asarray(v, np.float64) for v in (x, y, z))
    X = (x - cam.cx) / cam.fx * z
    Y = (y - cam.cy) / cam.fy * z
    return np.stack([np.broadcast_to(X, z.shape), np.broadcast_to(Y, z.shape), z], axis=-1)
