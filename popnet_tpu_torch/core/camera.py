"""Pinhole camera intrinsics (the port's copy of the Kinect Azure rig)."""

from __future__ import annotations

import dataclasses

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
