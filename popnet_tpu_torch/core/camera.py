"""Pinhole camera intrinsics (the port's copies of the Kinect Azure rig and
of the ITOP camera), the back-projections, and the pelvis frame of a pose
(`approx_root_orientation`, which the pose-rarity weights of
`data.construction` use)."""

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

# The ITOP camera: 320x240 frames, f = 1 / 0.0035.
ITOP_INTRINSICS = CameraIntrinsics(fx=1.0 / 0.0035, fy=1.0 / 0.0035, cx=160.0, cy=120.0)


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


def approx_root_orientation(hip_left_pt, hip_right_pt, neck_pt) -> np.ndarray:
    """The pelvis frame of each pose from its hips and neck, float64: X the
    left -> right hip, Y = (right -> left hip) x (left hip -> neck), Z = X x
    Y, each normalized (+ 1e-9). Returns (N, 3, 3) with the axes as
    columns."""
    hip_left = np.asarray(hip_left_pt, dtype=np.float64).reshape(-1, 3)
    hip_right = np.asarray(hip_right_pt, dtype=np.float64).reshape(-1, 3)
    neck = np.asarray(neck_pt, dtype=np.float64).reshape(-1, 3)

    x_axis = hip_right - hip_left
    x_axis = x_axis / (np.linalg.norm(x_axis, axis=1, keepdims=True) + 1e-9)
    y_axis = np.cross(-x_axis, neck - hip_left)
    y_axis = y_axis / (np.linalg.norm(y_axis, axis=1, keepdims=True) + 1e-9)
    z_axis = np.cross(x_axis, y_axis)
    return np.concatenate(
        [x_axis.reshape(-1, 3, 1), y_axis.reshape(-1, 3, 1), z_axis.reshape(-1, 3, 1)], axis=2)
