"""Pinhole camera intrinsics (the port's copy of the Kinect Azure rig)."""

from __future__ import annotations

import dataclasses


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
