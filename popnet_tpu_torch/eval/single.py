"""Single-person evaluation: the 10-cm rule and the 2D pixel rule (the A2J
protocol), in float64 NumPy, as the JAX package's `eval/single.py`.

Inputs are aligned (N, K, 3) or (N, K, 2) prediction and ground-truth
arrays, one person a frame.
"""

from __future__ import annotations

import numpy as np

from popnet_tpu_torch.core.camera import ITOP_INTRINSICS


def itop_pixel2world(x, y, z):
    """ITOP's camera with a flipped Y: pixel (x, y) at depth z -> (X, Y)."""
    X = (x - ITOP_INTRINSICS.cx) * z / ITOP_INTRINSICS.fx
    Y = (ITOP_INTRINSICS.cy - y) * z / ITOP_INTRINSICS.fy
    return X, Y


def itop_world2pixel(X, Y, z):
    x = ITOP_INTRINSICS.cx + X / z * ITOP_INTRINSICS.fx
    y = ITOP_INTRINSICS.cy - Y / z * ITOP_INTRINSICS.fy
    return x, y


def accuracy_10cm(pred3d, gt3d, thresh: float = 0.1) -> float:
    """The share of joints within `thresh` metres of the ground truth."""
    d2 = np.sum((np.asarray(pred3d) - np.asarray(gt3d)) ** 2, axis=-1)
    return float(np.mean(d2 < thresh**2))


def accuracy_10cm_per_joint(pred3d, gt3d, thresh: float = 0.1) -> np.ndarray:
    """(K,) the share of each joint within `thresh` metres."""
    d2 = np.sum((np.asarray(pred3d) - np.asarray(gt3d)) ** 2, axis=-1)
    return np.mean(d2 < thresh**2, axis=0)


def accuracy_2d(pred2d, gt2d, dist_th: float) -> float:
    """The share of joints within `dist_th` pixels."""
    d2 = np.sum((np.asarray(pred2d)[..., :2] - np.asarray(gt2d)[..., :2]) ** 2, axis=-1)
    return float(np.mean(d2 < dist_th**2))


def accuracy_2d_per_joint(pred2d, gt2d, dist_th: float) -> np.ndarray:
    """(K,) the share of each joint within `dist_th` pixels."""
    d2 = np.sum((np.asarray(pred2d)[..., :2] - np.asarray(gt2d)[..., :2]) ** 2, axis=-1)
    return np.mean(d2 < dist_th**2, axis=0)


def default_2d_threshold(w_org: int, h_org: int) -> float:
    """0.02 of the image diagonal."""
    return 0.02 * np.sqrt(w_org**2 + h_org**2)
