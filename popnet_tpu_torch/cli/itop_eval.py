"""ITOP's single-person evaluation drivers, scored by the 10-cm protocol
(`eval/single.py`).

- run_itop_a2j_eval: torso-box crops (`data/itop_a2j.py`) and the A2J
  anchor vote on the dataset's device, then the uncrop and the flipped-Y
  ITOP back-projection on the host in float64.
- run_itop_openpose_eval: the whole Open-Pose+ decode (`run_openpose_eval`),
  the person of best mean confidence in each frame, the same
  back-projection.

Predictions and ground truth both go to world space through
`itop_pixel2world`: the metric is a function of (u, v, z) on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.cli import evaluate as ev
from popnet_tpu_torch.core.config import DecodeConfig, EncoderConfig
from popnet_tpu_torch.data.itop_a2j import CROP, itop_uncrop_keypoints, person_uvz, torso_crops
from popnet_tpu_torch.decode.a2j import a2j_post_process
from popnet_tpu_torch.eval.single import accuracy_10cm, accuracy_10cm_per_joint, itop_pixel2world
from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors

__all__ = ["run_itop_a2j_eval", "run_itop_openpose_eval", "score_itop_uvz"]


def _world(uvz: np.ndarray) -> np.ndarray:
    """(N, K, 3) (u, v, z) -> (N, K, 3) world through the flipped-Y ITOP camera."""
    u, v, z = uvz[..., 0], uvz[..., 1], uvz[..., 2]
    X, Y = itop_pixel2world(u, v, z)
    return np.stack([X, Y, z], -1)


def score_itop_uvz(pred_uvz, gt_uvz) -> dict:
    """The 10-cm protocol on aligned (N, K, 3) (u, v, z) arrays."""
    pw, gw = _world(np.asarray(pred_uvz)), _world(np.asarray(gt_uvz))
    return {"acc_10cm": accuracy_10cm(pw, gw),
            "per_joint": accuracy_10cm_per_joint(pw, gw).tolist()}


def _gt_uvz(dataset) -> np.ndarray:
    """(N, K, 3) float64 single-person ground truth (u, v, z)."""
    return np.stack([person_uvz(dataset.anno_dic[image_id]) for image_id in dataset.ids])


def run_itop_a2j_eval(infer_a2j, dataset, batch_size: int = 16, xy_thres: float = 120.0,
                      depth_thres: float = 0.4, center_joint: int = 8,
                      mean: float | None = None, std: float | None = None) -> dict:
    """A2J over torso-box crops -> the 10-cm accuracy, per joint, and the
    predictions `pred_uvz`.

    `dataset` is a single-person set at ITOP_DATASET geometry with a
    `device` (the port's KDH3DDataset); `infer_a2j(crops (N, 288, 288, 1))`
    returns the (cls, reg, depth) heads as tensors on that device. The crops
    are `ITOPA2JCropDataset`'s without augmentation (`torso_crops`). `mean` and `std`
    normalize the torso-relative crop values and must be the statistics
    the net was trained with (`itop_relative_stats` for the ITOP table);
    they default to the dataset's absolute statistics."""
    mean = dataset.dcfg.depth.mean if mean is None else float(mean)
    std = dataset.dcfg.depth.std if std is None else float(std)
    anchors = torch.as_tensor(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
                              dtype=torch.float32, device=dataset.device)

    preds, gts = [], []
    n = len(dataset)
    for s in range(0, n, batch_size):
        crops, boxes, cz, uvd = torso_crops(dataset, range(s, min(s + batch_size, n)), mean,
                                            std, xy_thres, depth_thres, center_joint)
        yxz = a2j_post_process(infer_a2j(crops), anchors).cpu().numpy()   # (B, K, 3)
        preds.append(itop_uncrop_keypoints(yxz, boxes, cz))
        gts.append(uvd)
    pred, gt = np.concatenate(preds), np.concatenate(gts)

    out = score_itop_uvz(pred, gt)
    out["pred_uvz"] = pred.tolist()
    return out


def run_itop_openpose_eval(infer, dataset, batch_size: int = 16,
                           ecfg: EncoderConfig = EncoderConfig(),
                           dcfg: DecodeConfig = DecodeConfig()) -> dict:
    """Open-Pose+ at ITOP geometry (`dataset` an MPRealDataset at
    ITOP_DATASET) -> the person of best mean confidence in each frame ->
    the 10-cm accuracy. A frame without a person, and each joint that the
    assembler left unmatched ([-1, -1]) or without depth, counts as a
    miss (1e6 in `pred_uvz`)."""
    data = ev.run_openpose_eval(infer, dataset, batch_size, ecfg, dcfg)
    gt = _gt_uvz(dataset)
    K = gt.shape[1]

    pred = np.full_like(gt, 1e6)
    for i, (h2, h3, conf) in enumerate(zip(data["human_pred_set_2d"], data["human_pred_set_3d"],
                                           data["human_pred_set_part_conf"])):
        if not h2:
            continue
        best = int(np.argmax([np.mean(c) for c in conf]))
        j2 = np.asarray(h2[best], np.float64)
        z = np.asarray(h3[best], np.float64)[:, 2]
        row = np.concatenate([j2, z[:, None]], 1)
        row[(j2[:, 0] < 0) | (z < 0)] = 1e6
        pred[i, :K] = row
    out = score_itop_uvz(pred, gt)
    out["pred_uvz"] = pred.tolist()
    return out
