"""Best-match PCK / PCKh evaluation for multi-person pose.

The port's own copy of `popnet_tpu/eval/pck.py`, kept equal to it
(tests/test_torch_eval.py pins the two).

NumPy reference implementation of the benchmark metrics. Semantics match
the reference protocol exactly (reference: util/eval_pck.py:20-475):

- Per image, each GT person is matched to the predicted person whose
  skeleton bounding box has the highest IoU (greedy per-GT argmax; a
  prediction may serve several GTs).
- A GT person whose best IoU is below `iou_th` contributes -1 distances.
- Joints predicted as [-1, -1] ("not found") contribute -1 distances.
- 2D PCKh: per-GT threshold = h_th * (2 * ||head - neck||).
- 3D PCK: match in 2D, measure metric 3D distance, 0.1 m threshold;
  GT joints at [-1, -1] in 2D are excluded.
- Per-joint PCK denominator = number of GT humans (or the count of visible
  GT joints when a visibility set is supplied).

Inputs are per-image Python lists of K x 2 (2D) / K x 3 (3D) joint lists —
the prediction-JSON contract of the benchmark.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "compute_bbox_from_humans",
    "bbox_ious",
    "match_humans_2d",
    "match_humans_3d",
    "compute_head_size",
    "compute_head_size_from_rect",
    "eval_human_dataset_2d",
    "eval_human_dataset_2d_pckh",
    "eval_human_dataset_2d_pckh_rect",
    "eval_human_dataset_3d",
]


def compute_bbox_from_humans(humans):
    """Tight bbox over valid ([-1,-1]-free) joints per human.

    Returns (N, 4) [xmin, ymin, xmax, ymax]. Like the reference, a human
    with no valid joints yields an empty array (which downstream treats as
    "no predictions"); callers matching GT humans raise a clear error
    instead of the reference's IndexError
    (reference: util/eval_pck.py:433-449).
    """
    bboxes = []
    for human in humans:
        pts = np.asarray(human, dtype=np.float64)
        valid = ~np.all(pts == -1.0, axis=1)
        pts = pts[valid]
        if pts.shape[0] == 0:
            return np.array([])
        bboxes.append([pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()])
    return np.asarray(bboxes, dtype=np.float64)


def bbox_ious(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU (N1, N2); all -1 when boxes2 is empty
    (reference: util/eval_pck.py:452-475)."""
    if len(boxes2) == 0:
        return np.ones([len(boxes1), 1]) * -1.0
    b1 = np.asarray(boxes1, dtype=np.float64)
    b2 = np.asarray(boxes2, dtype=np.float64)
    dx = np.maximum(
        np.minimum(b1[:, None, 2], b2[None, :, 2]) - np.maximum(b1[:, None, 0], b2[None, :, 0]),
        0.0,
    )
    dy = np.maximum(
        np.minimum(b1[:, None, 3], b2[None, :, 3]) - np.maximum(b1[:, None, 1], b2[None, :, 1]),
        0.0,
    )
    inter = dx * dy
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    return inter / union


def match_humans_2d(humans_pred, humans_gt, iou_th: float = 0.5):
    """Per-GT joint pixel distances against the best-IoU prediction.

    Returns a list of K-vectors; -1 marks unmatched GT persons and invalid
    predicted joints (reference: util/eval_pck.py:266-310).
    """
    joint_dists = []
    if len(humans_pred) == 0:
        return [np.full(len(h), -1.0) for h in humans_gt]

    bboxes_gt = compute_bbox_from_humans(humans_gt)
    if bboxes_gt.ndim != 2:
        raise ValueError("a GT human has no valid joints (all [-1, -1])")
    bboxes_pred = compute_bbox_from_humans(humans_pred)
    ious = bbox_ious(bboxes_gt, bboxes_pred)

    for i, human_gt in enumerate(humans_gt):
        if np.max(ious[i, :]) < iou_th:
            joint_dists.append(np.full(len(human_gt), -1.0))
            continue
        pred = np.asarray(humans_pred[int(np.argmax(ious[i, :]))], dtype=np.float64)
        gt = np.asarray(human_gt, dtype=np.float64)
        d = np.sqrt(np.sum((gt - pred) ** 2, axis=1))
        d[np.logical_and(pred[:, 0] == -1, pred[:, 1] == -1)] = -1.0
        joint_dists.append(d)
    return joint_dists


def match_humans_3d(humans_pred_2d, humans_gt_2d, humans_pred_3d, humans_gt_3d, iou_th=0.5):
    """Match by 2D skeleton-bbox IoU, measure metric 3D joint distances.

    -1 for unmatched persons, invalid predicted 2D joints, and invisible GT
    2D joints (reference: util/eval_pck.py:382-430).
    """
    joint_dists = []
    if len(humans_pred_2d) == 0:
        return [np.full(len(h), -1.0) for h in humans_gt_2d]

    bboxes_gt = compute_bbox_from_humans(humans_gt_2d)
    if bboxes_gt.ndim != 2:
        raise ValueError("a GT human has no valid joints (all [-1, -1])")
    bboxes_pred = compute_bbox_from_humans(humans_pred_2d)
    ious = bbox_ious(bboxes_gt, bboxes_pred)

    for i, human_gt_3d in enumerate(humans_gt_3d):
        if np.max(ious[i, :]) < iou_th:
            joint_dists.append(np.full(len(human_gt_3d), -1.0))
            continue
        j = int(np.argmax(ious[i, :]))
        pred3 = np.asarray(humans_pred_3d[j], dtype=np.float64)
        gt3 = np.asarray(human_gt_3d, dtype=np.float64)
        d = np.sqrt(np.sum((gt3 - pred3) ** 2, axis=1))
        pred2 = np.asarray(humans_pred_2d[j], dtype=np.float64)
        d[np.logical_and(pred2[:, 0] == -1, pred2[:, 1] == -1)] = -1.0
        gt2 = np.asarray(humans_gt_2d[i], dtype=np.float64)
        d[np.logical_and(gt2[:, 0] == -1, gt2[:, 1] == -1)] = -1.0
        joint_dists.append(d)
    return joint_dists


def compute_head_size(humans, head_id: int, neck_id: int):
    """Per-person head size = 2 * ||head - neck||
    (reference: util/eval_pck.py:230-244)."""
    out = []
    for human in humans:
        h = np.asarray(human, dtype=np.float64)
        out.append(2.0 * np.sqrt(np.sum((h[head_id] - h[neck_id]) ** 2)))
    return out


def compute_head_size_from_rect(head_rects, sc_bias: float = 0.6):
    """MPII head-rect diagonal * 0.6 (reference: util/eval_pck.py:247-261)."""
    return [
        np.sqrt((r[2] - r[0]) ** 2 + (r[3] - r[1]) ** 2) * sc_bias for r in head_rects
    ]


def _aggregate(joint_dists_set, hit_flags, num_joints, samples_cnt, visibility_all):
    joint_dists_set = np.asarray(joint_dists_set, dtype=np.float64)
    hit_flags = np.asarray(hit_flags)
    joint_avg_dist = []
    joint_pck = []
    for k in range(num_joints):
        d = joint_dists_set[:, k]
        matched = d[d >= 0]
        joint_avg_dist.append(float(np.mean(matched)) if matched.size else float("nan"))
        hit_cnt = float(np.sum(hit_flags[:, k])) if hit_flags.size else 0.0
        if visibility_all is not None and visibility_all.shape[0] != 0:
            joint_pck.append(hit_cnt / np.sum(visibility_all[:, k]))
        else:
            joint_pck.append(hit_cnt / samples_cnt)
    return joint_avg_dist, joint_pck


def eval_human_dataset_2d(
    humans_pred_set,
    humans_gt_set,
    num_joints: int = 15,
    dist_th: float = 10.0,
    iou_th: float = 0.5,
    human_gt_set_visibility=None,
):
    """Dataset-level 2D PCK at a fixed pixel threshold
    (reference: util/eval_pck.py:20-77)."""
    assert len(humans_gt_set) == len(humans_pred_set)
    samples_cnt = 0
    joint_dists_set = []
    visibility_all = []
    for i in range(len(humans_gt_set)):
        humans_gt = humans_gt_set[i]
        samples_cnt += len(humans_gt)
        if len(humans_gt) == 0:
            continue
        joint_dists = match_humans_2d(humans_pred_set[i], humans_gt, iou_th)
        if human_gt_set_visibility is not None:
            for j, vis in enumerate(human_gt_set_visibility[i]):
                visibility_all.append(vis)
                joint_dists[j][np.asarray(vis) == 0] = -1.0
        joint_dists_set += joint_dists

    visibility_arr = np.asarray(visibility_all) if visibility_all else np.zeros((0, num_joints))
    dists = np.asarray(joint_dists_set, dtype=np.float64)
    hits = np.logical_and(dists >= 0, dists < dist_th)
    return _aggregate(dists, hits, num_joints, samples_cnt, visibility_arr)


def eval_human_dataset_2d_pckh(
    humans_pred_set,
    humans_gt_set,
    head_id: int,
    neck_id: int,
    num_joints: int = 15,
    h_th: float = 0.5,
    iou_th: float = 0.5,
    human_gt_set_visibility=None,
):
    """Dataset-level 2D PCKh (per-GT threshold = h_th * head size)
    (reference: util/eval_pck.py:80-154)."""
    assert len(humans_gt_set) == len(humans_pred_set)

    if human_gt_set_visibility is None:
        human_gt_set_visibility = [
            np.ones((len(humans_gt_set[i]), num_joints)).tolist()
            for i in range(len(humans_gt_set))
        ]

    samples_cnt = 0
    joint_dists_set = []
    hit_vec = []
    visibility_all = []
    for i in range(len(humans_gt_set)):
        humans_gt = humans_gt_set[i]
        samples_cnt += len(humans_gt)
        if len(humans_gt) == 0:
            continue
        joint_dists = match_humans_2d(humans_pred_set[i], humans_gt, iou_th)
        hsz_vec = compute_head_size(humans_gt, head_id, neck_id)
        for j, vis in enumerate(human_gt_set_visibility[i]):
            visibility_all.append(vis)
            joint_dists[j][np.asarray(vis) == 0] = -1.0
            hit_vec.append(
                np.logical_and(joint_dists[j] >= 0, joint_dists[j] < hsz_vec[j] * h_th)
            )
        joint_dists_set += joint_dists

    visibility_arr = np.asarray(visibility_all)
    return _aggregate(joint_dists_set, hit_vec, num_joints, samples_cnt, visibility_arr)


def eval_human_dataset_2d_pckh_rect(
    humans_pred_set,
    humans_gt_set,
    head_sz_set,
    num_joints: int = 15,
    h_th: float = 0.5,
    iou_th: float = 0.5,
    human_gt_set_visibility=None,
):
    """PCKh with MPII head-rect reference (reference: util/eval_pck.py:157-229)."""
    assert len(humans_gt_set) == len(humans_pred_set)
    if human_gt_set_visibility is None:
        human_gt_set_visibility = [
            np.ones((len(humans_gt_set[i]), num_joints)).tolist()
            for i in range(len(humans_gt_set))
        ]

    samples_cnt = 0
    joint_dists_set = []
    hit_vec = []
    visibility_all = []
    for i in range(len(humans_gt_set)):
        humans_gt = humans_gt_set[i]
        samples_cnt += len(humans_gt)
        if len(humans_gt) == 0:
            continue
        joint_dists = match_humans_2d(humans_pred_set[i], humans_gt, iou_th)
        hsz_vec = compute_head_size_from_rect(head_sz_set[i])
        for j, vis in enumerate(human_gt_set_visibility[i]):
            visibility_all.append(vis)
            joint_dists[j][np.asarray(vis) == 0] = -1.0
            hit_vec.append(
                np.logical_and(joint_dists[j] >= 0, joint_dists[j] < hsz_vec[j] * h_th)
            )
        joint_dists_set += joint_dists

    visibility_arr = np.asarray(visibility_all)
    return _aggregate(joint_dists_set, hit_vec, num_joints, samples_cnt, visibility_arr)


def eval_human_dataset_3d(
    humans_pred_set_2d,
    humans_gt_set_2d,
    humans_pred_set_3d,
    humans_gt_set_3d,
    num_joints: int = 15,
    dist_th: float = 0.1,
    iou_th: float = 0.5,
    human_gt_set_visibility=None,
):
    """Dataset-level 3D PCK at a metric threshold (matching done in 2D)
    (reference: util/eval_pck.py:313-379)."""
    assert len(humans_gt_set_2d) == len(humans_pred_set_2d)

    samples_cnt = 0
    joint_dists_set = []
    visibility_all = []
    for i in range(len(humans_gt_set_2d)):
        humans_gt_2d = humans_gt_set_2d[i]
        samples_cnt += len(humans_gt_2d)
        if len(humans_gt_2d) == 0:
            continue
        joint_dists = match_humans_3d(
            humans_pred_set_2d[i], humans_gt_2d, humans_pred_set_3d[i], humans_gt_set_3d[i], iou_th
        )
        if human_gt_set_visibility is not None:
            for j, vis in enumerate(human_gt_set_visibility[i]):
                visibility_all.append(vis)
                joint_dists[j][np.asarray(vis) == 0] = -1.0
        joint_dists_set += joint_dists

    visibility_arr = (
        np.asarray(visibility_all) if human_gt_set_visibility is not None else None
    )
    dists = np.asarray(joint_dists_set, dtype=np.float64)
    hits = np.logical_and(dists >= 0, dists < dist_th)
    return _aggregate(dists, hits, num_joints, samples_cnt, visibility_arr)
