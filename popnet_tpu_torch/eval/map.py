"""MPII-protocol mAP evaluation (2D PCKh rule and 3D metric rule).

The port's own copy of `popnet_tpu/eval/map.py`, kept equal to it
(tests/test_torch_eval.py pins the two).

NumPy reference implementation matching the benchmark protocol exactly
(reference: util/eval_mAP.py:60-395):

- `assign_gt_multi`: per image, builds the pred x GT x joint normalized
  distance tensor, computes per-(pred, GT) PCKh, keeps only each pred's best
  GT, then inverts to a GT -> best-pred assignment; matched preds contribute
  (score, hit) pairs per joint, unmatched preds contribute (score, 0).
- `get_rpc`: precision/recall from confidence-sorted labels.
- `voc_ap`: interpolated AP.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "assign_gt_multi",
    "get_rpc",
    "voc_ap",
    "eval_ap_mpii",
    "eval_ap_mpii_v2",
    "eval_ap_3d",
    "compute_head_size_from_two_joints",
    "compute_head_size_from_rect",
]


def compute_head_size_from_two_joints(humans, ind1: int, ind2: int):
    """2 * ||head - neck|| per person (reference: util/eval_mAP.py:26-40)."""
    out = []
    for human in humans:
        h = np.asarray(human, dtype=np.float64)
        out.append(2.0 * np.sqrt(np.sum((h[ind1] - h[ind2]) ** 2)))
    return out


def compute_head_size_from_rect(head_rects, sc_bias: float = 0.6):
    """Head-rect diagonal * 0.6 (reference: util/eval_mAP.py:43-57)."""
    return [
        np.sqrt((r[2] - r[0]) ** 2 + (r[3] - r[1]) ** 2) * sc_bias for r in head_rects
    ]


def assign_gt_multi(
    humans_pred_set,
    conf_pred_set,
    humans_gt_set,
    gt_visibility_set,
    ref_dist_set,
    num_joints: int,
    thresh: float,
):
    """Best-match assignment of predicted to GT poses across a dataset.

    Returns (scores_all, labels_all, n_gt_all) with scores/labels indexed
    [joint][image] -> list per prediction, and n_gt_all a
    (num_joints, num_images) count matrix (reference: util/eval_mAP.py:60-157).
    """
    num_images = len(humans_gt_set)
    scores_all = [[[] for _ in range(num_images)] for _ in range(num_joints)]
    labels_all = [[[] for _ in range(num_images)] for _ in range(num_joints)]
    n_gt_all = np.zeros((num_joints, num_images))

    for imgidx in range(num_images):
        preds = humans_pred_set[imgidx]
        gts = humans_gt_set[imgidx]
        n_pred, n_gt = len(preds), len(gts)

        dist = np.full((n_pred, n_gt, num_joints), np.inf)
        score = np.zeros((n_pred, num_joints))
        has_pred = np.zeros((n_pred, num_joints))
        has_gt = np.zeros((n_gt, num_joints))

        if n_pred > 0:
            for rp in range(n_pred):
                points_pred = preds[rp]
                for rg in range(n_gt):
                    points_gt = gts[rg]
                    ref_dist = ref_dist_set[imgidx][rg]
                    for i in range(num_joints):
                        if len(points_pred[i]) > 0:
                            has_pred[rp, i] = 1
                            score[rp, i] = conf_pred_set[imgidx][rp][i]
                        if len(points_gt[i]) > 0 and gt_visibility_set[imgidx][rg][i] > 0:
                            has_gt[rg, i] = 1
                        if has_pred[rp, i] and has_gt[rg, i]:
                            dist[rp, rg, i] = (
                                np.linalg.norm(
                                    np.asarray(points_pred[i], dtype=np.float64)
                                    - np.asarray(points_gt[i], dtype=np.float64)
                                )
                                / ref_dist
                            )

            n_gt_per = np.repeat(np.sum(has_gt, 1).reshape([1, -1]), n_pred, axis=0)
            match = (dist <= thresh).astype(np.int64)
            pck = np.sum(match, 2) / n_gt_per
            # keep only each prediction's best GT
            idx = np.argmax(pck, 1)
            for rp in range(len(idx)):
                pck[rp, np.arange(pck.shape[1]) != idx[rp]] = 0
            val = np.max(pck, 0)
            pred_to_gt = np.argmax(pck, 0)
            pred_to_gt[val == 0] = -1

            for rp in range(n_pred):
                if rp in pred_to_gt:
                    rg = int(np.where(pred_to_gt == rp)[0][0])
                    m = match[rp, rg, :]
                else:
                    m = np.zeros(num_joints, dtype=np.int64)
                for i in np.where(has_pred[rp, :])[0]:
                    scores_all[i][imgidx].append(score[rp, i])
                    labels_all[i][imgidx].append(m[i])

        for rg in range(n_gt):
            n_gt_all[:, imgidx] += has_gt[rg, :]

    return scores_all, labels_all, n_gt_all


def get_rpc(class_margin, true_labels, totalpos):
    """Precision/recall from confidence-sorted labels
    (reference: util/eval_mAP.py:160-191)."""
    class_margin = np.asarray(class_margin, dtype=np.float64)
    true_labels = np.asarray(true_labels)
    # np.argsort's DEFAULT (unstable introsort) flipped, exactly as the
    # reference does: with tied confidences (common — assembled-joint scores
    # saturate) the tie order changes the precision curve, so AP parity
    # requires replicating the reference's sort, quirks and all
    # (reference: util/eval_mAP.py:179 np.flip(np.argsort(class_margin)))
    sortidx = np.flip(np.argsort(class_margin))
    sorted_labels = true_labels[sortidx]
    tp = np.cumsum(sorted_labels == 1)
    ranks = np.arange(1, len(sorted_labels) + 1)
    precision = tp / ranks
    recall = tp / totalpos
    return precision, recall


def voc_ap(recall, precision):
    """Interpolated average precision (reference: util/eval_mAP.py:194-207)."""
    n = len(recall) + 2
    mrec = np.zeros(n)
    mrec[1:-1] = recall
    mrec[-1] = 1.0
    mpre = np.zeros(n)
    mpre[1:-1] = precision
    mpre[-1] = 0.0
    for i in range(n - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    indices = np.where((mrec[1:] - mrec[:-1]) > 0)[0] + 1
    return float(np.sum((mrec[indices] - mrec[indices - 1]) * mpre[indices]))


def _default_visibility(gt_visibility_set, humans_gt_set, num_joints):
    if len(gt_visibility_set) == 0:
        for humans in humans_gt_set:
            gt_visibility_set.append(np.ones((len(humans), num_joints)).tolist())
    return gt_visibility_set


def _default_conf(conf_pred_set, humans_pred_set, num_joints):
    if len(conf_pred_set) == 0:
        for humans in humans_pred_set:
            conf_pred_set.append(np.ones((len(humans), num_joints)).tolist())
    return conf_pred_set


def _ap_from_assignment(
    humans_pred_set, conf_pred_set, humans_gt_set, gt_visibility_set,
    ref_dist_set, joint_names, thresh, verbose,
):
    num_joints = len(joint_names)
    scores_all, labels_all, n_gt_all = assign_gt_multi(
        humans_pred_set, conf_pred_set, humans_gt_set, gt_visibility_set,
        ref_dist_set, num_joints, thresh,
    )
    ap = np.zeros(num_joints + 1)
    for j in range(num_joints):
        scores, labels = [], []
        for i in range(len(humans_pred_set)):
            scores += scores_all[j][i]
            labels += labels_all[j][i]
        precision, recall = get_rpc(scores, labels, np.sum(n_gt_all[j, :]))
        ap[j] = voc_ap(recall, precision) * 100
    ap[-1] = np.mean(ap[:-1])
    if verbose:
        for j, name in enumerate(joint_names):
            print(f"    {name},  AP: {ap[j]:03f}")
        print(f"\n     Overall: AP: {ap[-1]:03f}\n")
    return ap


def eval_ap_mpii(
    humans_pred_set, conf_pred_set, humans_gt_set, gt_visibility_set,
    head_sz_set, joint_names, thresh: float = 0.5, verbose: bool = True,
):
    """2D mAP under PCKh with MPII head-rect reference
    (reference: util/eval_mAP.py:210-269)."""
    assert len(humans_gt_set) == len(humans_pred_set)
    num_joints = len(joint_names)
    ref_dist_set = [compute_head_size_from_rect(head_sz_set[i]) for i in range(len(humans_gt_set))]
    gt_visibility_set = _default_visibility(gt_visibility_set, humans_gt_set, num_joints)
    conf_pred_set = _default_conf(conf_pred_set, humans_pred_set, num_joints)
    return _ap_from_assignment(
        humans_pred_set, conf_pred_set, humans_gt_set, gt_visibility_set,
        ref_dist_set, joint_names, thresh, verbose,
    )


def eval_ap_mpii_v2(
    humans_pred_set, conf_pred_set, humans_gt_set, gt_visibility_set,
    head_id: int, neck_id: int, joint_names, thresh: float = 0.5, verbose: bool = True,
):
    """2D mAP under PCKh with 2x head-neck reference
    (reference: util/eval_mAP.py:272-332)."""
    assert len(humans_gt_set) == len(humans_pred_set)
    num_joints = len(joint_names)
    ref_dist_set = [
        compute_head_size_from_two_joints(humans_gt_set[i], head_id, neck_id)
        for i in range(len(humans_gt_set))
    ]
    gt_visibility_set = _default_visibility(gt_visibility_set, humans_gt_set, num_joints)
    conf_pred_set = _default_conf(conf_pred_set, humans_pred_set, num_joints)
    return _ap_from_assignment(
        humans_pred_set, conf_pred_set, humans_gt_set, gt_visibility_set,
        ref_dist_set, joint_names, thresh, verbose,
    )


def eval_ap_3d(
    humans_pred_set, conf_pred_set, humans_gt_set, gt_visibility_set,
    joint_names, thresh: float = 0.1, verbose: bool = True,
):
    """3D mAP under the metric rule (ref dist = 1, thresh in meters)
    (reference: util/eval_mAP.py:335-395)."""
    assert len(humans_gt_set) == len(humans_pred_set)
    num_joints = len(joint_names)
    ref_dist_set = [np.ones(len(humans_gt_set[i])).tolist() for i in range(len(humans_gt_set))]
    gt_visibility_set = _default_visibility(gt_visibility_set, humans_gt_set, num_joints)
    conf_pred_set = _default_conf(conf_pred_set, humans_pred_set, num_joints)
    return _ap_from_assignment(
        humans_pred_set, conf_pred_set, humans_gt_set, gt_visibility_set,
        ref_dist_set, joint_names, thresh, verbose,
    )
