"""COCO keypoint AP without pycocotools (the port's copy of
`popnet_tpu/eval/coco_oks.py`, NumPy on the host, exact).

The COCOeval('keypoints') protocol: the OKS of each detection against each
annotation with the 17 standard per-joint sigmas; per image, detections by
descending score (stable order, at most 20) each take the best unmatched
annotation at OKS thresholds .50:.05:.95, crowds and annotations without
labelled keypoints ignored; precision interpolated at 101 recall points.
One category (person) and one area range ("all"). `score_results_json`
scores a list of COCO-format results against a person_keypoints JSON.
"""

from __future__ import annotations

import json

import numpy as np

# standard COCO keypoint sigmas (person-keypoints k_i constants)
OKS_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
])

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)


def compute_oks(gt: dict, dts: list[dict], sigmas=OKS_SIGMAS) -> np.ndarray:
    """OKS of each detection against one GT annotation.

    gt: {"keypoints": (17*3,), "bbox": [x, y, w, h], "area": float}
    dts: [{"keypoints": (17*3,)}, ...]
    """
    g = np.asarray(gt["keypoints"], dtype=np.float64).reshape(-1, 3)
    xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
    k1 = int(np.count_nonzero(vg > 0))
    bb = np.asarray(gt["bbox"], dtype=np.float64)
    x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
    y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
    var = (sigmas * 2.0) ** 2
    area = float(gt.get("area", bb[2] * bb[3]))

    out = np.zeros(len(dts))
    for i, dt in enumerate(dts):
        d = np.asarray(dt["keypoints"], dtype=np.float64).reshape(-1, 3)
        xd, yd = d[:, 0], d[:, 1]
        if k1 > 0:
            dx = xd - xg
            dy = yd - yg
        else:
            # no labeled joints: distance outside the doubled bbox
            z = np.zeros(len(sigmas))
            dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
            dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
        e = (dx**2 + dy**2) / var / (area + np.spacing(1)) / 2.0
        if k1 > 0:
            e = e[vg > 0]
        out[i] = np.sum(np.exp(-e)) / e.shape[0]
    return out


def _match_image(gts, dts, thrs, max_dets: int = 20):
    """Greedy per-image matching at each OKS threshold.

    Returns (dt_matched (T, D), dt_ignore (T, D), gt_ignore (G,), dt_scores).
    Detections sorted by descending score and truncated to `max_dets`
    (COCOeval keypoints maxDets=20); each picks the best remaining GT with
    OKS >= threshold (ignored GTs only if nothing else matched)."""
    T = len(thrs)
    gt_ignore = np.array(
        [bool(g.get("iscrowd", 0)) or g.get("num_keypoints", _nkp(g)) == 0 for g in gts],
        dtype=bool,  # explicit: an empty list would otherwise infer float64
    )
    order_g = np.argsort(gt_ignore, kind="stable")  # real GTs first
    gts = [gts[i] for i in order_g]
    gt_ignore = gt_ignore[order_g]

    scores = np.array([d.get("score", 0.0) for d in dts])
    order_d = np.argsort(-scores, kind="stable")[:max_dets]
    dts = [dts[i] for i in order_d]
    scores = scores[order_d]

    oks = np.stack([compute_oks(g, dts) for g in gts]) if gts else np.zeros((0, len(dts)))

    G, D = len(gts), len(dts)
    dt_m = np.zeros((T, D), dtype=np.int64)
    gt_m = np.zeros((T, G), dtype=np.int64)
    dt_ig = np.zeros((T, D), dtype=bool)
    for ti, t in enumerate(thrs):
        for di in range(D):
            best, bi = min(t, 1 - 1e-10), -1
            for gi in range(G):
                if gt_m[ti, gi]:
                    continue
                # stop at ignored GTs once a real match exists
                if bi > -1 and not gt_ignore[bi] and gt_ignore[gi]:
                    break
                if oks[gi, di] < best:
                    continue
                best, bi = oks[gi, di], gi
            if bi == -1:
                continue
            dt_m[ti, di] = 1
            gt_m[ti, bi] = 1
            dt_ig[ti, di] = gt_ignore[bi]
    return dt_m, dt_ig, gt_ignore, scores


def _nkp(g):
    kp = np.asarray(g["keypoints"]).reshape(-1, 3)
    return int(np.count_nonzero(kp[:, 2] > 0))


def oks_ap(gts_per_image: list, dts_per_image: list, thrs=IOU_THRS):
    """COCO keypoint AP/AR over per-image annotation/detection lists.

    Returns {"AP": mAP over thresholds, "AP50", "AP75", "AR",
    "precision": (T, R) curve}."""
    T = len(thrs)
    all_scores, all_matched, all_ignored = [], [], []
    n_gt = 0
    for gts, dts in zip(gts_per_image, dts_per_image):
        dt_m, dt_ig, gt_ig, scores = _match_image(gts, dts, thrs)
        all_scores.append(scores)
        all_matched.append(dt_m)
        all_ignored.append(dt_ig)
        n_gt += int(np.count_nonzero(~gt_ig))

    if n_gt == 0:
        return {"AP": np.nan, "AP50": np.nan, "AP75": np.nan, "AR": np.nan,
                "precision": np.full((T, len(REC_THRS)), np.nan)}

    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    order = np.argsort(-scores, kind="mergesort")
    matched = np.concatenate(all_matched, axis=1)[:, order]
    ignored = np.concatenate(all_ignored, axis=1)[:, order]

    precision = np.zeros((T, len(REC_THRS)))
    recall_T = np.zeros(T)
    for ti in range(T):
        keep = ~ignored[ti]
        tp = np.cumsum(matched[ti][keep])
        fp = np.cumsum(~matched[ti][keep].astype(bool))
        rc = tp / n_gt
        pr = tp / np.maximum(tp + fp, np.spacing(1))
        recall_T[ti] = rc[-1] if len(rc) else 0.0
        # monotone non-increasing envelope, then sample at 101 recalls
        for i in range(len(pr) - 1, 0, -1):
            pr[i - 1] = max(pr[i - 1], pr[i])
        idx = np.searchsorted(rc, REC_THRS, side="left")
        precision[ti] = [pr[j] if j < len(pr) else 0.0 for j in idx]

    ap_t = precision.mean(axis=1)
    return {
        "AP": float(ap_t.mean()),
        "AP50": float(ap_t[np.argmin(np.abs(thrs - 0.5))]),
        "AP75": float(ap_t[np.argmin(np.abs(thrs - 0.75))]),
        "AR": float(recall_T.mean()),
        "precision": precision,
    }


def score_results_json(gt_annotation_json: str, results: list):
    """Score COCO-format keypoint results against a person_keypoints GT
    file — the pycocotools-free twin of data/coco.py run_coco_eval.
    Returns the oks_ap dict."""
    with open(gt_annotation_json) as f:
        data = json.load(f)
    person_cat = {c["id"] for c in data.get("categories", []) if c.get("name") == "person"}
    gts_by_img = {}
    for ann in data["annotations"]:
        if person_cat and ann.get("category_id") not in person_cat:
            continue
        gts_by_img.setdefault(ann["image_id"], []).append(ann)
    dts_by_img = {}
    for r in results:
        dts_by_img.setdefault(r["image_id"], []).append(r)
    img_ids = sorted({i["id"] for i in data["images"]})
    return oks_ap(
        [gts_by_img.get(i, []) for i in img_ids],
        [dts_by_img.get(i, []) for i in img_ids],
    )
