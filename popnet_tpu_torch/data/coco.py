"""COCO keypoint annotations for the RGB rtpose path (the port's copy of
`popnet_tpu/data/coco.py`, NumPy, exact).

`load_coco_keypoints` parses a person_keypoints_*.json directly (no
pycocotools): per image file the people with at least `min_keypoints`
labelled keypoints, not crowds, their 17 COCO keypoints converted to the
18-part rtpose order with the neck synthesized as the shoulders' midpoint
(`coco17_to_rtpose18`), and their boxes as (x0, y0, x1, y1).
`remove_illegal_joints` and `mask_valid_area` are the reference's input
masking helpers. `coco_eval_results` formats decoded rtpose-18 people as
COCO-17 keypoint results, and `run_coco_eval` scores them: with
pycocotools where it is installed, else with the port's vendored scorer
(`eval.coco_oks`), as the JAX package does.
"""

from __future__ import annotations

import json

import numpy as np

from popnet_tpu_torch.core.skeleton_coco import COCO_KEYPOINT_NAMES, COCO_NUM_JOINTS

# the raw COCO-17 keypoint order
COCO17 = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)


def coco17_to_rtpose18(kp17: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(17, 3) COCO keypoint triples -> ((18, 2) joints, (18,) visibility)
    in the rtpose order; joints with v = 0 stay at (-1, -1), and the neck is
    the shoulders' midpoint where both are labelled."""
    joints = np.full((COCO_NUM_JOINTS, 2), -1.0)
    vis = np.zeros(COCO_NUM_JOINTS)
    for i17, name in enumerate(COCO17):
        j = COCO_KEYPOINT_NAMES.index(name)
        x, y, v = kp17[i17]
        if v > 0:
            joints[j] = (x, y)
            vis[j] = 1
    ls, rs = COCO17.index("left_shoulder"), COCO17.index("right_shoulder")
    if kp17[ls, 2] > 0 and kp17[rs, 2] > 0:
        neck = COCO_KEYPOINT_NAMES.index("neck")
        joints[neck] = (kp17[ls, :2] + kp17[rs, :2]) / 2.0
        vis[neck] = 1
    return joints, vis


def load_coco_keypoints(annotation_json: str, min_keypoints: int = 5) -> dict:
    """person_keypoints_*.json -> {file_name: [{"2d_joints", "visible_joints",
    "bbox"}, ...]}."""
    with open(annotation_json) as f:
        data = json.load(f)
    images = {im["id"]: im["file_name"] for im in data["images"]}
    out: dict[str, list] = {}
    for ann in data.get("annotations", []):
        if ann.get("num_keypoints", 0) < min_keypoints or ann.get("iscrowd", 0):
            continue
        kp17 = np.asarray(ann["keypoints"], dtype=np.float64).reshape(17, 3)
        joints, vis = coco17_to_rtpose18(kp17)
        x, y, w, h = ann["bbox"]
        out.setdefault(images[ann["image_id"]], []).append({
            "2d_joints": joints.tolist(),
            "visible_joints": vis.astype(int).tolist(),
            "bbox": [x, y, x + w, y + h],
        })
    return out


def remove_illegal_joints(joints: np.ndarray, input_x: int, input_y: int) -> np.ndarray:
    """Joints outside [0, input_x) x [0, input_y) -> the (-1, -1) hole."""
    j = np.asarray(joints, dtype=np.float64).copy()
    bad = (j[..., 0] >= input_x) | (j[..., 0] < 0) | (j[..., 1] >= input_y) | (j[..., 1] < 0)
    j[bad] = (-1.0, -1.0)
    return j


def mask_valid_area(image: np.ndarray, valid_area) -> np.ndarray:
    """Zero the rows above and the columns left of the valid area's origin
    (valid_area = (x, y, ...), each zeroed where at least 1); (H, W[, C])."""
    if valid_area is None:
        return image
    out = np.asarray(image).copy()
    if valid_area[1] >= 1.0:
        out[: int(valid_area[1])] = 0
    if valid_area[0] >= 1.0:
        out[:, : int(valid_area[0])] = 0
    return out


def coco_eval_results(humans_per_image, image_ids, scores_per_image) -> list:
    """Decoded people as COCO-17 keypoint results: for each image id, each
    (18, >= 2) rtpose-18 person (x < 0 a hole) and its score -> {"image_id",
    "category_id": 1, "keypoints": 51 floats (x, y, 1 where labelled, else
    0, 0, 0), "score"}."""
    results = []
    for img_id, humans, scores in zip(image_ids, humans_per_image, scores_per_image):
        for human, score in zip(humans, scores):
            h = np.asarray(human)
            kp = np.zeros((17, 3))
            for i17, name in enumerate(COCO17):
                j = COCO_KEYPOINT_NAMES.index(name)
                if h[j, 0] >= 0:
                    kp[i17] = (h[j, 0], h[j, 1], 1)
            results.append({
                "image_id": int(img_id),
                "category_id": 1,
                "keypoints": kp.ravel().tolist(),
                "score": float(score),
            })
    return results


def run_coco_eval(gt_annotation_json: str, results: list) -> np.ndarray:
    """COCO keypoint AP of `results` against a person_keypoints JSON:
    pycocotools' COCOeval where it is installed (its 10 stats), else the
    vendored scorer (`eval.coco_oks.score_results_json`), which prints its
    line and returns (AP, AP50, AP75, AR)."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        from popnet_tpu_torch.eval.coco_oks import score_results_json

        stats = score_results_json(gt_annotation_json, results)
        print(f"[coco_oks] AP={stats['AP']:.4f} AP50={stats['AP50']:.4f} "
              f"AP75={stats['AP75']:.4f} AR={stats['AR']:.4f} (vendored scorer)")
        return np.array([stats["AP"], stats["AP50"], stats["AP75"], stats["AR"]])
    coco_gt = COCO(gt_annotation_json)
    coco_dt = coco_gt.loadRes(results)
    ev = COCOeval(coco_gt, coco_dt, "keypoints")
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev.stats
