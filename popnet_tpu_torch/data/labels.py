"""Label-file parsing and fixed-size annotation packing.

The port's own copy of `popnet_tpu/data/labels.py`, kept equal to it
(tests/test_torch_eval.py pins the two).

The benchmark labels are one JSON per split: {image_id: [ann, ...], ...}
with an 'intrinsics' sibling key; each ann has '2d_joints' (K x 2),
'3d_joints' (K x 3), 'bbox' [xmin, ymin, xmax, ymax], optional
'pose_weight' and 'visible_joints'
(reference: lib/datasets/datasets_kdh3d.py:186-187,
parse_raw_KDH3D_dataset.py:183-190, main_evaluate_mp_human_3D.py:20-37).

Packing pads per-image annotation lists to (max_people, ...) arrays with a
validity mask so the whole pipeline stays static-shape for XLA.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from popnet_tpu_torch.core.camera import CameraIntrinsics

# far off-image sentinel for padded joints: fails every inbound test
OOB = -1e6


@dataclasses.dataclass
class PackedAnnotations:
    joints2d: np.ndarray      # (P, K, 2) float32, OOB-padded
    joints3d: np.ndarray      # (P, K, 3) float32
    bboxes: np.ndarray        # (P, 4) float32
    pose_weights: np.ndarray  # (P,) float32 (1.0 default)
    valid: np.ndarray         # (P,) bool


def load_label_file(path: str):
    """Returns (annotations dict image_id -> [ann...], intrinsics or None)."""
    data = json.load(open(path, "r"))
    intr = None
    if "intrinsics" in data:
        d = data.pop("intrinsics")
        if isinstance(d, dict) and {"fx", "fy", "cx", "cy"} <= set(d):
            intr = CameraIntrinsics(fx=d["fx"], fy=d["fy"], cx=d["cx"], cy=d["cy"])
    return data, intr


def pack_annotations(anns, max_people: int, num_joints: int = 15) -> PackedAnnotations:
    """Pad a per-image annotation list to fixed (max_people, ...) arrays."""
    P = max_people
    j2 = np.full((P, num_joints, 2), OOB, dtype=np.float32)
    j3 = np.zeros((P, num_joints, 3), dtype=np.float32)
    bb = np.zeros((P, 4), dtype=np.float32)
    w = np.ones(P, dtype=np.float32)
    valid = np.zeros(P, dtype=bool)
    for i, ann in enumerate(anns[:P]):
        j2[i] = np.asarray(ann["2d_joints"], dtype=np.float32).reshape(num_joints, 2)
        j3[i] = np.asarray(ann["3d_joints"], dtype=np.float32).reshape(num_joints, 3)
        bb[i] = np.asarray(ann["bbox"], dtype=np.float32)[:4]
        w[i] = float(ann.get("pose_weight", 1.0))
        valid[i] = True
    return PackedAnnotations(j2, j3, bb, w, valid)


def unpack_annotations(packed: PackedAnnotations):
    """Back to a per-image annotation list (valid people only)."""
    out = []
    for i in range(len(packed.valid)):
        if not packed.valid[i]:
            continue
        out.append(
            {
                "2d_joints": packed.joints2d[i].copy(),
                "3d_joints": packed.joints3d[i].copy(),
                "bbox": packed.bboxes[i].copy(),
                "pose_weight": float(packed.pose_weights[i]),
            }
        )
    return out
