"""The COCO 18-part body model (joint order, the 19 limbs, the left/right
swap of a horizontal flip).

The port's own copy of `popnet_tpu/core/skeleton_coco.py`: the limb order
fixes the PAF channel order and the assembly order, so it must not drift.
"""

from __future__ import annotations

COCO_KEYPOINT_NAMES: tuple[str, ...] = (
    "nose", "neck",
    "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist",
    "right_hip", "right_knee", "right_ankle",
    "left_hip", "left_knee", "left_ankle",
    "right_eye", "left_eye", "right_ear", "left_ear",
)

COCO_NUM_JOINTS = len(COCO_KEYPOINT_NAMES)  # 18


def _limbs() -> tuple[tuple[int, int], ...]:
    """The 19 limb (src, dst) pairs, in PAF channel order."""
    i = COCO_KEYPOINT_NAMES.index
    return (
        (i("neck"), i("right_hip")),
        (i("right_hip"), i("right_knee")),
        (i("right_knee"), i("right_ankle")),
        (i("neck"), i("left_hip")),
        (i("left_hip"), i("left_knee")),
        (i("left_knee"), i("left_ankle")),
        (i("neck"), i("right_shoulder")),
        (i("right_shoulder"), i("right_elbow")),
        (i("right_elbow"), i("right_wrist")),
        (i("right_shoulder"), i("right_eye")),
        (i("neck"), i("left_shoulder")),
        (i("left_shoulder"), i("left_elbow")),
        (i("left_elbow"), i("left_wrist")),
        (i("left_shoulder"), i("left_eye")),
        (i("neck"), i("nose")),
        (i("nose"), i("right_eye")),
        (i("nose"), i("left_eye")),
        (i("right_eye"), i("right_ear")),
        (i("left_eye"), i("left_ear")),
    )


COCO_LIMBS: tuple[tuple[int, int], ...] = _limbs()
COCO_NUM_LIMBS = len(COCO_LIMBS)  # 19

_SWAPS = (
    ("right_shoulder", "left_shoulder"), ("right_elbow", "left_elbow"),
    ("right_wrist", "left_wrist"), ("right_hip", "left_hip"),
    ("right_knee", "left_knee"), ("right_ankle", "left_ankle"),
    ("right_eye", "left_eye"), ("right_ear", "left_ear"),
)


def _swap_indices() -> tuple[int, ...]:
    """Joint k of a mirrored frame is joint COCO_SWAP_INDICES[k] of the frame."""
    m = {}
    for a, b in _SWAPS:
        m[a] = COCO_KEYPOINT_NAMES.index(b)
        m[b] = COCO_KEYPOINT_NAMES.index(a)
    return tuple(m.get(n, i) for i, n in enumerate(COCO_KEYPOINT_NAMES))


COCO_SWAP_INDICES: tuple[int, ...] = _swap_indices()
