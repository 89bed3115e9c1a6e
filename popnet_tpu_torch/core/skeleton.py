"""The 15-joint ITOP body model (joint order, the 14 limbs and the flip's
left/right swap).

The port's own copy of `popnet_tpu/core/skeleton.py:12-82`: the limb order
fixes the PAF channel order and the assembly order, so it must not drift.
"""

from __future__ import annotations

KEYPOINT_NAMES: tuple[str, ...] = (
    "head",
    "neck",
    "right_shoulder",
    "left_shoulder",
    "right_elbow",
    "left_elbow",
    "right_wrist",
    "left_wrist",
    "torso",
    "right_hip",
    "left_hip",
    "right_knee",
    "left_knee",
    "right_ankle",
    "left_ankle",
)

NUM_JOINTS = len(KEYPOINT_NAMES)  # 15


def _limbs() -> tuple[tuple[int, int], ...]:
    """The 14 limb (src, dst) pairs, in PAF channel order."""
    i = KEYPOINT_NAMES.index
    return (
        (i("torso"), i("right_hip")),
        (i("right_hip"), i("right_knee")),
        (i("right_knee"), i("right_ankle")),
        (i("torso"), i("left_hip")),
        (i("left_hip"), i("left_knee")),
        (i("left_knee"), i("left_ankle")),
        (i("torso"), i("neck")),
        (i("neck"), i("right_shoulder")),
        (i("right_shoulder"), i("right_elbow")),
        (i("right_elbow"), i("right_wrist")),
        (i("neck"), i("left_shoulder")),
        (i("left_shoulder"), i("left_elbow")),
        (i("left_elbow"), i("left_wrist")),
        (i("neck"), i("head")),
    )


LIMBS: tuple[tuple[int, int], ...] = _limbs()
NUM_LIMBS = len(LIMBS)  # 14

# left/right joint swap of the horizontal flip augmentation
_SWAP_PAIRS = (
    ("right_shoulder", "left_shoulder"),
    ("right_elbow", "left_elbow"),
    ("right_wrist", "left_wrist"),
    ("right_hip", "left_hip"),
    ("right_knee", "left_knee"),
    ("right_ankle", "left_ankle"),
)


def _swap_indices() -> tuple[int, ...]:
    mapping = {}
    for a, b in _SWAP_PAIRS:
        mapping[a] = KEYPOINT_NAMES.index(b)
        mapping[b] = KEYPOINT_NAMES.index(a)
    return tuple(mapping.get(name, i) for i, name in enumerate(KEYPOINT_NAMES))


SWAP_INDICES: tuple[int, ...] = _swap_indices()
