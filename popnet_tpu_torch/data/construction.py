"""Dataset construction: raw recordings -> the benchmark's file layout, and
the frozen MP-3DHP test sets (the port's copy of
`popnet_tpu/data/construction.py`).

- `compute_pose_weights`: pose-rarity weights, the Huber-transformed
  standardized distance of each pose to the set's mean pose in its pelvis
  frame (`core.camera.approx_root_orientation`);
- `compute_bbox_from_joints`: a clamped joints + margin box;
- `convert_itop_h5`: ITOP's h5 release -> per-frame `.npy` + labels (h5py
  is imported only there);
- `convert_raw_kdh3d_recordings`, `convert_raw_bg_recordings`,
  `convert_raw_kdh3d_mp_recordings`, `convert_kinect_raw_mp_frames`,
  `filter_labels_by_reference_dir`: the raw MP-3DHP recordings and
  captures -> depth, mask and label files;
- `generate_bgaug_set`, `generate_mpaug_set`: freeze the stochastic bg-aug
  and mp-aug composites (optionally with the freeze-time Rotate,
  RenderDepth and Resize of `freeze_augment_pipeline`) into static test
  sets: `depth_maps/%08d.npy` float32 clipped to the depth range and
  `labels_test.json`.

Every converter writes the files the JAX package writes, byte for byte
(NumPy and json on the host). The frozen sets do too: the composite runs
on the dataset's device (`load_composited_device`), or with
`device=False` in NumPy on the host (`load_composited`), and the
freeze-time transforms (`data.augment_host`, torch) run where the
composite lies; for the {0, 1} masks the benchmark ships both routes give
the same bytes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from popnet_tpu_torch.core.camera import approx_root_orientation
from popnet_tpu_torch.core.skeleton import KEYPOINT_NAMES


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: str, indent: int | None = None) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)


def compute_pose_weights(joints3d: np.ndarray, root_id=None, hip_left_id=None,
                         hip_right_id=None, neck_id=None):
    """Pose-rarity weights for (N, K, 3) world-frame poses.

    Canonicalize each pose into its pelvis frame, standardize per joint
    coordinate over the set, take the per-joint Euclidean z-score distance,
    apply the reference's smooth quadratic-to-linear transform, and average
    over joints. Returns (weights (N,), mean (1, K-1, 3), std (1, K-1, 3)).
    """
    names = list(KEYPOINT_NAMES)
    root_id = names.index("torso") if root_id is None else root_id
    hip_left_id = names.index("left_hip") if hip_left_id is None else hip_left_id
    hip_right_id = names.index("right_hip") if hip_right_id is None else hip_right_id
    neck_id = names.index("neck") if neck_id is None else neck_id

    self_poses = joints3d - joints3d[:, root_id : root_id + 1, :]
    root_axis = approx_root_orientation(
        joints3d[:, hip_left_id, :], joints3d[:, hip_right_id, :], joints3d[:, neck_id, :]
    )
    self_poses = np.einsum("nkj,njm->nkm", self_poses, root_axis)
    self_poses = np.delete(self_poses, root_id, axis=1)

    not_nan = self_poses[~np.isnan(self_poses).any(axis=2).any(axis=1)]
    mean = np.mean(not_nan, axis=0).reshape(1, -1, 3)
    std = np.std(not_nan, axis=0).reshape(1, -1, 3)

    dists = np.sqrt(np.sum(((self_poses - mean) / std) ** 2, axis=2))
    dists = np.where(dists < 1, dists**2 / 2, dists - 0.5)
    return np.mean(dists, axis=1).astype(np.float32), mean, std


def compute_bbox_from_joints(joints2d, margin: float, height: int, width: int):
    """Clamped joints+margin box (reference: parse_raw_ITOP_dataset.py:24-52,
    joints-only path)."""
    j = np.asarray(joints2d)
    xmin = int(max(0, min(width, np.min(j[:, 0]) - margin)))
    ymin = int(max(0, min(height, np.min(j[:, 1]) - margin)))
    xmax = int(max(0, min(width, np.max(j[:, 0]) + margin)))
    ymax = int(max(0, min(height, np.max(j[:, 1]) + margin)))
    return [xmin, ymin, xmax, ymax]


def convert_itop_h5(depth_h5_path: str, labels_h5_path: str, out_dir: str,
                    joint2box_margin: float = 30.0, split: str = "train"):
    """ITOP h5 release -> per-frame depth .npy + labels.json in the
    benchmark layout (reference: parse_raw_ITOP_dataset.py:134-168)."""
    import h5py

    os.makedirs(os.path.join(out_dir, "depth_maps"), exist_ok=True)
    with h5py.File(depth_h5_path, "r") as df, h5py.File(labels_h5_path, "r") as lf:
        depth = df["data"]
        valid = np.asarray(lf["is_valid"])
        j2 = np.asarray(lf["image_coordinates"])
        j3 = np.asarray(lf["real_world_coordinates"])
        ids = [i.decode() if isinstance(i, bytes) else str(i) for i in lf["id"]]

        weights, _, _ = compute_pose_weights(j3[valid > 0])
        widx = np.cumsum(valid > 0) - 1

        labels = {}
        h, w = depth.shape[1], depth.shape[2]
        for i in range(depth.shape[0]):
            if valid[i] <= 0:
                continue
            name = f"{split}_{ids[i]}.npy"
            np.save(os.path.join(out_dir, "depth_maps", name),
                    np.asarray(depth[i], dtype=np.float32))
            labels[name] = [
                {
                    "2d_joints": j2[i].tolist(),
                    "3d_joints": j3[i].tolist(),
                    "bbox": compute_bbox_from_joints(j2[i], joint2box_margin, h, w),
                    "pose_weight": float(weights[widx[i]]),
                }
            ]
    _dump(labels, os.path.join(out_dir, f"labels_{split}.json"))
    return labels


def freeze_augment_pipeline(dcfg, rng, max_ratio: float = 1.2):
    """The freeze-time geometric transforms of the reference generator, on
    torch images (`data.augment_host`): Rotate about the principal point
    with the 3D labels rotated too (`is_3d=True`, as the JAX package keeps
    the 2D <-> 3D pinhole relation), RenderDepth up to `max_ratio`, Resize
    back to the frame size; each draws from `rng` in the JAX package's
    order."""
    from popnet_tpu_torch.data import augment_host as ah

    intr = dcfg.intrinsics
    return ah.Compose([
        ah.Cvt2ndarray(),
        ah.Rotate(cx=intr.cx, cy=intr.cy, is_3d=True, rng=rng),
        ah.RenderDepth(cx=intr.cx, cy=intr.cy, max_ratio=max_ratio, rng=rng),
        ah.Resize(dcfg.width, dcfg.height),
    ])


def _freeze(dataset, out_dir: str, n_images: int | None = None,
            label_name: str = "labels_test.json", device: bool = True,
            augment: bool = False) -> dict:
    """Write frames 0 .. n - 1 of `dataset` (index i % len) as a frozen set;
    the composite (on the dataset's device, or with `device=False` the
    NumPy host route, as the JAX package composites by default) goes
    through the freeze-time transforms where it lies, then to the host,
    where it is clipped to [0, depth.max] as float32 and saved."""
    depth_dir = os.path.join(out_dir, "depth_maps")
    os.makedirs(depth_dir, exist_ok=True)
    labels = {}
    n = n_images or len(dataset)
    composite = dataset.load_composited_device if device else dataset.load_composited
    pipeline = freeze_augment_pipeline(dataset.dcfg, dataset.rng) if augment else None
    for i in range(n):
        depth, anns = composite(i % len(dataset))
        if pipeline is not None:
            depth, anns = pipeline((torch.as_tensor(depth), anns))
        if isinstance(depth, torch.Tensor):
            depth = depth.cpu().numpy()
        depth = np.clip(depth, 0.0, dataset.dcfg.depth.max)
        name = f"{i:08d}.npy"
        np.save(os.path.join(depth_dir, name), depth.astype(np.float32))
        labels[name] = [
            {
                "2d_joints": np.asarray(a["2d_joints"]).tolist(),
                "3d_joints": np.asarray(a["3d_joints"]).tolist(),
                "bbox": np.asarray(a["bbox"]).tolist(),
                **({"pose_weight": a["pose_weight"]} if "pose_weight" in a else {}),
            }
            for a in anns
        ]
    _dump(labels, os.path.join(out_dir, label_name), indent=2)
    return labels


def generate_bgaug_set(dataset, out_dir: str, n_images: int | None = None,
                       device: bool = True, augment: bool = False) -> dict:
    """Freeze the bg-aug composite of a `KDH3DDataset(bg_aug=True,
    augment=False)` into a static test set; `device` composites on the
    dataset's device (False: in NumPy on the host, the same bytes),
    `augment` adds `freeze_augment_pipeline`."""
    return _freeze(dataset, out_dir, n_images, device=device, augment=augment)


def generate_mpaug_set(dataset, out_dir: str, n_images: int | None = None,
                       device: bool = True, augment: bool = False) -> dict:
    """Freeze the mp-aug composite of a `KDH3DMPAugDataset(augment=False)`
    into a static test set; device and augment as in `generate_bgaug_set`."""
    return _freeze(dataset, out_dir, n_images, device=device, augment=augment)


# Kinect raw joint names used by the KDH3D recordings
# (reference: parse_raw_KDH3D_dataset.py:32-41 joint_names; the 15-joint
# subset maps onto the ITOP skeleton order)
KINECT_JOINT_SUBSET = (
    "HEAD", "NECK", "SHOULDER_RIGHT", "SHOULDER_LEFT", "ELBOW_RIGHT",
    "ELBOW_LEFT", "WRIST_RIGHT", "WRIST_LEFT", "SPINE_NAVAL", "HIP_RIGHT",
    "HIP_LEFT", "KNEE_RIGHT", "KNEE_LEFT", "ANKLE_RIGHT", "ANKLE_LEFT",
)


def convert_raw_kdh3d_recordings(
    depth_data_files, out_dir: str, train_files=None, joint_subset=KINECT_JOINT_SUBSET,
):
    """Raw KDH3D recordings -> per-frame depth/seg .npy + label JSONs.

    Each recording is a stack: <name>.npy (N, H, W) depth in mm,
    <name>_mask.npy seg stacks, <name>_label.json with
    {3D_joint_positions (mm), 2D_joint_positions, bounding_boxes,
    joint_names, intrinsics}, <name>_drop.json {drop_list}. Converts mm -> m,
    selects the 15-joint subset, attaches pose-rarity weights, and writes
    labels.json / labels_train.json / labels_test.json
    (reference: parse_raw_KDH3D_dataset.py:128-230).
    """
    depth_out = os.path.join(out_dir, "depth_maps")
    seg_out = os.path.join(out_dir, "seg_maps")
    os.makedirs(depth_out, exist_ok=True)
    os.makedirs(seg_out, exist_ok=True)
    train_files = set(train_files) if train_files is not None else set(depth_data_files)

    # pass 1: gather all 3D poses for the rarity statistics
    all_poses = []
    per_file = []
    intrinsics = None
    for depth_file in depth_data_files:
        stem = depth_file[: depth_file.rfind(".")]
        annos = _load(f"{stem}_label.json")
        drop = set(_load(f"{stem}_drop.json")["drop_list"])
        j3 = np.asarray(annos["3D_joint_positions"], dtype=np.float64) / 1000.0
        keep = [i for i in range(j3.shape[0]) if i not in drop]
        sub = [annos["joint_names"].index(n) for n in joint_subset]
        j3 = j3[keep][:, sub]
        j2 = np.asarray(annos["2D_joint_positions"], dtype=np.float64)[keep][:, sub]
        bb = np.asarray(annos["bounding_boxes"], dtype=np.float64)[keep]
        intrinsics = annos.get("intrinsics", intrinsics)
        per_file.append((depth_file, stem, keep, j2, j3, bb))
        all_poses.append(j3)

    weights, mean, std = compute_pose_weights(np.concatenate(all_poses, 0))

    labels, labels_train, labels_test = {}, {}, {}
    img_id = 0
    for depth_file, stem, keep, j2, j3, bb in per_file:
        depth_maps = np.load(depth_file).astype(np.float32)[keep] / 1000.0
        seg_maps = np.load(f"{stem}_mask.npy")[keep]
        is_train = depth_file in train_files
        for i in range(depth_maps.shape[0]):
            name = f"{img_id:08d}.npy"
            np.save(os.path.join(depth_out, name), depth_maps[i])
            np.save(os.path.join(seg_out, name), seg_maps[i])
            ann = {
                "2d_joints": j2[i].tolist(),
                "3d_joints": j3[i].tolist(),
                "bbox": bb[i].tolist(),
                "pose_weight": float(weights[img_id]),
            }
            labels[name] = [ann]
            (labels_train if is_train else labels_test)[name] = [ann]
            img_id += 1

    for d in (labels, labels_train, labels_test):
        if intrinsics is not None:
            d["intrinsics"] = intrinsics
    _dump(labels, os.path.join(out_dir, "labels.json"))
    _dump(labels_train, os.path.join(out_dir, "labels_train.json"))
    _dump(labels_test, os.path.join(out_dir, "labels_test.json"))
    return labels, mean, std


def convert_raw_bg_recordings(bg_data_files, out_dir: str):
    """Raw background recordings -> bg_maps/*.npy + labels_bg.json
    (reference: parse_raw_KDH3D_bg.py). Depth stacks in mm."""
    bg_out = os.path.join(out_dir, "bg_maps")
    os.makedirs(bg_out, exist_ok=True)
    index = {}
    img_id = 0
    for f in bg_data_files:
        stack = np.load(f).astype(np.float32) / 1000.0
        for i in range(stack.shape[0]):
            name = f"bg_{img_id:06d}.npy"
            np.save(os.path.join(bg_out, name), stack[i])
            index[str(img_id)] = {"file_name": name}
            img_id += 1
    _dump(index, os.path.join(out_dir, "labels_bg.json"))
    return index


def convert_raw_kdh3d_mp_recordings(depth_data_files, out_dir: str,
                                    joint_subset=KINECT_JOINT_SUBSET,
                                    label_name: str = "labels_test.json"):
    """Raw MULTI-PERSON KDH3D recordings -> per-frame .npy + labels.

    Like convert_raw_kdh3d_recordings but each frame's label file carries
    per-person lists (3D_joint_positions[i][j]) and 3D is mm -> m; no seg
    masks or pose weights for real mp test captures
    (reference: parse_raw_KDH3D_dataset_mp_test.py:57-176,
    parse_raw_KDH3D_dataset_mp_train.py).
    """
    depth_out = os.path.join(out_dir, "depth_maps")
    os.makedirs(depth_out, exist_ok=True)

    labels = {}
    intrinsics = None
    img_id = 0
    for depth_file in depth_data_files:
        stem = depth_file[: depth_file.rfind(".")]
        annos = _load(f"{stem}_label.json")
        depth_maps = np.load(depth_file).astype(np.float32)
        if depth_maps.max() > 100:  # raw stacks are mm
            depth_maps = depth_maps / 1000.0
        sub = [annos["joint_names"].index(n) for n in joint_subset]
        intrinsics = annos.get("intrinsics", intrinsics)
        j3_all = annos["3D_joint_positions"]
        j2_all = annos["2D_joint_positions"]
        bb_all = annos["bounding_boxes"]
        for i in range(depth_maps.shape[0]):
            name = f"{img_id:08d}.npy"
            np.save(os.path.join(depth_out, name), depth_maps[i])
            labels[name] = []
            for j in range(len(j3_all[i])):
                j2 = np.asarray(j2_all[i][j], dtype=np.float64)[sub]
                j3 = np.asarray(j3_all[i][j], dtype=np.float64)[sub] / 1000.0
                labels[name].append(
                    {
                        "2d_joints": j2.tolist(),
                        "3d_joints": j3.tolist(),
                        "bbox": list(bb_all[i][j]),
                    }
                )
            img_id += 1

    if intrinsics is not None:
        labels["intrinsics"] = intrinsics
    _dump(labels, os.path.join(out_dir, label_name))
    return labels


# Azure-Kinect 32-joint body-tracking order
# (reference: parse_kinect_raw_mp.py:110-117)
KINECT32_JOINT_NAMES = (
    "PELVIS", "SPINE_NAVAL", "SPINE_CHEST", "NECK", "CLAVICLE_LEFT",
    "SHOULDER_LEFT", "ELBOW_LEFT", "WRIST_LEFT", "HAND_LEFT", "HANDTIP_LEFT",
    "THUMB_LEFT", "CLAVICLE_RIGHT", "SHOULDER_RIGHT", "ELBOW_RIGHT",
    "WRIST_RIGHT", "HAND_RIGHT", "HANDTIP_RIGHT", "THUMB_RIGHT", "HIP_LEFT",
    "KNEE_LEFT", "ANKLE_LEFT", "FOOT_LEFT", "HIP_RIGHT", "KNEE_RIGHT",
    "ANKLE_RIGHT", "FOOT_RIGHT", "HEAD", "NOSE", "EYE_LEFT", "EAR_LEFT",
    "EYE_RIGHT", "EAR_RIGHT",
)


def compute_2d_bbox_from_3d_joints(joints3d: np.ndarray, joint_sz_3d, K: np.ndarray):
    """Project per-joint 3D extents (+-joint_sz in X and Y at the joint's
    depth) and take the 2D envelope — the box construction of the raw
    multi-person capture conversion
    (reference: parse_kinect_raw_mp.py:154-176)."""
    j = np.asarray(joints3d, dtype=np.float64)
    sz = np.asarray(joint_sz_3d, dtype=np.float64)

    def proj(pts):
        p = (K @ pts.T)
        return (p[:2] / p[2]).T

    xmin = np.min(proj(j - np.stack([sz, 0 * sz, 0 * sz], 1))[:, 0])
    xmax = np.max(proj(j + np.stack([sz, 0 * sz, 0 * sz], 1))[:, 0])
    ymin = np.min(proj(j - np.stack([0 * sz, sz, 0 * sz], 1))[:, 1])
    ymax = np.max(proj(j + np.stack([0 * sz, sz, 0 * sz], 1))[:, 1])
    return [float(xmin), float(ymin), float(xmax), float(ymax)]


def convert_kinect_raw_mp_frames(
    depth_stack: np.ndarray,       # (N, H2, W2) target-sensor depth, mm
    joints3d_per_frame,            # list of (P_i, 32, 3) kinect-frame mm
    K_target: np.ndarray,          # 3x3 target intrinsics (after crop offset)
    R: np.ndarray, T: np.ndarray,  # kinect -> target extrinsics (mm)
    out_dir: str,
    crop_x: int = 100, crop_y: int = 32,
    img_width: int = 480, img_height: int = 512,
    joint_sizes=None,
    label_name: str = "labels.json",
):
    """Synchronized raw multi-person capture -> benchmark files.

    Per frame: transform the 32-joint kinect skeletons into the target
    sensor frame, select the 15-joint subset, project, crop the depth map
    (and shift 2D coords) to img_width x img_height, convert mm -> m, and
    compute bboxes from per-joint 3D extents
    (reference: parse_kinect_raw_mp.py:121-364). Array-based so the caller
    owns the capture container format.
    """
    os.makedirs(os.path.join(out_dir, "depth_maps"), exist_ok=True)
    sub = [KINECT32_JOINT_NAMES.index(n) for n in KINECT_JOINT_SUBSET]
    if joint_sizes is None:
        # default joint extents (mm): head biggest, limbs smaller
        joint_sizes = np.full(len(sub), 100.0)
        joint_sizes[0] = 120.0

    Kc = np.asarray(K_target, dtype=np.float64).copy()
    # cropping shifts the principal point
    Kc[0, 2] -= crop_x
    Kc[1, 2] -= crop_y

    labels = {}
    for i in range(depth_stack.shape[0]):
        crop = depth_stack[i, crop_y : crop_y + img_height, crop_x : crop_x + img_width]
        name = f"{i:08d}.npy"
        np.save(os.path.join(out_dir, "depth_maps", name),
                (crop.astype(np.float32) / 1000.0))
        labels[name] = []
        for person in joints3d_per_frame[i]:
            j3_k = np.asarray(person, dtype=np.float64)[sub]  # (15, 3) mm
            j3_t = j3_k @ np.asarray(R, dtype=np.float64).T + np.asarray(T, dtype=np.float64).reshape(1, 3)
            p = Kc @ j3_t.T
            j2 = (p[:2] / p[2]).T
            bbox = compute_2d_bbox_from_3d_joints(j3_t, joint_sizes, Kc)
            labels[name].append(
                {
                    "2d_joints": j2.tolist(),
                    "3d_joints": (j3_t / 1000.0).tolist(),
                    "bbox": bbox,
                }
            )
    labels["intrinsics"] = {
        "fx": float(Kc[0, 0]), "fy": float(Kc[1, 1]),
        "cx": float(Kc[0, 2]), "cy": float(Kc[1, 2]),
    }
    _dump(labels, os.path.join(out_dir, label_name))
    return labels


def filter_labels_by_reference_dir(
    labels_json: str, reference_dir: str, out_json: str, ext: str = ".jpg"
):
    """Keep only the label entries whose visually-verified reference image
    exists — the manual-refinement pass applied to the multi-person test
    split (reference: parse_KDH3D_dataset_mp_refine.py:60-85: entry key
    ``./depth_maps/<name>.npy`` is kept iff ``<ref_dir>/<name>.jpg``
    survived the human screen). Non-frame keys (e.g. ``intrinsics``) pass
    through untouched. Returns the filtered dict after writing it."""
    labels = _load(labels_json)
    out = {}
    for key, val in labels.items():
        if not key.endswith(".npy"):
            out[key] = val
            continue
        stem = os.path.splitext(os.path.basename(key))[0]
        if os.path.exists(os.path.join(reference_dir, stem + ext)):
            out[key] = val
    _dump(out, out_json, indent=4)
    return out
