"""MPII RGB keypoints: the 16-joint skeleton, label parsing and the
training dataset of PopNetRGB (the port of `popnet_tpu/data/mpii.py`).

Labels: the standard MPII JSON release (`prepare_mpii_labels`) or the
official RELEASE .mat (`prepare_mpii_labels_from_mat`, through
scipy.io.loadmat), per-joint visibility from the image border
(`assign_visibility_from_border`) and boxes from the visible joints
(`bbox_from_visible_joints`), NumPy, exact.

`MPIIKeypointsDataset`: per frame, the flip draw, then (on a pool of
threads) the JPEG read as cv2.imread reads it, cv2's uint8 letterbox resize
into the top-left of a zero canvas, the visibility from the border and the
GT flags, the joints scaled (mirrored with the left/right swap on a flip:
the JAX dataset mirrors the labels and leaves the image, and so does this
one), people with no visible joint left out, boxes from the visible
joints with a 10-pixel margin. On the dataset's device: the ImageNet
normalization rounded as the JAX dataset's NumPy one, and the targets of
the whole batch (`encode_mpii_batch`): heatmaps of the in-bounds joints,
align maps of the visible ones only (invisible joints pushed to -1e6
first), and the prior with the visibility in the z slot under identity
depth statistics (5 + 3K channels an anchor).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from popnet_tpu_torch.core.config import DepthStats, EncoderConfig
from popnet_tpu_torch.core.device import resolve_device
from popnet_tpu_torch.data.augment_host import resize_linear_u8
from popnet_tpu_torch.data.coco_dataset import RGBDataset
from popnet_tpu_torch.data.image_io import imread_bgr
from popnet_tpu_torch.data.preprocessing import preprocess_divided
from popnet_tpu_torch.ops.encoders import (encode_alignmaps, encode_heatmaps,
                                           encode_prior_targets)

# MPII 16-joint order
MPII_KEYPOINT_NAMES: tuple[str, ...] = (
    "ANKLE_RIGHT", "KNEE_RIGHT", "HIP_RIGHT", "HIP_LEFT", "KNEE_LEFT",
    "ANKLE_LEFT", "PELVIS", "THORAX", "UPPER_NECK", "HEAD_TOP",
    "WRIST_RIGHT", "ELBOW_RIGHT", "SHOULDER_RIGHT", "SHOULDER_LEFT",
    "ELBOW_LEFT", "WRIST_LEFT",
)
MPII_NUM_JOINTS = len(MPII_KEYPOINT_NAMES)  # 16


def _mpii_limbs() -> tuple[tuple[int, int], ...]:
    i = MPII_KEYPOINT_NAMES.index
    return (
        (i("PELVIS"), i("HIP_RIGHT")), (i("HIP_RIGHT"), i("KNEE_RIGHT")),
        (i("KNEE_RIGHT"), i("ANKLE_RIGHT")), (i("PELVIS"), i("HIP_LEFT")),
        (i("HIP_LEFT"), i("KNEE_LEFT")), (i("KNEE_LEFT"), i("ANKLE_LEFT")),
        (i("PELVIS"), i("THORAX")), (i("THORAX"), i("UPPER_NECK")),
        (i("UPPER_NECK"), i("HEAD_TOP")), (i("THORAX"), i("SHOULDER_RIGHT")),
        (i("SHOULDER_RIGHT"), i("ELBOW_RIGHT")), (i("ELBOW_RIGHT"), i("WRIST_RIGHT")),
        (i("THORAX"), i("SHOULDER_LEFT")), (i("SHOULDER_LEFT"), i("ELBOW_LEFT")),
        (i("ELBOW_LEFT"), i("WRIST_LEFT")),
    )


MPII_LIMBS = _mpii_limbs()

_SWAPS = (
    ("ANKLE_RIGHT", "ANKLE_LEFT"), ("KNEE_RIGHT", "KNEE_LEFT"),
    ("HIP_RIGHT", "HIP_LEFT"), ("WRIST_RIGHT", "WRIST_LEFT"),
    ("ELBOW_RIGHT", "ELBOW_LEFT"), ("SHOULDER_RIGHT", "SHOULDER_LEFT"),
)


def _swap_indices() -> tuple[int, ...]:
    m = {}
    for a, b in _SWAPS:
        m[a] = MPII_KEYPOINT_NAMES.index(b)
        m[b] = MPII_KEYPOINT_NAMES.index(a)
    return tuple(m.get(n, i) for i, n in enumerate(MPII_KEYPOINT_NAMES))


MPII_SWAP_INDICES = _swap_indices()


def prepare_mpii_labels(annotation_json: str, istrain: bool = True) -> dict:
    """The MPII JSON release ([{"image", "joints", "joints_vis"}, ...]) ->
    {image: [{"2d_joints", "visible_joints"}, ...]} (empty lists without
    `istrain`)."""
    with open(annotation_json) as f:
        annos = json.load(f)
    out: dict[str, list] = {}
    for a in annos:
        out.setdefault(a["image"], [])
        if istrain:
            out[a["image"]].append({"2d_joints": a["joints"], "visible_joints": a["joints_vis"]})
    return out


def assign_visibility_from_border(anns, height: int, width: int, margin: int = 3,
                                  intersect_gt: bool = False) -> list:
    """Each person's "visible_joints" set to the joints at least `margin`
    inside the image (and, with `intersect_gt`, flagged visible in the
    labels); copies of the annotations."""
    out = []
    for ann in anns:
        ann = dict(ann)
        j = np.asarray(ann["2d_joints"], dtype=np.float64)
        vis = ((j[:, 0] >= margin) & (j[:, 0] < width - margin)
               & (j[:, 1] >= margin) & (j[:, 1] < height - margin))
        if intersect_gt and "visible_joints" in ann:
            vis = vis & (np.asarray(ann["visible_joints"]) != 0)
        ann["visible_joints"] = vis.astype(np.int64).tolist()
        out.append(ann)
    return out


def bbox_from_visible_joints(ann, margin: float = 25.0) -> list:
    """[x0, y0, x1, y1] of the visible joints (all joints where none is)
    grown by `margin`."""
    j = np.asarray(ann["2d_joints"], dtype=np.float64)
    vis = np.asarray(ann.get("visible_joints", np.ones(len(j)))) > 0
    jv = j[vis] if vis.any() else j
    return [float(jv[:, 0].min() - margin), float(jv[:, 1].min() - margin),
            float(jv[:, 0].max() + margin), float(jv[:, 1].max() + margin)]


def _unwrap(a):
    """Peel size-1 object-array wrappers (loadmat's nesting varies)."""
    while isinstance(a, np.ndarray) and a.dtype == object and a.size == 1:
        a = a.reshape(-1)[0]
    return a


def _cells(a):
    """The entries of a MATLAB cell or struct array."""
    a = _unwrap(a) if isinstance(a, np.ndarray) and a.dtype == object and a.size == 1 else a
    if isinstance(a, np.ndarray):
        return list(a.reshape(-1))
    return [a]


def _scalar(a):
    a = _unwrap(a)
    if isinstance(a, np.ndarray):
        return a.reshape(-1)[0]
    return a


def prepare_mpii_labels_from_mat(mat_path: str, train_only: bool = True) -> dict:
    """The official RELEASE .mat -> {image: [{"2d_joints" (16 by joint id,
    (-1, -1) where absent), "visible_joints", "head_rect"}, ...]}: the
    training images (all with `train_only` False), the people with
    annotated points and visibility flags; robust to loadmat's varying
    object-array nesting."""
    import scipy.io as sio

    mat = sio.loadmat(mat_path)
    release = _unwrap(mat["RELEASE"])
    annolist = _cells(release["annolist"])
    img_train = np.asarray(_unwrap(release["img_train"])).reshape(-1)
    out: dict[str, list] = {}
    for anno, train_flag in zip(annolist, img_train):
        if train_only and not int(train_flag):
            continue
        anno = _unwrap(anno)
        image = _unwrap(anno["image"])
        img_fn = str(_scalar(image["name"]))
        rects_arr = anno["annorect"]
        if "annopoints" not in str(getattr(_unwrap(rects_arr), "dtype", "")):
            continue
        for rect in _cells(rects_arr):
            rect = _unwrap(rect)
            try:
                head_rect = [float(_scalar(rect["x1"])), float(_scalar(rect["y1"])),
                             float(_scalar(rect["x2"])), float(_scalar(rect["y2"]))]
                pts = _unwrap(_unwrap(rect["annopoints"])["point"])
            except (ValueError, IndexError, KeyError, TypeError):
                continue
            if getattr(pts, "size", 0) == 0:
                continue
            j_ids = [int(_scalar(v)) for v in _cells(pts["id"])]
            xs = [float(_scalar(v)) for v in _cells(pts["x"])]
            ys = [float(_scalar(v)) for v in _cells(pts["y"])]
            if "is_visible" not in str(pts.dtype):
                continue
            vis_raw = []
            for v in _cells(pts["is_visible"]):
                v = _unwrap(v)
                vis_raw.append(int(_scalar(v)) if getattr(v, "size", 1) else 0)
            joints = np.full((MPII_NUM_JOINTS, 2), -1.0)
            vis = np.zeros(MPII_NUM_JOINTS, dtype=int)
            for j_id, x, y, v in zip(j_ids, xs, ys, vis_raw):
                if 0 <= j_id < MPII_NUM_JOINTS:
                    joints[j_id] = (x, y)
                    vis[j_id] = v
            out.setdefault(img_fn, []).append({"2d_joints": joints.tolist(),
                                               "visible_joints": vis.tolist(),
                                               "head_rect": head_rect})
    return out


def mpii_anchors(input_y: int = 368, stride_prior: int = 16):
    """The default anchors: h = input_y / stride_prior - 3, ((h/2, h/4),
    (h, h/2)) as (w, h)."""
    h = input_y / stride_prior - 3
    return ((h / 2, h / 4), (h, h / 2))


IDENTITY_DEPTH = DepthStats(mean=0.0, std=1.0, max=1.0)


def encode_mpii_batch(joints2d, vis, valid, bboxes, weights, ecfg: EncoderConfig) -> dict:
    """A batch's PopNetRGB targets on the tensors' device: joints2d (B, P,
    16, 2), vis (B, P, 16), valid (B, P) bool, bboxes (B, P, 4), weights
    (B, P) -> {"heatmaps", "align_maps", "fg_masks_align", "prior_map",
    "prior_mask_conf", "prior_mask_coord", "prior_weight_map"}."""
    heat = encode_heatmaps(joints2d, valid, ecfg)
    far = torch.full((), -1e6, dtype=joints2d.dtype, device=joints2d.device)
    amap, afg = encode_alignmaps(torch.where(vis[..., None] > 0, joints2d, far), valid, ecfg)
    prior, mconf, mcoord, wmap = encode_prior_targets(bboxes, joints2d, vis, weights, valid, ecfg,
                                                      IDENTITY_DEPTH)
    return {"heatmaps": heat, "align_maps": amap, "fg_masks_align": afg, "prior_map": prior,
            "prior_mask_conf": mconf, "prior_mask_coord": mcoord, "prior_weight_map": wmap}


class MPIIKeypointsDataset(RGBDataset):
    """Batched MPII RGB frames for PopNetRGB training on `device` (see the
    module docstring): batches of `encode_mpii_batch`'s targets and
    "image" (B, input_y, input_x, 3) float32."""

    def __init__(self, img_dir: str, ann_file: str, input_y: int = 368, input_x: int = 368,
                 stride: int = 8, stride_prior: int = 16, align_radius: int = 3,
                 max_people: int = 8, is_train: bool = True, hflip: bool = True, seed: int = 0,
                 border_margin: int = 3, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.img_dir = img_dir
        self.anno_dic = prepare_mpii_labels(ann_file, istrain=True)
        self.ids = list(self.anno_dic.keys())
        self.ecfg = EncoderConfig(input_x=input_x, input_y=input_y, stride=stride,
                                  stride_align=stride, stride_prior=stride_prior,
                                  align_radius=align_radius, num_joints=MPII_NUM_JOINTS,
                                  num_limbs=len(MPII_LIMBS),
                                  anchors=mpii_anchors(input_y, stride_prior),
                                  max_people=max_people)
        self.is_train = is_train
        self.hflip = hflip and is_train
        self.border_margin = border_margin
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.ids)

    def load_frame(self, index: int, flip: bool):
        """Frame `index` with its flip draw -> (uint8 canvas, joints (P, 16,
        2) float64, vis (P, 16), valid (P,), boxes (P, 4), weights (P,))."""
        fname = self.ids[index]
        img = imread_bgr(os.path.join(self.img_dir, fname))
        h, w = img.shape[:2]
        anns = assign_visibility_from_border(self.anno_dic[fname], h, w,
                                             margin=self.border_margin, intersect_gt=True)
        iy, ix = self.ecfg.input_y, self.ecfg.input_x
        scale = min(iy / h, ix / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        canvas = np.zeros((iy, ix, 3), np.uint8)
        canvas[:nh, :nw] = resize_linear_u8(img, nw, nh)

        P, K = self.ecfg.max_people, MPII_NUM_JOINTS
        joints = np.full((P, K, 2), -1.0)
        vis = np.zeros((P, K), np.float32)
        valid = np.zeros(P, bool)
        boxes = np.zeros((P, 4), np.float32)
        weights = np.ones(P, np.float32)
        for p, ann in enumerate(anns[:P]):
            v = (np.asarray(ann["visible_joints"]) != 0).astype(np.float32)
            if v.sum() == 0:
                continue        # a person with no visible joint is left out
            j = np.asarray(ann["2d_joints"], np.float64) * scale
            if flip:
                j[:, 0] = ix - 1 - j[:, 0]
                j = j[list(MPII_SWAP_INDICES)]
                v = v[list(MPII_SWAP_INDICES)]
            joints[p], vis[p], valid[p] = j, v, True
            boxes[p] = bbox_from_visible_joints({"2d_joints": j.tolist(),
                                                 "visible_joints": v.tolist()}, margin=10.0)
            weights[p] = float(ann.get("pose_weight", 1.0))
        return canvas, joints, vis, valid, boxes, weights

    def get_batch_host(self, indices):
        """The host stage: the flip draws in order, then the frames on the
        pool -> (canvases uint8, joints float32, vis, valid, boxes, weights)."""
        items = [(int(i), bool(self.hflip and self.rng.random() < 0.5)) for i in indices]
        frames = self.map_frames(self.load_frame, items)
        canvas, joints, vis, valid, boxes, weights = (np.stack(x) for x in zip(*frames))
        return canvas, joints.astype(np.float32), vis, valid, boxes, weights

    def to_device(self, host) -> dict:
        canvas, joints, vis, valid, boxes, weights = host
        dev = self.device
        t = [torch.from_numpy(a).to(dev) for a in (joints, vis, valid, boxes, weights)]
        batch = encode_mpii_batch(*t, self.ecfg)
        batch["image"] = preprocess_divided(torch.from_numpy(canvas).to(dev), "vgg")
        return batch
