"""The COCO RGB keypoint training dataset (the port of
`popnet_tpu/data/coco_dataset.py`).

Host stage (NumPy, `get_batch_host`): each frame's draws from the
dataset's `np.random.Generator` in the JAX dataset's order (rotation, blur
sigma, scale jitter, flip: `_draws`), then, on a pool of threads, the
frame itself (`load_frame`): the JPEG read as cv2.imread reads it
(`image_io.imread_bgr`), the rotation with canvas expansion
(`rotate_bound`, cv2's cubic warp on a grey 128 border), the blur
(`blur_image`, scipy's as the JAX dataset calls it), the letterbox scale
(with the jitter folded in, clamped so the canvas always fits) and cv2's
uint8 resize into the top-left of a zero canvas, and the labels: COCO-17
to the rtpose-18 order with the neck (`add_neck`), rotated with the
image, scaled, off-input joints to the (-1, -1) hole, mirrored with the
left/right swap on a flip. Device stage (`to_device`): the uint8 canvases
are normalized on the dataset's device, rounded as the JAX dataset's NumPy
normalization rounds them (`preprocessing.preprocess_divided`), and the
COCO-18 heatmaps and 19-limb PAFs are painted there for the whole batch
(`encode_coco_batch`). One seed gives the JAX dataset's images bit for bit
and its maps within the encoders' bars, and leaves the generator where the
JAX dataset leaves it.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from popnet_tpu_torch.core.config import EncoderConfig
from popnet_tpu_torch.core.device import resolve_device
from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS, COCO_SWAP_INDICES
from popnet_tpu_torch.data.augment_host import (get_rotation_matrix_2d, resize_linear_u8,
                                                warp_affine_cubic_u8)
from popnet_tpu_torch.data.datasets import PREFETCH, _pipeline_iter
from popnet_tpu_torch.data.image_io import imread_bgr
from popnet_tpu_torch.data.preprocessing import preprocess_divided
from popnet_tpu_torch.ops.encoders import encode_heatmaps, encode_pafs

# COCO-17 index -> rtpose-18 order, applied after the neck row is appended at index 17
OUR_ORDER = (0, 17, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3)
ROTATE_BORDER = 128     # the grey of the canvas a rotation expands
HOST_WORKERS = 8        # threads of the host stage's per-frame work


def rotate_bound(image: np.ndarray, angle_deg: float, border: int = ROTATE_BORDER):
    """Rotate a uint8 image about its centre by `angle_deg` (clockwise, as
    cv2.getRotationMatrix2D's -angle turns it), expanding the canvas so no
    pixel is cropped, on a constant `border`: (rotated image, the (2, 3)
    float64 map from original to rotated pixel coordinates)."""
    h, w = image.shape[:2]
    cx, cy = w // 2, h // 2
    M = get_rotation_matrix_2d((cx, cy), -angle_deg, 1.0)
    cos, sin = abs(M[0, 0]), abs(M[0, 1])
    nw = int(h * sin + w * cos)
    nh = int(h * cos + w * sin)
    M[0, 2] += nw / 2 - cx
    M[1, 2] += nh / 2 - cy
    return warp_affine_cubic_u8(image, M, (nw, nh), border), M


def blur_image(image: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian blur over the two spatial axes only (scipy.ndimage, the
    image's dtype kept)."""
    from scipy import ndimage

    return ndimage.gaussian_filter(image, sigma=(sigma, sigma, 0))


def add_neck(kp17: np.ndarray) -> np.ndarray:
    """(17, 3) COCO keypoints -> (18, 3) in the rtpose order: the neck the
    shoulders' mean (rounded half to even, visibility 2 where both are 2,
    else their product)."""
    kp17 = np.asarray(kp17, dtype=np.float64)
    r, l = kp17[6], kp17[5]
    neck = (r + l) / 2.0
    neck[2] = 2.0 if (r[2] == 2 and l[2] == 2) else r[2] * l[2]
    neck = np.round(neck)
    return np.vstack([kp17, neck[None]])[list(OUR_ORDER)]


def load_coco_images(annotation_json: str) -> list:
    """person_keypoints_*.json -> [(file_name, [(17, 3) keypoints, ...]),
    ...] sorted by file name, the images with at least one labelled
    keypoint."""
    with open(annotation_json) as f:
        data = json.load(f)
    images = {im["id"]: im["file_name"] for im in data["images"]}
    per_image: dict[int, list] = {}
    for ann in data.get("annotations", []):
        if "keypoints" not in ann:
            continue
        kp = np.asarray(ann["keypoints"], dtype=np.float64).reshape(17, 3)
        per_image.setdefault(ann["image_id"], []).append(kp)
    out = [(images[i], kps) for i, kps in per_image.items()
           if any(np.any(k[:, 2] > 0) for k in kps)]
    out.sort(key=lambda t: t[0])
    return out


def encode_coco_batch(joints2d: torch.Tensor, person_valid: torch.Tensor, ecfg: EncoderConfig):
    """The whole batch's GT maps on the tensors' device: joints2d (B, P, 18,
    2) float32 input pixels with (-1, -1) holes, person_valid (B, P) bool ->
    (heat (B, gh, gw, 19), paf (B, gh, gw, 38))."""
    return (encode_heatmaps(joints2d, person_valid, ecfg),
            encode_pafs(joints2d, person_valid, ecfg, limbs=COCO_LIMBS))


class RGBDataset:
    """What the RGB training datasets share: the generator and its state,
    the per-frame host work of a batch on a pool of threads (the decoder,
    the warps and scipy's filter release the GIL; the results keep the
    batch's order), and the two-stage batch iterator. Subclasses give
    `get_batch_host` and `to_device`."""

    is_train: bool
    rng: np.random.Generator
    _pool: ThreadPoolExecutor | None = None

    def rng_state(self):
        """The generator's state, which a checkpoint keeps (`set_rng_state`)."""
        return self.rng.bit_generator.state

    def set_rng_state(self, state) -> None:
        self.rng.bit_generator.state = state

    def map_frames(self, fn, items) -> list:
        if len(items) <= 1:
            return [fn(*it) for it in items]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=min(HOST_WORKERS, os.cpu_count() or 1))
        return list(self._pool.map(lambda it: fn(*it), items))

    def get_batch(self, indices) -> dict:
        return self.to_device(self.get_batch_host(indices))

    def iter_batches(self, batch_size: int, shuffle: bool | None = None, drop_last: bool = True):
        """Device batches, shuffled by the generator when `shuffle` (by
        default when training); the host and device stages run on two
        threads PREFETCH batches ahead of the consumer."""
        order = np.arange(len(self))
        if shuffle if shuffle is not None else self.is_train:
            self.rng.shuffle(order)
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        yield from _pipeline_iter((order[s:s + batch_size] for s in range(0, stop, batch_size)),
                                  [self.get_batch_host, self.to_device], PREFETCH)


class CocoKeypointsDataset(RGBDataset):
    """Batched COCO RGB keypoints for RTPoseVGG training, on `device`:
    batches {"image" (B, input_y, input_x, 3) float32 normalized, "heat"
    (B, gh, gw, 19), "paf" (B, gh, gw, 38), "scale" (B,) float32, "valid"
    (B, P) bool}. Training augmentations, all off by default as in the JAX
    dataset: `rotate_max_deg` (uniform in +-deg, canvas expanded),
    `scale_jitter` (lo, hi) folded into the letterbox scale,
    `blur_max_sigma` (sigma uniform in [0, max]), and `hflip`; none without
    `is_train`."""

    def __init__(self, image_dir: str, annotation_json: str, input_y: int = 368,
                 input_x: int = 368, stride: int = 8, mode: str = "vgg", is_train: bool = True,
                 hflip: bool = True, rotate_max_deg: float = 0.0,
                 scale_jitter: tuple[float, float] | None = None, blur_max_sigma: float = 0.0,
                 max_people: int = 16, seed: int = 0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.image_dir = image_dir
        self.items = load_coco_images(annotation_json)
        self.ecfg = EncoderConfig(input_x=input_x, input_y=input_y, stride=stride,
                                  num_joints=COCO_NUM_JOINTS, num_limbs=len(COCO_LIMBS),
                                  max_people=max_people)
        self.mode = mode
        self.is_train = is_train
        self.hflip = hflip and is_train
        self.rotate_max_deg = float(rotate_max_deg) if is_train else 0.0
        self.scale_jitter = scale_jitter if is_train else None
        self.blur_max_sigma = float(blur_max_sigma) if is_train else 0.0
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def _draws(self) -> tuple:
        """One frame's draws, in the JAX dataset's order: (rotation degrees,
        blur sigma, scale-jitter factor, flip), None where off."""
        deg = sigma = jitter = None
        if self.rotate_max_deg > 0.0:
            deg = (self.rng.random() - 0.5) * 2.0 * self.rotate_max_deg
        if self.blur_max_sigma > 0.0:
            sigma = self.blur_max_sigma * self.rng.random()
        if self.scale_jitter is not None:
            jitter = self.rng.uniform(*self.scale_jitter)
        flip = bool(self.hflip and self.rng.random() < 0.5)
        return deg, sigma, jitter, flip

    def load_frame(self, index: int, draws: tuple):
        """Frame `index` under `draws`: (uint8 canvas (input_y, input_x, 3)
        BGR, joints (P, 18, 2) float64 with (-1, -1) holes, valid (P,), the
        letterbox scale)."""
        deg, sigma, jitter, flip = draws
        iy, ix = self.ecfg.input_y, self.ecfg.input_x
        fname, kps = self.items[index]
        img = imread_bgr(os.path.join(self.image_dir, fname))
        rot_M = None
        if deg is not None:
            img, rot_M = rotate_bound(img, deg)
        if sigma is not None:
            img = blur_image(img, sigma)
        h, w = img.shape[:2]
        scale = min(iy / h, ix / w)
        if jitter is not None:
            scale = min(scale * jitter, iy / h, ix / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        canvas = np.zeros((iy, ix, 3), np.uint8)
        canvas[:nh, :nw] = resize_linear_u8(img, nw, nh)

        P = self.ecfg.max_people
        joints = np.full((P, COCO_NUM_JOINTS, 2), -1.0)
        valid = np.zeros(P, bool)
        for p, kp17 in enumerate(kps[:P]):
            kp18 = add_neck(kp17)
            vis = kp18[:, 2] > 0.5
            if rot_M is not None:
                xy1 = np.concatenate([kp18[:, :2], np.ones((kp18.shape[0], 1))], axis=1)
                kp18[:, :2] = xy1 @ rot_M.T
            j = np.where(vis[:, None], kp18[:, :2] * scale, -1.0)
            bad = (j[:, 0] >= ix) | (j[:, 0] < 0) | (j[:, 1] >= iy) | (j[:, 1] < 0)
            j[bad] = -1.0
            joints[p] = j
            valid[p] = True
        if flip:
            canvas = canvas[:, ::-1]
            vis_j = joints[..., 0] >= 0
            joints[..., 0] = np.where(vis_j, ix - 1 - joints[..., 0], joints[..., 0])
            joints = joints[:, list(COCO_SWAP_INDICES)]
        return canvas, joints, valid, scale

    def get_batch_host(self, indices):
        """The host stage: the draws in order, then the frames on the pool ->
        (canvases (B, H, W, 3) uint8, joints (B, P, 18, 2) float32, valid
        (B, P), scales (B,) float32)."""
        items = [(int(i), self._draws()) for i in indices]
        frames = self.map_frames(self.load_frame, items)
        canvases, joints, valids, scales = zip(*frames)
        return (np.stack(canvases), np.stack(joints).astype(np.float32), np.stack(valids),
                np.asarray(scales, np.float32))

    def to_device(self, host) -> dict:
        """The device stage: normalize and paint the maps on the device."""
        canvases, joints, valid, scales = host
        dev = self.device
        j = torch.from_numpy(joints).to(dev)
        v = torch.from_numpy(valid).to(dev)
        heat, paf = encode_coco_batch(j, v, self.ecfg)
        return {"image": preprocess_divided(torch.from_numpy(canvases).to(dev), self.mode),
                "heat": heat, "paf": paf, "scale": torch.from_numpy(scales).to(dev), "valid": v}
