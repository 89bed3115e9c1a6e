"""A2J crops: person boxes -> fixed 288x288 normalized depth, for serving
and for training.

A box may reach past the image: taps out of bounds read zero. The crop is a
nearest-neighbour resize to out_size x out_size (CROP unless asked), then
(d - mean) / std. The whole batch of boxes is one gather.

Training (the JAX package's `A2JCropDataset`): each frame of a composited
depth dataset goes through the host augmentation (`data.augment_host`:
Rotate, RenderDepth, Resize back to the frame's size) on the dataset's
device, one of its people is drawn, its box is cropped, the labels move to
crop space as (y, x, z) (`crop_labels`), and with probability 0.5 unit
Gaussian noise is added over a random rectangle of the crop
(`erasing_draws`, `erasing_rectangles`, `apply_erasing`).

ITOP's training set (`ITOPA2JCropDataset`) crops torso-centred world boxes
of torso-relative depth instead (`data.itop_a2j`), with the same erasing.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.numerics import div_const
from popnet_tpu_torch.data.datasets import PREFETCH, _pipeline_iter
from popnet_tpu_torch.data.itop_a2j import CROP, itop_crop_labels, torso_crops


def crop_resize_batch(images: torch.Tensor, image_idx: torch.Tensor, boxes: torch.Tensor,
                      mean: float = 3.0, std: float = 2.0, out_size: int = CROP) -> torch.Tensor:
    """images (B, H, W) raw depth, image_idx (N,) which image each box
    crops, boxes (N, 4) [xmin, ymin, xmax, ymax] that may exceed the image
    -> (N, out_size, out_size) normalized crops, zero out of bounds.

    The source tap of output pixel u is floor(u * extent / out_size) + origin
    in float32, the division rounded as the JAX package's compiled
    crop rounds it (`core.numerics.div_const`), on the CPU and on the card.
    f32(1 / 288) lies above 1 / 288, so where u * extent / 288 is an exact
    integer k the tap is k; cv2's double arithmetic takes k - 1 there, and
    this crop follows the float32 arithmetic."""
    B, H, W = images.shape
    dev = images.device
    boxes = boxes.float()
    # std divides as a value, not a constant, in the JAX crop: a true division
    std_t = torch.full((), float(std), device=dev)
    u = torch.arange(out_size, dtype=torch.float32, device=dev)
    x0, y0 = boxes[:, 0:1], boxes[:, 1:2]
    sx = torch.floor(div_const(u * (boxes[:, 2:3] - x0), out_size)) + x0     # (N, out_size)
    sy = torch.floor(div_const(u * (boxes[:, 3:4] - y0), out_size)) + y0
    gx, gy = sx[:, None, :], sy[:, :, None]
    inside = (gx >= 0) & (gx < W) & (gy >= 0) & (gy < H)     # (N, out_size, out_size)
    xi = gx.clamp(0, W - 1).long()
    yi = gy.clamp(0, H - 1).long()
    crop = images[image_idx.long()[:, None, None], yi, xi]
    crop = torch.where(inside, crop, torch.zeros((), dtype=crop.dtype, device=dev))
    return (crop - mean) / std_t


def uncrop_keypoints(pred_yxz, boxes, out_size: int = CROP) -> np.ndarray:
    """Crop-space (N, K, 3) (y, x, z) -> image-space (N, K, 3) (x, y, z) in
    float64 NumPy, the evaluation's host arithmetic (the JAX package's
    `uncrop_keypoints`)."""
    p = np.asarray(pred_yxz, dtype=np.float64)
    b = np.asarray(boxes, dtype=np.float64)
    x = p[..., 1] * (b[:, None, 2] - b[:, None, 0]) / out_size + b[:, None, 0]
    y = p[..., 0] * (b[:, None, 3] - b[:, None, 1]) / out_size + b[:, None, 1]
    return np.stack([x, y, p[..., 2]], axis=-1)


def crop_labels(joints2d, joints_z, boxes, out_size: int = CROP) -> np.ndarray:
    """Image-space joints (N, K, 2) and depths (N, K) -> crop space (N, K,
    3) as (y, x, z) float32, the A2J annotation convention (anchors are (h,
    w)); the arithmetic in float64 NumPy, as the JAX package's."""
    j = np.asarray(joints2d, dtype=np.float64)
    b = np.asarray(boxes, dtype=np.float64)
    x = (j[..., 0] - b[:, None, 0]) / (b[:, None, 2] - b[:, None, 0]) * out_size
    y = (j[..., 1] - b[:, None, 1]) / (b[:, None, 3] - b[:, None, 1]) * out_size
    return np.stack([y, x, np.asarray(joints_z)], axis=-1).astype(np.float32)


# random erasing: probability, area range (of the crop's), least aspect ratio
ERASE_P, ERASE_SL, ERASE_SH, ERASE_R1 = 0.5, 0.02, 0.4, 0.3


def erasing_draws(n: int, out_size: int, generator: torch.Generator):
    """The random draws of erasing n crops, on the generator's device: five
    uniforms in [0, 1) a crop, (5, n) rows (do, area, aspect, y, x), and
    the noise (n, out_size, out_size, 1), unit normals."""
    dev = generator.device
    u = torch.rand((5, n), generator=generator, device=dev)
    noise = torch.randn((n, out_size, out_size, 1), generator=generator, device=dev)
    return u, noise


def _scaled(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jax.random.uniform(minval=lo, maxval=hi) from its unit draw u: max(lo,
    u * (hi - lo) + lo) in float32, the bounds rounded to float32 first."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp_min(u * float(hi32 - lo32) + float(lo32), float(lo32))


def erasing_rectangles(u: torch.Tensor, out_size: int):
    """The erased rectangle of each crop from `erasing_draws`' uniforms
    (5, n), in the JAX package's float32 arithmetic and int32 truncation:
    (do (n,) bool, ph, pw, y0, x0 (n,) int32). A crop is erased with
    probability ERASE_P; the area is a share in [ERASE_SL, ERASE_SH) of the
    crop, the aspect in [ERASE_R1, 1 / ERASE_R1); the sides are clipped to
    [1, S - 1]."""
    S = out_size
    do = u[0] < ERASE_P
    area = _scaled(u[1], ERASE_SL, ERASE_SH) * S * S
    aspect = _scaled(u[2], ERASE_R1, 1.0 / ERASE_R1)
    ph = torch.clamp(torch.sqrt(area * aspect), 1, S - 1).to(torch.int32)
    pw = torch.clamp(torch.sqrt(area / aspect), 1, S - 1).to(torch.int32)
    y0 = (u[3] * (S - ph).float()).to(torch.int32)
    x0 = (u[4] * (S - pw).float()).to(torch.int32)
    return do, ph, pw, y0, x0


def apply_erasing(crops: torch.Tensor, rects, noise: torch.Tensor) -> torch.Tensor:
    """crops (N, S, S, 1) plus the noise inside each crop's rectangle where
    it is erased (`erasing_rectangles`). The noise is added, not put in the
    rectangle's place, as the reference's `img[...] += rand_patch` does:
    replacing it let N(0, 1) patches dominate BatchNorm's batch statistics
    on narrow depth crops, and the eval-mode model, on running statistics
    skewed by them, lost its accuracy (the JAX package's `random_erasing`
    explains it)."""
    do, ph, pw, y0, x0 = (t[:, None, None] for t in rects)
    S = crops.shape[1]
    ar = torch.arange(S, device=crops.device)
    ys, xs = ar[None, :, None], ar[None, None, :]
    inpatch = (ys >= y0) & (ys < y0 + ph) & (xs >= x0) & (xs < x0 + pw) & do
    zero = torch.zeros((), dtype=noise.dtype, device=noise.device)
    return crops + torch.where(inpatch[..., None], noise, zero)


class _CropDataset:
    """What the two A2J crop datasets share: the inner dataset, the host
    generator, the erasing's generator on the device, their states and the
    batch iterator. Subclasses set `inner`, `device`, `is_train`,
    `augment`, `erase`, `out_size`, `rng` and `erase_generator`, and give
    `get_batch`."""

    def __len__(self):
        return len(self.inner)

    def rng_state(self) -> dict:
        """Every generator's state: this dataset's, the inner's and the
        erasing's (restored by `set_rng_state`, so a resumed run draws as
        the uninterrupted one would)."""
        return {"rng": self.rng.bit_generator.state, "inner": self.inner.rng_state(),
                "erase": self.erase_generator.get_state()}

    def set_rng_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.inner.set_rng_state(state["inner"])
        self.erase_generator.set_state(state["erase"])

    def _erased(self, crops: torch.Tensor) -> torch.Tensor:
        """crops (N, S, S, 1), erased where `augment` and `erase` ask."""
        if not (self.augment and self.erase):
            return crops
        u, noise = erasing_draws(len(crops), self.out_size, self.erase_generator)
        return apply_erasing(crops, erasing_rectangles(u, self.out_size), noise)

    def iter_batches(self, batch_size: int, shuffle: bool | None = None,
                     drop_last: bool = True):
        """Device batches made on one thread PREFETCH batches ahead of the
        consumer; the order is shuffled by the dataset's generator when
        `shuffle` (by default when `is_train`), as the JAX package's."""
        order = np.arange(len(self))
        if self.is_train if shuffle is None else shuffle:
            self.rng.shuffle(order)
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        yield from _pipeline_iter((order[s:s + batch_size] for s in range(0, stop, batch_size)),
                                  [self.get_batch], PREFETCH)


class A2JCropDataset(_CropDataset):
    """Person-crop training set for A2J over a composited depth dataset
    `inner` (one with `load_composited(i) -> (depth (H, W) float32, the
    frame's annotations)`, `rng_state` and a `device`: the port's KDH3D and
    mp-aug datasets). For each index: the composite, the host augmentation
    on the device (Rotate by uniform(+-10) degrees and RenderDepth by
    uniform(0.7, 1.7) about the principal point, Resize back to the frame's
    size; without `augment`, Cvt2ndarray and an identity-size Resize), one
    person drawn (person 0 without `augment`), its box cropped to out_size²
    (the box as Rotate leaves it: only RenderDepth and Resize move it, as in
    the JAX package) and its labels moved to crop space; with `augment` and
    `erase`, random erasing. The host draws come from the dataset's
    `np.random.Generator(seed)` in the JAX package's order, the erasing's
    from a `torch.Generator` on the device seeded with seed + 1.

    `get_batch(indices)` -> {"crops": (N, S, S, 1) normalized, "labels":
    (N, K, 3) (y, x, z)} on the inner's device."""

    def __init__(self, inner, augment: bool = True, erase: bool = True, out_size: int = CROP,
                 seed: int = 0):
        from popnet_tpu_torch.data import augment_host as ah

        self.inner = inner
        self.is_train = getattr(inner, "is_train", True)
        self.augment = augment and self.is_train
        self.erase = erase
        self.out_size = out_size
        self.device = inner.device
        self.rng = np.random.default_rng(seed)
        self.erase_generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.depth = inner.dcfg.depth
        cam = inner.dcfg.intrinsics
        w, h = inner.dcfg.width, inner.dcfg.height
        cvt = ah.Cvt2ndarray(num_joints=inner.ecfg.num_joints)
        self._pipeline = ah.Compose([
            cvt,
            ah.Rotate(cx=cam.cx, cy=cam.cy, rng=self.rng),
            ah.RenderDepth(cx=cam.cx, cy=cam.cy, max_ratio=1.7, rng=self.rng),
            ah.Resize(w, h),
        ])
        self._ident = ah.Compose([cvt, ah.Resize(w, h)])

    def frames(self, indices):
        """The host stage of `get_batch`: (images (N, H, W) float32 on the
        device, boxes (N, 4) float64, joints (N, K, 2) float64, depths (N,
        K) float64), the augmentation and the person draws done."""
        imgs, boxes, j2s, zs = [], [], [], []
        for idx in indices:
            depth, anns = self.inner.load_composited(int(idx))
            image = torch.from_numpy(np.array(depth, np.float32)).to(self.device)
            image, anns = (self._pipeline if self.augment else self._ident)((image, anns))
            i = int(self.rng.integers(0, len(anns))) if self.augment else 0
            ann = anns[i]
            imgs.append(image)
            boxes.append(np.asarray(ann["bbox"][:4], np.float64))
            j2s.append(np.asarray(ann["2d_joints"], np.float64))
            zs.append(np.asarray(ann["3d_joints"], np.float64)[:, 2])
        return torch.stack(imgs), np.stack(boxes), np.stack(j2s), np.stack(zs)

    def get_batch(self, indices) -> dict:
        return self.crop_frames(*self.frames(indices))

    def crop_frames(self, images, boxes, j2s, zs) -> dict:
        """The device stage of `get_batch` on `frames`' output: the crops,
        erased where `augment` and `erase` ask, and the crop-space labels."""
        n = len(images)
        crops = crop_resize_batch(
            images, torch.arange(n, device=self.device),
            torch.from_numpy(boxes).float().to(self.device),
            mean=self.depth.mean, std=self.depth.std, out_size=self.out_size)[..., None]
        labels = crop_labels(j2s, zs, boxes, self.out_size)
        return {"crops": self._erased(crops), "labels": torch.from_numpy(labels).to(self.device)}


class ITOPA2JCropDataset(_CropDataset):
    """ITOP's A2J training set over a single-person depth dataset `inner`
    (one with `load_composited(i)`, `intrinsics`, `dcfg`, `rng_state` and a
    `device`: the port's KDH3DDataset at ITOP_DATASET): for each index,
    person 0's torso joint (`center_joint`) centres a world box of
    half-extent `xy_thres` (`itop_a2j.boxes_from_centers`; with `augment`,
    each side shifted by an integer in [-rand_shift, rand_shift)), the
    frame is cropped to out_size² of torso-relative depth clamped at
    +-depth_thres (`itop_a2j.itop_crop_batch`) on the inner's device,
    normalized by `mean` and `std` (by default the inner's absolute depth
    statistics, as the JAX command line leaves them; `itop_relative_stats`
    measures the relative ones that the ITOP table uses), and with
    `augment` and `erase`, randomly erased. The labels are (y, x, z - cz)
    in crop space (`itop_a2j.itop_crop_labels`). The shifts come from the
    dataset's `np.random.Generator(seed)` in the JAX package's order, the
    erasing's draws from a `torch.Generator` on the device seeded with
    seed + 1.

    `get_batch(indices)` -> {"crops": (N, S, S, 1), "labels": (N, K, 3)} on
    the inner's device."""

    def __init__(self, inner, xy_thres: float = 120.0, depth_thres: float = 0.4,
                 rand_shift: int = 5, center_joint: int = 8, augment: bool = True,
                 erase: bool = True, out_size: int = CROP, seed: int = 0,
                 mean: float | None = None, std: float | None = None):
        self.inner = inner
        self.is_train = getattr(inner, "is_train", True)
        self.augment = augment and self.is_train
        self.erase = erase
        self.out_size = out_size
        self.device = inner.device
        self.rng = np.random.default_rng(seed)
        self.erase_generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.xy_thres, self.depth_thres = xy_thres, depth_thres
        self.rand_shift, self.center_joint = rand_shift, center_joint
        self.mean = inner.dcfg.depth.mean if mean is None else float(mean)
        self.std = inner.dcfg.depth.std if std is None else float(std)

    def get_batch(self, indices) -> dict:
        crops, boxes, cz, uvd = torso_crops(
            self.inner, indices, self.mean, self.std, self.xy_thres, self.depth_thres,
            self.center_joint, self.out_size,
            rand_shift=self.rand_shift if self.augment else 0, rng=self.rng)
        labels = itop_crop_labels(uvd, boxes, cz, self.out_size)
        return {"crops": self._erased(crops), "labels": torch.from_numpy(labels).to(self.device)}
