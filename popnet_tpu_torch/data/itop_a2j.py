"""ITOP's A2J preprocessing: torso-centred crops of torso-relative depth.

The ITOP recipe differs from the KDH3D one (`data/a2j_crops.py`):

- the person box comes from the torso centre: +-xy_thres in world units
  about the centre, projected back to pixels (`boxes_from_centers`, float64
  on the host, float32 out; the recipe's 120 is the reference's millimetres,
  so on depths in metres every box clamps to the whole frame, as in the JAX
  package);
- the depth is clamped to centre_z +- depth_thres, values outside set to
  centre_z, and taken relative to centre_z (`itop_crop_batch`, on the
  images' device, one gather for the batch);
- the crops are normalized with the mean and std of that relative depth
  (`itop_relative_stats`);
- the labels are (y, x) in crop space and z - centre_z (`itop_crop_labels`,
  `itop_uncrop_keypoints`, float64 on the host).

The crop rounds as the JAX package's jitted crop: the tap is
floor(u * extent * f32(1 / out_size)) + origin (`core.numerics.div_const`),
the clamp tests `>=` then `<=` on float32 centre depths, and `/ std` is a
true division, on the CPU and on the card alike.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.camera import ITOP_INTRINSICS, CameraIntrinsics
from popnet_tpu_torch.core.numerics import div_const

CROP = 288


def boxes_from_centers(centers_uvd, cam: CameraIntrinsics = ITOP_INTRINSICS,
                       xy_thres: float = 120.0, img_h: int = 240, img_w: int = 320,
                       rand_shift: int = 0, rng: np.random.Generator | None = None) -> np.ndarray:
    """(N, 3) torso (u, v, z) -> (N, 4) float32 [xmin, ymin, xmax, ymax]:
    the world-space box of half-extent `xy_thres` about each centre,
    projected to pixels in float64 and clamped to the image. With
    `rand_shift` and `rng`, each side moves by an integer draw in
    [-rand_shift, rand_shift), four draws of N in the order xmin, ymin,
    xmax, ymax, before the clamp."""
    c = np.asarray(centers_uvd, dtype=np.float64)
    X = (c[:, 0] - cam.cx) * c[:, 2] / cam.fx
    Y = (c[:, 1] - cam.cy) * c[:, 2] / cam.fy
    x0 = (X - xy_thres) * cam.fx / c[:, 2] + cam.cx
    x1 = (X + xy_thres) * cam.fx / c[:, 2] + cam.cx
    y0 = (Y - xy_thres) * cam.fy / c[:, 2] + cam.cy
    y1 = (Y + xy_thres) * cam.fy / c[:, 2] + cam.cy
    xmin, xmax = np.minimum(x0, x1), np.maximum(x0, x1)
    ymin, ymax = np.minimum(y0, y1), np.maximum(y0, y1)
    if rand_shift and rng is not None:
        xmin = xmin + rng.integers(-rand_shift, rand_shift, len(c))
        ymin = ymin + rng.integers(-rand_shift, rand_shift, len(c))
        xmax = xmax + rng.integers(-rand_shift, rand_shift, len(c))
        ymax = ymax + rng.integers(-rand_shift, rand_shift, len(c))
    xmin = np.maximum(xmin, 0)
    ymin = np.maximum(ymin, 0)
    xmax = np.minimum(xmax, img_w - 1)
    ymax = np.minimum(ymax, img_h - 1)
    return np.stack([xmin, ymin, xmax, ymax], 1).astype(np.float32)


def itop_crop_batch(images: torch.Tensor, image_idx: torch.Tensor, boxes: torch.Tensor,
                    center_z: torch.Tensor, mean: float, std: float, depth_thres: float = 0.4,
                    out_size: int = CROP) -> torch.Tensor:
    """images (B, H, W) float32 depth, image_idx (N,), boxes (N, 4) float32,
    center_z (N,) float32, all on one device -> (N, out_size, out_size, 1)
    crops ((clamped d - cz) - mean) / std: the box floored, the taps of a
    nearest-neighbour resize clipped to the image, each value at or beyond
    cz +- depth_thres replaced by cz."""
    B, H, W = images.shape
    dev = images.device
    b = torch.floor(boxes.float())
    u = torch.arange(out_size, dtype=torch.float32, device=dev)
    sx = torch.floor(div_const(u * (b[:, 2:3] - b[:, 0:1]), out_size)) + b[:, 0:1]   # (N, S)
    sy = torch.floor(div_const(u * (b[:, 3:4] - b[:, 1:2]), out_size)) + b[:, 1:2]
    xi = sx.clamp(0, W - 1).long()[:, None, :]
    yi = sy.clamp(0, H - 1).long()[:, :, None]
    crop = images[image_idx.long()[:, None, None], yi, xi]
    cz = center_z.float()[:, None, None]
    thres = torch.full((), float(np.float32(depth_thres)), device=dev)
    crop = torch.where(crop >= cz + thres, cz, crop)
    crop = torch.where(crop <= cz - thres, cz, crop)
    # mean and std are values, not constants, in the JAX crop: a true division
    mean_t = torch.full((), float(np.float32(mean)), device=dev)
    std_t = torch.full((), float(np.float32(std)), device=dev)
    return ((crop - cz - mean_t) / std_t)[..., None]


def person_uvz(anns) -> np.ndarray:
    """(K, 3) float64 (u, v, z) of person 0 of a frame's annotation list."""
    j2 = np.asarray(anns[0]["2d_joints"], np.float64)
    z = np.asarray(anns[0]["3d_joints"], np.float64)[:, 2:3]
    return np.concatenate([j2, z], 1)


def torso_crops(dataset, indices, mean: float, std: float, xy_thres: float = 120.0,
                depth_thres: float = 0.4, center_joint: int = 8, out_size: int = CROP,
                rand_shift: int = 0, rng: np.random.Generator | None = None):
    """The torso-box crops of frames `indices` of a single-person dataset
    (`load_composited`, `intrinsics` and `device`) -> (crops (N, S, S, 1)
    on the dataset's device, boxes (N, 4) float32, centre depths (N,)
    float32, person 0's (N, K, 3) float64 (u, v, z)). With `rand_shift` and
    `rng`, the boxes shift as in `boxes_from_centers`."""
    frames = [dataset.load_composited(int(i)) for i in indices]
    imgs = np.stack([np.asarray(d, np.float32) for d, _ in frames])
    uvd = np.stack([person_uvz(anns) for _, anns in frames])
    centers = uvd[:, center_joint]
    h, w = imgs.shape[1:]
    boxes = boxes_from_centers(centers, dataset.intrinsics or ITOP_INTRINSICS,
                               xy_thres=xy_thres, img_h=h, img_w=w, rand_shift=rand_shift,
                               rng=rng)
    cz = centers[:, 2].astype(np.float32)
    dev = dataset.device
    crops = itop_crop_batch(
        torch.from_numpy(imgs).to(dev), torch.arange(len(imgs), device=dev),
        torch.from_numpy(boxes).to(dev), torch.from_numpy(cz).to(dev), mean=mean, std=std,
        depth_thres=depth_thres, out_size=out_size)
    return crops, boxes, cz, uvd


def itop_relative_stats(dataset, xy_thres: float = 120.0, depth_thres: float = 0.4,
                        center_joint: int = 8, batch_size: int = 32,
                        out_size: int = CROP) -> tuple[float, float]:
    """(mean, std) of the torso-relative clamped crops of a single-person
    dataset (`load_composited`, `intrinsics` and `device`): the statistics
    that `ITOPA2JCropDataset` and `run_itop_a2j_eval` normalize with. The crop values lie in
    [-depth_thres, depth_thres], so the absolute depth statistics (3.0 and
    2.0) would park every crop near -1.5 with a variance near 0.1. The sums
    run in float64 on the dataset's device."""
    dev = dataset.device
    total = torch.zeros((), dtype=torch.float64, device=dev)
    total_sq = torch.zeros((), dtype=torch.float64, device=dev)
    count = 0
    n = len(dataset)
    for s in range(0, n, batch_size):
        crops = torso_crops(dataset, range(s, min(s + batch_size, n)), 0.0, 1.0, xy_thres,
                            depth_thres, center_joint, out_size)[0].double()
        total += crops.sum()
        total_sq += (crops ** 2).sum()
        count += crops.numel()
    mean = float(total) / count
    var = max(float(total_sq) / count - mean * mean, 1e-12)
    return float(mean), float(np.sqrt(var))


def itop_crop_labels(joints_uvd, boxes, center_z, out_size: int = CROP) -> np.ndarray:
    """(N, K, 3) image (u, v, z) -> (N, K, 3) float32 (y, x, z - cz) in crop
    space, in float64 on the floored boxes."""
    j = np.asarray(joints_uvd, dtype=np.float64)
    b = np.floor(np.asarray(boxes, dtype=np.float64))
    x = (j[..., 0] - b[:, None, 0]) * out_size / (b[:, None, 2] - b[:, None, 0])
    y = (j[..., 1] - b[:, None, 1]) * out_size / (b[:, None, 3] - b[:, None, 1])
    z = j[..., 2] - np.asarray(center_z)[:, None]
    return np.stack([y, x, z], -1).astype(np.float32)


def itop_uncrop_keypoints(pred_yxz, boxes, center_z, out_size: int = CROP) -> np.ndarray:
    """Crop-space (N, K, 3) (y, x, z - cz) -> image-space (N, K, 3) float64
    (x, y, z), on the floored boxes."""
    p = np.asarray(pred_yxz, dtype=np.float64)
    b = np.floor(np.asarray(boxes, dtype=np.float64))
    x = p[..., 1] * (b[:, None, 2] - b[:, None, 0]) / out_size + b[:, None, 0]
    y = p[..., 0] * (b[:, None, 3] - b[:, None, 1]) / out_size + b[:, None, 1]
    z = p[..., 2] + np.asarray(center_z)[:, None]
    return np.stack([x, y, z], -1)
