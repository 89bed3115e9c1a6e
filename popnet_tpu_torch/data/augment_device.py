"""The JAX package's on-device augmentation (`popnet_tpu/data/augment_device.py`):
the scalar draws and the label algebra on the host (NumPy), and one batched
inverse-affine bilinear warp on the device the frames lie on (torch).

- `sample_augment_params` draws one training augmentation (random rotation,
  render scale, crop, resize and optional flip) from an `np.random.Generator`
  in the JAX package's order and composes it into one affine map, so one seed
  gives the same parameters bit for bit; `transform_labels` moves the joints
  and boxes by it.
- `resize_inv_mat` is the inverse map of a plain resize, the only
  augmentation the evaluation draws; `params_from_box` the parameters of
  a plain integer crop and resize (the ROI dataset's).
- `warp_depth_batch` samples the frames through the inverse maps: one map for
  the batch (evaluation), or one per frame with depth scales and flips
  (training).

The JAX package compiles the warp with XLA, whose CPU compiler contracts a
multiply and the add after it into one fused multiply-add; the warp here
rounds its source coordinates and its sum of four weighted taps the same way
(`core.numerics.fma_f32`), on the CPU and on the card alike, so its images
equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from popnet_tpu_torch.core.numerics import fma_f32


@dataclasses.dataclass
class AffineParams:
    """Composed augmentation for one sample."""

    label_mat: np.ndarray    # (2, 3) forward map input px -> output px (2D joints)
    bbox_scale: np.ndarray   # (2,) forward bbox scale (no rotation)
    bbox_offset: np.ndarray  # (2,) forward bbox offset
    inv_mat: np.ndarray      # (2, 3) inverse map output px -> input px (sampling)
    depth_scale: float       # multiply depth values and 3D Z
    rot_deg: float           # 3D X, Y rotation
    flip: bool               # horizontal flip applied
    src_w: int               # source width (for the flip's label algebra)


def _rot_mat(cx: float, cy: float, deg: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, deg, 1.0) equivalent."""
    a = math.cos(math.radians(deg))
    b = math.sin(math.radians(deg))
    return np.array(
        [[a, b, (1 - a) * cx - b * cy], [-b, a, b * cx + (1 - a) * cy]], dtype=np.float64
    )


def _compose(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(2,3) affine composition: A after B."""
    M = np.eye(3)
    M[:2] = A
    N = np.eye(3)
    N[:2] = B
    return (M @ N)[:2]


def sample_augment_params(
    rng: np.random.Generator,
    h: int,
    w: int,
    out_h: int = 224,
    out_w: int = 224,
    rotate_deg: float = 10.0,
    render_min: float = 0.7,
    render_max: float = 1.2,
    max_crop: float = 0.1,
    hflip: bool = False,
) -> AffineParams:
    """Draw one augmentation (Rotate -> RenderDepth -> Crop -> Resize, with
    RenderDepth's integer-rounded bounds and ratio recompute) and compose it
    into a single affine map. The draws: rotation if rotate_deg > 0, render
    scale, four crop fractions if max_crop > 0, the flip if hflip."""
    # --- Rotate ---
    rot = float(rng.uniform(-rotate_deg, rotate_deg)) if rotate_deg > 0 else 0.0
    cx0, cy0 = w / 2, h / 2
    R = _rot_mat(cx0, cy0, rot)

    # --- RenderDepth (integer-rounded bounds, ratio recompute) ---
    a = float(rng.uniform(render_min, render_max))
    xmin, ymin, xmax, ymax = 0.0, 0.0, float(w), float(h)
    new_xmin = int(a * (xmin - cx0) + cx0)
    new_ymin = int(a * (ymin - cy0) + cy0)
    new_xmax = int(a * (xmax - cx0) + cx0)
    new_ymax = int(a * (ymax - cy0) + cy0)
    ax = (new_xmin - cx0) / (xmin - cx0)
    ay = (new_ymin - cy0) / (ymin - cy0)
    a = (ax + ay) / 2
    if a <= 1:
        # crop: size is the slice length
        rd_w = new_xmax - new_xmin
        rd_h = new_ymax - new_ymin
    else:
        rd_w = new_xmax - new_xmin + 1
        rd_h = new_ymax - new_ymin + 1
    T_rd = np.array([[1, 0, -new_xmin], [0, 1, -new_ymin]], dtype=np.float64)

    # --- Crop ---
    if max_crop > 0:
        cl = float(rng.uniform(0, max_crop))
        cr = float(rng.uniform(0, max_crop))
        ct = float(rng.uniform(0, max_crop))
        cb = float(rng.uniform(0, max_crop))
        c_xmin = int(min(cl * rd_w, rd_w))
        c_ymin = int(min(ct * rd_h, rd_h))
        c_xmax = int(max(rd_w - 1 - cr * rd_w, 0))
        c_ymax = int(max(rd_h - 1 - cb * rd_h, 0))
    else:
        # no Crop stage at all (the evaluation's Resize only): no 1-px shave
        c_xmin = c_ymin = 0
        c_xmax, c_ymax = rd_w, rd_h
    crop_w = c_xmax - c_xmin
    crop_h = c_ymax - c_ymin
    T_c = np.array([[1, 0, -c_xmin], [0, 1, -c_ymin]], dtype=np.float64)

    # --- Resize ---
    wr = float(out_w) / crop_w
    hr = float(out_h) / crop_h
    S = np.array([[wr, 0, 0], [0, hr, 0]], dtype=np.float64)

    flip = bool(hflip and rng.uniform(0, 1) >= 0.5)

    # forward 2D-label map (the flip precedes everything, in transform_labels)
    label_mat = _compose(S, _compose(T_c, _compose(T_rd, R)))
    # the boxes skip the rotation
    bbox_scale = np.array([wr, hr])
    bbox_offset = np.array([(-new_xmin - c_xmin) * wr, (-new_ymin - c_ymin) * hr])

    # inverse map for sampling, out px -> src px, with cv2.resize's
    # half-pixel convention ((u + 0.5) * scale - 0.5)
    inv_resize = np.array(
        [[1 / wr, 0, 0.5 / wr - 0.5], [0, 1 / hr, 0.5 / hr - 0.5]], dtype=np.float64
    )
    M3 = np.eye(3)
    M3[:2] = _compose(T_c, _compose(T_rd, R))       # src -> pre-resize px
    inv_mat = _compose(np.linalg.inv(M3)[:2], inv_resize)

    return AffineParams(
        label_mat=label_mat.astype(np.float32),
        bbox_scale=bbox_scale.astype(np.float32),
        bbox_offset=bbox_offset.astype(np.float32),
        inv_mat=inv_mat.astype(np.float32),
        depth_scale=float(a),
        rot_deg=rot,
        flip=flip,
        src_w=w,
    )


def transform_labels(params: AffineParams, joints2d, joints3d, bboxes, swap_indices=None):
    """The label algebra of the composed augmentation (NumPy, per sample):
    (joints2d, joints3d, bboxes) float32 in the network input's frame."""
    j2 = np.asarray(joints2d, dtype=np.float64).copy()
    j3 = np.asarray(joints3d, dtype=np.float64).copy()
    bb = np.asarray(bboxes, dtype=np.float64).copy()

    if params.flip:
        j2[..., 0] = -j2[..., 0] + params.src_w
        j3[..., 0] *= -1
        if swap_indices is not None:
            j2 = j2[..., swap_indices, :]
            j3 = j3[..., swap_indices, :]
        xmin = -bb[..., 2] + params.src_w
        xmax = -bb[..., 0] + params.src_w
        bb[..., 0], bb[..., 2] = xmin, xmax

    A = params.label_mat
    x = A[0, 0] * j2[..., 0] + A[0, 1] * j2[..., 1] + A[0, 2]
    y = A[1, 0] * j2[..., 0] + A[1, 1] * j2[..., 1] + A[1, 2]
    j2 = np.stack([x, y], axis=-1)

    R3 = _rot_mat(0.0, 0.0, params.rot_deg)
    X = R3[0, 0] * j3[..., 0] + R3[0, 1] * j3[..., 1]
    Y = R3[1, 0] * j3[..., 0] + R3[1, 1] * j3[..., 1]
    j3 = np.stack([X, Y, j3[..., 2] * params.depth_scale], axis=-1)

    bb[..., 0:4:2] = bb[..., 0:4:2] * params.bbox_scale[0] + params.bbox_offset[0]
    bb[..., 1:4:2] = bb[..., 1:4:2] * params.bbox_scale[1] + params.bbox_offset[1]
    return j2.astype(np.float32), j3.astype(np.float32), bb.astype(np.float32)


def params_from_box(box, out_h: int = 224, out_w: int = 224, src_w: int = 480) -> AffineParams:
    """AffineParams of a plain integer crop of `box` (x0, y0, x1, y1, each
    truncated to an integer) resized to (out_h, out_w): no rotation,
    render scale or flip."""
    x0, y0, x1, y1 = (int(v) for v in box)
    wr = float(out_w) / max(x1 - x0, 1)
    hr = float(out_h) / max(y1 - y0, 1)
    return AffineParams(
        label_mat=np.array([[wr, 0, -x0 * wr], [0, hr, -y0 * hr]], dtype=np.float32),
        bbox_scale=np.array([wr, hr], np.float32),
        bbox_offset=np.array([-x0 * wr, -y0 * hr], np.float32),
        inv_mat=np.array([[1 / wr, 0, 0.5 / wr - 0.5 + x0], [0, 1 / hr, 0.5 / hr - 0.5 + y0]],
                         dtype=np.float32),
        depth_scale=1.0, rot_deg=0.0, flip=False, src_w=src_w)


def resize_inv_mat(h: int, w: int, out_h: int = 224, out_w: int = 224) -> np.ndarray:
    """(2, 3) float32 inverse map of resizing (h, w) to (out_h, out_w):
    output px -> source px with cv2.resize's half-pixel convention
    ((u + 0.5) * scale - 0.5)."""
    wr = float(out_w) / w
    hr = float(out_h) / h
    return np.array([[1 / wr, 0, 0.5 / wr - 0.5], [0, 1 / hr, 0.5 / hr - 0.5]], np.float32)


def warp_depth_batch(images: torch.Tensor, inv_mat, out_h: int = 224, out_w: int = 224,
                     depth_scales: torch.Tensor | None = None,
                     flips: torch.Tensor | None = None) -> torch.Tensor:
    """Batched inverse-affine bilinear warp with zero fill: images (B, H, W)
    float32 -> (B, out_h, out_w).

    inv_mat is the output px -> source px map: one (2, 3) float32 array for
    the whole batch, or a (B, 2, 3) float32 tensor, one map a frame. With
    per-frame maps, `flips` (B,) bool mirrors a frame's columns before the
    warp and `depth_scales` (B,) float32 multiplies the warped depth."""
    B, H, W = images.shape
    dev = images.device
    vv, uu = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    if isinstance(inv_mat, torch.Tensor) and inv_mat.dim() == 3:
        if flips is not None:
            images = torch.where(flips[:, None, None], images.flip(-1), images)
        m = inv_mat.to(device=dev, dtype=torch.float32)[:, :, :, None, None]   # (B, 2, 3, 1, 1)
        (m00, m01, m02), (m10, m11, m12) = m[:, 0].unbind(1), m[:, 1].unbind(1)
    else:
        (m00, m01, m02), (m10, m11, m12) = np.asarray(inv_mat, np.float32).tolist()
    img = images.reshape(B, H * W)
    # the source coordinates and the sum of the four weighted taps, each
    # multiply-add rounded as XLA's contraction rounds it
    sx = fma_f32(uu, m00, m01 * vv) + m02                       # (out_h, out_w) or (B, ...)
    sy = fma_f32(uu, m10, m11 * vv) + m12
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    per_frame = sx.dim() == 3

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        flat = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        if per_frame:
            v = torch.gather(img, 1, flat.reshape(B, -1)).reshape(B, out_h, out_w)
        else:
            v = img[:, flat.reshape(-1)].reshape(B, out_h, out_w)
        return torch.where(inside, v, torch.zeros((), device=dev))

    gx, gy = 1 - fx, 1 - fy
    out = fma_f32(tap(x0, y0) * gx, gy, (tap(x0 + 1, y0) * fx) * gy)
    out = fma_f32(tap(x0, y0 + 1) * gx, fy, out)
    out = fma_f32(tap(x0 + 1, y0 + 1) * fx, fy, out)
    if depth_scales is not None:
        out = out * depth_scales.to(device=dev, dtype=torch.float32)[:, None, None]
    return out
