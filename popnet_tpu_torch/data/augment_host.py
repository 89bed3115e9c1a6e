"""2D+3D-consistent geometric augmentation of one frame at a time, without cv2
(the port of `popnet_tpu/data/augment_host.py`).

Each transform maps (image, [ann, ...]) -> (image, [ann, ...]) with the JAX
package's draws, in its order, from an explicit `np.random.Generator`. The
image is a torch tensor, (H, W) or (H, W, C), on any device; the label
algebra stays NumPy with the JAX package's dtypes: joints are float32
arrays updated in place, boxes float64, and the homography's `M @ pos` is
float64.

The two warps compute what cv2 5.0.0 computes on float32 images, bit for
bit, on the CPU and on the card (`warp_affine_linear` where the width is a
multiple of 16, as KDH3D's 480 is: cv2's vector loop then covers whole
rows, and its scalar tail rounds otherwise, 1.1e-4 apart at most on [0, 8)
noise):

- `warp_affine_linear` is `cv2.warpAffine` (INTER_LINEAR, BORDER_CONSTANT
  0): the map is inverted in float64 as cv2 inverts it and cast to float32
  (m0..m5); output pixel (x, y) samples sx = fma(x, m0, y * m1 + m2), sy
  likewise, in float32; a tap outside the image reads 0; with a, b the
  fractions of sx, sy the value is v0 = fma(a, p01 - p00, p00), v1 =
  fma(a, p11 - p10, p10), fma(b, v1 - v0, v0);
- `resize_linear` is `cv2.resize` (INTER_LINEAR): the source coordinate
  (d + 0.5) * src / dst - 0.5 in float64, clamped at both edges, its
  fraction cast to float32; a horizontal lerp, then a vertical one, each
  one fused multiply-add.

Each fused multiply-add rounds once (`core.numerics.fma_f32`, separate
torch operations, none that a compiler could contract), so the two devices
agree. `get_rotation_matrix_2d` builds cv2's matrix in float64 as cv2 does
(the centre rounded to float32, the angle times pi / 180 as one constant).

cv2 computes both on uint8 images by other code; `resize_linear_u8` and
`warp_affine_cubic_u8` (the RGB datasets' letterbox and rotation) are
those, on NumPy arrays on the host, in host C++ (`csrc/image_u8.cpp`,
built at first use like the JPEG reader): cv2's fixed-point INTER_LINEAR
resize, and its float32 INTER_CUBIC warp with a constant border, equal to
cv2 5.0.0 bit for bit.
"""

from __future__ import annotations

import copy
import ctypes
import math

import numpy as np
import torch

from popnet_tpu_torch.core.numerics import fma_f32
from popnet_tpu_torch.ops._build import host_library


def _hom(M, x, y):
    ones = np.ones_like(y)
    pos = np.vstack([x, y, ones])
    t = M @ pos
    return t[0, :] / t[2, :], t[1, :] / t[2, :]


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D`: (2, 3) float64, `angle` in degrees,
    counter-clockwise about `center`, which cv2 takes as float32."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(M) -> np.ndarray:
    """The inverse of a (2, 3) affine map, in float64 as cv2 inverts it."""
    M = np.asarray(M, np.float64)
    D = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * D, M[0, 0] * D, -M[0, 1] * D, -M[1, 0] * D
    return np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                     [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]])


def _lerp(t: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """fma(t, p1 - p0, p0), rounded once, as cv2's float32 interpolation."""
    return fma_f32(t, p1 - p0, p0)


def _per_pixel(t: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """A (H', W') weight broadcast over the channels of an (H, W, C) image."""
    return t if image.dim() == 2 else t[..., None]


def warp_affine_linear(image: torch.Tensor, M, dsize: tuple[int, int]) -> torch.Tensor:
    """`cv2.warpAffine(image, M, dsize, flags=INTER_LINEAR)` with a zero
    border: image (H, W) or (H, W, C) float32, M the (2, 3) forward map,
    dsize (width, height)."""
    w, h = dsize
    m = [float(v) for v in _invert_affine(M).astype(np.float32).ravel()]
    dev = image.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    sx = fma_f32(xs, m[0], ys * m[1] + m[2])                 # (h, w)
    sy = fma_f32(xs, m[3], ys * m[4] + m[5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = _per_pixel(sx - fx, image), _per_pixel(sy - fy, image)
    ix, iy = fx.long(), fy.long()
    H, W = image.shape[:2]
    zero = torch.zeros((), dtype=image.dtype, device=dev)

    def tap(yy, xx):
        inside = _per_pixel((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H), image)
        return torch.where(inside, image[yy.clamp(0, H - 1), xx.clamp(0, W - 1)], zero)

    v0 = _lerp(a, tap(iy, ix), tap(iy, ix + 1))
    v1 = _lerp(a, tap(iy + 1, ix), tap(iy + 1, ix + 1))
    return _lerp(b, v0, v1)


def _resize_axis(src: int, dst: int, device, factor: float | None = None):
    """cv2 INTER_LINEAR's taps and float32 fractions along one axis: the
    source step is src / dst, or 1 / factor where the caller gave cv2 a
    scale factor rather than a size."""
    step = 1.0 / (dst / src) if factor is None else 1.0 / factor
    f = (np.arange(dst) + 0.5) * step - 0.5
    i0 = np.floor(f)
    frac = (f - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    frac[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    frac[i0 >= src - 1] = 0.0
    i0[i0 >= src - 1] = src - 1
    i1 = np.minimum(i0 + 1, src - 1)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(frac).to(device))


def resize_linear(image: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """`cv2.resize(image, (width, height), interpolation=INTER_LINEAR)`:
    image (H, W) or (H, W, C) float32."""
    return _resize_linear(image, width, height, None, None)


def scaled_size(h: int, w: int, fx: float, fy: float) -> tuple[int, int]:
    """The (height, width) that `cv2.resize(im, None, fx=fx, fy=fy)` gives
    an (h, w) image: w * fx and h * fy rounded half to even."""
    return int(np.rint(h * fy)), int(np.rint(w * fx))


def resize_linear_scaled(image: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """`cv2.resize(image, None, fx=fx, fy=fy)` (INTER_LINEAR) of an (H, W)
    or (H, W, C) float32 image: the size rounded from the factors, and each
    output pixel mapped back by 1 / fx, 1 / fy (not by the ratio of the
    sizes, as `resize_linear` maps)."""
    height, width = scaled_size(image.shape[0], image.shape[1], fx, fy)
    return _resize_linear(image, width, height, fx, fy)


def _resize_linear(image, width, height, fx, fy):
    H, W = image.shape[:2]
    x0, x1, ax = _resize_axis(W, width, image.device, fx)
    y0, y1, ay = _resize_axis(H, height, image.device, fy)
    rows = _lerp(_per_pixel(ax[None, :], image), image[:, x0], image[:, x1])
    return _lerp(_per_pixel(ay[:, None], image), rows[y0], rows[y1])


def _u8_lib():
    lib = host_library("image_u8")
    if not getattr(lib, "_typed", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.popnet_resize_linear_u8.argtypes = [p, i, i, i, p, i, i]
        lib.popnet_resize_linear_scaled_u8.argtypes = [p, i, i, i, p, i, i, ctypes.c_double,
                                                       ctypes.c_double]
        lib.popnet_warp_affine_cubic_u8.argtypes = [p, i, i, i, p, i, i, p, i]
        for fn in (lib.popnet_resize_linear_u8, lib.popnet_resize_linear_scaled_u8,
                   lib.popnet_warp_affine_cubic_u8):
            fn.restype = i
        lib._typed = True
    return lib


def _u8_image(image: np.ndarray) -> tuple[np.ndarray, int]:
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (image.ndim == 3 and not
                                                               1 <= image.shape[2] <= 4):
        raise ValueError(f"expected an (H, W) or (H, W, 1-4) uint8 image, got {image.dtype} "
                         f"{image.shape}")
    return image, 1 if image.ndim == 2 else image.shape[2]


def resize_linear_u8(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(image, (width, height))` (INTER_LINEAR) of an (H, W) or
    (H, W, C) uint8 NumPy image, bit for bit (`csrc/image_u8.cpp`)."""
    image, cn = _u8_image(image)
    out = np.empty((height, width) + image.shape[2:], np.uint8)
    if _u8_lib().popnet_resize_linear_u8(image.ctypes.data, image.shape[0], image.shape[1], cn,
                                         out.ctypes.data, height, width):
        raise ValueError(f"resize_linear_u8: bad sizes {image.shape} -> ({height}, {width})")
    return out


def resize_linear_scaled_u8(image: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """`cv2.resize(image, None, fx=fx, fy=fy)` (INTER_LINEAR) of an (H, W)
    or (H, W, C) uint8 NumPy image, bit for bit (`csrc/image_u8.cpp`): the
    size rounded from the factors (`scaled_size`), coordinates mapped by
    the factors."""
    image, cn = _u8_image(image)
    height, width = scaled_size(image.shape[0], image.shape[1], fx, fy)
    out = np.empty((height, width) + image.shape[2:], np.uint8)
    if _u8_lib().popnet_resize_linear_scaled_u8(image.ctypes.data, image.shape[0],
                                                image.shape[1], cn, out.ctypes.data, height,
                                                width, float(fx), float(fy)):
        raise ValueError(f"resize_linear_scaled_u8: bad sizes or factors {image.shape}, "
                         f"fx={fx}, fy={fy}")
    return out


def warp_affine_cubic_u8(image: np.ndarray, M, dsize: tuple[int, int],
                         border: int = 0) -> np.ndarray:
    """`cv2.warpAffine(image, M, dsize, flags=INTER_CUBIC,
    borderMode=BORDER_CONSTANT, borderValue=border)` of an (H, W) or
    (H, W, C) uint8 NumPy image, bit for bit: M the (2, 3) forward map,
    dsize (width, height)."""
    image, cn = _u8_image(image)
    w, h = dsize
    inv = np.ascontiguousarray(_invert_affine(M).ravel(), np.float64)
    out = np.empty((h, w) + image.shape[2:], np.uint8)
    if _u8_lib().popnet_warp_affine_cubic_u8(image.ctypes.data, image.shape[0], image.shape[1],
                                             cn, out.ctypes.data, h, w, inv.ctypes.data,
                                             int(border)):
        raise ValueError(f"warp_affine_cubic_u8: bad sizes {image.shape} -> ({h}, {w})")
    return out


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class Cvt2ndarray:
    """Normalize the annotations' dtypes, and the image tensor to float32."""

    def __init__(self, num_joints: int = 15):
        self.num_joints = num_joints

    def __call__(self, data):
        image, label = data
        out = []
        for lb in label:
            lb = copy.deepcopy(lb)
            lb["2d_joints"] = np.array(lb["2d_joints"]).reshape(self.num_joints, 2).astype(np.float32)
            lb["3d_joints"] = np.array(lb["3d_joints"]).reshape(self.num_joints, 3).astype(np.float32)
            if "visible_joints" in lb:
                lb["visible_joints"] = np.array(lb["visible_joints"])
            if "bbox" in lb:
                lb["bbox"] = np.array(lb["bbox"], dtype=np.float64)
            out.append(lb)
        return image.float(), out


class Crop:
    """Random edge crop up to max_crop per side; 2D labels shift."""

    def __init__(self, max_crop: float = 0.1, rng: np.random.Generator | None = None):
        self.max_crop = max_crop
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        image, label = data
        crop_left = self.rng.uniform(0, self.max_crop)
        crop_right = self.rng.uniform(0, self.max_crop)
        crop_top = self.rng.uniform(0, self.max_crop)
        crop_bottom = self.rng.uniform(0, self.max_crop)
        return self.apply(image, label, crop_left, crop_right, crop_top, crop_bottom)

    @staticmethod
    def apply(image, label, crop_left, crop_right, crop_top, crop_bottom):
        height, width = image.shape[:2]
        new_xmin = int(min(crop_left * width, width))
        new_ymin = int(min(crop_top * height, height))
        new_xmax = int(max(width - 1 - crop_right * width, 0))
        new_ymax = int(max(height - 1 - crop_bottom * height, 0))
        image = image[new_ymin:new_ymax, new_xmin:new_xmax]
        out = []
        for lb in label:
            lb = copy.deepcopy(lb)
            lb["2d_joints"][:, 0] -= new_xmin
            lb["2d_joints"][:, 1] -= new_ymin
            if "bbox" in lb:
                lb["bbox"][0:4:2] -= new_xmin
                lb["bbox"][1:4:2] -= new_ymin
            out.append(lb)
        return image, out


class RenderDepth:
    """Simulated camera dolly along the principal axis: crop (a <= 1) or
    zero-pad (a > 1) by ratio a about (cx, cy), then multiply the depth and
    the 3D Z by the ratio recomputed from the rounded bounds. The image is
    multiplied as NumPy multiplies a float32 array by a Python float: the
    ratio rounded to float32, one float32 product."""

    def __init__(self, cx=None, cy=None, min_ratio=0.7, max_ratio=1.2,
                 rng: np.random.Generator | None = None):
        self.cx = cx
        self.cy = cy
        self.min_ratio = min_ratio
        self.max_ratio = max_ratio
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        a = self.rng.uniform(self.min_ratio, self.max_ratio)
        image, label = data
        return self.apply(image, label, a, self.cx, self.cy)

    @staticmethod
    def apply(image, label, a, cx=None, cy=None):
        height, width = image.shape[:2]
        if cx is None:
            cx = width / 2
        if cy is None:
            cy = height / 2
        xmin, ymin, xmax, ymax = 0.0, 0.0, float(width), float(height)

        new_xmin = int(a * (xmin - cx) + cx)
        new_ymin = int(a * (ymin - cy) + cy)
        new_xmax = int(a * (xmax - cx) + cx)
        new_ymax = int(a * (ymax - cy) + cy)
        # the ratio again, from the rounded bounds
        ax = (new_xmin - cx) / (xmin - cx)
        ay = (new_ymin - cy) / (ymin - cy)
        a = (ax + ay) / 2

        new_width = new_xmax - new_xmin + 1
        new_height = new_ymax - new_ymin + 1
        if a <= 1:
            new_image = image[new_ymin:new_ymax, new_xmin:new_xmax]
        else:
            dx = int(xmin - new_xmin)
            dy = int(ymin - new_ymin)
            new_image = torch.zeros((new_height, new_width, *image.shape[2:]), dtype=torch.float32,
                                    device=image.device)
            new_image[dy:dy + height, dx:dx + width] = image

        out = []
        for lb in label:
            lb = copy.deepcopy(lb)
            lb["2d_joints"][:, 0] -= new_xmin
            lb["2d_joints"][:, 1] -= new_ymin
            lb["3d_joints"][:, 2] *= a
            if "bbox" in lb:
                lb["bbox"][0:4:2] -= new_xmin
                lb["bbox"][1:4:2] -= new_ymin
            out.append(lb)
        return new_image * float(np.float32(a)), out


class Rotate:
    """+-max_deg rotation about the principal point; 2D labels through the
    image's homography, with is_3d also the 3D X, Y about the camera axis.
    The box is left as it was."""

    def __init__(self, cx=None, cy=None, is_3d=False, max_deg=10.0,
                 rng: np.random.Generator | None = None):
        self.cx = cx
        self.cy = cy
        self.is_3d = is_3d
        self.max_deg = max_deg
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        rot = self.rng.uniform(-self.max_deg, self.max_deg)
        image, label = data
        return self.apply(image, label, rot, self.cx, self.cy, self.is_3d)

    @staticmethod
    def apply(image, label, rot, cx=None, cy=None, is_3d=False):
        height, width = image.shape[:2]
        center_x = cx if cx is not None else width / 2
        center_y = cy if cy is not None else height / 2
        rot_mat = get_rotation_matrix_2d((center_x, center_y), rot, 1.0)
        img_rot = warp_affine_linear(image, rot_mat, (width, height))
        rot_mat = np.vstack([rot_mat, [0, 0, 1]])
        rot_mat3d = np.vstack([get_rotation_matrix_2d((0, 0), rot, 1.0), [0, 0, 1]])

        out = []
        for lb in label:
            lb = copy.deepcopy(lb)
            lb["2d_joints"][:, 0], lb["2d_joints"][:, 1] = _hom(
                rot_mat, lb["2d_joints"][:, 0], lb["2d_joints"][:, 1]
            )
            if is_3d:
                lb["3d_joints"][:, 0], lb["3d_joints"][:, 1] = _hom(
                    rot_mat3d, lb["3d_joints"][:, 0], lb["3d_joints"][:, 1]
                )
            out.append(lb)
        return img_rot, out


class Hflip:
    """Horizontal flip with left/right joint swap; 3D X negated."""

    def __init__(self, swap_indices, is_3d=False, rng: np.random.Generator | None = None):
        self.swap_indices = list(swap_indices)
        self.is_3d = is_3d
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        if self.rng.uniform(0, 1) < 0.5:
            return data
        image, label = data
        return self.apply(image, label, self.swap_indices, self.is_3d)

    @staticmethod
    def apply(image, label, swap_indices, is_3d=False):
        image = torch.flip(image, dims=(1,))
        width = image.shape[1]
        out = []
        for lb in label:
            lb = copy.deepcopy(lb)
            lb["2d_joints"][:, 0] = -lb["2d_joints"][:, 0] + width
            if is_3d:
                lb["3d_joints"][:, 0] *= -1
            lb["2d_joints"] = lb["2d_joints"][swap_indices, :]
            if is_3d:
                lb["3d_joints"] = lb["3d_joints"][swap_indices, :]
            if "visible_joints" in lb:
                lb["visible_joints"] = lb["visible_joints"][swap_indices]
            if "bbox" in lb:
                xmin = -lb["bbox"][2] + width
                xmax = -lb["bbox"][0] + width
                lb["bbox"][0] = xmin
                lb["bbox"][2] = xmax
            out.append(lb)
        return image, out


class Resize:
    """Bilinear resize to the network input (`resize_linear`); 2D labels
    scale."""

    def __init__(self, target_w: int, target_h: int | None = None):
        self.target_w = target_w
        self.target_h = target_h if target_h is not None else target_w

    def __call__(self, data):
        image, label = data
        height, width = image.shape[:2]
        image = resize_linear(image, self.target_w, self.target_h)
        wr = float(self.target_w) / width
        hr = float(self.target_h) / height
        out = []
        for lb in label:
            lb = copy.deepcopy(lb)
            lb["2d_joints"][:, 0] *= wr
            lb["2d_joints"][:, 1] *= hr
            if "bbox" in lb:
                lb["bbox"][0:4:2] = lb["bbox"][0:4:2].astype(np.float64) * wr
                lb["bbox"][1:4:2] = lb["bbox"][1:4:2].astype(np.float64) * hr
            out.append(lb)
        return image, out


class CropPoseRoi:
    """Crop a random person's joints + margin ROI; keeps only that person's
    label (the ROI models' input crop)."""

    def __init__(self, joint2box_margin: float = 20, rng: np.random.Generator | None = None):
        self.joint2box_margin = joint2box_margin
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        image, label = data
        rnd_id = int(self.rng.integers(len(label)))
        return self.apply(image, label, rnd_id, self.joint2box_margin)

    @staticmethod
    def apply(image, label, person_idx, margin):
        height, width = image.shape[:2]
        j = np.asarray(label[person_idx]["2d_joints"])
        xmin = j[:, 0].min() - margin
        ymin = j[:, 1].min() - margin
        xmax = j[:, 0].max() + margin
        ymax = j[:, 1].max() + margin
        return _apply_roi(image, label, person_idx, xmin, ymin, xmax, ymax, height, width)


class CropPoseRoiJitter:
    """ROI crop with a random aspect shrink."""

    def __init__(self, joint2box_margin: float = 20, max_aspect_jitter: float = 0.2,
                 rng: np.random.Generator | None = None):
        self.joint2box_margin = joint2box_margin
        self.max_aspect_jitter = max_aspect_jitter
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        image, label = data
        w_jitter = self.rng.uniform(1 - self.max_aspect_jitter, 1)
        h_jitter = self.rng.uniform(1 - self.max_aspect_jitter, 1)
        rnd_id = int(self.rng.integers(len(label)))
        return self.apply(image, label, rnd_id, self.joint2box_margin, w_jitter, h_jitter)

    @staticmethod
    def apply(image, label, person_idx, margin, w_jitter, h_jitter):
        height, width = image.shape[:2]
        j = np.asarray(label[person_idx]["2d_joints"])
        xmin = j[:, 0].min() - margin
        ymin = j[:, 1].min() - margin
        xmax = j[:, 0].max() + margin
        ymax = j[:, 1].max() + margin
        cx = (xmin + xmax) / 2
        cy = (ymin + ymax) / 2
        crop_w = (xmax - xmin) * w_jitter
        crop_h = (ymax - ymin) * h_jitter
        return _apply_roi(
            image, label, person_idx, cx - crop_w / 2, cy - crop_h / 2,
            cx + crop_w / 2, cy + crop_h / 2, height, width,
        )


class CropPoseRoiV2:
    """ROI crop sized by margin ratios of the joint box."""

    def __init__(self, margin_ratio_x: float = 2.0, margin_ratio_y: float = 1.5,
                 rng: np.random.Generator | None = None):
        self.margin_ratio_x = margin_ratio_x
        self.margin_ratio_y = margin_ratio_y
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        image, label = data
        rnd_id = int(self.rng.integers(len(label)))
        return self.apply(image, label, rnd_id, self.margin_ratio_x, self.margin_ratio_y)

    @staticmethod
    def apply(image, label, person_idx, margin_ratio_x, margin_ratio_y):
        height, width = image.shape[:2]
        j = np.asarray(label[person_idx]["2d_joints"])
        xc = (j[:, 0].min() + j[:, 0].max()) / 2
        yc = (j[:, 1].min() + j[:, 1].max()) / 2
        bw = j[:, 0].max() - j[:, 0].min()
        bh = j[:, 1].max() - j[:, 1].min()
        return _apply_roi(
            image, label, person_idx,
            xc - bw / 2 * margin_ratio_x, yc - bh / 2 * margin_ratio_y,
            xc + bw / 2 * margin_ratio_x, yc + bh / 2 * margin_ratio_y,
            height, width,
        )


def _apply_roi(image, label, person_idx, xmin, ymin, xmax, ymax, height, width):
    new_xmin = int(max(0, min(width, xmin)))
    new_ymin = int(max(0, min(height, ymin)))
    new_xmax = int(max(0, min(width, xmax)))
    new_ymax = int(max(0, min(height, ymax)))
    image = image[new_ymin:new_ymax, new_xmin:new_xmax]
    lb = copy.deepcopy(label[person_idx])
    lb["2d_joints"][:, 0] -= new_xmin
    lb["2d_joints"][:, 1] -= new_ymin
    if "bbox" in lb:
        lb["bbox"][0:4:2] -= new_xmin
        lb["bbox"][1:4:2] -= new_ymin
    return image, [lb]


class RandomScaleRGB:
    """RGB scale crop/pad: RenderDepth's geometry without the depth
    scaling."""

    def __init__(self, min_ratio=0.7, max_ratio=1.3, rng: np.random.Generator | None = None):
        self.min_ratio = min_ratio
        self.max_ratio = max_ratio
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        a = self.rng.uniform(self.min_ratio, self.max_ratio)
        image, label = data
        return self.apply(image, label, a)

    @staticmethod
    def apply(image, label, a):
        height, width, chn = image.shape
        cx, cy = width / 2, height / 2
        new_xmin = int(a * (0 - cx) + cx)
        new_ymin = int(a * (0 - cy) + cy)
        new_xmax = int(a * (width - cx) + cx)
        new_ymax = int(a * (height - cy) + cy)
        ax = (new_xmin - cx) / (0 - cx)
        ay = (new_ymin - cy) / (0 - cy)
        a = (ax + ay) / 2
        if a <= 1:
            new_image = image[new_ymin:new_ymax, new_xmin:new_xmax]
        else:
            new_image = torch.zeros((new_ymax - new_ymin + 1, new_xmax - new_xmin + 1, chn),
                                    dtype=torch.float32, device=image.device)
            new_image[-new_ymin:-new_ymin + height, -new_xmin:-new_xmin + width] = image
        out = []
        for lb in label:
            lb = copy.deepcopy(lb)
            lb["2d_joints"][:, 0] -= new_xmin
            lb["2d_joints"][:, 1] -= new_ymin
            if "bbox" in lb:
                lb["bbox"][0:4:2] -= new_xmin
                lb["bbox"][1:4:2] -= new_ymin
            out.append(lb)
        return new_image, out


class SquarePadRGB:
    """Zero-pad an RGB image to a centred square."""

    def __call__(self, data):
        image, label = data
        height, width, chn = image.shape
        edge = max(height, width)
        new_image = torch.zeros((edge, edge, chn), dtype=torch.float32, device=image.device)
        x0 = int((edge - width) / 2)
        y0 = int((edge - height) / 2)
        new_image[y0:y0 + height, x0:x0 + width] = image
        out = []
        for lb in label:
            lb = copy.deepcopy(lb)
            lb["2d_joints"][:, 0] += x0
            lb["2d_joints"][:, 1] += y0
            if "bbox" in lb:
                lb["bbox"][0:4:2] += x0
                lb["bbox"][1:4:2] += y0
            out.append(lb)
        return new_image, out
