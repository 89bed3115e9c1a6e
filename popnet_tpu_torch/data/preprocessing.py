"""RGB image normalizations of the COCO path, on channels-last tensors.

The port's own copy of `popnet_tpu/data/preprocessing.py`'s four
normalizations, their inverses and the `preprocess` dispatch, in torch:
images are BGR (..., 3), as cv2 reads them. The serving pipeline
(`serving.build_rtpose_vgg_pipeline`) normalizes with them on the card.

`vgg_preprocess` rounds as the JAX pipeline's compiled normalization does:
XLA's CPU compiler turns `/ 255` and the division by the standard
deviations into multiplies by float32 reciprocals (`core.numerics
div_const`) and fuses `x * (1/255) - mean` into one rounding
(`core.numerics.fma_f32`), so the port equals it bit for bit; the NumPy
functions of the JAX package divide, and differ from both by an ulp. The
other three modes scale by powers of two and round alike either way.

The RGB training datasets (`data.coco_dataset`, `data.mpii`) normalize
with `preprocess_divided`, which rounds as those NumPy functions do (true
divisions), since the JAX datasets normalize on the host with them.

The COCO evaluation's helpers:

- `crop_with_factor` scales an image so its short side is `dest_size`, as
  `cv2.resize(im, None, fx=s, fy=s)` does (`augment_host
  .resize_linear_scaled_u8`, bit for bit on uint8; `resize_linear_scaled`
  on float32), and zero-pads each side up to a multiple of `factor`: the
  evaluation canvas, on the host;
- `rgb_infer` copies that canvas once to the device, normalizes it there
  (`preprocess_divided`, as the JAX package's NumPy normalization rounds),
  runs the CNN (and, with `flip`, the mirrored pass averaged in by
  `decode.flip_average`) and returns one image's (paf, heat) maps on the
  device with the scale, for `decode.openpose_infer.paf_decode_2d`.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.device import resolve_device
from popnet_tpu_torch.core.numerics import div_const, fma_f32
from popnet_tpu_torch.data.augment_host import resize_linear_scaled, resize_linear_scaled_u8

VGG_MEANS = (0.485, 0.456, 0.406)   # RGB order
VGG_STDS = (0.229, 0.224, 0.225)
SSD_MEANS = (104.0, 117.0, 123.0)   # RGB order


def _per_channel(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def rtpose_preprocess(image: torch.Tensor) -> torch.Tensor:
    """x / 256 - 0.5, BGR kept."""
    return div_const(image.float(), 256.0) - 0.5


def inverse_rtpose_preprocess(image: torch.Tensor) -> torch.Tensor:
    return ((image.float() + 0.5) * 256.0).to(torch.uint8)


def vgg_preprocess(image: torch.Tensor) -> torch.Tensor:
    """BGR -> RGB, / 255, ImageNet mean and std, rounded as XLA rounds it."""
    x = image.float().flip(-1)
    x = fma_f32(x, np.float32(1.0) / np.float32(255.0), -_per_channel(VGG_MEANS, x))
    inv_std = np.float32(1.0) / np.asarray(VGG_STDS, np.float32)
    return x * _per_channel(inv_std.tolist(), x)


def inverse_vgg_preprocess(image: torch.Tensor) -> torch.Tensor:
    x = image.float() * _per_channel(VGG_STDS, image) + _per_channel(VGG_MEANS, image)
    return x.flip(-1) * 255.0


def inception_preprocess(image: torch.Tensor) -> torch.Tensor:
    """BGR -> RGB, x / 128 - 1."""
    return div_const(image.float().flip(-1), 128.0) - 1.0


def inverse_inception_preprocess(image: torch.Tensor) -> torch.Tensor:
    x = (image.float() + 1.0) * 128.0
    return x.flip(-1).to(torch.uint8)


def ssd_preprocess(image: torch.Tensor) -> torch.Tensor:
    """RGB mean subtraction, given back in BGR order."""
    x = image.float().flip(-1) - _per_channel(SSD_MEANS, image)
    return x.flip(-1)


PREPROCESSORS = {
    "rtpose": rtpose_preprocess,
    "vgg": vgg_preprocess,
    "inception": inception_preprocess,
    "ssd": ssd_preprocess,
}


def preprocess(image: torch.Tensor, mode: str) -> torch.Tensor:
    """Normalize by `mode`; an unknown mode passes the image through
    unchanged, as the reference's dispatch does."""
    fn = PREPROCESSORS.get(mode)
    return image if fn is None else fn(image)


def preprocess_divided(image: torch.Tensor, mode: str) -> torch.Tensor:
    """`preprocess` of uint8 BGR images rounded as the JAX package's NumPy
    normalizations round it: "vgg" divides by 255 and by the standard
    deviations (divisors that are tensors on the image's device, so the
    card divides too, rather than multiplying by a reciprocal); the other
    modes scale by powers of two or subtract, and round alike either way."""
    if mode != "vgg":
        return preprocess(image, mode)
    x = image.float().flip(-1) / torch.tensor(255.0, device=image.device)
    return (x - _per_channel(VGG_MEANS, x)) / _per_channel(VGG_STDS, x)


def _factor_closest(num: float, factor: int, is_ceil: bool = True) -> int:
    num = np.ceil(float(num) / factor) if is_ceil else np.floor(float(num) / factor)
    return int(num) * factor


def crop_with_factor(im: np.ndarray, dest_size: int, factor: int = 32, is_ceil: bool = True):
    """Resize an (H, W) or (H, W, C) uint8 or float32 NumPy image so that
    min(H, W) == dest_size, as `cv2.resize(im, None, fx=s, fy=s)` (s =
    dest_size / min(H, W)), then zero-pad H and W up to multiples of
    `factor` (down, where not `is_ceil`: a resized side that is not such a
    multiple then raises, as the JAX package's NumPy assignment does).

    Returns (canvas (H', W', C), im_scale, resized_shape); the canvas's
    top-left holds the resized image, and the model's outputs map back to
    the image's pixels by stride / im_scale."""
    im = np.asarray(im)
    im_scale = float(dest_size) / np.min(im.shape[0:2])
    if im.dtype == np.uint8:
        im = resize_linear_scaled_u8(im, im_scale, im_scale)
    elif im.dtype == np.float32:
        im = resize_linear_scaled(torch.from_numpy(np.ascontiguousarray(im)), im_scale,
                                  im_scale).numpy()
    else:
        raise ValueError(f"crop_with_factor takes uint8 or float32 images, got {im.dtype}")
    if im.ndim == 2:
        im = im[:, :, None]
    h, w, c = im.shape
    canvas = np.zeros([_factor_closest(h, factor, is_ceil), _factor_closest(w, factor, is_ceil),
                       c], dtype=im.dtype)
    if canvas.shape[0] < h or canvas.shape[1] < w:
        raise ValueError(f"crop_with_factor: the resized image {im.shape} does not fit the "
                         f"canvas {canvas.shape} that is_ceil=False leaves")
    canvas[0:h, 0:w, :] = im
    return canvas, im_scale, im.shape


def rgb_infer(infer, image: np.ndarray, mode: str = "vgg", dest_size: int = 368,
              factor: int = 8, flip: bool = False, limbs=None, swap_indices=None,
              device: str | torch.device = "cuda"):
    """One image through the COCO evaluation's CNN: `crop_with_factor` on
    the host, the canvas copied once to `device` and normalized there
    (`preprocess_divided`), `infer((1, H', W', 3) float32) -> (paf, heat,
    ...)` channels-last, and with `flip` the mirrored pass averaged in
    (`decode.flip_average.flip_average_infer` with the skeleton tables
    `limbs`, `swap_indices`).

    image: (H, W, 3) BGR uint8, as `data.image_io` reads it. Returns (paf
    (H'/8, W'/8, 2L), heat (H'/8, W'/8, K+1), im_scale), the maps on
    `device`."""
    from popnet_tpu_torch.decode.flip_average import flip_average_infer

    canvas, im_scale, _ = crop_with_factor(image, dest_size, factor=factor)
    x = torch.from_numpy(canvas).to(resolve_device(device))
    x = preprocess_divided(x, mode).float()[None]
    if flip:
        paf, heat = flip_average_infer(infer, x, limbs, swap_indices)[:2]
    else:
        paf, heat = infer(x)[:2]
    return paf[0], heat[0], im_scale
