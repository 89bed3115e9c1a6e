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

`crop_with_factor` and `rgb_infer` (the COCO evaluation driver's host
helpers, which call cv2) are not ported here.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.numerics import div_const, fma_f32

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
