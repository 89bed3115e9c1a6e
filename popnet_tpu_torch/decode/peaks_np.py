"""Heatmap peaks with a sub-pixel bicubic refine, on the host (the JAX
package's `decode/peaks_np.py`, the exact decode's NMS):

1. the local maxima of each joint's heatmap under a cross (4-neighbour)
   footprint, above `thresh` (`scipy.ndimage.maximum_filter`);
2. for each peak, its 5x5 patch (clipped at the map's edges) upsampled by
   the downsample factor with cv2's INTER_CUBIC (`resize_cubic`) and the
   argmax taken for a sub-pixel position;
3. coordinates through the half-pixel convention (c + 0.5) * factor - 0.5.

`resize_cubic` computes what `cv2.resize(img, None, fx=f, fy=f,
interpolation=cv2.INTER_CUBIC)` computes for a float32 image by cv2 5.0.0's
own code, without cv2: the weights of Keys' kernel (A = -0.75) in float32 as
cv2 takes them, border taps replicated, the horizontal pass summed in tap
order and the vertical pass as cv2's vector loop sums it, last tap first,
each product and sum rounded to float32. For single-channel images of at
least 4x4 pixels (and 3 or 4 channels) cv2 hands the resize to Intel IPP
where its build has IPP, which rounds apart by an ulp or two; the refine's
argmax follows cv2's own code, and flips on near-ties against cv2 with IPP
(`tests/test_torch_exact_decode.py` states the rate).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import maximum_filter

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """(n, 4) float32 weights of the fractions x, as cv2's interpolateCubic
    computes them in float32."""
    f = np.float32
    A, one = f(-0.75), f(1)
    x = x.astype(f)
    c0 = ((A * (x + one) - f(5) * A) * (x + one) + f(8) * A) * (x + one) - f(4) * A
    c1 = ((A + f(2)) * x - (A + f(3))) * x * x + one
    c2 = ((A + f(2)) * (one - x) - (A + f(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1)


def _cubic_taps(n: int, factor: int):
    """(taps (n * factor, 4) int, weights (n * factor, 4) float32) of one
    axis: the source coordinate (d + 0.5) * (1 / factor) - 0.5 in double,
    rounded to float32, its floor's four neighbours clipped to the axis."""
    d = np.arange(n * factor, dtype=np.float64)
    fx = ((d + 0.5) * (1.0 / factor) - 0.5).astype(np.float32)
    sx = np.floor(fx)
    frac = (fx - sx).astype(np.float32)
    taps = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n - 1)
    return taps, _cubic_coeffs(frac)


def resize_cubic(img: np.ndarray, factor: int) -> np.ndarray:
    """(H, W) or (H, W, C) -> float32 (H * factor, W * factor[, C]), cv2's
    INTER_CUBIC upsample by the integer `factor` (module docstring). The
    vertical pass sums as cv2's vector loop does wherever the output row
    (W * factor * C values) is a whole number of its vectors, which every
    factor that is a multiple of 8 gives."""
    img = np.asarray(img, np.float32)
    flat = img.ndim == 2
    if flat:
        img = img[..., None]
    h, w, c = img.shape
    xi, xw = _cubic_taps(w, factor)
    t = img[:, xi[:, 0]] * xw[:, 0, None]
    for k in range(1, 4):
        t = t + img[:, xi[:, k]] * xw[:, k, None]          # (h, W, c)
    yi, yw = _cubic_taps(h, factor)
    b = yw[:, :, None, None]
    out = t[yi[:, 0]] * b[:, 0] + (t[yi[:, 1]] * b[:, 1]
                                   + (t[yi[:, 2]] * b[:, 2] + t[yi[:, 3]] * b[:, 3]))
    return out[..., 0] if flat else out


def find_peaks(thresh: float, img: np.ndarray, top_n: int | None = None) -> np.ndarray:
    """[x, y] integer coordinates of the local maxima above `thresh`; with
    `top_n`, the `top_n` highest."""
    peaks_binary = (maximum_filter(img, footprint=_CROSS) == img) & (img > thresh)
    peaks = np.array(np.nonzero(peaks_binary)[::-1]).T
    if top_n and len(peaks) > top_n:
        confs = img[peaks[:, 1], peaks[:, 0]]
        order = np.argsort(confs)[::-1]
        return peaks[order[:top_n]]
    return peaks


def compute_resized_coords(coords, resize_factor):
    """The half-pixel coordinate mapping under a resize."""
    return (np.array(coords, dtype=float) + 0.5) * resize_factor - 0.5


def nms_heatmaps(heatmaps: np.ndarray, upsamp_factor: float = 8.0, thresh: float = 0.1,
                 num_joints: int = 15, refine_center: bool = True, win_size: int = 2):
    """Per-joint peak lists [(N_j, 4) of x, y, score, id] of (H, W, >= K)
    heatmaps."""
    joint_list_per_joint_type = []
    cnt_total = 0
    for joint in range(num_joints):
        map_orig = heatmaps[:, :, joint]
        peak_coords = find_peaks(thresh, map_orig)
        peaks = np.zeros((len(peak_coords), 4))
        for i, peak in enumerate(peak_coords):
            if refine_center:
                x_min, y_min = np.maximum(0, peak - win_size)
                x_max, y_max = np.minimum(np.array(map_orig.T.shape) - 1, peak + win_size)
                patch = map_orig[y_min:y_max + 1, x_min:x_max + 1]
                map_upsamp = resize_cubic(patch, int(upsamp_factor))
                loc_max = np.unravel_index(map_upsamp.argmax(), map_upsamp.shape)
                patch_center = compute_resized_coords(peak[::-1] - [y_min, x_min], upsamp_factor)
                refined = np.array(loc_max) - patch_center  # (dy, dx)
                score = map_upsamp[loc_max]
            else:
                refined = np.zeros(2)
                score = map_orig[tuple(peak[::-1])]
            xy = compute_resized_coords(peak_coords[i], upsamp_factor) + refined[::-1]
            peaks[i, :] = (xy[0], xy[1], score, cnt_total)
            cnt_total += 1
        joint_list_per_joint_type.append(peaks)
    return joint_list_per_joint_type
