"""PoP-Net's universal alignment field on the host (the JAX package's
`decode/align.py`, library-only there too): the network's short-range
(dx, dy) fields, fused with long-range fields from the heatmap peaks, so
that every pixel points at its nearest joint of each type."""

from __future__ import annotations

import numpy as np

from popnet_tpu_torch.decode.peaks_np import find_peaks


def universe_align_map(heatmaps: np.ndarray, alignmaps: np.ndarray, num_joints: int,
                       align_radius: int, ht_thresh: float = 0.5, top_n: int | None = None,
                       visibility=None) -> np.ndarray:
    """heatmaps (H, W, >= K), alignmaps (H, W, 2K) -> a copy of alignmaps
    in which every pixel outside the radius boxes of a joint's peaks holds
    the offset toward that joint's nearest peak; a joint without peaks, or
    with visibility under 0.5, keeps its field."""
    h, w = heatmaps.shape[0], heatmaps.shape[1]
    xx, yy = np.meshgrid(range(w), range(h))

    uni = np.copy(alignmaps)
    for j in range(num_joints):
        map_orig = heatmaps[:, :, j]
        peaks = find_peaks(ht_thresh, map_orig, top_n)
        if len(peaks) == 0 or (visibility is not None and visibility[j] < 0.5):
            continue
        dx_maps, dy_maps, dist_maps = [], [], []
        fg_mask = np.zeros((h, w), dtype=np.int64)
        for peak in peaks:
            dx = peak[0] - xx
            dy = peak[1] - yy
            dx_maps.append(dx)
            dy_maps.append(dy)
            dist_maps.append(dx**2 + dy**2)
            x_min, y_min = np.maximum(0, peak - align_radius)
            x_max, y_max = np.minimum(np.array(map_orig.T.shape) - 1, peak + align_radius)
            fg_mask[y_min:y_max + 1, x_min:x_max + 1] = 1

        dx_maps = np.array(dx_maps)
        dy_maps = np.array(dy_maps)
        dist_maps = np.array(dist_maps)
        nearest = np.argmin(dist_maps, axis=0)
        far_x = dx_maps[nearest, yy, xx]
        far_y = dy_maps[nearest, yy, xx]
        bg = fg_mask == 0
        uni[bg, 2 * j] = far_x[bg]
        uni[bg, 2 * j + 1] = far_y[bg]
    return uni
