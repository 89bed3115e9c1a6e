"""Window readouts of depth / alignment fields at decoded joint positions.

The port's own copy of `popnet_tpu/decode/readout.py`, kept equal to it
(tests/test_torch_eval.py pins the two).

Exact-semantics NumPy implementations (reference: lib/utils/common.py:118-318).
All take (x, y) centers on the map's grid and a window radius; windows are
clamped to the map like the reference (min(max(...)) ordering preserved).
"""

from __future__ import annotations

import numpy as np


def _window(center, h, w, radius):
    min_x = min(max(int(center[0] - radius), 0), w - 1)
    max_x = max(min(int(center[0] + radius), w - 1), 0)
    min_y = min(max(int(center[1] - radius), 0), h - 1)
    max_y = max(min(int(center[1] + radius), h - 1), 0)
    xx, yy = np.meshgrid(range(min_x, max_x + 1), range(min_y, max_y + 1))
    return xx, yy


def retrieve_depth_weighted(center, depthmap, radius=1):
    """Plain window mean of the depth map (reference: common.py:251-269)."""
    xx, yy = _window(center, depthmap.shape[0], depthmap.shape[1], radius)
    return float(np.mean(depthmap[yy, xx]))


def retrieve_depth_heat_weighted(center, depthmap, heatmap, radius=1):
    """Heatmap-weighted window average of the depth map
    (reference: common.py:272-293). Clamps negative heat in place like the
    reference (pass a copy if that matters)."""
    heatmap[heatmap < 0] = 0
    xx, yy = _window(center, depthmap.shape[0], depthmap.shape[1], radius)
    w = heatmap[yy, xx] + 1e-9
    return float(np.sum(depthmap[yy, xx] * w) / np.sum(w))


def retrieve_depth_heat_max(center, depthmap, heatmap, radius=1):
    """Depth at the window's heatmap argmax (reference: common.py:296-318)."""
    heatmap[heatmap < 0] = 0
    xx, yy = _window(center, depthmap.shape[0], depthmap.shape[1], radius)
    w = heatmap[yy, xx]
    return float(depthmap[yy, xx].ravel()[np.argmax(w)])


def retrieve_offsets_direct(center, align_field):
    """(reference: common.py:118-129)."""
    dx = align_field[center[1], center[0], 0] + 0.5
    dy = align_field[center[1], center[0], 1] + 0.5
    return float(dx), float(dy)


def retrieve_offsets_weighted(center, align_field, radius=1):
    """Window mean of corrected offsets (reference: common.py:132-158)."""
    xx, yy = _window(center, align_field.shape[0], align_field.shape[1], radius)
    dx_vec = align_field[yy, xx, 0] + (xx - center[0]) + 0.5
    dy_vec = align_field[yy, xx, 1] + (yy - center[1]) + 0.5
    return float(np.mean(dx_vec)), float(np.mean(dy_vec))


def retrieve_offsets_heat_weighted(center, align_field, heatmap, radius=1):
    """Heat-weighted mean of corrected offsets (reference: common.py:161-187)."""
    heatmap[heatmap < 0] = 0
    xx, yy = _window(center, align_field.shape[0], align_field.shape[1], radius)
    w = heatmap[yy, xx] + 1e-9
    dx_vec = align_field[yy, xx, 0] + (xx - center[0]) + 0.5
    dy_vec = align_field[yy, xx, 1] + (yy - center[1]) + 0.5
    return float(np.sum(dx_vec * w) / np.sum(w)), float(np.sum(dy_vec * w) / np.sum(w))


def retrieve_offsets_heat_max(center, align_field, heatmap, radius=1):
    """Corrected offset at the window's heat argmax
    (reference: common.py:190-218)."""
    heatmap[heatmap < 0] = 0
    xx, yy = _window(center, align_field.shape[0], align_field.shape[1], radius)
    w = heatmap[yy, xx]
    dx_vec = (align_field[yy, xx, 0] + (xx - center[0]) + 0.5).ravel()
    dy_vec = (align_field[yy, xx, 1] + (yy - center[1]) + 0.5).ravel()
    k = np.argmax(w)
    return float(dx_vec[k]), float(dy_vec[k])


def retrieve_offsets_nn(center, align_field, radius=1):
    """Offset of the window cell whose stored offset is smallest
    (reference: common.py:221-248). Note the floor-style clamping differs
    from the other readers, matching the reference."""
    h, w = align_field.shape[0], align_field.shape[1]
    min_x = max(int(int(center[0] - radius)), 0)
    max_x = min(int(int(center[0] + radius)), w - 1)
    min_y = max(int(int(center[1] - radius)), 0)
    max_y = min(int(int(center[1] + radius)), h - 1)
    xx, yy = np.meshgrid(range(min_x, max_x + 1), range(min_y, max_y + 1))
    dx_map = ((xx - center[0]) + 0.5).ravel()
    dy_map = ((yy - center[1]) + 0.5).ravel()
    dx_vec = align_field[yy, xx, 0].ravel()
    dy_vec = align_field[yy, xx, 1].ravel()
    k = np.argmin(dx_vec**2 + dy_vec**2)
    return float(dx_vec[k] + dx_map[k]), float(dy_vec[k] + dy_map[k])
