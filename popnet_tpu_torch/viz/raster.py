"""cv2's line and circle rasterizer on a host uint8 BGR image, in place.

`line(img, p1, p2, color, thickness)` sets the pixels that OpenCV 5.0.0's
`cv2.line(img, p1, p2, color, thickness)` sets at `lineType=8`, and
`circle(img, c, r, color, thickness)` those of `cv2.circle(img, c, r, color,
thickness, lineType=8)`, bit for bit: the Bresenham walk, the thick line's
fixed-point quad and round caps, the midpoint circle and the thick circle's
polygon of table sines (`csrc/draw_u8.cpp`, host C++ built with the host
C++ compiler at first use, `ops._build.host_library`). Points may lie off
the image or be negative; both clip as cv2 clips. Only `LINE_8` is drawn:
other line types raise.
"""

from __future__ import annotations

import ctypes

import numpy as np

from popnet_tpu_torch.ops._build import host_library

LINE_8 = 8
MAX_THICKNESS = 32767
_INT32 = (-(1 << 31), (1 << 31) - 1)


def _lib():
    lib = host_library("draw_u8")
    if not getattr(lib, "_typed", False):
        i = ctypes.c_int
        lib.popnet_draw_line.argtypes = [ctypes.c_void_p, i, i, i, i, i, i, ctypes.c_char_p, i]
        lib.popnet_draw_circle.argtypes = [ctypes.c_void_p, i, i, i, i, i, ctypes.c_char_p, i]
        lib.popnet_draw_line.restype = lib.popnet_draw_circle.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(img: np.ndarray, color, line_type: int) -> bytes:
    if line_type != LINE_8:
        raise ValueError(f"only lineType=8 (LINE_8) is drawn, got {line_type}: "
                         "LINE_4 and LINE_AA are not ported")
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3
            and img.shape[2] == 3 and img.flags.c_contiguous and img.flags.writeable):
        raise ValueError("the rasterizer draws into a writable C-contiguous (H, W, 3) uint8 "
                         f"array, got {type(img).__name__} "
                         f"{getattr(img, 'shape', None)} {getattr(img, 'dtype', None)}")
    c = tuple(color)
    if len(c) != 3 or not all(isinstance(v, (int, np.integer)) and 0 <= v <= 255 for v in c):
        raise ValueError(f"color must be three integers 0..255 (B, G, R), got {color!r}")
    return bytes(int(v) for v in c)


def _ints(*values) -> list[int]:
    out = []
    for v in values:
        if not isinstance(v, (int, np.integer)) or not _INT32[0] <= v <= _INT32[1]:
            raise ValueError(f"coordinates and sizes must be 32-bit integers, got {v!r}")
        out.append(int(v))
    return out


def line(img: np.ndarray, p1, p2, color, thickness: int = 1, line_type: int = LINE_8):
    """`cv2.line(img, p1, p2, color, thickness, lineType=8)`: returns `img`."""
    c = _check(img, color, line_type)
    x1, y1, x2, y2, t = _ints(*p1, *p2, thickness)
    if not 0 < t <= MAX_THICKNESS:
        raise ValueError(f"line thickness must be 1..{MAX_THICKNESS}, got {t}")
    _lib().popnet_draw_line(img.ctypes.data, img.shape[0], img.shape[1], x1, y1, x2, y2, c, t)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1,
           line_type: int = LINE_8):
    """`cv2.circle(img, center, radius, color, thickness, lineType=8)`
    (thickness < 0 fills): returns `img`."""
    c = _check(img, color, line_type)
    cx, cy, r, t = _ints(*center, radius, thickness)
    if r < 0 or t > MAX_THICKNESS:
        raise ValueError(f"circle radius must be >= 0 and thickness <= {MAX_THICKNESS}, "
                         f"got {r}, {t}")
    _lib().popnet_draw_circle(img.ctypes.data, img.shape[0], img.shape[1], cx, cy, r, c, t)
    return img
