"""Image files read as cv2.imread reads them, without cv2 or PIL.

`imread_bgr(path)` decodes a baseline or extended-sequential JPEG (SOF0,
SOF1: 8-bit, Huffman-coded, one component or three YCbCr ones, any
sampling of integral factors, restart intervals, optimized tables) into
an (H, W, 3) uint8 BGR array equal to `cv2.imread(path)` (IMREAD_COLOR)
bit for bit, with the EXIF orientation of the file applied as cv2 applies
it. The decoding is `csrc/jpeg_decode.cpp`, host C++ rebuilding what
libjpeg-turbo does by default (the ISLOW integer IDCT, fancy upsampling,
the fixed-point YCbCr -> BGR tables), built with the host C++ compiler at
first use (`ops._build.host_library`). It refuses, with a `ValueError`
that names the file and the reason, progressive, lossless, hierarchical
and arithmetic-coded JPEG, sample precisions other than 8 bits, CMYK and
other 4-component files, RGB-coded files (an Adobe APP14 transform 0),
and anything that is not a JPEG. There is no other route: no fallback to
another decoder.

`encode_jpeg(bgr, quality)` writes the baseline JFIF file that
`cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])` writes,
byte for byte (`csrc/jpeg_encode.cpp`: libjpeg-turbo's defaults, 4:2:0,
the islow DCT, the standard Huffman tables), and `imwrite_jpeg(path, bgr)`
is `cv2.imwrite(path, bgr)` for a `.jpg` path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from popnet_tpu_torch.ops._build import host_library

_ERRLEN = 256


def _encoder():
    lib = host_library("jpeg_encode")
    if not getattr(lib, "_typed", False):
        lib.popnet_jpeg_encode_bound.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.popnet_jpeg_encode_bound.restype = ctypes.c_longlong
        lib.popnet_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.POINTER(ctypes.c_longlong), ctypes.c_char_p,
                                           ctypes.c_int]
        lib.popnet_jpeg_encode.restype = ctypes.c_int
        lib._typed = True
    return lib


def _lib():
    lib = host_library("jpeg_decode")
    if not getattr(lib, "_typed", False):
        lib.popnet_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                         ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        lib.popnet_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
                                           ctypes.c_char_p, ctypes.c_int]
        lib.popnet_jpeg_info.restype = lib.popnet_jpeg_decode.restype = ctypes.c_int
        lib._typed = True
    return lib


def apply_exif_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation tag's transform, as cv2.imread applies it
    (1 and unknown values leave the image as it is; 5-8 transpose it)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flips:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 BGR, oriented (`imread_bgr`); `name`
    goes into the error."""
    lib = _lib()
    h, w, orient = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.popnet_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(orient), err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.popnet_jpeg_decode(data, len(data), out.ctypes.data, err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return apply_exif_orientation(out, orient.value)


def imread_bgr(path) -> np.ndarray:
    """`cv2.imread(path)` for JPEG files: (H, W, 3) uint8 BGR. Raises
    FileNotFoundError for a missing file and ValueError (naming the file)
    for one it does not read."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, str(path))


def encode_jpeg(bgr: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 BGR -> the bytes of `cv2.imencode(".jpg", bgr,
    [cv2.IMWRITE_JPEG_QUALITY, quality])`: baseline JFIF, 4:2:0, IJG
    quality 1-100 (95, cv2's default, unless given). Raises ValueError for
    another shape or dtype, or a quality outside 1-100."""
    arr = np.asarray(bgr)
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes an (H, W, 3) uint8 BGR image, got shape "
                         f"{arr.shape} of {arr.dtype}")
    if isinstance(quality, bool) or int(quality) != quality or not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be an integer 1..100, got {quality!r}")
    h, w = arr.shape[:2]
    if not (1 <= h <= 65535 and 1 <= w <= 65535):
        raise ValueError(f"encode_jpeg takes sides of 1..65535 pixels, got shape {arr.shape}")
    arr = np.ascontiguousarray(arr)
    lib = _encoder()
    cap = lib.popnet_jpeg_encode_bound(h, w)
    out = np.empty(cap, np.uint8)
    n = ctypes.c_longlong()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.popnet_jpeg_encode(arr.ctypes.data, h, w, int(quality), out.ctypes.data, cap,
                              ctypes.byref(n), err, _ERRLEN):
        raise ValueError(f"encode_jpeg: {err.value.decode()}")
    return out[:n.value].tobytes()


def imwrite_jpeg(path, bgr: np.ndarray, quality: int = 95) -> None:
    """`cv2.imwrite(path, bgr)` for a JPEG file: `encode_jpeg`'s bytes."""
    data = encode_jpeg(bgr, quality)
    with open(path, "wb") as f:
        f.write(data)
