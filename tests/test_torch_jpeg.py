"""The port's JPEG reader (popnet_tpu_torch.data.image_io) against
cv2.imread, bit for bit, on files written here by cv2: qualities, chroma
samplings, grey, optimized tables, restart intervals, sizes from 1x1 up and
the eight EXIF orientations; and the files it refuses, each with a
ValueError that names the file and the reason. cv2 is the reference here
only: the package reads no file through it."""

import os
import struct

import cv2
import numpy as np
import pytest

from popnet_tpu_torch.data.image_io import apply_exif_orientation, decode_jpeg, imread_bgr

QUALITIES = (50, 75, 95, 100)
SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "grey": None}
SIZES = ((1, 1), (7, 9), (17, 33), (427, 640), (480, 640))
EXTRAS = {"plain": [], "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
          "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}


def frame(rng, h: int, w: int) -> np.ndarray:
    """Noise over a smooth ramp: both the DC and the AC paths of the IDCT
    and the upsampling filters carry signal."""
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, ((xx + yy) * 2) % 256], -1)
    return np.clip(ramp + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def encode(img: np.ndarray, quality: int, sampling: str, extra: str) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *EXTRAS[extra]]
    if SAMPLINGS[sampling] is None:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def exif_segment(orientation: int, little_endian: bool = True) -> bytes:
    """An APP1 Exif segment whose IFD0 holds one tag, the orientation."""
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def check_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
    ref = cv2.imread(path)
    got = imread_bgr(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_reader_equals_cv2_imread(tmp_path, size, sampling):
    """Every quality of QUALITIES, plain, with optimized Huffman tables and
    with a restart interval of 3 MCUs, at this size and sampling."""
    h, w = size
    rng = np.random.default_rng([h, w, len(sampling)])
    img = frame(rng, h, w)
    for q in QUALITIES:
        for extra in EXTRAS:
            check_file(str(tmp_path / f"{q}_{extra}.jpg"), encode(img, q, sampling, extra))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_reader_applies_the_exif_orientation_as_cv2(tmp_path, orientation):
    """An Exif segment spliced in after SOI, in both byte orders: cv2
    flips and transposes the frame by its orientation, 5-8 swapping height
    and width, and so does the reader."""
    img = frame(np.random.default_rng(orientation), 17, 33)
    data = encode(img, 90, "420", "plain")
    for le in (True, False):
        check_file(str(tmp_path / f"o{orientation}{le}.jpg"),
                   data[:2] + exif_segment(orientation, le) + data[2:])
    assert apply_exif_orientation(np.zeros((2, 3, 3), np.uint8), orientation).shape == (
        (3, 2, 3) if orientation >= 5 else (2, 3, 3))


def refused(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError) as err:
        imread_bgr(path)
    msg = str(err.value)
    assert msg.startswith(path), msg
    return msg


def test_reader_refuses_what_it_does_not_read(tmp_path):
    """Progressive, arithmetic-coded, lossless, hierarchical, 12-bit,
    4-component, RGB-coded (Adobe transform 0, no JFIF) files and files
    that are no JPEG each raise a ValueError naming the file and the
    reason; a missing file raises FileNotFoundError."""
    img = frame(np.random.default_rng(0), 17, 33)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert "progressive" in refused(tmp_path, "p.jpg", prog.tobytes())
    base = encode(img, 90, "420", "plain")
    sof = base.index(b"\xff\xc0")
    for marker, what in ((b"\xff\xc9", "arithmetic"), (b"\xff\xca", "arithmetic"),
                         (b"\xff\xc3", "lossless"), (b"\xff\xc5", "hierarchical")):
        assert what in refused(tmp_path, f"{marker.hex()}.jpg", base[:sof] + marker + base[sof + 2:])
    p12 = bytearray(base)
    p12[sof + 4] = 12
    assert "12 bits" in refused(tmp_path, "12.jpg", bytes(p12))
    # a frame header of 4 components (CMYK), 16x16
    cmyk = (b"\xff\xd8\xff\xc0\x00\x14\x08\x00\x10\x00\x10\x04"
            + b"".join(bytes([i, 0x11, 0]) for i in range(1, 5)) + b"\xff\xd9")
    assert "CMYK" in refused(tmp_path, "cmyk.jpg", cmyk)
    # Adobe APP14 with transform 0 (RGB) in place of the JFIF APP0 segment
    app0 = base.index(b"\xff\xe0")
    app0_end = app0 + 2 + struct.unpack(">H", base[app0 + 2:app0 + 4])[0]
    adobe_payload = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    adobe = b"\xff\xee" + struct.pack(">H", len(adobe_payload) + 2) + adobe_payload
    assert "RGB" in refused(tmp_path, "rgb.jpg", base[:app0] + adobe + base[app0_end:])
    ok, png = cv2.imencode(".png", img)
    assert "not a JPEG" in refused(tmp_path, "x.png", png.tobytes())
    assert "not a JPEG" in refused(tmp_path, "empty.jpg", b"")
    assert "truncated" in refused(tmp_path, "cut.jpg", base[:sof + 6])
    with pytest.raises(FileNotFoundError):
        imread_bgr(str(tmp_path / "missing.jpg"))
    with pytest.raises(ValueError, match="<bytes>: progressive"):
        decode_jpeg(prog.tobytes())


def test_reader_keeps_a_transform_1_adobe_file_as_ycbcr(tmp_path):
    """An Adobe segment with transform 1 (YCbCr) decodes as cv2 decodes
    it."""
    base = encode(frame(np.random.default_rng(1), 33, 17), 80, "422", "plain")
    adobe_payload = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 1)
    adobe = b"\xff\xee" + struct.pack(">H", len(adobe_payload) + 2) + adobe_payload
    check_file(str(tmp_path / "ycc.jpg"), base[:2] + adobe + base[2:])


def test_committed_fixtures_decode_to_their_recorded_hashes():
    """The JPEG fixtures the chip run decodes (tests/fixtures/jpeg, written by
    cv2.imwrite): cv2.imread's output hashes as recorded beside them, the
    reader's the same, the progressive one refused by the reader."""
    import hashlib
    import json

    root = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg")
    with open(os.path.join(root, "hashes.json")) as f:
        recorded = json.load(f)
    assert len(recorded["decoded"]) >= 6 and recorded["refused"]
    for name, digest in recorded["decoded"].items():
        path = os.path.join(root, name)
        assert hashlib.sha256(cv2.imread(path).tobytes()).hexdigest() == digest, name
        assert hashlib.sha256(imread_bgr(path).tobytes()).hexdigest() == digest, name
    for name in recorded["refused"]:
        with pytest.raises(ValueError, match="progressive"):
            imread_bgr(os.path.join(root, name))


def test_chip_smoke_writer_is_read_alike_by_cv2_and_the_reader():
    """chip_smoke.jpeg_baseline, the NumPy baseline writer of the chip run's
    RGB sets: cv2 and the reader decode its files to the same frame, close
    to the written one (PSNR over 25 dB at quality 90: measured 30 dB on
    the noisiest frame here, 33 dB on painted 640x480 frames)."""
    import chip_smoke

    rng = np.random.default_rng(5)
    frames, _ = chip_smoke.rgb_frames(rng, 1, 120, 160)
    for img in frames + [frame(rng, 37, 53), frame(rng, 1, 1)]:
        data = chip_smoke.jpeg_baseline(img)
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        got = decode_jpeg(data)
        np.testing.assert_array_equal(got, ref)
        mse = float(np.mean((got.astype(np.float64) - img) ** 2))
        assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 25.0
