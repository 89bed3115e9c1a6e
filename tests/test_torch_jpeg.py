"""The port's JPEG reader (popnet_tpu_torch.data.image_io) against
cv2.imread, bit for bit, on files written here by cv2: qualities, chroma
samplings, grey, optimized tables, restart intervals, sizes from 1x1 up and
the eight EXIF orientations; and the files it refuses, each with a
ValueError that names the file and the reason. The port's JPEG writer
(`encode_jpeg`, `imwrite_jpeg`) against cv2.imencode and cv2.imwrite, byte
for byte. cv2 is the reference here only: the package reads and writes no
file through it."""

import os
import struct

import cv2
import numpy as np
import pytest
import torch

from popnet_tpu_torch.data.image_io import (apply_exif_orientation, decode_jpeg, encode_jpeg,
                                            imread_bgr, imwrite_jpeg)

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


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def test_chip_smoke_writer_is_read_alike_by_cv2_and_the_reader(tmp_path):
    """chip_smoke.write_rgb_sets, the writer of the chip run's RGB sets,
    writes each painted frame as cv2.imencode does at RGB_QUALITY, byte for
    byte (encode_jpeg), and cv2 and the reader decode its files to the same
    frame, close to the painted one (PSNR over 25 dB at quality 90)."""
    import chip_smoke

    frames, _ = chip_smoke.rgb_frames(np.random.default_rng(5), 2)
    chip_smoke.write_rgb_sets(np.random.default_rng(5), str(tmp_path), 1, 1)
    for i, img in enumerate(frames):
        with open(tmp_path / "images" / f"{i:06d}.jpg", "rb") as f:
            data = f.read()
        assert data == cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                                  chip_smoke.RGB_QUALITY])[1].tobytes()
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        got = decode_jpeg(data)
        np.testing.assert_array_equal(got, ref)
        mse = float(np.mean((got.astype(np.float64) - img) ** 2))
        assert 10 * np.log10(255.0 ** 2 / mse) > 25.0


ENCODE_QUALITIES = (50, 90, 95, 100)
ENCODE_SIZES = ((1, 1), (7, 9), (15, 17), (480, 512))


@pytest.mark.parametrize("size", ENCODE_SIZES, ids=[f"{h}x{w}" for h, w in ENCODE_SIZES])
def test_encoder_equals_cv2_imencode(tmp_path, size):
    """encode_jpeg = cv2.imencode(".jpg") byte for byte on a seeded frame,
    noise and a flat image at each quality of ENCODE_QUALITIES (95 also by
    default, as cv2's); imwrite_jpeg's file = cv2.imwrite's; the reader
    decodes every file as cv2.imdecode does."""
    h, w = size
    rng = np.random.default_rng(h * 31 + w)
    images = (frame(rng, h, w), rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
              np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8))
    for img in images:
        for q in ENCODE_QUALITIES:
            ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()
            got = encode_jpeg(img, q)
            assert got == ref, (q, len(got), len(ref))
            np.testing.assert_array_equal(
                decode_jpeg(got), cv2.imdecode(np.frombuffer(ref, np.uint8), cv2.IMREAD_COLOR))
        assert encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes()
    cv2.imwrite(str(tmp_path / "ref.jpg"), images[0])
    imwrite_jpeg(tmp_path / "got.jpg", images[0])
    assert (tmp_path / "got.jpg").read_bytes() == (tmp_path / "ref.jpg").read_bytes()


def test_encoder_refuses_what_it_does_not_write():
    """Grey, one- and four-channel images, other dtypes and qualities
    outside 1-100 raise, naming the shape or the value."""
    img = np.zeros((4, 5, 3), np.uint8)
    for bad in (np.zeros((4, 5), np.uint8), np.zeros((4, 5, 1), np.uint8),
                np.zeros((4, 5, 4), np.uint8), np.zeros((4, 5, 3), np.float32),
                np.zeros((0, 5, 3), np.uint8)):
        with pytest.raises(ValueError, match=r"\(4, 5|\(0, 5"):
            encode_jpeg(bad)
    for q in (0, 101, -5, 95.5, True):
        with pytest.raises(ValueError, match="quality"):
            encode_jpeg(img, q)
