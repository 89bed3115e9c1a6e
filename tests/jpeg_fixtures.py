"""Writes the JPEG fixtures of tests/fixtures/jpeg with cv2 and records the
sha256 of cv2.imread's output for each (hashes.json): every chroma
sampling, grey, restart markers, optimized tables, an EXIF orientation, and
progressive files (4:2:0 at 20x24, with a restart interval, 4:4:4, 4:2:2,
grey, 1x1 and 37x53), with a 320x240 progressive frame and its baseline
twin, which the chip run times. The port's reader decodes every one. The
card's machine has no cv2, so the chip run checks the reader against these
hashes.

    python -m tests.jpeg_fixtures      # rewrites the fixtures and hashes.json
"""

import hashlib
import json
import os

import cv2
import numpy as np

from tests.test_torch_jpeg import SAMPLINGS, encode, exif_segment, frame

ROOT = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg")
# (file, (height, width), quality, sampling, extra)
FIXTURES = (
    ("s444_q95.jpg", (37, 53), 95, "444", "plain"),
    ("s422_q75.jpg", (37, 53), 75, "422", "plain"),
    ("s420_q50_rst.jpg", (61, 45), 50, "420", "restart"),
    ("s440_q90.jpg", (45, 61), 90, "440", "plain"),
    ("s411_q80_opt.jpg", (33, 70), 80, "411", "optimize"),
    ("grey_q85.jpg", (29, 31), 85, "grey", "plain"),
    ("s420_q100_1x1.jpg", (1, 1), 100, "420", "plain"),
)
EXIF = ("s420_exif6.jpg", (24, 40), 90, "420", 6)
PROGRESSIVE = "progressive.jpg"
# progressive fixtures: (file, (height, width), quality, sampling, restart interval)
PROGRESSIVE_FIXTURES = (
    ("p420_q75_rst.jpg", (45, 61), 75, "420", 2),
    ("p444_q90.jpg", (37, 53), 90, "444", 0),
    ("p422_q60.jpg", (33, 70), 60, "422", 0),
    ("pgrey_q85.jpg", (29, 31), 85, "grey", 0),
    ("p420_q95_1x1.jpg", (1, 1), 95, "420", 0),
    ("p420_q80_37x53.jpg", (37, 53), 80, "420", 0),
)
# the chip run's timing pair: one 320x240 frame, progressive and baseline
TIMED = ("p420_q75_320x240.jpg", "b420_q75_320x240.jpg")
TIMED_SIZE = (240, 320)


def smooth_frame(rng, h: int, w: int) -> np.ndarray:
    """A smooth colour field with a little noise: a 320x240 frame of a few KB."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / 23.0), 128 + 90 * np.cos(yy / 17.0),
                     128 + 60 * np.sin((xx + yy) / 41.0)], -1)
    return np.clip(base + rng.integers(-3, 4, (h, w, 3)), 0, 255).astype(np.uint8)


def progressive(img: np.ndarray, quality: int, sampling: str, restart: int = 0) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if SAMPLINGS[sampling] is None:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def write_fixtures(root: str = ROOT) -> dict:
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(14)
    files = {}
    for name, (h, w), q, sampling, extra in FIXTURES:
        files[name] = encode(frame(rng, h, w), q, sampling, extra)
    name, (h, w), q, sampling, orientation = EXIF
    data = encode(frame(rng, h, w), q, sampling, "plain")
    files[name] = data[:2] + exif_segment(orientation) + data[2:]
    ok, prog = cv2.imencode(".jpg", frame(rng, 20, 24), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    files[PROGRESSIVE] = prog.tobytes()
    for name, (h, w), q, sampling, restart in PROGRESSIVE_FIXTURES:
        files[name] = progressive(frame(rng, h, w), q, sampling, restart)
    img = smooth_frame(rng, *TIMED_SIZE)
    files[TIMED[0]] = progressive(img, 75, "420")
    files[TIMED[1]] = encode(img, 75, "420", "plain")
    decoded = {}
    for name, data in files.items():
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(data)
        decoded[name] = hashlib.sha256(cv2.imread(path).tobytes()).hexdigest()
    recorded = {"decoded": decoded, "refused": [], "timed": list(TIMED)}
    with open(os.path.join(root, "hashes.json"), "w") as f:
        json.dump(recorded, f, indent=1, sort_keys=True)
    return recorded


if __name__ == "__main__":
    print(json.dumps(write_fixtures(), indent=1))
