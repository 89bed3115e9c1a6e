"""Writes the JPEG fixtures of tests/fixtures/jpeg with cv2 and records the
sha256 of cv2.imread's output for each (hashes.json): every chroma
sampling, grey, restart markers, optimized tables, an EXIF orientation and
one progressive file, which the port's reader refuses. The card's machine
has no cv2, so the chip run checks the reader against these hashes.

    python -m tests.jpeg_fixtures      # rewrites the fixtures and hashes.json
"""

import hashlib
import json
import os

import cv2
import numpy as np

from tests.test_torch_jpeg import encode, exif_segment, frame

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
    decoded = {}
    for name, data in files.items():
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(data)
        if name != PROGRESSIVE:
            decoded[name] = hashlib.sha256(cv2.imread(path).tobytes()).hexdigest()
    recorded = {"decoded": decoded, "refused": [PROGRESSIVE]}
    with open(os.path.join(root, "hashes.json"), "w") as f:
        json.dump(recorded, f, indent=1, sort_keys=True)
    return recorded


if __name__ == "__main__":
    print(json.dumps(write_fixtures(), indent=1))
