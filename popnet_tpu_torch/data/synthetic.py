"""Synthetic MP-3DHP-shaped depth sets on disk, in NumPy only.

`build` writes the layout of the benchmark's release, which the training,
mp-aug, evaluation and set-construction code reads: depth_maps/*.npy,
seg_maps/*.npy, bg_maps/*.npy, labels.json (with its "intrinsics" key),
labels_bg.json and one labels_loc<i>.json per recording location of
mp-aug. `build_itop` writes a single-person set at the ITOP camera's
geometry. Each person is a kinematic template (`person_scene`).

The draws, their order and the arithmetic are those of the JAX package's
test generator (tests/synthetic_data.py), so a seed writes the same bytes in
both packages: the port's method, ablation and ITOP tables train and score
on the sets the JAX package's tables used.
"""

from __future__ import annotations

import json
import os

import numpy as np

from popnet_tpu_torch.core.camera import ITOP_INTRINSICS, KDH3D_INTRINSICS, CameraIntrinsics

H, W = 512, 480
K = 15
# where the people of each mp-aug location stand, (x, y) in pixels
LOCATION_CENTERS = ((140.0, 256.0), (340.0, 256.0), (140.0, 380.0), (340.0, 380.0),
                    (240.0, 300.0))


def person_scene(rng: np.random.Generator, center, z_base: float, H: int = H, W: int = W,
                 intr: CameraIntrinsics = KDH3D_INTRINSICS, scale: float = 1.0,
                 block: int = 18):
    """One person of the kinematic template: (depth (H, W) float32, seg
    mask (H, W) float32, annotation). The joints follow an articulated
    skeleton (head above neck, shoulders either side, limbs hanging with
    random articulation) in the benchmark's keypoint order, so a joint's
    identity follows from the arrangement; each joint is a block of side
    2 * block * scale at its depth."""
    s = rng.uniform(0.85, 1.25) * scale
    lean = rng.normal(0.0, 0.12)

    def rot(vx, vy, a):
        return np.array([vx * np.cos(a) - vy * np.sin(a), vx * np.sin(a) + vy * np.cos(a)])

    torso = np.asarray(center, np.float64) + rng.normal(0, 8, 2)
    neck = torso + rot(0, -62 * s, lean)
    head = neck + rot(0, -34 * s, lean + rng.normal(0, 0.1))
    pts = np.zeros((K, 2))
    pts[8], pts[1], pts[0] = torso, neck, head
    for side, sh_i, el_i, wr_i, hip_i, kn_i, an_i in ((+1, 2, 4, 6, 9, 11, 13),
                                                       (-1, 3, 5, 7, 10, 12, 14)):
        sh = neck + rot(side * 30 * s, 6 * s, lean)
        el = sh + rot(0, 42 * s, lean + rng.normal(0, 0.5))
        wr = el + rot(0, 40 * s, lean + rng.normal(0, 0.7))
        hip = torso + rot(side * 20 * s, 46 * s, lean)
        kn = hip + rot(0, 50 * s, lean + rng.normal(0, 0.25))
        an = kn + rot(0, 48 * s, lean + rng.normal(0, 0.25))
        for i, p in ((sh_i, sh), (el_i, el), (wr_i, wr), (hip_i, hip), (kn_i, kn), (an_i, an)):
            pts[i] = p
    pts += rng.normal(0, 2.0 * scale, size=(K, 2))
    pts = np.clip(pts, 10 * scale, [W - 10 * scale, H - 10 * scale])
    z = z_base + rng.normal(0, 0.05, K)
    depth = np.zeros((H, W), np.float32)
    seg = np.zeros((H, W), np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    blk = max(4, int(round(block * scale)))
    for k in range(K):
        m = (np.abs(xs - pts[k, 0]) < blk) & (np.abs(ys - pts[k, 1]) < blk)
        depth[m] = z[k]
        seg[m] = 1.0
    j3 = np.stack([(pts[:, 0] - intr.cx) / intr.fx * z, (pts[:, 1] - intr.cy) / intr.fy * z, z], 1)
    margin = 20 * scale
    ann = {
        "2d_joints": pts.tolist(),
        "3d_joints": j3.tolist(),
        "bbox": [float(pts[:, 0].min() - margin), float(pts[:, 1].min() - margin),
                 float(pts[:, 0].max() + margin), float(pts[:, 1].max() + margin)],
        "pose_weight": float(rng.uniform(0.8, 1.5)),
    }
    return depth, seg, ann


def _intrinsics(cam: CameraIntrinsics) -> dict:
    return {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy}


def _dump(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def build_itop(root: str, n_images: int = 6, seed: int = 0) -> dict:
    """A synthetic ITOP-geometry set under `root`: depth_maps/itop_NNNN.npy,
    320x240 single-person frames at the ITOP camera over a flat 4.5 m
    background, and labels.json (with its "intrinsics"). Returns
    {"img_dir", "labels"}."""
    rng = np.random.default_rng(seed)
    h, w = 240, 320
    img_dir = os.path.join(root, "depth_maps")
    os.makedirs(img_dir, exist_ok=True)
    labels = {"intrinsics": _intrinsics(ITOP_INTRINSICS)}
    for i in range(n_images):
        center = np.array([w / 2, h / 2]) + rng.uniform(-25, 25, 2)
        depth, _, ann = person_scene(rng, center, rng.uniform(1.8, 3.6), H=h, W=w,
                                     intr=ITOP_INTRINSICS, scale=0.42, block=16)
        depth[depth == 0] = 4.5
        name = f"itop_{i:04d}.npy"
        np.save(os.path.join(img_dir, name), depth)
        labels[name] = [ann]
    path = os.path.join(root, "labels.json")
    _dump(labels, path)
    return {"img_dir": img_dir, "labels": path}


def build(root: str, n_images: int = 6, n_bg: int = 2, n_locations: int = 2,
          seed: int = 0) -> dict:
    """A synthetic MP-3DHP tree under `root`: `n_bg` smooth 2.5-5.5 m
    backgrounds (bg_maps/, labels_bg.json), `n_images` single-person frames
    at the frame's centre (labels.json) and, for each of `n_locations`
    mp-aug locations, `n_images` recordings of one person there
    (labels_loc<i>.json), each frame with its seg mask. Returns the paths:
    {"img_dir", "seg_dir", "bg_dir", "labels", "labels_bg", "labels_locs"}."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "depth_maps")
    seg_dir = os.path.join(root, "seg_maps")
    bg_dir = os.path.join(root, "bg_maps")
    for d in (img_dir, seg_dir, bg_dir):
        os.makedirs(d, exist_ok=True)

    bg_index = {}
    for i in range(n_bg):
        ys, xs = np.mgrid[0:H, 0:W]
        bg = (4.0 + 1.5 * np.sin(xs / 60.0 + i) * np.cos(ys / 80.0)).astype(np.float32)
        name = f"bg_{i:03d}.npy"
        np.save(os.path.join(bg_dir, name), bg)
        bg_index[str(i)] = {"file_name": name}
    _dump(bg_index, os.path.join(root, "labels_bg.json"))

    intr = _intrinsics(KDH3D_INTRINSICS)
    labels = {"intrinsics": intr}
    for i in range(n_images):
        depth, seg, ann = person_scene(rng, np.array([W / 2, H / 2]), rng.uniform(2.5, 4.0))
        name = f"img_{i:04d}.npy"
        np.save(os.path.join(img_dir, name), depth)
        np.save(os.path.join(seg_dir, name), seg)
        labels[name] = [ann]
    _dump(labels, os.path.join(root, "labels.json"))

    loc_files = []
    for loc in range(n_locations):
        loc_labels = {"intrinsics": intr}
        center = np.array(LOCATION_CENTERS[loc % len(LOCATION_CENTERS)])
        for i in range(n_images):
            depth, seg, ann = person_scene(rng, center, rng.uniform(2.0, 4.5))
            name = f"loc{loc}_{i:04d}.npy"
            np.save(os.path.join(img_dir, name), depth)
            np.save(os.path.join(seg_dir, name), seg)
            loc_labels[name] = [ann]
        path = os.path.join(root, f"labels_loc{loc}.json")
        _dump(loc_labels, path)
        loc_files.append(path)

    return {"img_dir": img_dir, "seg_dir": seg_dir, "bg_dir": bg_dir,
            "labels": os.path.join(root, "labels.json"),
            "labels_bg": os.path.join(root, "labels_bg.json"), "labels_locs": loc_files}
