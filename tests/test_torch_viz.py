"""The port's visualizers (popnet_tpu_torch.viz) against cv2 5.0.0 and the
JAX package's, on the CPU: the rasterizer's lines and circles bit for bit
with cv2's over a seeded sweep of thicknesses, radii, canvases from 1x1 to
512x480 and ends inside, on the border, off the canvas and negative; the
skeleton drawers, the grey map and the overlay equal to `popnet_tpu.viz`;
and the `visualize-gt` / `visualize-pred` commands writing the JAX command
line's bytes. cv2 is the reference here only: the package draws without it."""

import filecmp
import json
import os

import cv2
import numpy as np
import pytest
import torch

import popnet_tpu.viz as jviz
from popnet_tpu.cli.main import main as jax_main
from popnet_tpu_torch import viz
from popnet_tpu_torch.cli.main import main as port_main
from popnet_tpu_torch.viz.raster import circle, line

from tests import synthetic_data

CANVASES = ((1, 1), (1, 9), (7, 1), (2, 3), (9, 13), (64, 48), (512, 480))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def point(rng, h: int, w: int) -> tuple[int, int]:
    """A point inside, on the border, just off, far off or negative."""
    kind = rng.integers(6)
    if kind == 0:
        return int(rng.integers(w)), int(rng.integers(h))
    if kind == 1:
        return int(rng.choice([0, w - 1])), int(rng.integers(h))
    if kind == 2:
        return int(rng.integers(w)), int(rng.choice([0, h - 1]))
    if kind == 3:
        return int(rng.integers(-8, w + 8)), int(rng.integers(-8, h + 8))
    if kind == 4:
        return int(rng.integers(-3 * w - 40, 0)), int(rng.integers(-3 * h - 40, 4 * h + 40))
    return int(rng.integers(-20000, 20000)), int(rng.integers(-20000, 20000))


@pytest.mark.parametrize("h,w", CANVASES, ids=[f"{h}x{w}" for h, w in CANVASES])
def test_line_and_circle_equal_cv2(h, w):
    """Lines of thickness 1-5 and circles of radius 0-30 (every angle step
    of cv2's polygon) at thickness -1 (filled), 1, 2 and 3, drawn one over
    another in several colours: the canvas equals cv2's after every call."""
    rng = np.random.default_rng(h * 1000 + w)
    ref = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = ref.copy()
    n = 60 if h * w > 10000 else 300
    for i in range(n):
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        p1, p2 = point(rng, h, w), point(rng, h, w)
        t = int(rng.integers(1, 6)) if i % 2 else int(rng.integers(1, 4))
        cv2.line(ref, p1, p2, color, t)
        line(got, p1, p2, color, t)
        assert np.array_equal(got, ref), ("line", p1, p2, t)
        r = int(rng.integers(1, 7)) if i % 2 else int(rng.integers(0, 31))
        ct = int(rng.choice([-1, 1, 2, 3]))
        cv2.circle(ref, p1, r, color, thickness=ct, lineType=8)
        circle(got, p1, r, color, ct)
        assert np.array_equal(got, ref), ("circle", p1, r, ct)


def test_rasterizer_refuses_what_it_does_not_draw():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="LINE_8"):
        line(img, (0, 0), (3, 3), (1, 2, 3), 1, line_type=cv2.LINE_AA)
    with pytest.raises(ValueError, match="LINE_8"):
        circle(img, (1, 1), 2, (1, 2, 3), 1, line_type=4)
    with pytest.raises(ValueError, match="uint8"):
        line(np.zeros((4, 4, 3), np.float32), (0, 0), (3, 3), (1, 2, 3))
    with pytest.raises(ValueError, match="uint8"):
        line(img[:, ::2], (0, 0), (3, 3), (1, 2, 3))
    with pytest.raises(ValueError, match="color"):
        line(img, (0, 0), (3, 3), (1, 2, 300))
    with pytest.raises(ValueError, match="thickness"):
        line(img, (0, 0), (3, 3), (1, 2, 3), 0)
    with pytest.raises(ValueError, match="32-bit"):
        circle(img, (1 << 31, 0), 2, (1, 2, 3))
    with pytest.raises(ValueError, match="radius"):
        circle(img, (1, 1), -1, (1, 2, 3))
    assert not img.any()


def skeletons(rng, n: int, h: int, w: int) -> list:
    """n (15, 2) skeletons as JSON floats: inside, across the border and
    negative, some coordinates whole numbers, some -0.5 < x < 0."""
    out = []
    for _ in range(n):
        s = rng.uniform(-30, max(h, w) + 30, (15, 2))
        s[rng.random((15, 2)) < 0.2] = np.round(s[rng.random((15, 2)) < 0.2].mean())
        s[0] = (-0.4, 3.999999)
        out.append(json.loads(json.dumps(s.tolist())))
    return out


@pytest.mark.parametrize("with_vis", [False, True])
def test_skeleton_drawers_equal_jax(with_vis):
    """draw_humans and draw_humans_visibility on seeded skeletons, with and
    without visibilities: the port's image equals JAX's, in place for a
    NumPy image, from one host copy for a tensor."""
    rng = np.random.default_rng(11)
    for h, w in ((512, 480), (40, 31), (1, 1)):
        humans = skeletons(rng, 3, h, w)
        vis = rng.uniform(0, 1, (3, 15)).tolist() if with_vis else None
        base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for jfn, pfn in ((jviz.draw_humans, viz.draw_humans),
                         (jviz.draw_humans_visibility, viz.draw_humans_visibility)):
            ref = jfn(base.copy(), humans, visibilities=vis)
            mine = base.copy()
            assert pfn(mine, humans, visibilities=vis) is mine
            np.testing.assert_array_equal(mine, ref)
            t = torch.from_numpy(base.copy())
            np.testing.assert_array_equal(pfn(t, humans, visibilities=vis), ref)
            assert torch.equal(t, torch.from_numpy(base))


def test_grey_map_and_overlay_equal_jax():
    """depth_to_gray (clip, scale, truncate) and overlay_seg (float64 blend,
    truncated) equal JAX's NumPy bit for bit: depths across [0, 6] and its
    ends, float32 and float64 maps, a float and a uint8 mask."""
    rng = np.random.default_rng(12)
    d = rng.uniform(-1, 8, (48, 40))
    d[:4, :4] = [[0.0, 6.0, 6.0 - 1e-12, 3.0], [np.float32(2.4)] * 4, [1e-9] * 4, [5.99] * 4]
    for depth in (d, d.astype(np.float32)):
        ref = jviz.depth_to_gray(depth)
        got = viz.depth_to_gray(torch.from_numpy(depth))
        assert got.dtype == torch.uint8 and got.shape == (48, 40, 3)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(viz.depth_to_gray(depth, 4.5).numpy(),
                                      jviz.depth_to_gray(depth, 4.5))
    img = jviz.depth_to_gray(d)
    for seg in (rng.uniform(-1, 1, (48, 40)).astype(np.float32),
                (rng.random((48, 40)) < 0.5).astype(np.uint8)):
        np.testing.assert_array_equal(viz.overlay_seg(torch.from_numpy(img), seg).numpy(),
                                      jviz.overlay_seg(img, seg))
        np.testing.assert_array_equal(
            viz.overlay_seg(img, seg, color=(10, 200, 77), alpha=0.3).numpy(),
            jviz.overlay_seg(img, seg, color=(10, 200, 77), alpha=0.3))


@pytest.fixture(scope="module")
def vis_data(tmp_path_factory):
    """A tiny synthetic data root (with seg_maps) and a prediction JSON
    holding both keys."""
    root = tmp_path_factory.mktemp("vis")
    paths = synthetic_data.build(str(root / "data"), n_images=3)
    rng = np.random.default_rng(13)
    pred = {key: [skeletons(rng, n, 512, 480) for _ in range(3)]
            for key, n in (("human_pred_set_2d", 2), ("human_pred_set_2d_aligned", 1))}
    pred_path = root / "pred.json"
    pred_path.write_text(json.dumps(pred))
    return root, paths, pred_path


@pytest.mark.parametrize("command", ["visualize-gt", "visualize-pred"])
def test_visualize_commands_write_the_jax_bytes(vis_data, command):
    """The port's command line writes the files the JAX command line writes,
    byte for byte (the grey map, the seg overlay or the aligned skeletons,
    cv2.imwrite's JPEG); --limit stops after that many frames."""
    root, paths, pred_path = vis_data
    extra = ["--pred", str(pred_path)] if command == "visualize-pred" else []
    common = [command, "--data-root", str(root / "data"), *extra]
    jax_main([*common, "--out-dir", str(root / f"jax-{command}")])
    written = port_main([*common, "--out-dir", str(root / f"port-{command}"), "--device", "cpu"])
    names = sorted(os.listdir(root / f"jax-{command}"))
    assert names == ["000000.jpg", "000001.jpg", "000002.jpg"]
    assert [os.path.basename(p) for p in written] == names
    for name in names:
        assert filecmp.cmp(root / f"jax-{command}" / name, root / f"port-{command}" / name,
                           shallow=False), name
    limited = port_main([*common, "--out-dir", str(root / f"lim-{command}"), "--device", "cpu",
                         "--limit", "2"])
    assert [os.path.basename(p) for p in limited] == names[:2]
