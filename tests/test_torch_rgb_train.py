"""COCO and MPII RGB training in the port against the JAX package and cv2 on
the CPU: cv2's uint8 resize and cubic warp rebuilt without cv2
(data.augment_host), the COCO and MPII labels (data.coco, data.mpii), the
two RGB datasets from one seed (data.coco_dataset, data.mpii), PopNetRGB
and RTPoseLight against Flax, the RGB losses, the float64 SGD steps of
RTPoseVGG (MobileNet trunk, 2 stages) and PopNetRGB from one set of Flax
variables,
the MobileNet trunk's BatchNorm statistics, and `train --dataset coco|mpii`
on the command line (popnet_tpu_torch). Frames of 64², at most 6 a batch.

The uint8 warps are held bit for bit against cv2 5.0.0, whose arithmetic
they rebuild; the messages name the version."""

import functools
import json
import os
import shutil
import types

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu import losses as jlosses
from popnet_tpu.data import coco as jcoco
from popnet_tpu.data import coco_dataset as jcd
from popnet_tpu.data import mpii as jmpii
from popnet_tpu.models import PopNetRGB as FlaxPopNetRGB
from popnet_tpu.models.rtpose_light import RTPoseLight as FlaxRTPoseLight
from popnet_tpu.models.rtpose_vgg import RTPoseVGG as FlaxRTPoseVGG
from popnet_tpu.train.state import create_train_state
from popnet_tpu.train.steps import make_popnet_rgb_train_step as jax_popnet_rgb_step
from popnet_tpu.train.steps import make_rtpose_vgg_train_step as jax_rtpose_vgg_step
from popnet_tpu_torch.cli.main import main as port_main
from popnet_tpu_torch.data import augment_host as pah
from popnet_tpu_torch.data import coco as pcoco
from popnet_tpu_torch.data import coco_dataset as pcd
from popnet_tpu_torch.data import mpii as pmpii
from popnet_tpu_torch.interop.from_jax import load_into, load_sgd_momentum
from popnet_tpu_torch.losses import losses as plosses
from popnet_tpu_torch.models import PopNetRGB, RTPoseLight, RTPoseVGG
from popnet_tpu_torch.models.layers import BatchNorm
from popnet_tpu_torch.train import checkpoint, steps
from popnet_tpu_torch.train.state import TrainState, make_optimizer

from tests.test_torch_train_step import (SGD_LOSS_RTOL, SGD_STATS_RTOL, SGD_UPDATE_BAR,
                                         assert_state_close, flat)

CV2_VERSION = "5.0.0"   # the version whose arithmetic the uint8 warps rebuild
SIZE = 64               # the network input of the datasets, steps and command lines
LR = 0.05
LR32 = float(np.float32(LR))   # the one rate both sides step at (the port rounds to float32)
MAP_BAR = 1.2e-7        # heat, PAF and align maps (exp rounds apart by an ulp)
FWD_ATOL, FWD_RTOL = 1e-4, 1e-5
LOSS_BAR = 5e-6         # XLA's float32 mean is up to 2.4e-6 off the exact sum
COCO_SHAPES = ((96, 128), (120, 90), (128, 128), (71, 64), (64, 200), (150, 150))
STEP_FRAMES = 2         # the float64 steps' batch
CLI_FRAMES = 4          # the command-line runs' frames (2 steps an epoch)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _noise_and_ramp(rng, h, w, c=3):
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = ((xx * 7 + yy * 3) % 256)[..., None].repeat(c, -1)
    return [rng.integers(0, 256, (h, w, c), dtype=np.uint8), ramp.astype(np.uint8)]


# -- the uint8 transforms ---------------------------------------------------------------------


@pytest.mark.parametrize("src", [(427, 640), (480, 640), (640, 427), (500, 375), (33, 17)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_linear_u8_equals_cv2(src):
    """cv2.resize (INTER_LINEAR) of uint8 noise and ramps, 3 channels and 1,
    to the datasets' letterbox sizes at 368 and 64, up and down, and an
    exact 2x (cv2's area path)."""
    h, w = src
    rng = np.random.default_rng(h * w)
    targets = {(368, 245), (245, 368), (552, 368), (300, 200), (64, 43), (43, 64), (64, 64),
               (2 * w, 2 * h), (max(w // 2, 1), max(h // 2, 1)), (w + 1, max(h - 1, 1))}
    for s in (min(368 / h, 368 / w), min(64 / h, 64 / w)):
        targets.add((int(round(w * s)), int(round(h * s))))
    for img in _noise_and_ramp(rng, h, w):
        for im in (img, np.ascontiguousarray(img[..., 0])):
            for dw, dh in sorted(targets):
                got = pah.resize_linear_u8(im, dw, dh)
                np.testing.assert_array_equal(got, cv2.resize(im, (dw, dh)),
                                              err_msg=f"cv2 {CV2_VERSION} resize {im.shape} to "
                                                      f"{dw}x{dh}")


@pytest.mark.parametrize("angle", [0.0, -0.0, 17.3, -17.3, 40.0, -40.0])
def test_rotate_bound_equals_the_jax_package(angle):
    """rotate_bound (cv2.getRotationMatrix2D + warpAffine INTER_CUBIC on a
    128 border) on COCO-sized and small frames, noise and ramps: the image
    bit for bit, the float64 map equal; and the plain cubic warp on a zero
    border and one channel."""
    rng = np.random.default_rng(int(abs(angle) * 10) + (angle < 0))
    for h, w in ((427, 640), (64, 64), (37, 23)):
        for img in _noise_and_ramp(rng, h, w):
            ref, ref_m = jcd.rotate_bound(img, angle)
            got, got_m = pcd.rotate_bound(img, angle)
            np.testing.assert_array_equal(got_m, ref_m)
            np.testing.assert_array_equal(got, ref, err_msg=f"cv2 {CV2_VERSION} cubic warp "
                                                            f"{img.shape} at {angle}")
    img = rng.integers(0, 256, (50, 70), dtype=np.uint8)
    m = cv2.getRotationMatrix2D((31.0, 20.0), angle + 5.0, 0.9)
    np.testing.assert_array_equal(pah.warp_affine_cubic_u8(img, m, (60, 80)),
                                  cv2.warpAffine(img, m, (60, 80), flags=cv2.INTER_CUBIC))


def test_blur_image_equals_the_jax_package():
    img = np.random.default_rng(0).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    for sigma in (0.0, 0.7, 2.3):
        np.testing.assert_array_equal(pcd.blur_image(img, sigma), jcd.blur_image(img, sigma))


# -- COCO -------------------------------------------------------------------------------------


def write_coco_set(root, rng, n_people: int = 3) -> str:
    """COCO_SHAPES' frames as JPEG (cv2.imwrite) under root/images and a
    person_keypoints JSON: per frame n_people people, keypoints inside and
    just outside the frame, some unlabelled, the shoulders labelled on
    most; one crowd annotation and one without keypoints."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(COCO_SHAPES):
        name = f"{i:06d}.jpg"
        cv2.imwrite(os.path.join(root, "images", name),
                    cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 1))
        images.append({"id": 100 + i, "file_name": name, "height": h, "width": w})
        for p in range(n_people):
            kp = np.zeros((17, 3))
            kp[:, 0] = rng.uniform(-5, w + 5, 17)
            kp[:, 1] = rng.uniform(-5, h + 5, 17)
            kp[:, 2] = rng.integers(0, 3, 17)
            if p < 2:
                kp[5, 2], kp[6, 2] = 2, rng.integers(1, 3)
            anns.append({"id": len(anns), "image_id": 100 + i, "keypoints": kp.ravel().tolist(),
                         "num_keypoints": int((kp[:, 2] > 0).sum()), "iscrowd": int(p == 2 and i == 0),
                         "bbox": [float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2)), 20.0,
                                  30.0]})
    anns.append({"id": len(anns), "image_id": 100, "bbox": [0, 0, 1, 1], "num_keypoints": 0})
    path = os.path.join(root, "person_keypoints.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return path


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    return root, write_coco_set(root, np.random.default_rng(3))


def test_coco_labels_equal_the_jax_package(coco_set):
    """add_neck, load_coco_images, coco17_to_rtpose18, load_coco_keypoints,
    remove_illegal_joints and mask_valid_area, exact."""
    _, ann = coco_set
    jitems, pitems = jcd.load_coco_images(ann), pcd.load_coco_images(ann)
    assert [n for n, _ in pitems] == [n for n, _ in jitems] and len(pitems) == len(COCO_SHAPES)
    for (_, jk), (_, pk) in zip(jitems, pitems):
        assert len(jk) == len(pk)
        for a, b in zip(jk, pk):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(pcd.add_neck(b), jcd.add_neck(a))
            for x, y in zip(pcoco.coco17_to_rtpose18(b), jcoco.coco17_to_rtpose18(a)):
                np.testing.assert_array_equal(x, y)
    half = np.array([[10.5, 3.5, 2.0], [11.5, 4.5, 1.0]] + [[0.0, 0.0, 0.0]] * 15)
    half[5], half[6] = [10.5, 3.5, 2.0], [11.5, 4.5, 2.0]
    np.testing.assert_array_equal(pcd.add_neck(half), jcd.add_neck(half))   # half to even
    for k in (1, 5, 17):
        assert pcoco.load_coco_keypoints(ann, k) == jcoco.load_coco_keypoints(ann, k)
    j = np.random.default_rng(0).uniform(-10, 80, (4, 18, 2))
    np.testing.assert_array_equal(pcoco.remove_illegal_joints(j, 64, 48),
                                  jcoco.remove_illegal_joints(j, 64, 48))
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    for area in (None, (0.0, 0.0), (3.0, 0.5), (2.7, 5.2)):
        np.testing.assert_array_equal(pcoco.mask_valid_area(img, area),
                                      jcoco.mask_valid_area(img, area))


def compare_batches(jb: dict, pb: dict, exact=("image", "scale", "valid", "prior_mask_conf",
                                               "prior_mask_coord", "prior_weight_map",
                                               "fg_masks_align", "prior_map")) -> None:
    assert set(jb) == set(pb), (set(jb), set(pb))
    for k, ref in jb.items():
        ref, got = np.asarray(ref), pb[k].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, k
        if k in exact:
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            assert float(np.abs(got.astype(np.float64) - ref).max()) <= MAP_BAR, k


AUGMENTS = {"none": {}, "flip": {"hflip": True}, "rotate": {"rotate_max_deg": 35.0},
            "jitter": {"scale_jitter": (0.5, 1.0)}, "blur": {"blur_max_sigma": 2.0},
            "all": {"hflip": True, "rotate_max_deg": 35.0, "scale_jitter": (0.5, 1.0),
                    "blur_max_sigma": 2.0}}


@pytest.mark.parametrize("augment", list(AUGMENTS))
def test_coco_dataset_equals_the_jax_package(coco_set, augment):
    """CocoKeypointsDataset with each augmentation alone and all together,
    two batches from one seed (a shuffled epoch order, then a batch in file
    order): images bit for bit, heat and PAF within MAP_BAR, scales and
    valid exact, the generators in lockstep after each batch."""
    root, ann = coco_set
    kw = {"input_y": SIZE, "input_x": SIZE, "seed": 11, "hflip": False, **AUGMENTS[augment]}
    jd = jcd.CocoKeypointsDataset(os.path.join(root, "images"), ann, **kw)
    pd = pcd.CocoKeypointsDataset(os.path.join(root, "images"), ann, device="cpu", **kw)
    order = np.arange(len(pd))
    jd.rng.shuffle(order)
    pd.rng.shuffle(order.copy())
    for idx in (order[:4], np.arange(len(pd))):
        compare_batches(jd.get_batch(idx), pd.get_batch(idx))
        assert pd.rng.bit_generator.state == jd.rng.bit_generator.state
    ps = pcd.CocoKeypointsDataset(os.path.join(root, "images"), ann, device="cpu",
                                  is_train=False, **kw)
    assert not ps.hflip and ps.rotate_max_deg == 0.0 and ps.scale_jitter is None


# -- MPII -------------------------------------------------------------------------------------


def write_mpii_set(root, rng, n_images: int = 5) -> str:
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    annos = []
    for i in range(n_images):
        h, w = ((80, 96), (120, 70), (64, 64), (100, 160), (90, 90))[i % 5]
        name = f"m{i:03d}.jpg"
        cv2.imwrite(os.path.join(root, "images", name),
                    cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 1))
        for p in range(3):
            j = np.stack([rng.uniform(-5, w + 5, 16), rng.uniform(-5, h + 5, 16)], 1)
            vis = rng.integers(0, 2, 16) if p < 2 else np.zeros(16, int)
            annos.append({"image": name, "joints": j.tolist(), "joints_vis": vis.tolist()})
    path = os.path.join(root, "mpii.json")
    with open(path, "w") as f:
        json.dump(annos, f)
    return path


@pytest.fixture(scope="module")
def mpii_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mpii"))
    return root, write_mpii_set(root, np.random.default_rng(4))


def write_release_mat(path) -> None:
    """A RELEASE .mat built as tests/test_mpii_rgb_loss.py builds one
    (MATLAB struct arrays): a training image with two people, the second
    with joint 3 left out and a joint flagged invisible, and a test
    image."""
    import scipy.io as sio

    def cell(items):
        c = np.empty((1, len(items)), dtype=object)
        for i, a in enumerate(items):
            c[0, i] = a
        return c

    def person(ids, x0, vis):
        point = np.zeros((1, 1), dtype=[("id", "O"), ("x", "O"), ("y", "O"), ("is_visible", "O")])
        point[0, 0]["id"] = cell([np.array([[j]]) for j in ids])
        point[0, 0]["x"] = cell([np.array([[x0 + 2.5 * j]]) for j in ids])
        point[0, 0]["y"] = cell([np.array([[30.0 - j]]) for j in ids])
        point[0, 0]["is_visible"] = cell([np.array([[str(v)]]) for v in vis])
        annopoint = np.zeros((1, 1), dtype=[("point", "O")])
        annopoint[0, 0]["point"] = point
        return annopoint[0, 0]

    rects = np.zeros((1, 2), dtype=[("annopoints", "O"), ("x1", "O"), ("y1", "O"), ("x2", "O"),
                                    ("y2", "O")])
    for k, (ids, x0) in enumerate(((range(16), 10.0), ([j for j in range(16) if j != 3], 40.0))):
        rects[0, k]["annopoints"] = person(list(ids), x0, [int(j % 5 != 2) for j in ids])
        rects[0, k]["x1"], rects[0, k]["y1"] = np.array([[5.0 + k]]), np.array([[6.0]])
        rects[0, k]["x2"], rects[0, k]["y2"] = np.array([[50.0]]), np.array([[60.0 + k]])
    anno = np.zeros((1, 2), dtype=[("image", "O"), ("annorect", "O")])
    for k, name in enumerate(("a.jpg", "b.jpg")):
        image = np.zeros((1, 1), dtype=[("name", "O")])
        image[0, 0]["name"] = np.array([name])
        anno[0, k]["image"] = image
        anno[0, k]["annorect"] = rects
    sio.savemat(path, {"RELEASE": {"annolist": anno, "img_train": np.array([[1, 0]])}})


def test_mpii_labels_equal_the_jax_package(mpii_set, tmp_path):
    """prepare_mpii_labels (JSON), prepare_mpii_labels_from_mat (.mat, with
    and without train_only), the visibility from the border, the boxes, the
    tables and the anchors, exact."""
    _, ann = mpii_set
    assert pmpii.prepare_mpii_labels(ann) == jmpii.prepare_mpii_labels(ann)
    assert pmpii.prepare_mpii_labels(ann, False) == jmpii.prepare_mpii_labels(ann, False)
    mat = str(tmp_path / "release.mat")
    write_release_mat(mat)
    for train_only in (True, False):
        got = pmpii.prepare_mpii_labels_from_mat(mat, train_only)
        assert got == jmpii.prepare_mpii_labels_from_mat(mat, train_only)
    assert sorted(got) == ["a.jpg", "b.jpg"] and len(got["a.jpg"]) == 2
    assert got["a.jpg"][1]["2d_joints"][3] == [-1.0, -1.0] and got["a.jpg"][0]["visible_joints"][2] == 0
    anns = jmpii.prepare_mpii_labels(ann)["m000.jpg"]
    for margin, inter in ((3, False), (3, True), (10, True)):
        assert pmpii.assign_visibility_from_border(anns, 80, 96, margin, inter) == \
            jmpii.assign_visibility_from_border(anns, 80, 96, margin, inter)
    for a in anns + [{"2d_joints": anns[0]["2d_joints"], "visible_joints": [0] * 16}]:
        assert pmpii.bbox_from_visible_joints(a, 10.0) == jmpii.bbox_from_visible_joints(a, 10.0)
    assert pmpii.MPII_LIMBS == jmpii.MPII_LIMBS
    assert pmpii.MPII_SWAP_INDICES == jmpii.MPII_SWAP_INDICES
    assert pmpii.MPII_KEYPOINT_NAMES == jmpii.MPII_KEYPOINT_NAMES
    assert pmpii.mpii_anchors(368, 16) == jmpii.mpii_anchors(368, 16)


@pytest.mark.parametrize("hflip", [False, True])
def test_mpii_dataset_equals_the_jax_package(mpii_set, hflip):
    """MPIIKeypointsDataset from one seed: images bit for bit, the align
    masks and the prior targets exact, heat and align maps within MAP_BAR,
    the generators in lockstep after each batch."""
    root, ann = mpii_set
    kw = dict(input_y=SIZE, input_x=SIZE, seed=5, hflip=hflip)
    jd = jmpii.MPIIKeypointsDataset(os.path.join(root, "images"), ann, **kw)
    pd = pmpii.MPIIKeypointsDataset(os.path.join(root, "images"), ann, device="cpu", **kw)
    for idx in (np.array([3, 0, 4, 1]), np.arange(len(pd))):
        compare_batches(jd.get_batch(idx), pd.get_batch(idx))
        assert pd.rng.bit_generator.state == jd.rng.bit_generator.state


# -- models and losses ------------------------------------------------------------------------


def flax_variables(model, shape, rng):
    """Flax variables of `model` (the tree of its init at `shape`), every
    kernel at He gain and the biases and BatchNorm values at random, so the
    outputs carry signal; as {'/'-joined path: float32 array}."""
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(shape),
                                                  train=False))
    out = {}
    for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]:
        k = "/".join(getattr(p, "key", str(p)) for p in kp)
        if k.endswith("/kernel"):
            fan_in = v.shape[0] * v.shape[1] * v.shape[2]
            out[k] = (rng.normal(0, 1, v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        elif k.endswith("/mean"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
    return out


def tree_of(flat_vars: dict) -> dict:
    tree = {}
    for k, v in flat_vars.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("name", ["popnet_rgb", "rtpose_light"])
def test_forward_matches_flax(name):
    """PopNetRGB (3-channel stem, 16 parts) and RTPoseLight (1 channel, 15
    parts) in eval mode against Flax at 64² on 2 frames, from the same
    variables (interop.load_into): every output and saved map within
    FWD_ATOL + FWD_RTOL x |Flax|."""
    rng = np.random.default_rng(7)
    if name == "popnet_rgb":
        fmodel, pmodel, shape = FlaxPopNetRGB(num_parts=16), PopNetRGB(), (2, SIZE, SIZE, 3)
    else:
        fmodel, pmodel, shape = FlaxRTPoseLight(), RTPoseLight(), (2, SIZE, SIZE, 1)
    variables = flax_variables(fmodel, shape, rng)
    x = rng.normal(0, 1, shape).astype(np.float32)
    ref_out, ref_saved = jax.jit(fmodel.apply, static_argnames="train")(
        tree_of(variables), jnp.asarray(x), train=False)
    model = load_into(pmodel, variables).eval()
    with torch.no_grad():
        out, saved = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(saved) == len(ref_saved)
    for a, b in zip(list(out) + saved, list(ref_out) + list(ref_saved)):
        got, ref = a.permute(0, 2, 3, 1).numpy(), np.asarray(b)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=FWD_ATOL, rtol=FWD_RTOL)
    assert float(np.abs(np.asarray(ref_saved[-1])).max()) > 0.1


def test_losses_match_the_jax_package():
    """rtpose_light_loss (6 stages of 19 heat and 38 PAF channels) and
    popnet_rgb_loss (2 stages, 16 joints, 2 anchors of 5 + 3K) against JAX
    on random maps and masks: total and every logged part within LOSS_BAR
    relative."""
    rng = np.random.default_rng(0)
    B, H, W = 2, 8, 8
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    saved = [u(B, H, W, 38) if i % 2 == 0 else u(B, H, W, 19) for i in range(12)]
    heat, paf = rng.uniform(0, 1, (B, H, W, 19)).astype(np.float32), u(B, H, W, 38)
    jt, jl = jlosses.rtpose_light_loss([jnp.asarray(s) for s in saved], jnp.asarray(heat),
                                       jnp.asarray(paf), 6)
    pt, pl = plosses.rtpose_light_loss([nchw(s) for s in saved], torch.from_numpy(heat),
                                       torch.from_numpy(paf))
    pairs = [(pt, jt)] + [(pl[k], jl[k]) for k in jl]
    assert set(pl) == set(jl)
    K, A = 16, 2
    naf = 5 + 3 * K
    rsaved = [u(B, H, W, K + 1), u(B, H, W, 2 * K), u(B, H, W, K + 1), u(B, H, W, 2 * K),
              u(B, 4, 4, A * naf)]
    fg = (rng.uniform(size=(B, H, W, 2 * K)) > 0.5).astype(np.float32)
    prior = u(B, 4, 4, A * naf)
    prior.reshape(B, 4, 4, A, naf)[..., 5 + 2 * K:] = rng.integers(0, 2, (B, 4, 4, A, K))
    mconf = rng.uniform(0, 1, (B, 4, 4, A)).astype(np.float32)
    mcoord = (rng.uniform(size=(B, 4, 4, A)) > 0.6).astype(np.float32)
    args = (u(B, H, W, K + 1), u(B, H, W, 2 * K), fg, prior, mconf, mcoord)
    jt, jl = jlosses.popnet_rgb_loss([jnp.asarray(s) for s in rsaved],
                                     *(jnp.asarray(a) for a in args), K)
    pt, pl = plosses.popnet_rgb_loss([nchw(s) for s in rsaved], *(torch.from_numpy(a) for a in args),
                                     K)
    assert set(pl) == set(jl)
    pairs += [(pt, jt)] + [(pl[k], jl[k]) for k in jl]
    for p, j in pairs:
        np.testing.assert_allclose(float(p), float(j), rtol=LOSS_BAR)


# -- float64 steps ----------------------------------------------------------------------------


STEPS = {
    "rtpose_vgg": (lambda dtype=jnp.float32: FlaxRTPoseVGG(num_stages=2, trunk="mobilenet",
                                                          dtype=dtype),
                   lambda: RTPoseVGG(num_stages=2, trunk="mobilenet"),
                   lambda: jax_rtpose_vgg_step(num_stages=2), steps.make_rtpose_vgg_train_step),
    "popnet_rgb": (lambda dtype=jnp.float32: FlaxPopNetRGB(num_parts=16, dtype=dtype), PopNetRGB,
                   lambda: jax_popnet_rgb_step(num_joints=16), steps.make_popnet_rgb_train_step),
}


@functools.lru_cache(maxsize=None)
def step_batch(name: str, root: str, ann: str) -> dict:
    """STEP_FRAMES frames of the JAX dataset (augmented for COCO) as NumPy
    arrays."""
    if name == "rtpose_vgg":
        ds = jcd.CocoKeypointsDataset(os.path.join(root, "images"), ann, input_y=SIZE,
                                      input_x=SIZE, seed=1, rotate_max_deg=20.0)
        keys = ("image", "heat", "paf")
    else:
        ds = jmpii.MPIIKeypointsDataset(os.path.join(root, "images"), ann, input_y=SIZE,
                                        input_x=SIZE, seed=1)
        keys = ("image", "heatmaps", "align_maps", "fg_masks_align", "prior_map",
                "prior_mask_conf", "prior_mask_coord")
    b = ds.get_batch(np.arange(STEP_FRAMES))
    return {k: np.asarray(b[k]) for k in keys}


@functools.lru_cache(maxsize=None)
def jax_steps(name: str, root: str, ann: str):
    """One set of Flax variables (`flax_variables`: the init's tree, seeded
    values; not Flax's init, whose jitted compile would double the test's
    time) as a float32 JAX train state, and two JAX steps in float64 from
    it at the float32 rate: (init state, states after each step, losses)."""
    flax_model, _, jax_step, _ = STEPS[name]
    model = flax_model()
    start = tree_of(flax_variables(model, (1, SIZE, SIZE, 3), np.random.default_rng(0)))
    given = types.SimpleNamespace(init=lambda *args, **kw: start, apply=model.apply)
    f32 = create_train_state(given, jax.random.PRNGKey(0), None, learning_rate=LR32)
    batch = step_batch(name, root, ann)
    with jax.enable_x64(True):
        up = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        params = up(f32.params)
        js = f32.replace(apply_fn=flax_model(jnp.float64).apply, params=params,
                         batch_stats=None if f32.batch_stats is None else up(f32.batch_stats),
                         opt_state=f32.tx.init(params))
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        step = jax.jit(jax_step())
        states, losses = [], []
        for _ in range(2):
            js, logs = step(js, jb)
            states.append(js)
            losses.append(float(logs["loss"]))
    return f32, states, losses


def variables(state) -> dict:
    v = flat(state.params, "params")
    if state.batch_stats is not None:
        v.update(flat(state.batch_stats, "batch_stats"))
    return v


def port_state(name: str, flat_vars: dict) -> TrainState:
    model = load_into(STEPS[name][1]().double(), flat_vars)
    return TrainState(model, make_optimizer(model, "sgd", LR, 0.9, 0.0))


@pytest.mark.parametrize("name", list(STEPS))
def test_rgb_step_matches_jax_in_float64(name, coco_set, mpii_set):
    """Two SGD-Nesterov steps from one set of Flax variables on a dataset batch of
    STEP_FRAMES frames, float64 on both sides at one float32 rate: the loss within
    SGD_LOSS_RTOL, every parameter's update within SGD_UPDATE_BAR of JAX's
    largest of the tensor, the BatchNorm statistics within SGD_STATS_RTOL;
    JAX's state after one step, carried across with its SGD trace
    (interop.load_sgd_momentum), steps on in the port as JAX does."""
    root, ann = coco_set if name == "rtpose_vgg" else mpii_set
    f32, jstates, jlosses_ = jax_steps(name, root, ann)
    batch = {k: torch.from_numpy(v.astype(np.float64)) for k, v in step_batch(name, root, ann).items()}
    init = variables(f32)
    port = port_state(name, init)
    step = STEPS[name][3]()
    bars = {"update_bar": SGD_UPDATE_BAR, "stats_rtol": SGD_STATS_RTOL}
    for k in range(2):
        port, logs = step(port, batch)
        np.testing.assert_allclose(float(logs["loss"]), jlosses_[k], rtol=SGD_LOSS_RTOL)
        assert_state_close(port, jstates[k], init, f"{name} step {k + 1}", **bars)
    after1 = variables(jstates[0])
    cont = port_state(name, after1)
    load_sgd_momentum(cont.model, cont.optimizer,
                      flat(jstates[0].opt_state.inner_state[0].trace, "params"))
    cont, logs = step(cont, batch)
    np.testing.assert_allclose(float(logs["loss"]), jlosses_[1], rtol=SGD_LOSS_RTOL)
    assert_state_close(cont, jstates[1], after1, f"{name} continued step 2", **bars)


def test_mobilenet_batchnorm_statistics_match_flax(coco_set):
    """Every BatchNorm of the MobileNet trunk is models.layers.BatchNorm,
    and after one train step from one set of Flax variables its running means and
    variances are Flax's (momentum 0.99, biased variance) within 1e-5
    relative, float64 on both sides; torch's own BatchNorm2d (momentum 0.1
    of the new value, the unbiased variance) would stand far off."""
    norms = [m for m in RTPoseVGG(trunk="mobilenet").modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(norms) == 9 and all(type(m) is BatchNorm for m in norms)
    root, ann = coco_set
    f32, jstates, _ = jax_steps("rtpose_vgg", root, ann)
    port = port_state("rtpose_vgg", variables(f32))
    batch = {k: torch.from_numpy(v.astype(np.float64))
             for k, v in step_batch("rtpose_vgg", root, ann).items()}
    port, _ = steps.make_rtpose_vgg_train_step()(port, batch)
    got = port.model.state_dict()
    n = 0
    for key, ref in variables(jstates[0]).items():
        if key.startswith("batch_stats/"):
            name = ".".join(key.split("/")[1:-1]) + (".running_mean" if key.endswith("mean")
                                                      else ".running_var")
            np.testing.assert_allclose(got[name].numpy(), ref, rtol=1e-5, atol=1e-12, err_msg=name)
            n += 1
    assert n == 2 * len(norms)


def test_three_channel_batches_reach_the_model_in_plain_nchw():
    """A 3-channel NHWC batch permuted to NCHW reads as channels-last; the
    steps copy it to plain strides (the CUDA avg_pool2d backward is wrong
    on channels-last input)."""
    x = torch.zeros(2, 8, 8, 3)
    assert x.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    y = steps._nchw(x)
    assert y.is_contiguous() and y.shape == (2, 3, 8, 8)


# -- the command line -------------------------------------------------------------------------


def final_params(out: str) -> dict:
    return checkpoint.restore_params(os.path.join(out, "ckpt"))[0]


@pytest.mark.parametrize("dataset", ["coco", "mpii"])
def test_train_rgb_on_the_command_line(dataset, coco_set, mpii_set, tmp_path):
    """`train --dataset coco --model rtpose_vgg --trunk mobilenet` (every
    augmentation on) and `train --dataset mpii --model popnet_rgb` on the
    CPU, 2 epochs on CLI_FRAMES of the set's frames at 64², batch 2: the
    training loss falls and validation runs; for MPII, 1 epoch then
    `--resume` for 1 more ends bit for bit where the 2-epoch run ends (the
    model, the history's losses; the resume of COCO's run, whose
    checkpoints are ~0.4 GB each, is held on the card by chip_smoke.py
    phase 12). The runs' directories are removed as the test goes."""
    root, ann = coco_set if dataset == "coco" else mpii_set
    with open(ann) as f:
        labels = json.load(f)
    if dataset == "coco":      # the first CLI_FRAMES frames
        labels["images"] = labels["images"][:CLI_FRAMES]
        kept = {im["id"] for im in labels["images"]}
        labels["annotations"] = [a for a in labels["annotations"] if a["image_id"] in kept]
    else:
        labels = [a for a in labels if a["image"] < f"m{CLI_FRAMES:03d}.jpg"]
    ann = str(tmp_path / "labels.json")
    with open(ann, "w") as f:
        json.dump(labels, f)
    model = {"coco": "rtpose_vgg", "mpii": "popnet_rgb"}[dataset]
    extra = (["--trunk", "mobilenet", "--rotate-aug", "20", "--scale-jitter", "0.6,1.0",
              "--blur-aug", "1.0"] if dataset == "coco" else [])
    common = ["train", "--dataset", dataset, "--model", model, "--data-root", root,
              "--labels", ann, "--val-labels", ann,
              "--device", "cpu", "--input-size", str(SIZE), "--batch-size", "2", "--lr", "0.1",
              "--seed", "2", *extra]
    one = str(tmp_path / "one")
    t = port_main([*common, "--epochs", "2", "--out-dir", one])
    hist = t.history
    assert all(np.isfinite([h["train_loss"] for h in hist] + [h["val_loss"] for h in hist]))
    assert hist[-1]["train_loss"] < hist[0]["train_loss"], hist
    ref = final_params(one)
    shutil.rmtree(one)
    if dataset == "coco":
        return
    two = str(tmp_path / "two")
    port_main([*common, "--epochs", "1", "--out-dir", two])
    t2 = port_main([*common, "--epochs", "1", "--out-dir", two, "--resume"])
    got = final_params(two)
    shutil.rmtree(two)
    assert [h["train_loss"] for h in t2.history] == [hist[1]["train_loss"]]
    assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


def test_train_rgb_refuses_the_other_models(tmp_path):
    """As the JAX command line: each RGB dataset trains its one model, the
    RGB models train on their dataset only; neither command line evaluates
    an RGB model."""
    base = ["--data-root", str(tmp_path), "--device", "cpu"]
    for argv, what in ((["train", "--dataset", "coco", "--model", "popnet"],
                        "--dataset coco trains --model rtpose_vgg"),
                       (["train", "--dataset", "mpii", "--model", "rtpose_vgg"],
                        "--dataset mpii trains --model popnet_rgb"),
                       (["train", "--model", "popnet_rgb"], "popnet_rgb trains with --dataset mpii"),
                       (["train", "--model", "rtpose_vgg"], "rtpose_vgg trains with --dataset coco"),
                       (["evaluate", "--dataset", "mpii", "--model", "popnet_rgb"],
                        "neither command line evaluates an RGB model")):
        with pytest.raises(SystemExit, match=what):
            port_main([*argv, *base])


def batchnorm_record() -> dict:
    """The MobileNet trunk's first BatchNorm, channel 0, after one
    train-mode forward of 2 normal(0, 1) frames of 64² from Flax's
    PRNGKey(0) init: JAX's running mean and variance, the port's
    (models.layers.BatchNorm) and torch's nn.BatchNorm2d's, which the trunk
    used before (ROADMAP Queue 3). `python -m tests.test_torch_rgb_train`
    prints them."""
    from flax import traverse_util

    x = np.random.default_rng(0).normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    fmodel = FlaxRTPoseVGG(trunk="mobilenet", num_stages=2)
    v = jax.jit(fmodel.init, static_argnames="train")(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    _, mut = fmodel.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    jbn = mut["batch_stats"]["trunk"]["BatchNorm_0"]
    flat_vars = {"/".join(k): np.asarray(a)
                 for k, a in traverse_util.flatten_dict(jax.device_get(v)).items()}
    port = load_into(RTPoseVGG(trunk="mobilenet", num_stages=2), flat_vars).train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        port(xt)
        old = torch.nn.BatchNorm2d(32, eps=1e-5).train()
        old(port.trunk.Conv_0(xt))
    bn = port.trunk.BatchNorm_0
    return {"jax": (float(jbn["mean"][0]), float(jbn["var"][0])),
            "port": (float(bn.running_mean[0]), float(bn.running_var[0])),
            "nn.BatchNorm2d": (float(old.running_mean[0]), float(old.running_var[0]))}


if __name__ == "__main__":
    for k, (mean, var) in batchnorm_record().items():
        print(f"{k}: running mean {mean:.9g}, running var {var:.9g}")
