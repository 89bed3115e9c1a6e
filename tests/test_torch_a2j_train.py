"""A2J training in the port against the JAX package and cv2 on the CPU: the
host augmentation without cv2 (data.augment_host), the person-crop dataset
and its random erasing (data.a2j_crops), the anchor loss, the train step
with Adam-L2 from one Flax init, and `train --model a2j` on the command line
(popnet_tpu_torch). Crops of 96², few frames, one JAX step compile.

The warps are held bit for bit against cv2 5.0.0 (`cv2.warpAffine` on
frames whose width is a multiple of 16, as KDH3D's 480, and `cv2.resize`):
the match depends on that version's float32 rounding, which the messages
name."""

import copy
import functools
import json
import os
import types

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu import losses as jlosses
from popnet_tpu.core.config import EncoderConfig as JaxEncoderConfig
from popnet_tpu.data import a2j_crops as ja2j
from popnet_tpu.data import augment_host as jah
from popnet_tpu.data import datasets as jds
from popnet_tpu.models import A2J as FlaxA2J
from popnet_tpu.models.a2j import generate_anchors, shift_anchors
from popnet_tpu.train.state import create_train_state
from popnet_tpu.train.steps import make_a2j_train_step as jax_a2j_step
from popnet_tpu_torch.cli.main import main as port_main
from popnet_tpu_torch.core import config
from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS
from popnet_tpu_torch.data import a2j_crops as pa2j
from popnet_tpu_torch.data import augment_host as pah
from popnet_tpu_torch.data import datasets as pds
from popnet_tpu_torch.interop.from_jax import load_adam_state, load_into
from popnet_tpu_torch.losses import losses as plosses
from popnet_tpu_torch.models import A2J
from popnet_tpu_torch.models.layers import BatchNorm
from popnet_tpu_torch.train import checkpoint, steps
from popnet_tpu_torch.train.state import TrainState, make_optimizer

from tests import synthetic_data
from tests.test_torch_train_step import (LOSS_RTOL, STATS_RTOL, assert_state_close, flat,
                                         variables_of)

CV2_VERSION = "5.0.0"   # the version whose rounding the warps are held against
SIZE = 96               # the crops' side
LR, WD = 3.5e-4, 1e-4   # the A2J recipe's Adam-L2
LR32 = float(np.float32(LR))   # the one rate both sides step at (the port rounds to float32)
CAM = KDH3D_INTRINSICS
H, W = 512, 480


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("a2j_train"))
    return synthetic_data.build(root, n_images=6, n_locations=3, seed=4)


# -- the host transforms ---------------------------------------------------------------------


def random_anns(rng, n_people: int = 3, K: int = 15) -> list:
    """People as the label files carry them: lists, 15 joints, a box."""
    anns = []
    for _ in range(n_people):
        j2 = rng.uniform([20, 30], [460, 490], (K, 2))
        z = rng.uniform(1.5, 5.0, K)
        j3 = np.stack([(j2[:, 0] - CAM.cx) / CAM.fx * z, (j2[:, 1] - CAM.cy) / CAM.fy * z, z], 1)
        box = np.concatenate([j2.min(0) - 9.5, j2.max(0) + 11.25])
        anns.append({"2d_joints": j2.tolist(), "3d_joints": j3.tolist(), "bbox": box.tolist(),
                     "visible_joints": rng.integers(0, 2, K).tolist(), "pose_weight": 1.0})
    return anns


def _cvt(mod, image, anns):
    return mod.Cvt2ndarray()((image, anns))


def _assert_labels_equal(got, ref, what):
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r), what
        for k in r:
            a, b = np.asarray(g[k]), np.asarray(r[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{what} {k}"


# name: (arguments -> (JAX transform, port transform), the image's channels)
TRANSFORMS = {
    "crop": (lambda m, rng: m.Crop(0.1, rng=rng), 1),
    "render_depth_in": (lambda m, rng: m.RenderDepth(CAM.cx, CAM.cy, 0.7, 0.95, rng=rng), 1),
    "render_depth_out": (lambda m, rng: m.RenderDepth(CAM.cx, CAM.cy, 1.2, 1.7, rng=rng), 1),
    "rotate": (lambda m, rng: m.Rotate(CAM.cx, CAM.cy, is_3d=True, rng=rng), 1),
    "rotate_centre": (lambda m, rng: m.Rotate(rng=rng), 1),
    "hflip": (lambda m, rng: m.Hflip([0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 14],
                                     is_3d=True, rng=rng), 1),
    "resize": (lambda m, rng: m.Resize(224), 1),
    "crop_pose_roi": (lambda m, rng: m.CropPoseRoi(20, rng=rng), 1),
    "crop_pose_roi_jitter": (lambda m, rng: m.CropPoseRoiJitter(20, 0.2, rng=rng), 1),
    "crop_pose_roi_v2": (lambda m, rng: m.CropPoseRoiV2(2.0, 1.5, rng=rng), 1),
    "random_scale_rgb": (lambda m, rng: m.RandomScaleRGB(0.7, 1.3, rng=rng), 3),
    "square_pad_rgb": (lambda m, rng: m.SquarePadRGB(), 3),
    "a2j_pipeline": (lambda m, rng: m.Compose([
        m.Rotate(cx=CAM.cx, cy=CAM.cy, rng=rng),
        m.RenderDepth(cx=CAM.cx, cy=CAM.cy, max_ratio=1.7, rng=rng), m.Resize(W, H)]), 1),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_host_transform_matches_jax(name, seed):
    """Each transform of augment_host on the same frame, annotations and
    generator state as the JAX package's: the image bit for bit (Rotate
    and Resize against cv2 5.0.0, the rest copies and products), every
    label array bit for bit with its dtype, and the generators' next draws
    equal."""
    make, chn = TRANSFORMS[name]
    rng = np.random.default_rng(100 + seed)
    shape = (H, W) if chn == 1 else (H, W, chn)
    image = rng.uniform(0, 8 if chn == 1 else 255, shape).astype(np.float32)
    anns = random_anns(rng)
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    ref_img, ref = make(jah, rj)(_cvt(jah, image, copy.deepcopy(anns)))
    got_img, got = make(pah, rp)(_cvt(pah, torch.from_numpy(image.copy()), copy.deepcopy(anns)))
    assert isinstance(got_img, torch.Tensor) and got_img.dtype == torch.float32
    ref_img = np.asarray(ref_img)
    assert got_img.shape == ref_img.shape
    assert np.array_equal(got_img.numpy(), ref_img), (
        f"{name}: max |port - cv2 {cv2.__version__}| "
        f"{np.abs(got_img.numpy() - ref_img).max()} (held at cv2 {CV2_VERSION})")
    _assert_labels_equal(got, ref, name)
    assert rj.integers(0, 1 << 30) == rp.integers(0, 1 << 30)


@pytest.mark.parametrize("src", [(614, 575), (431, 403), (481, 513), (336, 359), (512, 480)])
def test_resize_equals_cv2(src):
    """resize_linear on [0, 8) m white noise to KDH3D's 512x480 (dsize (480,
    512)) from four sizes and the identity: bit for bit with cv2.resize
    INTER_LINEAR of cv2 5.0.0."""
    im = np.random.default_rng(src[0]).uniform(0, 8, src).astype(np.float32)
    ref = cv2.resize(im, (W, H), interpolation=cv2.INTER_LINEAR)
    got = pah.resize_linear(torch.from_numpy(im), W, H).numpy()
    assert np.array_equal(got, ref), (cv2.__version__, np.abs(got - ref).max())
    if src == (H, W):
        assert np.array_equal(got, im)


def test_rotation_matrix_equals_cv2():
    """get_rotation_matrix_2d equals cv2.getRotationMatrix2D bit for bit on
    20,000 angles in +-10 degrees about KDH3D's principal point and on
    centres that float32 rounds; warp_affine_linear equals cv2.warpAffine
    on a 96x96 crop's frame too."""
    rng = np.random.default_rng(7)
    for a in rng.uniform(-10, 10, 20000):
        assert np.array_equal(pah.get_rotation_matrix_2d((CAM.cx, CAM.cy), a, 1.0),
                              cv2.getRotationMatrix2D((CAM.cx, CAM.cy), a, 1.0)), a
    for c in rng.uniform(0, 500, (20, 2)):
        assert np.array_equal(pah.get_rotation_matrix_2d(tuple(c), 3.3, 1.0),
                              cv2.getRotationMatrix2D(tuple(c), 3.3, 1.0))
    im = rng.uniform(0, 8, (SIZE, SIZE)).astype(np.float32)
    M = cv2.getRotationMatrix2D((47.3, 50.1), -8.2, 1.0)
    assert np.array_equal(pah.warp_affine_linear(torch.from_numpy(im), M, (SIZE, SIZE)).numpy(),
                          cv2.warpAffine(im, M, (SIZE, SIZE), flags=cv2.INTER_LINEAR))


def test_render_depth_multiplies_as_numpy():
    """RenderDepth's image times the recomputed ratio rounds as NumPy's
    float32 array times a Python float (NEP 50: the ratio rounded to
    float32, one float32 product), cropping and padding, bit for bit."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 8, (H, W)).astype(np.float32)
    for a in np.concatenate([rng.uniform(0.7, 1.0, 6), rng.uniform(1.0, 1.7, 6)]):
        ref, _ = jah.RenderDepth.apply(img, [], a, CAM.cx, CAM.cy)
        got, _ = pah.RenderDepth.apply(torch.from_numpy(img), [], a, CAM.cx, CAM.cy)
        assert got.shape == ref.shape and np.array_equal(got.numpy(), ref), a


# -- the crop dataset ------------------------------------------------------------------------


JECFG = JaxEncoderConfig(max_people=4)
PECFG = config.EncoderConfig(max_people=4)


def _inner(mod, p, kind: str, device=None):
    kw = dict(ecfg=JECFG if mod is jds else PECFG, seed=3)
    if mod is pds:
        kw["device"] = device
    bg = dict(bg_file=p["labels_bg"], bg_dir=p["bg_dir"], seg_dir=p["seg_dir"])
    if kind == "bg_aug":
        return mod.KDH3DDataset(p["img_dir"], p["labels"], bg_aug=True, **bg, **kw)
    return mod.KDH3DMPAugDataset(p["img_dir"], p["labels_locs"], **bg, **kw)


def jax_crops(p, kind: str, augment: bool, monkeypatch, seed: int = 5, n: int = 4):
    """A JAX A2JCropDataset batch (no erasing) and the float32 boxes it
    cropped, with its dataset."""
    ds = ja2j.A2JCropDataset(_inner(jds, p, kind), augment=augment, erase=False,
                             out_size=SIZE, seed=seed)
    boxes = []
    crop = ja2j.crop_resize_batch
    monkeypatch.setattr(ja2j, "crop_resize_batch",
                        lambda imgs, idx, b, **kw: boxes.append(np.asarray(b)) or crop(imgs, idx, b,
                                                                                   **kw))
    batch = ds.get_batch(np.arange(n))
    monkeypatch.setattr(ja2j, "crop_resize_batch", crop)
    return {k: np.asarray(v) for k, v in batch.items()}, boxes[0], ds


@pytest.mark.parametrize("kind", ["bg_aug", "mp_aug"])
@pytest.mark.parametrize("augment", [True, False])
def test_crop_dataset_matches_jax(data, kind, augment, monkeypatch):
    """A2JCropDataset over KDH3DDataset(bg_aug=True) and KDH3DMPAugDataset
    at 96², erasing off, against the JAX package's from one seed: the
    boxes and the labels bit for bit, the crops bit for bit (the warps
    equal cv2's; the bar would be 1.7 x the warp's / 2), and both
    generators' next draws equal. Without augment, the identity pipeline
    on person 0."""
    ref, ref_boxes, jds_ = jax_crops(data, kind, augment, monkeypatch)
    ds = pa2j.A2JCropDataset(_inner(pds, data, kind, "cpu"), augment=augment, erase=False,
                             out_size=SIZE, seed=5)
    images, boxes, _, _ = ds.frames(np.arange(4))
    ds = pa2j.A2JCropDataset(_inner(pds, data, kind, "cpu"), augment=augment, erase=False,
                             out_size=SIZE, seed=5)
    got = ds.get_batch(np.arange(4))
    assert np.array_equal(boxes.astype(np.float32), ref_boxes)
    assert got["crops"].shape == ref["crops"].shape == (4, SIZE, SIZE, 1)
    assert np.array_equal(got["labels"].numpy(), ref["labels"])
    assert np.array_equal(got["crops"].numpy(), ref["crops"]), \
        np.abs(got["crops"].numpy() - ref["crops"]).max()
    assert ds.rng.integers(0, 1 << 30) == jds_.rng.integers(0, 1 << 30)
    assert ds.inner.rng.integers(0, 1 << 30) == jds_.inner.rng.integers(0, 1 << 30)


def test_crop_labels_match_jax():
    """crop_labels in float64, then float32, as the JAX package's."""
    rng = np.random.default_rng(9)
    j2 = rng.uniform(0, 480, (6, 15, 2))
    z = rng.uniform(1, 6, (6, 15))
    b = np.concatenate([j2.min(1) - 7.3, j2.max(1) + 5.1], 1)
    ref = ja2j.crop_labels(j2, z, b, SIZE)
    got = pa2j.crop_labels(j2, z, b, SIZE)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


# -- random erasing --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_erasing_matches_jax_given_its_draws(seed):
    """erasing_rectangles and apply_erasing on JAX's own uniforms and noise
    (its keys split as random_erasing splits them) equal JAX's
    random_erasing bit for bit, at 288² on 32 crops."""
    n, S = 32, pa2j.CROP
    crops = np.random.default_rng(seed).normal(0, 1, (n, S, S, 1)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(ja2j.random_erasing(jnp.asarray(crops), key))
    keys = jax.random.split(key, 6)
    u = torch.from_numpy(np.stack([np.array(jax.random.uniform(k, (n,))) for k in keys[:5]]))
    noise = torch.from_numpy(np.array(jax.random.normal(keys[5], crops.shape)))
    rects = pa2j.erasing_rectangles(u, S)
    got = pa2j.apply_erasing(torch.from_numpy(crops), rects, noise).numpy()
    assert np.array_equal(got, ref)
    assert 0 < int(rects[0].sum()) < n


def test_erasing_draws_statistics():
    """erasing_draws from a torch.Generator: about half the crops erased,
    the area a share in [0.02, 0.4) of the crop before truncation, the
    sides in [1, S - 1], each rectangle inside the crop; unit normal
    noise; the same generator state draws the same."""
    n, S = 4000, 48
    g = torch.Generator().manual_seed(0)
    u, noise = pa2j.erasing_draws(n, S, g)
    assert u.shape == (5, n) and noise.shape == (n, S, S, 1)
    do, ph, pw, y0, x0 = pa2j.erasing_rectangles(u, S)
    assert abs(float(do.float().mean()) - 0.5) < 0.03
    area = pa2j._scaled(u[1], 0.02, 0.4)
    assert float(area.min()) >= np.float32(0.02) and float(area.max()) < 0.4
    assert int(ph.min()) >= 1 and int(pw.min()) >= 1 and int(ph.max()) <= S - 1
    assert int(pw.max()) <= S - 1 and float((ph * pw).float().max()) <= 0.4 * S * S
    assert int(y0.min()) >= 0 and int((y0 + ph).max()) <= S
    assert int(x0.min()) >= 0 and int((x0 + pw).max()) <= S
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 1.0) < 0.01
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(pa2j.erasing_draws(n, S, g2)[0], u)


# -- the loss and the step -------------------------------------------------------------------


ANCHORS = shift_anchors((SIZE // 16, SIZE // 16), 16, generate_anchors()).astype(np.float32)


def test_a2j_loss_matches_jax():
    """a2j_loss on random heads at 96² (576 anchors): both terms within
    5e-6 relative of JAX's (XLA's float32 mean, as the other losses)."""
    rng = np.random.default_rng(2)
    B, N, K = 4, len(ANCHORS), 15
    heads = (rng.normal(0, 2, (B, N, K)), rng.normal(0, 8, (B, N, K, 2)),
             rng.normal(3, 1, (B, N, K)))
    heads = [h.astype(np.float32) for h in heads]
    labels = np.concatenate([rng.uniform(0, SIZE, (B, K, 2)), rng.uniform(1, 6, (B, K, 1))],
                            -1).astype(np.float32)
    ref = jlosses.a2j_loss([jnp.asarray(h) for h in heads], jnp.asarray(labels),
                           jnp.asarray(ANCHORS))
    got = plosses.a2j_loss([torch.from_numpy(h) for h in heads], torch.from_numpy(labels),
                           torch.from_numpy(ANCHORS))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=5e-6)


@functools.lru_cache(maxsize=None)
def flax_state():
    """The JAX train state of the Flax A2J's PRNGKey(0) init at 96², Adam-L2
    at the float32 rate, made once a file (the init jitted: op by op it
    takes twice as long)."""
    model = FlaxA2J(depth_prior=3.0)
    jitted = types.SimpleNamespace(init=jax.jit(model.init, static_argnames="train"),
                                   apply=model.apply)
    return create_train_state(jitted, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)),
                              learning_rate=LR32, weight_decay=WD, optimizer="adam")


@pytest.fixture(scope="module")
def step_batch(data):
    """Two 96² crops of the JAX A2JCropDataset (augmented, erasing off)."""
    ds = ja2j.A2JCropDataset(_inner(jds, data, "mp_aug"), erase=False, out_size=SIZE, seed=8)
    return {k: np.asarray(v) for k, v in ds.get_batch(np.arange(2)).items()}


@pytest.fixture(scope="module")
def jax_float64_steps(step_batch):
    """Two JAX A2J steps in float64 (`jax.enable_x64`, the Flax A2J at dtype
    float64) from the float32 init: (the states after each step, losses)."""
    f32 = flax_state()
    with jax.enable_x64(True):
        up = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        params = up(f32.params)
        jstate = f32.replace(apply_fn=FlaxA2J(depth_prior=3.0, dtype=jnp.float64).apply,
                             params=params, batch_stats=up(f32.batch_stats),
                             opt_state=f32.tx.init(params))
        jbatch = {k: jnp.asarray(v, jnp.float64) for k, v in step_batch.items()}
        step_j = jax.jit(jax_a2j_step(jnp.asarray(ANCHORS, jnp.float64)))
        jstates, jlosses_ = [], []
        for _ in range(2):
            jstate, logs = step_j(jstate, jbatch)
            jstates.append(jstate)
            jlosses_.append(float(logs["loss"]))
    return jstates, jlosses_


# the head convs ahead of a BatchNorm: their bias's gradient is zero in exact
# arithmetic, and Adam turns its rounding noise (read: updates up to 2.9e-12)
# into an update of noise / (|noise| + 1e-8) of the rate
ZERO_GRAD = {f"{h}.Conv_{n}.bias" for h in ("classification", "regression", "depth")
             for n in range(4)}
ZERO_GRAD_BAR = 1e-6 * LR


def port_state(variables: dict) -> TrainState:
    model = load_into(A2J(depth_prior=3.0).double(), variables)
    return TrainState(model, make_optimizer(model, "adam", LR, weight_decay=WD))


@pytest.fixture(scope="module")
def port_float64_steps(step_batch):
    """Two port A2J steps in float64 from the Flax init: (copies of the
    train state after each step, their losses)."""
    tbatch = {k: torch.from_numpy(v.astype(np.float64)) for k, v in step_batch.items()}
    port, step_p = port_state(variables_of(flax_state())), steps.make_a2j_train_step(ANCHORS)
    states, losses = [], []
    for _ in range(2):
        port, logs = step_p(port, tbatch)
        states.append(copy.deepcopy(port))
        losses.append(float(logs["loss"]))
    return states, losses


def test_a2j_batchnorm_statistics_match_flax(jax_float64_steps, port_float64_steps):
    """Every BatchNorm of the port's A2J is models.layers.BatchNorm, and
    after one train step from the Flax init its running means and
    variances are Flax's (momentum 0.99, biased variance) within 1e-5
    relative, float64 on both sides (torch's own BatchNorm2d, momentum 0.1
    of the new value and the unbiased variance, would stand far off)."""
    norms = [m for m in A2J().modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(norms) == 53 + 12 and all(type(m) is BatchNorm for m in norms)
    got = port_float64_steps[0][0].model.state_dict()
    n = 0
    for key, r in variables_of(jax_float64_steps[0][0]).items():
        if key.startswith("batch_stats/"):
            name = ".".join(key.split("/")[1:-1]) + (".running_mean" if key.endswith("mean")
                                                      else ".running_var")
            np.testing.assert_allclose(got[name].numpy(), r, rtol=STATS_RTOL, atol=1e-12,
                                       err_msg=name)
            n += 1
    assert n == 2 * len(norms)


def test_a2j_step_matches_jax_in_float64(step_batch, jax_float64_steps, port_float64_steps):
    """The A2J step (loss = anchor + 3 x regression, Adam with L2 1e-4 at
    one float32 rate) from one Flax init on two 96² crops, float64 on both
    sides, at tests/test_torch_train_step.py's bars (loss 1e-5 relative,
    each parameter's update within 1e-3 of JAX's largest of the tensor,
    BatchNorm statistics 1e-5; the head biases ahead of a BatchNorm within
    ZERO_GRAD_BAR): two port steps in a row, and JAX's state after one step
    carried across (load_adam_state: its moments and count) and stepped on
    by the port."""
    jstates, jlosses_ = jax_float64_steps
    init = variables_of(flax_state())
    for k, (port, loss) in enumerate(zip(*port_float64_steps)):
        np.testing.assert_allclose(loss, jlosses_[k], rtol=LOSS_RTOL)
        assert assert_state_close(port, jstates[k], init, f"step {k + 1}", ZERO_GRAD,
                                  ZERO_GRAD_BAR) > 0

    after1 = variables_of(jstates[0])
    cont = port_state(after1)
    adam = jstates[0].opt_state.inner_state[1]
    load_adam_state(cont.model, cont.optimizer, flat(adam.mu, "params"), flat(adam.nu, "params"),
                    int(adam.count))
    tbatch = {k: torch.from_numpy(v.astype(np.float64)) for k, v in step_batch.items()}
    cont, logs = steps.make_a2j_train_step(ANCHORS)(cont, tbatch)
    np.testing.assert_allclose(float(logs["loss"]), jlosses_[1], rtol=LOSS_RTOL)
    assert_state_close(cont, jstates[1], after1, "continued step 2", ZERO_GRAD, ZERO_GRAD_BAR)
    with pytest.raises(ValueError, match="missing"):
        load_adam_state(cont.model, cont.optimizer, {}, {}, 1)


# -- the command line ------------------------------------------------------------------------


def _history(out):
    return [{k: v for k, v in json.loads(x).items() if k != "train_seconds"}
            for x in open(os.path.join(out, "history.jsonl"))]


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """Two frames a file: one step an epoch at batch 2."""
    return synthetic_data.build(str(tmp_path_factory.mktemp("a2j_cli")), n_images=2)


def test_train_a2j_subcommand_and_resume(small_data, tmp_path):
    """`train --model a2j` on the CPU, the JAX recipe's smoke (1 epoch at
    batch 2 of the mp-aug composite, 288² crops, validating on labels.json):
    a checkpoint and one history line at the recipe's rate; `--resume` for
    one more epoch equals 2 epochs in one call (parameters, Adam's state
    and the history), every generator of the dataset carried in the
    checkpoint."""
    root = os.path.dirname(small_data["img_dir"])
    cli = ["train", "--model", "a2j", "--data-root", root, "--device", "cpu",
           "--batch-size", "2", "--mp-aug", "--val-labels", "labels.json"]
    ra, rb = str(tmp_path / "a"), str(tmp_path / "b")
    trainer = port_main([*cli, "--out-dir", ra, "--epochs", "1"])
    assert checkpoint.checkpoint_steps(os.path.join(ra, "ckpt")) == [0]
    hist = _history(ra)
    assert len(hist) == 1 and np.isfinite([hist[0]["train_loss"], hist[0]["val_loss"]]).all()
    assert hist[0]["lr"] == pytest.approx(3.5e-4)
    assert trainer.state.optimizer.param_groups[0]["weight_decay"] == 1e-4
    port_main([*cli, "--out-dir", ra, "--epochs", "1", "--resume"])
    port_main([*cli, "--out-dir", rb, "--epochs", "2"])
    a, _, sa = checkpoint.restore_checkpoint(os.path.join(ra, "ckpt"))
    b, _, sb = checkpoint.restore_checkpoint(os.path.join(rb, "ckpt"))
    assert sa == sb == 1 and _history(ra) == _history(rb)
    assert all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    for i, s in a["optimizer"]["state"].items():
        assert all(torch.equal(v, b["optimizer"]["state"][i][k]) for k, v in s.items())
    assert set(a["data_rng"]) == {"rng", "inner", "erase"}
