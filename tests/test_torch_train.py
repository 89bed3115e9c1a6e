"""The port's training data path and training machinery against the JAX
package, on the CPU: augmentation draws and label algebra, the per-frame
warp, the GT encoders, the training dataset's batches, the losses, the
schedules, the optimizers, BatchNorm's train-mode statistics, checkpoints
and resume, and the `train` subcommand (popnet_tpu_torch)."""

import dataclasses
import json
import os
import pickle

import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from popnet_tpu import losses as jlosses
from popnet_tpu.core.config import EncoderConfig as JaxEncoderConfig, KDH3D_DEPTH as JAX_DEPTH
from popnet_tpu.core.skeleton import SWAP_INDICES as JAX_SWAP
from popnet_tpu.data import augment_device as jad
from popnet_tpu.data.datasets import KDH3DDataset as JaxKDH3DDataset
from popnet_tpu.ops import encoders as jenc
from popnet_tpu.train import schedule as jsched
from popnet_tpu.train.state import adam_l2, sgd_nesterov
from popnet_tpu_torch.cli.main import main as port_main
from popnet_tpu_torch.core import config
from popnet_tpu_torch.core.skeleton import SWAP_INDICES
from popnet_tpu_torch.data import augment_device as pad
from popnet_tpu_torch.data.datasets import KDH3DDataset
from popnet_tpu_torch.losses import losses as plosses
from popnet_tpu_torch.models import PopNet, RTPoseLight3D, YoloPoseNet
from popnet_tpu_torch.models.layers import BatchNorm
from popnet_tpu_torch.ops import encoders as penc
from popnet_tpu_torch.train import checkpoint, schedule as psched
from popnet_tpu_torch.train.loop import Trainer
from popnet_tpu_torch.train.state import TrainState, make_optimizer
from popnet_tpu_torch.train.steps import make_yolo_eval_loss, make_yolo_train_step

from tests import synthetic_data

P = 4
JECFG = JaxEncoderConfig(input_x=64, input_y=64, max_people=P)
PECFG = config.EncoderConfig(input_x=64, input_y=64, max_people=P)
MASKS = ("fg_masks_z", "fg_masks_align", "prior_mask_conf", "prior_mask_coord",
         "prior_weight_map")
EXACT = MASKS + ("zmaps",)
CLOSE = ("heatmaps", "pafs", "align_maps", "prior_map")   # within 2e-6
FAMILY_TARGETS = {"openpose": (False, False), "popnet": (True, True), "yolo": (False, True)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_targets(got: dict, ref: dict, close: float = 2e-6):
    """Masks and zmaps equal, the rest within `close`."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, v in ref.items():
        r, g = np.asarray(v), got[k].cpu().numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k in EXACT or k == "image":
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            assert k in CLOSE, k
            np.testing.assert_allclose(g, r, rtol=0, atol=close, err_msg=k)


# -- config, augmentation draws, label algebra, warp ---------------------------


def test_encoder_config_and_swap_copies_match_jax():
    ours, ref = config.EncoderConfig(), JaxEncoderConfig()
    for f in dataclasses.fields(ref):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    for prop in ("grid_w", "grid_h", "zgrid_w", "zgrid_h", "agrid_w", "agrid_h", "prior_w",
                 "prior_h", "num_anchors"):
        assert getattr(PECFG, prop) == getattr(JECFG, prop), prop
    assert SWAP_INDICES == JAX_SWAP


@pytest.mark.parametrize("hflip", [False, True])
def test_augment_params_and_labels_equal_jax_bit_for_bit(hflip):
    """Over 200 seeds of training draws (and the evaluation's plain
    resize), the parameters and the moved labels equal JAX's bit for bit,
    and both generators end in the same state."""
    rng_l = np.random.default_rng(9)
    flips = 0
    for seed in range(200):
        kw = dict(rotate_deg=10.0, render_min=0.7, render_max=1.2, max_crop=0.1, hflip=hflip)
        if seed % 20 == 0:
            kw = dict(rotate_deg=0.0, render_min=1.0, render_max=1.0, max_crop=0.0, hflip=False)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        a = jad.sample_augment_params(ra, 512, 480, 224, 224, **kw)
        b = pad.sample_augment_params(rb, 512, 480, 224, 224, **kw)
        assert ra.bit_generator.state == rb.bit_generator.state
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(vb, va, err_msg=f.name)
            else:
                assert type(va) is type(vb) and va == vb, f.name
        flips += a.flip
        j2 = rng_l.uniform(-20, 500, (P, 15, 2)).astype(np.float32)
        j3 = rng_l.uniform(-1, 5, (P, 15, 3)).astype(np.float32)
        bb = rng_l.uniform(0, 480, (P, 4)).astype(np.float32)
        for x, y in zip(jad.transform_labels(a, j2, j3, bb, list(JAX_SWAP)),
                        pad.transform_labels(b, j2, j3, bb, list(SWAP_INDICES))):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(y, x)
    assert (flips > 50) == hflip


def test_per_frame_warp_equals_jax_bit_for_bit():
    """Per-frame maps, depth scales and flips: equal to JAX's warp bit for
    bit; the one-map evaluation call is unchanged."""
    rng = np.random.default_rng(1)
    B = 6
    imgs = rng.uniform(0, 8, (B, 64, 48)).astype(np.float32)
    params = [jad.sample_augment_params(np.random.default_rng(i), 64, 48, 32, 24, hflip=True)
              for i in range(B)]
    inv = np.stack([p.inv_mat for p in params])
    scales = np.array([p.depth_scale for p in params], np.float32)
    flips = np.array([True, False, True, True, False, False])
    ref = jad.warp_depth_batch(jnp.asarray(imgs), jnp.asarray(inv), jnp.asarray(scales),
                               jnp.asarray(flips), 32, 24)
    got = pad.warp_depth_batch(torch.from_numpy(imgs), torch.from_numpy(inv), 32, 24,
                               depth_scales=torch.from_numpy(scales),
                               flips=torch.from_numpy(flips))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    one = pad.resize_inv_mat(64, 48, 32, 24)
    a = pad.warp_depth_batch(torch.from_numpy(imgs), one, 32, 24)
    b = pad.warp_depth_batch(torch.from_numpy(imgs), torch.from_numpy(np.stack([one] * B)), 32, 24,
                             depth_scales=torch.ones(B), flips=torch.zeros(B, dtype=torch.bool))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- the GT encoders -------------------------------------------------------------


def random_labels(seed: int, B: int = 12):
    """Labels of B frames of 64x64 input, joints partly off the image, a
    fifth of the people invalid."""
    rng = np.random.default_rng(seed)
    j2 = rng.uniform(-6, 70, (B, P, 15, 2)).astype(np.float32)
    z = rng.uniform(0.5, 7, (B, P, 15)).astype(np.float32)
    j3 = np.stack([(j2[..., 0] - 32) / 504 * z, (j2[..., 1] - 32) / 504 * z, z], -1).astype(
        np.float32)
    bb = np.stack([j2[..., 0].min(-1) - 3, j2[..., 1].min(-1) - 3,
                   j2[..., 0].max(-1) + 3, j2[..., 1].max(-1) + 3], -1).astype(np.float32)
    w = rng.uniform(0.5, 2, (B, P)).astype(np.float32)
    valid = rng.uniform(0, 1, (B, P)) < 0.8
    dr = rng.uniform(-0.5, 7, (B, JECFG.zgrid_h, JECFG.zgrid_w)).astype(np.float32)
    return j2, j3, bb, w, valid, dr


def shared_cell_labels():
    """Two frames where two valid people (0 and 2) fall in one prior cell
    with the same best anchor (person 1 between them invalid, person 3 in
    another cell), and joints placed so that align-map cells lie at equal
    distance from two instances of one joint type."""
    j2, j3, bb, w, valid, dr = random_labels(5, B=2)
    valid[:] = [True, False, True, True]
    for b in range(2):
        bb[b, 0] = [18.0, 17.0, 30.0, 41.0]        # centre (24, 29): cell (1, 1), 12x24 px
        bb[b, 2] = [19.5, 18.0, 29.0, 40.5]        # the same cell and anchor, other values
        bb[b, 3] = [40.0, 40.0, 60.0, 50.0]
        w[b, 0], w[b, 2] = 0.7, 1.9
        # joint 4 of people 0 and 2 at x = 20 -+ 3 px, same y: the cells
        # between them lie at equal distance from both
        j2[b, 0, 4] = [17.0, 28.0]
        j2[b, 2, 4] = [23.0, 28.0]
        j2[b, 3, 4] = [60.0, 60.0]
    return j2, j3, bb, w, valid, dr


def jax_targets(labels, pose_align=True, with_prior=True):
    return jax.vmap(lambda a, b, c, d, e, f: jenc.encode_targets(
        a, b, c, d, e, f, JECFG, JAX_DEPTH, pose_align=pose_align, with_prior=with_prior))(
        *map(jnp.asarray, labels))


def port_targets(labels, pose_align=True, with_prior=True):
    return penc.encode_targets(*map(torch.as_tensor, labels), PECFG, config.KDH3D_DEPTH,
                               pose_align=pose_align, with_prior=with_prior)


@pytest.mark.parametrize("family", sorted(FAMILY_TARGETS))
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_targets_match_jax(family, seed):
    """Each family's target bundle: masks and zmaps equal, heat, PAF, align
    and prior within 2e-6."""
    align, prior = FAMILY_TARGETS[family]
    labels = random_labels(seed)
    assert_targets(port_targets(labels, align, prior), jax_targets(labels, align, prior))


def test_prior_encoder_last_person_wins_and_align_ties_take_the_first():
    """Two valid people in one (cell, anchor): the later one's target and
    pose weight stand, as JAX's sequential loop leaves them; align cells
    equidistant from two joints take the first person's offsets."""
    labels = shared_cell_labels()
    got, ref = port_targets(labels), jax_targets(labels)
    assert_targets(got, ref)
    pm = got["prior_map"].reshape(2, 4, 4, 2, -1)
    n = int(got["prior_mask_coord"][0, 1, 1].argmax())
    assert float(got["prior_mask_coord"][0, 1, 1].sum()) == 1.0
    cx = (19.5 + 29.0) / 2 / 16
    assert float(pm[0, 1, 1, n, 0]) == np.float32(np.float32(cx) - 1)      # person 2's dx
    np.testing.assert_array_equal(got["prior_weight_map"][:, 1, 1].numpy(), np.float32(1.9))
    # the tie: cell x = 2 (centre 2.5 cells = 20 px) sits 3 px from both joints 4
    am = got["align_maps"].reshape(2, 8, 8, 15, 2)
    dx = float(am[0, 3, 2, 4, 0])
    assert dx == np.float32(-(2.5 - np.float32(17.0) / 8) / 2.5)            # person 0's side


def test_paf_band_edge_cell_pinned_beside_both_jax_values():
    """The PAF cell where a limb's band width is 1 in exact arithmetic
    (random_labels(114), the even frames' joints snapped to quarter pixels;
    frame 10, cell (5, 3), limb 9: person 3's unit vector rounds to (0.6,
    0.8), its width 1.0000000019 exactly). Rounded once a product the width
    is 0.99999994 and person 3 paints; as the fused multiply-add
    fma(ba_x, u1, -(ba_y * u0)) it is 1.0 and it does not. The compiled
    JAX encoder (per frame and batched alike) counts two painters but adds
    person 2's vector alone, so no one paint mask gives its value: the port
    keeps one mask, in plain float32, equal to JAX run op by op (both
    people's vectors over 2)."""
    labels = list(random_labels(114))
    labels[0] = labels[0].copy()
    labels[0][0::2] = np.round(labels[0][0::2] * 4) / 4
    cell = (10, 5, 3, slice(18, 20))
    got = port_targets(labels)["pafs"][cell].numpy()
    frame = [jnp.asarray(a[10]) for a in labels]
    with jax.disable_jit():
        eager = np.asarray(jenc.encode_targets(*frame, JECFG, JAX_DEPTH)["pafs"])[cell[1:]]
    per_frame = np.asarray(jenc.encode_targets(*frame, JECFG, JAX_DEPTH)["pafs"])[cell[1:]]
    batched = np.asarray(jax_targets(labels)["pafs"])[cell]
    u2 = np.float32([-0.5014238, -0.86520183])
    np.testing.assert_allclose(got, (u2 + np.float32([0.6, 0.8])) / 2, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(per_frame, u2 / np.float32(2))
    np.testing.assert_array_equal(batched, per_frame)
    np.testing.assert_array_equal(got, np.float32([0.049288124, -0.03260091]))
    np.testing.assert_array_equal(batched, np.float32([-0.2507119, -0.43260092]))


# -- the training dataset ----------------------------------------------------------


@pytest.fixture(scope="module")
def data_paths(tmp_path_factory):
    return synthetic_data.build(str(tmp_path_factory.mktemp("train_data")), n_images=8)


@pytest.mark.parametrize("bg_aug,transfer", [(False, "f32"), (True, "u16mm")])
def test_dataset_batches_equal_jax(data_paths, bg_aug, transfer):
    """KDH3DDataset.get_batch with the training augmentation:
    images bit for bit with JAX's get_batch from the same seed, targets at
    the encoders' bars, over two batches (the generator carries over)."""
    p = data_paths
    kw = dict(bg_aug=bg_aug, bg_file=p["labels_bg"] if bg_aug else None,
              bg_dir=p["bg_dir"] if bg_aug else None, seg_dir=p["seg_dir"] if bg_aug else None,
              seed=3, transfer=transfer)
    jds = JaxKDH3DDataset(p["img_dir"], p["labels"], ecfg=JaxEncoderConfig(max_people=P), **kw)
    pds = KDH3DDataset(p["img_dir"], p["labels"], ecfg=config.EncoderConfig(max_people=P),
                       device="cpu", **kw)
    for idx in ([0, 1, 2, 3], [5, 7, 6]):
        ref, got = jds.get_batch(np.array(idx)), pds.get_batch(np.array(idx))
        assert got["image"].shape == (len(idx), 224, 224, 1)
        assert_targets(got, ref)
    assert jds.rng.bit_generator.state == pds.rng.bit_generator.state


def test_iter_batches_pipeline_equals_get_batch(data_paths):
    """The two-stage thread pipeline yields the batches get_batch makes in
    the same order, shuffled by the dataset's generator; the unaugmented
    dataset of the validation draws the plain resize."""
    p = data_paths
    mk = lambda: KDH3DDataset(p["img_dir"], p["labels"], ecfg=config.EncoderConfig(max_people=P),
                              pose_align=False, with_prior=False, seed=4, device="cpu")
    a, b = mk(), mk()
    piped = list(a.iter_batches(3))
    order = np.arange(8)
    b.rng.shuffle(order)
    assert len(piped) == 2
    for n, batch in enumerate(piped):
        ref = b.get_batch(order[3 * n:3 * n + 3])
        assert sorted(batch) == ["fg_masks_z", "heatmaps", "image", "pafs", "zmaps"]
        for k in batch:
            assert torch.equal(batch[k], ref[k]), k
    assert len(list(a.iter_batches(3, shuffle=False, drop_last=False))) == 3


# -- losses ---------------------------------------------------------------------------


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


LOSS_RTOL = 5e-6


def test_losses_match_jax():
    """The three families' losses (and each logged part) on the same
    outputs and targets, within LOSS_RTOL relative, not 1e-6: measured on
    20 seeds of (4, 8, 8, 15) z-maps, XLA's float32 mean
    on the CPU lies up to 2.4e-6 from the exact sum of the same float32
    products and PyTorch's within 1.3e-7, so the two can stand 2.4e-6
    apart with the port the closer: 5e-6 holds that with room."""
    labels = random_labels(2, B=4)
    tj = jax_targets(labels)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in tj.items()}
    rng = np.random.default_rng(3)

    def like(key, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, np.asarray(tj[key]).shape).astype(np.float32)

    saved_op = [a for _ in range(2) for a in (like("pafs"), like("heatmaps", 0, 1), like("zmaps"))]
    saved_pn = [a for _ in range(2) for a in (like("heatmaps", 0, 1), like("zmaps"),
                                              like("align_maps"))] + [like("prior_map")]
    cases = [
        (jlosses.rtpose_light3d_loss_fgweight(
            [jnp.asarray(a) for a in saved_op], tj["heatmaps"], tj["pafs"], tj["zmaps"],
            tj["fg_masks_z"]),
         plosses.rtpose_light3d_loss_fgweight(
            [_nchw(a) for a in saved_op], tp["heatmaps"], tp["pafs"], tp["zmaps"],
            tp["fg_masks_z"])),
        (jlosses.popnet_loss(
            [jnp.asarray(a) for a in saved_pn], tj["heatmaps"], tj["zmaps"], tj["fg_masks_z"],
            tj["align_maps"], tj["fg_masks_align"], tj["prior_map"], tj["prior_mask_conf"],
            tj["prior_mask_coord"], 15, prior_weight_map=tj["prior_weight_map"]),
         plosses.popnet_loss(
            [_nchw(a) for a in saved_pn], tp["heatmaps"], tp["zmaps"], tp["fg_masks_z"],
            tp["align_maps"], tp["fg_masks_align"], tp["prior_map"], tp["prior_mask_conf"],
            tp["prior_mask_coord"], tp["prior_weight_map"], 15)),
        (jlosses.yolo_loss(jnp.asarray(saved_pn[-1]), tj["prior_map"], tj["prior_mask_conf"],
                           tj["prior_mask_coord"], 15, weight_map=tj["prior_weight_map"]),
         plosses.yolo_loss(_nchw(saved_pn[-1]), tp["prior_map"], tp["prior_mask_conf"],
                           tp["prior_mask_coord"], tp["prior_weight_map"], 15)),
    ]
    for (jt, jl), (pt, pl) in cases:
        assert set(jl) == set(pl)
        np.testing.assert_allclose(float(pt), float(jt), rtol=LOSS_RTOL)
        for k in jl:
            np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=LOSS_RTOL, err_msg=k)


# -- schedules and optimizers ------------------------------------------------------------


def test_schedules_give_the_jax_rates():
    """For random validation losses (with plateaus), each controller's rate
    sequence equals JAX's."""
    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(1, 0.5, 10), np.full(20, 0.5),
                              rng.uniform(0.3, 0.6, 30)]).tolist()
    pairs = [(psched.ReduceLROnPlateau(1.0), jsched.ReduceLROnPlateau(1.0)),
             (psched.ReduceLROnPlateau(0.5, mode="max", threshold_mode="abs", patience=2),
              jsched.ReduceLROnPlateau(0.5, mode="max", threshold_mode="abs", patience=2)),
             (psched.StepLR(0.1, 7, 0.5), jsched.StepLR(0.1, 7, 0.5)),
             (psched.WarmupCosine(0.2, 40, 5, 0.01), jsched.WarmupCosine(0.2, 40, 5, 0.01))]
    for ours, ref in pairs:
        assert getattr(ours, "initial_lr", None) == getattr(ref, "initial_lr", None)
        assert [ours.step(m) for m in metrics] == [ref.step(m) for m in metrics]
        assert vars(ours) == vars(ref)


@pytest.mark.parametrize("name,wd,bar", [("sgd", 0.0, 1e-6), ("sgd", 1e-3, 1e-6),
                                         ("adam", 0.0, 2e-5), ("adam", 1e-2, 2e-5)])
def test_optimizers_match_optax(name, wd, bar):
    """SGD-Nesterov and Adam with L2 against the JAX package's optax
    chains on a toy parameter over 5 steps (a float32 rate of 0.05, a
    quadratic loss with curvatures in (0, 2]): after every step, the
    parameters' change within `bar` of the largest change of optax's. SGD:
    1e-6 (measured 1.4e-7). Adam: 2e-5 (measured 8.9e-6): optax takes the
    bias correction 1 - 0.999^t in float32, where f32(0.999) puts it
    1.3e-5 off at t = 1 and its square root 6.4e-6; torch's first step
    lies within 4.8e-8 of a float64 Adam, optax's 3.4e-7."""
    rng = np.random.default_rng(0)
    target = rng.normal(0, 1, (7, 3)).astype(np.float32)
    p0 = rng.normal(0, 1, (7, 3)).astype(np.float32)
    lr = 0.05
    tx = sgd_nesterov(lr, 0.9, wd) if name == "sgd" else adam_l2(lr, wd)
    params, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(params)
    curv = np.arange(1, 22, dtype=np.float32).reshape(7, 3) / 21
    loss = lambda p: jnp.sum((p - target) ** 2 * curv)
    lin = torch.nn.Linear(3, 7, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p0))
    opt = make_optimizer(lin, name, lr, 0.9, wd)
    wts = torch.from_numpy(curv)
    for _ in range(5):
        g = jax.grad(loss)(params)
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        torch.sum((lin.weight - torch.from_numpy(target)) ** 2 * wts).backward()
        opt.step()
        dj, dp = np.asarray(params) - p0, lin.weight.detach().numpy() - p0
        assert np.abs(dp - dj).max() <= bar * np.abs(dj).max()


# -- BatchNorm, init -----------------------------------------------------------------------


def test_train_step_feeds_the_cnn_plain_nchw_strides():
    """The steps' NCHW batch keeps the image's values with plain strides:
    a one-channel image only permuted from NHWC reads as channels-last,
    which cuDNN carries into the stem, where the CUDA backward of
    `F.avg_pool2d` goes wrong (ROADMAP Queue 3)."""
    from popnet_tpu_torch.train.steps import _nchw

    img = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 10, 8, 1)).astype(np.float32))
    assert img.permute(0, 3, 1, 2).contiguous().stride()[1] == 1
    got = _nchw(img)
    assert got.stride() == (80, 80, 8, 1)
    assert torch.equal(got, img.permute(0, 3, 1, 2))


def test_batchnorm_train_mode_keeps_flax_statistics():
    """Three train-mode forwards: the running mean and variance equal
    Flax's (momentum 0.99, the biased E[x^2] - E[x]^2) within 1e-6
    relative, the outputs within 1e-5; nn.BatchNorm2d's defaults (0.9 on
    the old value, the unbiased variance) land far from them."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(0.7, 2.0, (4, 6, 5, 3)).astype(np.float32) for _ in range(3)]
    fbn = fnn.BatchNorm(use_running_average=False)
    variables = fbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    ours, plain = BatchNorm(3), torch.nn.BatchNorm2d(3, eps=1e-5)
    ours.train(), plain.train()
    for x in xs:
        y, upd = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        got = ours(_nchw(x))
        plain(_nchw(x))
        np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
    st = variables["batch_stats"]
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(st["mean"]), rtol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(st["var"]), rtol=1e-6)
    assert not np.allclose(plain.running_mean.numpy(), np.asarray(st["mean"]), rtol=1e-2)
    assert not np.allclose(plain.running_var.numpy(), np.asarray(st["var"]), rtol=1e-2)
    ours.eval()
    ref = torch.nn.functional.batch_norm(_nchw(xs[0]), ours.running_mean, ours.running_var,
                                         ours.weight, ours.bias, False, 0.0, 1e-5)
    assert torch.equal(ours(_nchw(xs[0])), ref)


@pytest.mark.parametrize("cls", [RTPoseLight3D, PopNet, YoloPoseNet])
def test_init_seeded_follows_the_flax_initialisers(cls):
    """Reproducible by seed; the stem's convs He-normal truncated at two
    standard deviations (fan-in), the others normal(0.01); zero biases,
    unit BatchNorm."""
    a, b, c = cls().init_seeded(0), cls().init_seeded(0), cls().init_seeded(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
    w = a.stem.Conv_0.weight.detach()
    std = (2.0 / 49) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.1 and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert not torch.equal(w, c.stem.Conv_0.weight)
    convs = [m for n, m in a.named_modules() if isinstance(m, torch.nn.Conv2d)
             and not n.startswith("stem.") and m.weight.numel() > 10000]
    for m in convs:
        assert abs(float(m.weight.detach().std()) / 0.01 - 1) < 0.1
        assert m.bias is None or (m.bias == 0).all()
    for m in a.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert isinstance(m, BatchNorm)
            assert (m.weight == 1).all() and (m.bias == 0).all() and (m.running_var == 1).all()


# -- Trainer, checkpoints, the train subcommand ---------------------------------------------


def _trainer(out, **kw):
    return Trainer(YoloPoseNet(), make_yolo_train_step(), make_yolo_eval_loss(),
                   learning_rate=0.02, out_dir=str(out), print_freq=100, device="cpu", **kw)


def _datasets(p):
    ecfg = config.EncoderConfig(input_x=64, input_y=64, max_people=P)
    train = KDH3DDataset(p["img_dir"], p["labels"], ecfg=ecfg, pose_align=False, seed=0,
                         device="cpu")
    val = KDH3DDataset(p["img_dir"], p["labels"], ecfg=ecfg, pose_align=False, augment=False,
                       seed=1, device="cpu")
    return train, val


def test_resume_continues_bit_for_bit_like_an_uninterrupted_fit(data_paths, tmp_path):
    """fit 2 epochs, against fit 1 epoch, a new Trainer resumed from its
    checkpoint and fit 1 more: the same history, parameters, BatchNorm
    statistics, momentum buffers and controller, bit for bit on the CPU;
    ckpt keeps every step (up to 3), ckpt_best 1."""
    torch.manual_seed(0)
    whole = _trainer(tmp_path / "a", optimizer="sgd")
    whole.scheduler.patience = 0                       # the rate moves within the run
    hist = whole.fit(*_datasets(data_paths), epochs=2, batch_size=4)
    part = _trainer(tmp_path / "b")
    part.scheduler.patience = 0
    part.fit(*_datasets(data_paths), epochs=1, batch_size=4)
    resumed = _trainer(tmp_path / "b", seed=7).resume()
    assert resumed.epoch == 1
    hist2 = resumed.fit(*_datasets(data_paths), epochs=1, batch_size=4)
    strip = lambda h: [{k: v for k, v in r.items() if k != "train_seconds"} for r in h]
    assert strip(hist2) == strip(hist)[1:]
    assert vars(resumed.scheduler) == vars(whole.scheduler)
    a, b = whole.state.state_dict(), resumed.state.state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, s in a["optimizer"]["state"].items():
        assert torch.equal(s["momentum_buffer"], b["optimizer"]["state"][i]["momentum_buffer"])
    assert a["optimizer"]["param_groups"][0]["lr"] == b["optimizer"]["param_groups"][0]["lr"]
    assert sorted(os.listdir(tmp_path / "a" / "ckpt")) == ["0", "1"]
    assert len(os.listdir(tmp_path / "a" / "ckpt_best")) == 1
    sd, meta, step = checkpoint.restore_params(str(tmp_path / "a" / "ckpt"))
    assert step == 1 and meta["epoch"] == 1 and torch.equal(sd["tower4.bias"],
                                                            a["model"]["tower4.bias"])
    lines = open(tmp_path / "a" / "history.jsonl").read().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0, 1]


class StubWriter:
    """A SummaryWriter that records its log directory and its scalars."""
    made = []

    def __init__(self, log_dir):
        self.log_dir, self.scalars, self.flushes = log_dir, [], 0
        StubWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def flush(self):
        self.flushes += 1


@pytest.fixture
def stub_tensorboard(monkeypatch):
    """torch.utils.tensorboard replaced by a module holding StubWriter."""
    import types

    StubWriter.made = []
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=StubWriter))
    return StubWriter.made


def test_epoch_scalars_reach_the_summary_writer(data_paths, tmp_path, stub_tensorboard):
    """Each epoch's train_loss, val_loss and lr go to one SummaryWriter in
    <out_dir>/tb at the epoch's number, as the JAX Trainer writes them;
    history.jsonl holds the same records."""
    trainer = _trainer(tmp_path)
    hist = trainer.fit(*_datasets(data_paths), epochs=2, batch_size=4)
    assert len(stub_tensorboard) == 1
    w = stub_tensorboard[0]
    assert w.log_dir == os.path.join(str(tmp_path), "tb") and w.flushes == 2
    assert w.scalars == [(k, r[k], r["epoch"]) for r in hist for k in
                         ("train_loss", "val_loss", "lr")]
    lines = open(tmp_path / "history.jsonl").read().splitlines()
    assert [json.loads(x)["val_loss"] for x in lines] == [r["val_loss"] for r in hist]


def test_profile_epoch_writes_a_chrome_trace_of_that_epoch(data_paths, tmp_path,
                                                            stub_tensorboard):
    """profile_epoch=1: epoch 1's training runs under torch.profiler and its
    Chrome trace (<out_dir>/trace/epoch1.json) holds the step's operators;
    no other epoch is traced."""
    trainer = _trainer(tmp_path, profile_epoch=1)
    trainer.fit(*_datasets(data_paths), epochs=2, batch_size=4)
    assert os.listdir(tmp_path / "trace") == ["epoch1.json"]
    with open(tmp_path / "trace" / "epoch1.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "cpu_op"}
    assert any("conv" in n for n in names) and any("adam" in n or "sgd" in n or "add" in n
                                                   for n in names), sorted(names)[:20]


def test_resume_best_loads_ckpt_best(data_paths, tmp_path, stub_tensorboard):
    """ckpt_best at epoch 0 and ckpt at epoch 1 (the best validation loss
    set out of reach after the first epoch): resume(best=True) restores
    ckpt_best's model, optimizer, controller, epoch and data generators,
    resume() ckpt's; the two differ."""
    trainer = _trainer(tmp_path)
    train, val = _datasets(data_paths)
    trainer.fit(train, val, epochs=1, batch_size=4)
    trainer.best_val = -1.0
    trainer.fit(train, val, epochs=1, batch_size=4)
    best, meta, step = checkpoint.restore_checkpoint(str(tmp_path / "ckpt_best"))
    last, _, last_step = checkpoint.restore_checkpoint(str(tmp_path / "ckpt"))
    assert (step, last_step) == (0, 1)
    for which, payload, epoch in ((True, best, 1), (False, last, 2)):
        r = _trainer(tmp_path, seed=7).resume(best=which)
        assert r.epoch == epoch
        sd = r.state.state_dict()
        for k, v in payload["model"].items():
            assert torch.equal(sd["model"][k], v), (which, k)
        assert vars(r.scheduler) == payload["scheduler"]
        assert r._data_rng_state == payload["data_rng"]
    assert not all(torch.equal(best["model"][k], last["model"][k]) for k in best["model"])


def test_checkpoints_keep_the_last_steps_and_restore_the_model_alone(tmp_path):
    """save_checkpoint keeps the newest `keep` steps and replaces a step
    saved again; restore_params gives the model's tensors alone."""
    d = str(tmp_path / "ck")
    for step in range(5):
        checkpoint.save_checkpoint(d, {"model": {"w": torch.full((2,), float(step))},
                                       "optimizer": {}}, step, {"epoch": step}, keep=3)
    assert checkpoint.checkpoint_steps(d) == [2, 3, 4] and sorted(os.listdir(d)) == ["2", "3", "4"]
    checkpoint.save_checkpoint(d, {"model": {"w": torch.zeros(2)}}, 4, {"epoch": 9}, keep=3)
    sd, meta, step = checkpoint.restore_params(d)
    assert step == 4 and meta == {"epoch": 9} and torch.equal(sd["w"], torch.zeros(2))
    assert checkpoint.restore_checkpoint(d, 2)[0]["model"]["w"].tolist() == [2.0, 2.0]
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_params(str(tmp_path / "none"))


class _Pickled:
    """Stands for any object whose unpickling would run code."""


def test_restore_loads_tensors_and_plain_values_and_refuses_pickled_objects(tmp_path):
    """restore_checkpoint loads with torch.load's weights_only: the payload
    the Trainer writes (tensors, the controller's attributes, the numpy
    generator's 128-bit state) restores equal, and an object of a class
    is refused."""
    d = str(tmp_path / "ck")
    rng_state = np.random.default_rng(5).bit_generator.state
    payload = {"model": {"w": torch.arange(3.0)}, "optimizer": {"state": {}, "param_groups": []},
               "scheduler": {"lr": 0.5, "best": None, "mode": "min", "bad": 2},
               "data_rng": rng_state}
    checkpoint.save_checkpoint(d, payload, 0)
    got = checkpoint.restore_checkpoint(d)[0]
    assert got["data_rng"] == rng_state and got["scheduler"] == payload["scheduler"]
    assert torch.equal(got["model"]["w"], payload["model"]["w"])
    checkpoint.save_checkpoint(d, {"model": {}, "extra": _Pickled()}, 1)
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.restore_checkpoint(d)


def _flax_flat(sd: dict) -> dict:
    """The port's state dict as '/'-joined Flax variables (the inverse of
    interop.state_dict_from_jax), for an npz."""
    leaf = {"weight": "kernel", "bias": "bias", "running_mean": "mean", "running_var": "var"}
    out = {}
    for k, v in sd.items():
        *path, name = k.split(".")
        if name == "num_batches_tracked":
            continue
        coll = "batch_stats" if name.startswith("running") else "params"
        arr = v.numpy()
        if name == "weight" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        fname = "scale" if name == "weight" and arr.ndim == 1 else leaf[name]
        out["/".join([coll, *path, fname])] = arr
    return out


@pytest.mark.parametrize("model", ["openpose", "popnet", "yolo"])
def test_train_subcommand_writes_history_and_checkpoints_that_evaluate_scores(
        data_paths, tmp_path, model):
    """`train --device cpu --bg-aug` (64² input, 1 epoch of one batch of 8)
    writes history.jsonl, ckpt/ and ckpt_best/; `--resume` adds an epoch;
    `evaluate --ckpt` writes the JSON that `evaluate --weights` writes with
    the same weights."""
    root = os.path.dirname(data_paths["img_dir"])
    out = str(tmp_path / "run")
    common = ["--model", model, "--data-root", root, "--device", "cpu", "--input-size", "64",
              "--batch-size", "8", "--out-dir", out]
    port_main(["train", *common, "--epochs", "1", "--bg-aug", "--val-labels", "labels.json",
               "--lr", "0.01", "--transfer", "u16mm"])
    port_main(["train", *common, "--epochs", "1", "--bg-aug", "--val-labels", "labels.json",
               "--lr", "0.01", "--resume"])
    hist = [json.loads(x) for x in open(os.path.join(out, "history.jsonl"))]
    assert [r["epoch"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in hist)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["0", "1"]
    assert len(os.listdir(os.path.join(out, "ckpt_best"))) == 1
    sd = checkpoint.restore_params(os.path.join(out, "ckpt"))[0]
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **_flax_flat(sd))
    ev = ["evaluate", "--model", model, "--data-root", root, "--device", "cpu",
          "--input-size", "64", "--batch-size", "8"]
    a = port_main([*ev, "--ckpt", os.path.join(out, "ckpt"), "--out-dir", str(tmp_path / "e1")])
    b = port_main([*ev, "--weights", npz, "--out-dir", str(tmp_path / "e2")])
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    name = f"{model}_results.json"
    assert json.load(open(tmp_path / "e1" / name)) == json.load(open(tmp_path / "e2" / name))


def test_train_refuses_what_is_not_ported(tmp_path):
    for extra, what in ((["--dataset", "coco"], "--dataset coco trains --model rtpose_vgg"),
                        (["--mesh", "data=4,pipe"], "bad --mesh spec"),
                        (["--mesh", "data=1,pipe=2", "--n-micro", "3"],
                         r"batch 32 must divide data axis \(1\) x n_micro \(3\)")):
        with pytest.raises(SystemExit, match=what):
            port_main(["train", "--data-root", str(tmp_path), "--device", "cpu",
                       "--model", "openpose", *extra])
    state = TrainState(YoloPoseNet(), make_optimizer(YoloPoseNet()))
    assert set(state.state_dict()) == {"model", "optimizer"}
    with pytest.raises(ValueError, match="layout 'tp' needs a mesh"):
        _trainer(tmp_path, layout="tp")
