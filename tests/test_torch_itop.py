"""ITOP in the port against the JAX package on the CPU: the ITOP constants,
the single-person metrics (eval/single.py), the torso-box crops, labels and
relative statistics (data/itop_a2j.py), ITOPA2JCropDataset, the two ITOP
drivers (cli/itop_eval.py) on oracle heads and maps, `train --dataset itop`
and `evaluate --dataset itop` beside the JAX command line's, and the ITOP
table's synthetic set (cli/itop_table.py) beside tests/synthetic_data.py's.
Eight frames of 320x240; the A2J CNN is never run."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu.cli import itop_eval as jie
from popnet_tpu.cli import main as jcli
from popnet_tpu.core import camera as jcamera
from popnet_tpu.core import config as jconfig
from popnet_tpu.data import a2j_crops as ja2j
from popnet_tpu.data import datasets as jds
from popnet_tpu.data import itop_a2j as jitop
from popnet_tpu.eval import single as jsingle
from popnet_tpu_torch.cli import itop_eval as pie
from popnet_tpu_torch.cli import itop_table
from popnet_tpu_torch.cli import main as pcli
from popnet_tpu_torch.core import camera as pcamera
from popnet_tpu_torch.core import config as pconfig
from popnet_tpu_torch.data import a2j_crops as pa2j
from popnet_tpu_torch.data import datasets as pds
from popnet_tpu_torch.data import itop_a2j as pitop
from popnet_tpu_torch.eval import single as psingle

import chip_smoke
from tests import synthetic_data
from tests.test_torch_eval import jitted_jax_state_init  # noqa: F401 (a fixture)
from tests.test_torch_train import assert_targets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "results", "bench_weights_openpose.npz")
N = 8
BATCH = 4
VOTE_PX, VOTE_M = 5e-3, 1e-4     # the A2J vote's bars against JAX (ROADMAP Queue 3)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def itop_set(tmp_path_factory):
    return synthetic_data.build_itop(str(tmp_path_factory.mktemp("torch_itop")), n_images=N,
                                     seed=4)


def _kdh3d(mod, p, **kw):
    """The single-person dataset at ITOP geometry that the drivers and the
    crop dataset read, JAX's (`mod` jds) or the port's."""
    if mod is jds:
        return jds.KDH3DDataset(p["img_dir"], p["labels"], ecfg=jconfig.EncoderConfig(max_people=2),
                                dcfg=jconfig.ITOP_DATASET, **kw)
    return pds.KDH3DDataset(p["img_dir"], p["labels"], ecfg=pconfig.EncoderConfig(max_people=2),
                            dcfg=pconfig.ITOP_DATASET, device="cpu", **kw)


@pytest.fixture(scope="module")
def kds(itop_set):
    return _kdh3d(jds, itop_set, is_train=False, seed=0), _kdh3d(pds, itop_set, seed=0)


# -- constants and metrics --------------------------------------------------------------------


def test_itop_constants_equal_jax():
    assert vars(pcamera.ITOP_INTRINSICS) == vars(jcamera.ITOP_INTRINSICS) == dict(
        fx=1.0 / 0.0035, fy=1.0 / 0.0035, cx=160.0, cy=120.0)
    assert vars(pconfig.ITOP_DEPTH) == vars(jconfig.ITOP_DEPTH) == dict(mean=3.0, std=2.0, max=5.0)
    ref, got = jconfig.ITOP_DATASET, pconfig.ITOP_DATASET
    assert (got.width, got.height, vars(got.intrinsics), vars(got.depth)) == (
        ref.width, ref.height, vars(ref.intrinsics), vars(ref.depth))
    assert (got.width, got.height) == (320, 240) and got.intrinsics is pcamera.ITOP_INTRINSICS


def test_single_person_metrics_equal_jax():
    """eval/single.py: every function equal to JAX's bit for bit on random
    (N, K, 3) sets with near misses."""
    rng = np.random.default_rng(0)
    gt = np.stack([rng.uniform(80, 240, (40, 15)), rng.uniform(40, 200, (40, 15)),
                   rng.uniform(1.5, 4.5, (40, 15))], -1)
    pred = gt + rng.normal(0, [3.0, 3.0, 0.04], gt.shape)
    for f in ("itop_pixel2world", "itop_world2pixel"):
        for a, b in zip(getattr(psingle, f)(*pred.T), getattr(jsingle, f)(*pred.T)):
            assert np.array_equal(a, b), f
    pw, gw = (np.stack([*psingle.itop_pixel2world(*a.T), a[..., 2].T], -1) for a in (pred, gt))
    for f in ("accuracy_10cm", "accuracy_10cm_per_joint"):
        assert np.array_equal(getattr(psingle, f)(pw, gw), getattr(jsingle, f)(pw, gw)), f
    for f in ("accuracy_2d", "accuracy_2d_per_joint"):
        for th in (2.0, 4.5):
            assert np.array_equal(getattr(psingle, f)(pred, gt, th),
                                  getattr(jsingle, f)(pred, gt, th)), f
    assert psingle.default_2d_threshold(320, 240) == jsingle.default_2d_threshold(320, 240)
    score = pie.score_itop_uvz(pred, gt)
    assert score == jie.score_itop_uvz(pred, gt) and 0.2 < score["acc_10cm"] < 0.95


# -- boxes, crops, labels, statistics ---------------------------------------------------------


def _centres(rng, n):
    return np.stack([rng.uniform(10, 310, n), rng.uniform(10, 230, n), rng.uniform(1.2, 4.8, n)], 1)


@pytest.mark.parametrize("xy_thres", [120.0, 0.12])
@pytest.mark.parametrize("rand_shift", [0, 5])
def test_boxes_from_centers_equal_jax_bit_for_bit(xy_thres, rand_shift):
    """The float32 boxes equal JAX's, the shifts drawn in JAX's order (the
    generators' next draws equal), boxes at the image's edges clamped; at
    the recipe's xy_thres and at one whose boxes lie inside the frame."""
    c = _centres(np.random.default_rng(1), 64)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    got = pitop.boxes_from_centers(c, xy_thres=xy_thres, rand_shift=rand_shift, rng=ra)
    ref = jitop.boxes_from_centers(c, xy_thres=xy_thres, rand_shift=rand_shift, rng=rb)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)
    assert ra.integers(0, 1 << 30) == rb.integers(0, 1 << 30)
    whole = (got == [0, 0, 319, 239]).all(1)
    assert whole.all() if xy_thres > 1 else not whole.any()
    clamped = (got[:, :2] == 0).any(1) | (got[:, 2] == 319) | (got[:, 3] == 239)
    assert clamped.any() and (xy_thres > 1 or not clamped.all())


def test_recipe_boxes_cover_the_whole_frame_in_both_packages(kds):
    """Found in the reference: xy_thres = 120 is a half-extent in the
    reference's millimetres, while ITOP's depths here are metres, so every
    torso box of the recipe reaches far past the frame and clamps to the
    whole of it, the box shifts included (JAX's and the port's alike)."""
    from popnet_tpu_torch.cli.itop_eval import _gt_uvz

    c = _gt_uvz(kds[1])[:, 8]
    for shift in (0, 5):
        for mod in (pitop, jitop):
            b = mod.boxes_from_centers(c, rand_shift=shift, rng=np.random.default_rng(0))
            assert (b == [0, 0, 319, 239]).all()


def _crop_inputs(seed: int):
    """Frames of depth in [0.5, 5.5] m with a torso patch about each centre
    that holds the clamp's edges exactly (f32(cz) +- f32(0.4))."""
    rng = np.random.default_rng(seed)
    B = 6
    imgs = rng.uniform(0.5, 5.5, (B, 240, 320)).astype(np.float32)
    c = _centres(rng, B)
    cz = c[:, 2].astype(np.float32)
    for b in range(B):
        x, y = int(c[b, 0]), int(c[b, 1])
        patch = cz[b] + rng.uniform(-0.6, 0.6, (30, 30)).astype(np.float32)
        patch[0, :4] = [cz[b] + np.float32(0.4), cz[b] - np.float32(0.4), cz[b], 0.0]
        y0, x0 = max(y - 15, 0), max(x - 15, 0)
        imgs[b, y0:y0 + 30, x0:x0 + 30] = patch[:min(30, 240 - y0), :min(30, 320 - x0)]
    return imgs, c, cz


@pytest.mark.parametrize("stats", ["absolute", "relative"])
@pytest.mark.parametrize("xy_thres", [120.0, 0.12])
def test_itop_crop_batch_equals_the_jitted_jax_crop(stats, xy_thres):
    """itop_crop_batch at 288² equals the jitted JAX crop bit for bit: the
    taps through f32(1/288), the clamp (>= then <=, at its exact edges), the
    true division by std; at the absolute statistics (3.0, 2.0) and at a
    relative pair, on whole-frame boxes (the recipe's) and on shifted boxes
    inside the frame."""
    imgs, c, cz = _crop_inputs(3 if xy_thres > 1 else 8)
    mean, std = (3.0, 2.0) if stats == "absolute" else (-0.0123, 0.137)
    boxes = jitop.boxes_from_centers(c, xy_thres=xy_thres, rand_shift=5,
                                     rng=np.random.default_rng(2))
    ref = np.asarray(jitop.itop_crop_batch(jnp.asarray(imgs), jnp.arange(len(imgs)),
                                           jnp.asarray(boxes), jnp.asarray(cz), mean=mean,
                                           std=std))
    got = pitop.itop_crop_batch(torch.from_numpy(imgs), torch.arange(len(imgs)),
                                torch.from_numpy(boxes), torch.from_numpy(cz), mean, std)
    assert got.shape == ref.shape == (len(imgs), 288, 288, 1)
    assert np.array_equal(got.numpy(), ref), np.abs(got.numpy() - ref).max()


def test_crop_labels_and_uncrop_equal_jax():
    """itop_crop_labels (float32) and itop_uncrop_keypoints (float64) equal
    JAX's exactly on float32 boxes with fractions."""
    rng = np.random.default_rng(4)
    c = _centres(rng, 16)
    boxes = jitop.boxes_from_centers(c)
    uvd = c[:, None, :] + rng.normal(0, [20, 30, 0.2], (16, 15, 3))
    cz = c[:, 2].astype(np.float32)
    got, ref = pitop.itop_crop_labels(uvd, boxes, cz), jitop.itop_crop_labels(uvd, boxes, cz)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)
    got = pitop.itop_uncrop_keypoints(got, boxes, cz)
    ref = jitop.itop_uncrop_keypoints(ref, boxes, cz)
    assert got.dtype == ref.dtype == np.float64 and np.array_equal(got, ref)


def test_relative_stats_equal_jax(kds):
    """itop_relative_stats within 1e-12 relative of JAX's (the float64 sums
    run in another order), at a scale far from the absolute statistics."""
    ref = jitop.itop_relative_stats(kds[0], batch_size=3)
    got = pitop.itop_relative_stats(kds[1], batch_size=3)
    for a, b in zip(got, ref):
        assert abs(a - b) <= 1e-12 * abs(b), (got, ref)
    assert abs(got[0]) < 0.4 and 0.0 < got[1] < 0.5


# -- the crop dataset --------------------------------------------------------------------------


def jax_erasing_draws(seed: int):
    """erasing_draws' stand-in that hands the port JAX's draws: the key of
    JAX's ITOPA2JCropDataset (PRNGKey(seed + 1)) split as its get_batch and
    random_erasing split it."""
    key = {"k": jax.random.PRNGKey(seed + 1)}

    def draws(n, out_size, generator):
        key["k"], sub = jax.random.split(key["k"])
        keys = jax.random.split(sub, 6)
        u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys[:5]]))
        noise = torch.from_numpy(np.array(jax.random.normal(keys[5], (n, out_size, out_size, 1))))
        return u, noise

    return draws


@pytest.mark.parametrize("augment", [True, False])
def test_crop_dataset_batches_equal_jax(itop_set, augment, monkeypatch):
    """ITOPA2JCropDataset against JAX's from one seed over two batches, at
    the relative statistics: crops bit for bit (with the box shifts, and
    the erasing given JAX's draws), labels exact, the generators' next
    draws equal."""
    mean, std = -0.0117, 0.0731
    ref_ds = ja2j.ITOPA2JCropDataset(_kdh3d(jds, itop_set, seed=0), augment=augment, seed=5,
                                     mean=mean, std=std)
    got_ds = pa2j.ITOPA2JCropDataset(_kdh3d(pds, itop_set, seed=0), augment=augment, seed=5,
                                     mean=mean, std=std)
    monkeypatch.setattr(pa2j, "erasing_draws", jax_erasing_draws(5))
    erased = 0
    for idx in ([0, 1, 2, 3], [6, 4, 7]):
        ref, got = ref_ds.get_batch(np.array(idx)), got_ds.get_batch(np.array(idx))
        assert np.array_equal(got["labels"].numpy(), np.asarray(ref["labels"]))
        assert np.array_equal(got["crops"].numpy(), np.asarray(ref["crops"]))
        plain = pa2j.ITOPA2JCropDataset(got_ds.inner, augment=False, mean=mean, std=std)
        erased += int((got["crops"] != plain.get_batch(np.array(idx))["crops"]).any((1, 2, 3))
                      .sum())
    assert ref_ds.rng.integers(0, 1 << 30) == got_ds.rng.integers(0, 1 << 30)
    assert (erased > 0) == augment
    assert set(got_ds.rng_state()) == {"rng", "inner", "erase"}


# -- the drivers --------------------------------------------------------------------------------


def _jax_in(port_infer, n_out: int = 3):
    """A port oracle as a JAX driver's infer: JAX arrays in and out."""
    def infer(x):
        out = port_infer(torch.from_numpy(np.array(x)))
        return tuple(jnp.asarray(t.numpy()) for t in out[:n_out])
    return infer


def test_a2j_driver_oracle_matches_jax(itop_set, kds):
    """GT-derived A2J heads (chip_smoke.itop_a2j_oracle) through the whole
    crop -> vote -> uncrop -> world -> 10-cm chain: over
    tests/test_itop_syngen.py's 0.995, the predictions at the vote's bars
    of JAX's on the same heads."""
    got = pie.run_itop_a2j_eval(chip_smoke.itop_a2j_oracle(kds[1]), kds[1], BATCH)
    ref = jie.run_itop_a2j_eval(_jax_in(chip_smoke.itop_a2j_oracle(kds[1])), kds[0], BATCH)
    assert got["acc_10cm"] > 0.995 and ref["acc_10cm"] > 0.995, (got["acc_10cm"], ref["acc_10cm"])
    g, r = np.asarray(got["pred_uvz"]), np.asarray(ref["pred_uvz"])
    assert np.abs(g[..., :2] - r[..., :2]).max() <= VOTE_PX
    assert np.abs(g[..., 2] - r[..., 2]).max() <= VOTE_M
    assert got["acc_10cm"] == ref["acc_10cm"] and got["per_joint"] == ref["per_joint"]


def test_openpose_driver_oracle_matches_jax(itop_set):
    """GT-encoded maps (the port's encoders, chip_smoke.itop_openpose_oracle)
    through the whole Open-Pose+ decode at ITOP geometry: over
    tests/test_itop_syngen.py's 0.9; given the same maps, the 2D
    predictions equal JAX's and the depths within 1e-6 m (the host path's
    bars)."""
    pmr = pds.MPRealDataset(itop_set["img_dir"], itop_set["labels"], dcfg=pconfig.ITOP_DATASET,
                            device="cpu")
    jmr = jds.MPRealDataset(itop_set["img_dir"], itop_set["labels"], dcfg=jconfig.ITOP_DATASET)
    got = pie.run_itop_openpose_eval(chip_smoke.itop_openpose_oracle(pmr, "cpu"), pmr, BATCH)
    ref = jie.run_itop_openpose_eval(_jax_in(chip_smoke.itop_openpose_oracle(pmr, "cpu")), jmr,
                                     BATCH)
    assert got["acc_10cm"] > 0.9 and ref["acc_10cm"] > 0.9, (got["acc_10cm"], ref["acc_10cm"])
    g, r = np.asarray(got["pred_uvz"]), np.asarray(ref["pred_uvz"])
    assert np.array_equal(g[..., :2], r[..., :2])
    np.testing.assert_allclose(g[..., 2], r[..., 2], rtol=0, atol=1e-6)
    assert got["per_joint"] == ref["per_joint"]


def test_eval_images_at_itop_geometry_equal_jax(itop_set, tmp_path):
    """MPRealDataset at ITOP_DATASET: the 320x240 -> 224² warp and the 5 m
    clip equal JAX's get_batch bit for bit, on the set's frames and on
    frames reaching 7 m."""
    pmr = pds.MPRealDataset(itop_set["img_dir"], itop_set["labels"], dcfg=pconfig.ITOP_DATASET,
                            device="cpu")
    jmr = jds.MPRealDataset(itop_set["img_dir"], itop_set["labels"], dcfg=jconfig.ITOP_DATASET)
    for name in pmr.ids[:3]:
        far = np.load(os.path.join(itop_set["img_dir"], name))
        far = far + np.random.default_rng(0).uniform(0, 2.5, far.shape).astype(np.float32)
        np.save(tmp_path / name, far)
    pfar = pds.MPRealDataset(str(tmp_path), itop_set["labels"], dcfg=pconfig.ITOP_DATASET,
                             device="cpu")
    jfar = jds.MPRealDataset(str(tmp_path), itop_set["labels"], dcfg=jconfig.ITOP_DATASET)
    for (p, j), idx in (((pmr, jmr), [0, 1, 2, 3]), ((pmr, jmr), [7, 5]),
                        ((pfar, jfar), [0, 1, 2])):
        got, ref = p.get_batch(idx)["image"].numpy(), np.asarray(j.get_batch(idx)["image"])
        assert got.shape == (len(idx), 224, 224, 1) and np.array_equal(got, ref)
    assert got.max() == np.float32(1.0)     # (5 - 3) / 2: the clip


# -- the command line --------------------------------------------------------------------------


class _Stop(Exception):
    pass


def _capture_trainer(monkeypatch, module):
    """Replace `module`.Trainer by a stand-in that keeps its arguments and
    the datasets `fit` is given, then stops the command."""
    seen = {}

    class Trainer:
        def __init__(self, model, *args, **kw):
            seen.update(model=model, kw=kw)
            self.scheduler = type("S", (), {})()

        def resume(self):
            return self

        def fit(self, train_ds, val_ds, **kw):
            seen.update(train=train_ds, val=val_ds)
            raise _Stop

    monkeypatch.setattr(module, "Trainer", Trainer)
    return seen


def _train_args(itop_set, model, *extra):
    root = os.path.dirname(itop_set["img_dir"])
    return ["train", "--model", model, "--dataset", "itop", "--data-root", root,
            "--val-labels", "labels.json", "--seed", "3", *extra]


def test_cli_itop_a2j_datasets_match_the_jax_command_line(itop_set, monkeypatch):
    """`train --model a2j --dataset itop`: the port's training and validation
    sets equal the ones the JAX command line builds (ITOPA2JCropDataset
    over KDH3DDataset at ITOP geometry, the absolute statistics): crops with
    the shifts and erasing (JAX's draws) bit for bit, labels exact, the
    validation crops unshifted and unerased; A2J(depth_prior=3.0) and the
    recipe's Adam-L2 at 3.5e-4 in both."""
    import popnet_tpu.train.loop as jloop
    import popnet_tpu_torch.train.loop as ploop

    jseen, pseen = _capture_trainer(monkeypatch, jloop), _capture_trainer(monkeypatch, ploop)
    with pytest.raises(_Stop):
        jcli.main(_train_args(itop_set, "a2j"))
    with pytest.raises(_Stop):
        pcli.main([*_train_args(itop_set, "a2j"), "--device", "cpu"])
    assert isinstance(pseen["train"], pa2j.ITOPA2JCropDataset)
    assert isinstance(jseen["train"], ja2j.ITOPA2JCropDataset)
    assert jseen["model"].depth_prior == pseen["model"].depth_prior == 3.0
    assert pseen["kw"]["learning_rate"] == jseen["kw"]["learning_rate"] == 3.5e-4
    assert pseen["kw"]["weight_decay"] == jseen["kw"]["weight_decay"] == 1e-4
    monkeypatch.setattr(pa2j, "erasing_draws", jax_erasing_draws(3))
    for split in ("train", "val"):
        p, j = pseen[split], jseen[split]
        assert (p.mean, p.std, p.augment) == (j.mean, j.std, j.augment) == (
            3.0, 2.0, split == "train")
        ref, got = j.get_batch(np.arange(4)), p.get_batch(np.arange(4))
        assert np.array_equal(got["crops"].numpy(), np.asarray(ref["crops"]))
        assert np.array_equal(got["labels"].numpy(), np.asarray(ref["labels"]))


def test_command_line_and_table_normalize_itop_crops_apart(itop_set, kds):
    """The JAX command line's ITOP A2J recipe normalizes the torso-relative
    crops with the absolute statistics (3.0, 2.0), so every crop sits near
    -1.5 with a small spread, while the ITOP table's measured relative
    statistics leave them near 0 and 1; the port follows each route as it
    stands (ROADMAP Queue 3)."""
    mean, std = pitop.itop_relative_stats(kds[1])
    cli = pa2j.ITOPA2JCropDataset(kds[1], augment=False).get_batch(np.arange(N))["crops"]
    table = pa2j.ITOPA2JCropDataset(kds[1], augment=False, mean=mean,
                                    std=std).get_batch(np.arange(N))["crops"]
    assert abs(float(cli.mean()) + 1.5) < 0.01 and float(cli.std()) < 0.01
    assert abs(float(table.mean())) < 0.01 and abs(float(table.std()) - 1.0) < 0.01


@pytest.mark.parametrize("model", ["openpose", "popnet", "yolo"])
def test_cli_itop_dense_datasets_match_the_jax_command_line(itop_set, model, monkeypatch):
    """`train --model openpose|popnet|yolo --dataset itop`: the training set
    is the KDH3D dataset at ITOP geometry in both command lines, and its
    augmented batch equals JAX's (images bit for bit, targets at the
    encoders' bars)."""
    args = _train_args(itop_set, model, "--input-size", "64")
    ja = jcli.build_parser().parse_args(args)
    pa = pcli.build_parser().parse_args([*args, "--device", "cpu"])
    ecfg = dict(input_x=64, input_y=64, max_people=2)
    pose_align, with_prior = model == "popnet", model in ("popnet", "yolo")
    ref_ds = jcli._train_dataset(ja, jconfig.EncoderConfig(**ecfg), jcli._dataset_cfg("itop"))
    got_ds = pcli._train_dataset(pa, pa.labels, pconfig.EncoderConfig(**ecfg), pose_align,
                                 with_prior, torch.device("cpu"))
    assert got_ds.dcfg == pconfig.ITOP_DATASET and ref_ds.dcfg.width == 320
    ref, got = ref_ds.get_batch(np.arange(4)), got_ds.get_batch(np.arange(4))
    assert got["image"].shape == (4, 64, 64, 1)
    assert_targets(got, ref)


def test_cli_train_itop_openpose_runs(itop_set, tmp_path):
    """`train --model openpose --dataset itop` on the CPU at 64² for one
    epoch: finite losses, a checkpoint, a history line."""
    trainer = pcli.main([*_train_args(itop_set, "openpose", "--input-size", "64",
                                      "--batch-size", "4", "--epochs", "1", "--lr", "0.05"),
                         "--device", "cpu", "--out-dir", str(tmp_path)])
    h = trainer.history
    assert len(h) == 1 and np.isfinite([h[0]["train_loss"], h[0]["val_loss"]]).all()
    assert os.listdir(tmp_path / "ckpt") == ["0"]


def test_cli_evaluate_itop_matches_the_jax_command_line(itop_set, tmp_path, capsys,
                                                       jitted_jax_state_init):
    """`evaluate --dataset itop --model openpose` with the committed weights
    on the 8 ITOP frames, the port on the CPU against the JAX command line
    (its checkpoint of the same weights): the GT keys equal, the same
    people, each prediction key within the host path's bars (2D 1e-3 px,
    the rest 1e-5), the metrics within 1e-6."""
    from popnet_tpu.serving import variables_from_npz
    from popnet_tpu.train.checkpoint import save_checkpoint

    from tests.test_torch_eval import GT_KEYS, PRED_KEYS, assert_json

    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, dict(variables_from_npz(WEIGHTS)), 0)
    root = os.path.dirname(itop_set["img_dir"])
    common = ["evaluate", "--model", "openpose", "--dataset", "itop", "--data-root", root,
              "--batch-size", str(N)]
    jcli.main([*common, "--ckpt", ckpt, "--out-dir", str(tmp_path / "jax")])
    capsys.readouterr()
    got_m = pcli.main([*common, "--weights", WEIGHTS, "--device", "cpu",
                       "--out-dir", str(tmp_path / "port")])
    ref = json.load(open(tmp_path / "jax" / "openpose_results.json"))
    got = json.load(open(tmp_path / "port" / "openpose_results.json"))
    assert sorted(got) == sorted(ref) and len(got["human_gt_set_2d"]) == N
    for k in GT_KEYS[::2]:
        assert got[k] == ref[k], k
    for k in (k for k in PRED_KEYS if k in ref):
        assert_json(got, ref, k, atol=1e-3 if k == "human_pred_set_2d" else 1e-5)
    from popnet_tpu_torch.cli.evaluate import evaluate_eval_data

    ref_m = evaluate_eval_data(ref, verbose=False)
    for k in ("pck2d", "pck3d", "map2d", "map3d"):
        assert got_m[k] == pytest.approx(ref_m[k], abs=1e-6, nan_ok=True), k


@pytest.mark.parametrize("argv,match", [
    pytest.param(["evaluate", "--dataset", "coco"], "neither command line evaluates an RGB model",
                 id="argv0-item 9b"),
    pytest.param(["evaluate", "--dataset", "mpii"], "neither command line evaluates an RGB model",
                 id="argv1-item 9b"),
    (["train", "--dataset", "coco"], "--dataset coco trains --model rtpose_vgg"),
    (["train", "--dataset", "mpii"], "--dataset mpii trains --model popnet_rgb"),
])
def test_cli_refuses_coco_and_mpii_naming_the_jpeg_reader(tmp_path, argv, match):
    """evaluate refuses COCO and MPII, as the JAX command line does (neither
    evaluates an RGB model; COCO results are scored by the library chain,
    tests/test_torch_coco_eval.py); training runs
    (tests/test_torch_rgb_train.py), and refuses the depth models, as the
    JAX command line does."""
    with pytest.raises(SystemExit, match=match):
        pcli.main([*argv, "--data-root", str(tmp_path), "--device", "cpu"])


# -- the ITOP table -----------------------------------------------------------------------------


def test_build_itop_writes_the_files_of_the_test_builder(tmp_path):
    """cli.itop_table.build_itop writes the same bytes as
    tests/synthetic_data.build_itop for the same seed: every frame and the
    label file."""
    a = synthetic_data.build_itop(str(tmp_path / "jax"), n_images=5, seed=11)
    b = itop_table.build_itop(str(tmp_path / "port"), n_images=5, seed=11)
    assert open(a["labels"], "rb").read() == open(b["labels"], "rb").read()
    names = sorted(os.listdir(a["img_dir"]))
    assert names == sorted(os.listdir(b["img_dir"])) and len(names) == 5
    for n in names:
        assert open(os.path.join(a["img_dir"], n), "rb").read() == \
            open(os.path.join(b["img_dir"], n), "rb").read(), n


def test_itop_syngen_torch_floors():
    """The committed table of the port (examples/results/itop_syngen_torch.json,
    `python -m popnet_tpu_torch.cli.itop_table` on the card at the JAX
    budget) clears tests/test_itop_syngen.py's floors, names the card it
    ran on, and never overwrote the JAX package's artifact."""
    art = json.load(open(os.path.join(ROOT, "examples", "results", "itop_syngen_torch.json")))
    assert art["budget"]["train_images"] == 256 and art["budget"]["a2j_epochs"] == 300
    assert art["budget"]["epochs"] == 500 and art["device"]["platform"] == "gpu"
    assert "H100" in art["device"]["nvidia_smi"] and "W" in art["device"]["nvidia_smi"]
    for method, floor in {"a2j": 0.85, "openpose": 0.70}.items():
        rec = art["methods"][method]
        assert rec["done"] and rec["final"]["acc_10cm"] >= floor, (method, rec["final"])
    assert itop_table.DEFAULT_OUT == os.path.join(ROOT, "examples", "results",
                                                  "itop_syngen_torch.json")
    jax_art = json.load(open(os.path.join(ROOT, "examples", "results", "itop_syngen.json")))
    assert "device" not in jax_art
