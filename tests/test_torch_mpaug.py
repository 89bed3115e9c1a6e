"""mp-aug training in the port against the JAX package, on the CPU: the
composites, the visibility-inferring prior targets, the three mp-aug
datasets (host, device bank, per-person augmentation), the streaming bank,
PopNet(pred_vis=True), its loss and its train step, and `train --mp-aug`
with its banks and `--pred-vis` (popnet_tpu_torch). Input 64², few
frames, few JAX compiles."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu import losses as jlosses
from popnet_tpu.core.config import EncoderConfig as JaxEncoderConfig, KDH3D_DEPTH as JAX_DEPTH
from popnet_tpu.data import compositing as jcomp
from popnet_tpu.data import datasets as jds
from popnet_tpu.data.streaming import StreamingDeviceMPAugDataset as JaxStreaming
from popnet_tpu.models import PopNet as FlaxPopNet
from popnet_tpu.ops import encoders as jenc
from popnet_tpu.train.state import create_train_state
from popnet_tpu.train.steps import make_popnet_train_step as jax_popnet_step
from popnet_tpu_torch.cli.main import main as port_main
from popnet_tpu_torch.core import config
from popnet_tpu_torch.data import compositing as pcomp
from popnet_tpu_torch.data import datasets as pds
from popnet_tpu_torch.data.streaming import StreamingDeviceMPAugDataset
from popnet_tpu_torch.interop.from_jax import load_sgd_momentum
from popnet_tpu_torch.losses import losses as plosses
from popnet_tpu_torch.models import PopNet
from popnet_tpu_torch.ops import encoders as penc
from popnet_tpu_torch.train import checkpoint, steps

from tests import synthetic_data
from tests.test_torch_model import _compare, fresh_init
from tests.test_torch_train import random_labels
from tests.test_torch_train_step import (LR32, SGD_BARS, SGD_LOSS_RTOL, assert_state_close, flat,
                                         jitted_init, port_state, variables_of)

P = 4
SIZE = 64
JECFG = JaxEncoderConfig(input_x=SIZE, input_y=SIZE, max_people=P)
PECFG = config.EncoderConfig(input_x=SIZE, input_y=SIZE, max_people=P)
TARGETS_BAR = 1.2e-7   # heat, PAF, align and prior maps: the encoders' measured gap
EXACT = ("image", "zmaps", "fg_masks_z", "fg_masks_align", "prior_mask_conf",
         "prior_mask_coord", "prior_weight_map")
N_IMAGES = 8           # recordings a location
N_LOCATIONS = 3        # fewer than AUG_MODS names: locations 3 and 4 wrap


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mpaug"))
    return synthetic_data.build(root, n_images=N_IMAGES, n_locations=N_LOCATIONS, seed=2)


def _kw(p, seed=3, **extra):
    return dict(bg_file=p["labels_bg"], bg_dir=p["bg_dir"], seg_dir=p["seg_dir"], seed=seed,
                **extra)


def jax_dataset(cls, p, **extra):
    return cls(p["img_dir"], p["labels_locs"], ecfg=JECFG, **_kw(p, **extra))


def port_dataset(cls, p, **extra):
    return cls(p["img_dir"], p["labels_locs"], ecfg=PECFG, device="cpu", **_kw(p, **extra))


def assert_batches(got: dict, ref: dict, bar: float = TARGETS_BAR) -> None:
    """Images, z-maps and masks equal, the other maps within `bar`."""
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        r, g = np.asarray(v), got[k].cpu().numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k in EXACT:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=bar, err_msg=k)


# -- the composites ----------------------------------------------------------------------


def _layers(seed: int, binary: bool):
    rng = np.random.default_rng(seed)
    B, L, H, W = 4, 3, 48, 40
    depths = rng.uniform(0.5, 6, (B, L, H, W)).astype(np.float32)
    masks = rng.uniform(0, 1, (B, L, H, W)).astype(np.float32)
    masks = (masks < 0.4).astype(np.float32) if binary else np.where(masks < 0.3, 0, masks)
    keep = rng.uniform(0, 1, (B, L)) < 0.7
    keep[0] = False                                  # a frame of background alone
    bg = rng.uniform(2, 6, (B, H, W)).astype(np.float32)
    return depths, masks.astype(np.float32), keep, bg


def _composites(depths, masks, keep, bg):
    jim, jfg = jax.vmap(lambda d, m, k, b: jcomp.mp_composite(d, m, k, b, 12.0))(
        *map(jnp.asarray, (depths, masks, keep, bg)))
    pim, pfg = pcomp.mp_composite(*map(torch.from_numpy, (depths, masks, keep, bg)), 12.0)
    jbg = jcomp.bg_composite(*map(jnp.asarray, (depths[:, 0], masks[:, 0], bg)))
    pbg = pcomp.bg_composite(*map(torch.from_numpy, (depths[:, 0], masks[:, 0], bg)))
    return ((np.asarray(jim), pim.numpy()), (np.asarray(jfg), pfg.numpy()),
            (np.asarray(jbg), pbg.numpy()))


def test_composites_equal_jax_bit_for_bit_on_binary_masks():
    """mp_composite (a frame with no layer kept among them) and
    bg_composite on {0, 1} masks: equal to JAX's bit for bit."""
    depths, masks, keep, bg = _layers(0, binary=True)
    (jim, pim), (jfg, pfg), (jbg, pbg) = _composites(depths, masks, keep, bg)
    np.testing.assert_array_equal(pim, jim)
    np.testing.assert_array_equal(pfg, jfg)
    np.testing.assert_array_equal(pbg, jbg)
    np.testing.assert_array_equal(pim[0], bg[0])
    assert (pfg[1:] > 0).any() and (pfg[1:] == 0).any()


def test_composites_on_fractional_masks_stay_within_an_ulp_of_jax():
    """Fractional masks (not what the benchmark ships): XLA fuses the
    composite's multiply-adds and the port rounds each product, so the two
    lie one float32 ulp apart on part of the pixels (measured here: 1922 of
    12288 pixels of mp_composite, 1637 of bg_composite, at most 4.8e-7 m);
    the union of the masks stays equal."""
    depths, masks, keep, bg = _layers(1, binary=False)
    (jim, pim), (jfg, pfg), (jbg, pbg) = _composites(depths, masks, keep, bg)
    np.testing.assert_array_equal(pfg, jfg)
    for j, p in ((jim, pim), (jbg, pbg)):
        assert np.abs(j.view(np.int32) - p.view(np.int32)).max() <= 1
        assert (j != p).any()


# -- the visibility-inferring prior targets ------------------------------------------------


def test_visibility_and_the_pred_vis_prior_equal_jax():
    """infer_joint_visibility on the encoded z-maps and the prior of 2 x
    (5 + 4 x 15) = 130 channels equal JAX's, on random labels; no joint
    lies within 1e-4 m of the 0.03 m threshold there, where a rounding of
    the z-map could flip it (pinned below)."""
    for seed in (0, 1):
        labels = random_labels(seed)
        ref = jax.vmap(lambda a, b, c, d, e, f: jenc.encode_targets(
            a, b, c, d, e, f, JECFG, JAX_DEPTH, pred_vis=True))(*map(jnp.asarray, labels))
        got = penc.encode_targets(*map(torch.as_tensor, labels), PECFG, config.KDH3D_DEPTH,
                                  pred_vis=True)
        assert got["prior_map"].shape == (12, 4, 4, 130)
        assert_batches(got, ref, bar=2e-6)
        np.testing.assert_array_equal(got["prior_map"].numpy(), np.asarray(ref["prior_map"]))
        j2, j3 = labels[0], labels[1]
        vis_ref = np.asarray(jax.vmap(lambda a, b, c: jenc.infer_joint_visibility(
            a, b, c, JECFG, JAX_DEPTH))(jnp.asarray(j2), jnp.asarray(j3[..., 2]), ref["zmaps"]))
        vis = penc.infer_joint_visibility(torch.from_numpy(j2), torch.from_numpy(j3[..., 2]),
                                          got["zmaps"], PECFG, config.KDH3D_DEPTH).numpy()
        np.testing.assert_array_equal(vis, vis_ref)
        assert 0 < vis.mean() < 1
        # the margin to the threshold: |z-map at the joint's cell - z| * std vs 0.03
        xj, yj = np.trunc(j2[..., 0] / 8).astype(int), np.trunc(j2[..., 1] / 8).astype(int)
        inb = (xj >= 0) & (xj < 8) & (yj >= 0) & (yj < 8)
        b, p, k = np.nonzero(inb)
        zm = got["zmaps"].numpy()[b, yj[inb], xj[inb], k]
        gap = np.abs(zm - (j3[b, p, k, 2] - 3.0) / 2.0) * 2.0
        assert np.abs(gap - 0.03).min() > 1e-4


# -- the datasets --------------------------------------------------------------------------


DATASETS = {
    "host": (jds.KDH3DMPAugDataset, pds.KDH3DMPAugDataset, {}),
    "host_u16mm": (jds.KDH3DMPAugDataset, pds.KDH3DMPAugDataset, {"transfer": "u16mm"}),
    "device_bank": (jds.DeviceMPAugDataset, pds.DeviceMPAugDataset, {}),
    "device_bank_pred_vis_hflip": (jds.DeviceMPAugDataset, pds.DeviceMPAugDataset,
                                   {"pred_vis": True, "hflip": True}),
    "adv": (jds.KDH3DMPAugAdvDataset, pds.KDH3DMPAugAdvDataset, {"hflip": True}),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_mpaug_datasets_equal_jax(data, name):
    """Two batches from the same seed (the generator carries over): images,
    z-maps and masks bit for bit with JAX's, the other maps within 1.2e-7,
    the generators in lockstep."""
    jcls, pcls, extra = DATASETS[name]
    ref_ds, ds = jax_dataset(jcls, data, **extra), port_dataset(pcls, data, **extra)
    assert len(ds) == len(ref_ds) == N_IMAGES
    for idx in ([0, 1, 2, 3], [6, 5, 7]):
        assert_batches(ds.get_batch(np.array(idx)), ref_ds.get_batch(np.array(idx)))
    assert ds.rng.bit_generator.state == ref_ds.rng.bit_generator.state


def test_host_stage_labels_equal_jax(data):
    """The host stage of KDH3DMPAugDataset: the composited frames and every
    label row (inverse maps, depth scales, flips, joints, boxes, pose
    weights, valid) equal the JAX package's packed rows exactly."""
    ref_ds = jax_dataset(jds.KDH3DMPAugDataset, data, hflip=True)
    ds = port_dataset(pds.KDH3DMPAugDataset, data, hflip=True)
    idx = np.arange(N_IMAGES)
    images_ref, meta, _ = ref_ds.get_batch_host(idx)
    images, rows = ds.get_batch_host(idx)
    np.testing.assert_array_equal(images, images_ref)
    flat = np.stack([np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in r])
                     for r in rows])
    np.testing.assert_array_equal(flat, meta)
    assert meta[:, 7].any() and not meta[:, 7].all()                 # some frames flipped
    assert ds.rng.bit_generator.state == ref_ds.rng.bit_generator.state


def test_device_composite_equals_the_host_composite(data):
    """load_composited_device (compositing.mp_composite) gives the NumPy
    composite bit for bit, and both JAX's, from the same draws."""
    ref = jax_dataset(jds.KDH3DMPAugDataset, data)
    host, dev = port_dataset(pds.KDH3DMPAugDataset, data), port_dataset(pds.KDH3DMPAugDataset,
                                                                        data)
    for i in range(N_IMAGES):
        a, anns = host.load_composited(i)
        b, _ = dev.load_composited_device(i)
        r, ranns = ref.load_composited(i)
        np.testing.assert_array_equal(b.numpy(), a)
        np.testing.assert_array_equal(a, r)
        assert anns == ranns


def test_device_bank_matches_the_host_path(data):
    """DeviceMPAugDataset against KDH3DMPAugDataset(transfer="u16mm"), the
    JAX package's own comparison and bars: the draws identical, images and
    z-maps within 2e-3 (millimetres quantized per layer or per composite),
    the rest within 1e-5, and the generators' next draw equal."""
    host = port_dataset(pds.KDH3DMPAugDataset, data, seed=7, transfer="u16mm")
    bank = port_dataset(pds.DeviceMPAugDataset, data, seed=7)
    hb, db = host.get_batch(np.arange(4)), bank.get_batch(np.arange(4))
    assert sorted(hb) == sorted(db)
    for k in hb:
        bar = 2e-3 if k in ("image", "zmaps") else 1e-5
        np.testing.assert_allclose(db[k].numpy(), hb[k].numpy(), rtol=0, atol=bar, err_msg=k)
    assert host.rng.integers(0, 1 << 30) == bank.rng.integers(0, 1 << 30)


def test_bank_iter_batches_runs_get_batch_ahead(data):
    """iter_batches of a dataset with its own get_batch (the bank): the
    batches get_batch makes, in the order the generator shuffles."""
    a, b = port_dataset(pds.DeviceMPAugDataset, data, seed=4), port_dataset(
        pds.DeviceMPAugDataset, data, seed=4)
    piped = list(a.iter_batches(3))
    order = np.arange(N_IMAGES)
    b.rng.shuffle(order)
    assert len(piped) == 2
    for n, batch in enumerate(piped):
        ref = b.get_batch(order[3 * n:3 * n + 3])
        for k in batch:
            assert torch.equal(batch[k], ref[k]), k


# -- the streaming bank ----------------------------------------------------------------------


def _recording(ds):
    """Wrap ds._bank_batch to record each batch's indices."""
    seen, inner = [], ds._bank_batch

    def bank_batch(indices, *a):
        seen.append([int(i) for i in indices])
        return inner(indices, *a)

    ds._bank_batch = bank_batch
    return seen


def test_stream_matches_the_full_bank_and_jax_shards(data):
    """A streamed batch over a staged shard equals the full bank's batch for
    the same indices and seed bit for bit; the shard tables are JAX's."""
    full = port_dataset(pds.DeviceMPAugDataset, data, seed=11)
    stream = port_dataset(StreamingDeviceMPAugDataset, data, seed=11, shard_indices=4)
    ref = jax_dataset(JaxStreaming, data, seed=11, shard_indices=4)
    assert stream.n_shards == 2 and stream._shard_files == ref._shard_files
    shard = stream._stage(1)
    idx = np.arange(4, 8)
    a = full.get_batch(idx)
    b = stream._bank_batch(idx, shard.row_of, shard.bank_depth, shard.bank_seg)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    stream._release(shard)
    assert stream._live_shards == 0


@pytest.mark.parametrize("repeats", [1, 3])
def test_stream_epoch_coverage_repeats_and_residency(data, repeats):
    """An epoch visits every index `repeats` times, a batch never spans two
    shards, each shard is staged once, and at most two shards are ever
    resident, none after the epoch."""
    stream = port_dataset(StreamingDeviceMPAugDataset, data, seed=0, shard_indices=4,
                          shard_repeats=repeats, with_prior=False, pose_align=False)
    seen = _recording(stream)
    staged, stage = [], stream._stage
    stream._stage = lambda sid: staged.append(sid) or stage(sid)
    batches = list(stream.iter_batches(2, drop_last=False))
    assert len(batches) == len(seen) == repeats * N_IMAGES // 2
    assert all(len({i // 4 for i in b}) == 1 for b in seen)
    assert np.bincount(sum(seen, []), minlength=N_IMAGES).tolist() == [repeats] * N_IMAGES
    assert sorted(staged) == [0, 1]
    assert stream.max_live_shards <= 2 and stream._live_shards == 0


def test_stream_shard_bytes_are_bounded(data):
    """shard_bytes counts one padded shard (depth 2 B and mask 1 B a pixel)
    and grows with shard_indices, not with the dataset."""
    s2 = port_dataset(StreamingDeviceMPAugDataset, data, shard_indices=2)
    s4 = port_dataset(StreamingDeviceMPAugDataset, data, shard_indices=4)
    h, w = s4.dcfg.height, s4.dcfg.width
    assert s2.shard_bytes() <= s4.shard_bytes() <= 4 * N_LOCATIONS * h * w * 3
    assert s4.shard_bytes() == s4._max_rows * h * w * 3
    assert s4.shard_bytes() == jax_dataset(JaxStreaming, data, shard_indices=4).shard_bytes()


# -- PopNet(pred_vis=True), its loss and its step ---------------------------------------------


def test_pred_vis_popnet_carries_flax_variables_and_matches_its_forward():
    """A fresh Flax PopNet(pred_vis=True) init (prior head scaled up so the
    130 channels carry signal) loads by name into PopNet(pred_vis=True),
    and every saved map matches the Flax forward within 1e-4."""
    flax_cls = functools.partial(FlaxPopNet, pred_vis=True)
    rng = np.random.default_rng(8)
    tree, flat = fresh_init(flax_cls, rng)
    flat["params/prior_out/kernel"] = flat["params/prior_out/kernel"] * 40.0
    tree["params"]["prior_out"]["kernel"] = jnp.asarray(flat["params/prior_out/kernel"])
    assert flat["params/prior_out/kernel"].shape[-1] == 130
    x = rng.normal(0, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    outs = _compare(tree, flat, x, flax_cls, functools.partial(PopNet, pred_vis=True), 7)
    prior_ref = outs[-1][0]
    assert prior_ref.shape == (2, 4, 4, 130) and prior_ref.std() > 0.05
    for ref, got in outs:
        np.testing.assert_allclose(got, ref, atol=1e-4)
    with pytest.raises(RuntimeError, match="prior_out"):
        PopNet().load_state_dict(PopNet(pred_vis=True).state_dict())


@pytest.fixture(scope="module")
def pred_vis_batch(data) -> dict:
    """4 frames of the JAX device bank with pred_vis at 64², as arrays."""
    ds = jax_dataset(jds.DeviceMPAugDataset, data, seed=1, pred_vis=True)
    return {k: np.asarray(v) for k, v in ds.get_batch(np.arange(4)).items()}


def test_popnet_loss_with_pred_vis_matches_jax(pred_vis_batch):
    """popnet_loss(pred_vis=True) on random outputs and a pred_vis batch:
    the total and every logged part within 5e-6 relative (XLA's float32
    mean, tests/test_torch_train.py); the self-pose term is weighted by 4K."""
    batch = pred_vis_batch
    rng = np.random.default_rng(3)
    B = 4
    shapes = [(B, 8, 8, 16), (B, 8, 8, 15), (B, 8, 8, 30)] * 2 + [(B, 4, 4, 130)]
    saved = [rng.uniform(-1.5, 1.5, s).astype(np.float32) for s in shapes]
    args = [batch[k] for k in ("heatmaps", "zmaps", "fg_masks_z", "align_maps",
                               "fg_masks_align", "prior_map", "prior_mask_conf",
                               "prior_mask_coord")]
    ref_total, ref_logs = jlosses.popnet_loss(
        [jnp.asarray(s) for s in saved], *map(jnp.asarray, args), 15,
        prior_weight_map=jnp.asarray(batch["prior_weight_map"]), pred_vis=True)
    total, logs = plosses.popnet_loss(
        [torch.from_numpy(np.ascontiguousarray(s.transpose(0, 3, 1, 2))) for s in saved],
        *map(torch.from_numpy, args), torch.from_numpy(batch["prior_weight_map"]), 15,
        pred_vis=True)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=5e-6)
    assert sorted(logs) == sorted(ref_logs)
    for k, v in ref_logs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=5e-6, err_msg=k)
    _, plain = plosses.popnet_loss(
        [torch.from_numpy(np.ascontiguousarray(s.transpose(0, 3, 1, 2))) for s in saved],
        *map(torch.from_numpy, args), torch.from_numpy(batch["prior_weight_map"]), 15)
    np.testing.assert_allclose(float(logs["loss_selfpose"]) * 3, float(plain["loss_selfpose"]) * 4,
                               rtol=1e-6)


def test_pred_vis_step_matches_jax_in_float64(pred_vis_batch):
    """The PoP-Net step with visibility (PopNet(pred_vis=True),
    make_popnet_train_step(pred_vis=True), the JAX library's composition)
    from one Flax init on a pred_vis batch of the JAX device bank, float64
    on both sides at one float32 rate, at tests/test_torch_train_step.py's
    SGD bars (loss 1e-12 relative, each parameter's update within 1e-8 of
    JAX's largest of the tensor, BatchNorm statistics 1e-10 relative): two
    port steps in a row, and JAX's state after the first carried across
    with its SGD trace and stepped on by the port."""
    flax_cls = functools.partial(FlaxPopNet, pred_vis=True)
    batch = pred_vis_batch
    f32 = create_train_state(jitted_init(flax_cls()), jax.random.PRNGKey(0),
                             jnp.zeros((1, SIZE, SIZE, 1)), learning_rate=LR32)
    with jax.enable_x64(True):
        up = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        jbatch = {k: jnp.asarray(v, jnp.float64) if v.dtype == np.float32 else jnp.asarray(v)
                  for k, v in batch.items()}
        params = up(f32.params)
        jstate = f32.replace(apply_fn=flax_cls(dtype=jnp.float64).apply, params=params,
                             batch_stats=up(f32.batch_stats), opt_state=f32.tx.init(params))
        step_j = jax.jit(jax_popnet_step(pred_vis=True))
        jstates, jlosses = [], []
        for _ in range(2):
            jstate, logs = step_j(jstate, jbatch)
            jstates.append(jstate)
            jlosses.append(float(logs["loss"]))
    model_cls = functools.partial(PopNet, pred_vis=True)
    step_p = steps.make_popnet_train_step(pred_vis=True)
    tbatch = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v.copy())
              for k, v in batch.items()}
    init = variables_of(f32)
    port = port_state(model_cls, init, torch.float64)
    for k in range(2):
        port, logs = step_p(port, tbatch)
        np.testing.assert_allclose(float(logs["loss"]), jlosses[k], rtol=SGD_LOSS_RTOL)
        assert assert_state_close(port, jstates[k], init, f"step {k + 1}", **SGD_BARS) > 0
    after1 = variables_of(jstates[0])
    cont = port_state(model_cls, after1, torch.float64)
    load_sgd_momentum(cont.model, cont.optimizer,
                      flat(jstates[0].opt_state.inner_state[0].trace, "params"))
    cont, logs = step_p(cont, tbatch)
    np.testing.assert_allclose(float(logs["loss"]), jlosses[1], rtol=SGD_LOSS_RTOL)
    assert_state_close(cont, jstates[1], after1, "continued step 2", **SGD_BARS)


# -- the command line ------------------------------------------------------------------------


def _train(root, out, *extra):
    return port_main(["train", "--data-root", root, "--device", "cpu", "--input-size",
                      str(SIZE), "--batch-size", "4", "--lr", "0.01", "--mp-aug",
                      "--out-dir", out, *extra])


@pytest.mark.parametrize("model,extra", [
    ("openpose", []), ("yolo", ["--device-bank"]),
    ("popnet", ["--stream-bank", "4", "--stream-repeats", "2"]),
    ("popnet", ["--device-bank", "--pred-vis"]), ("openpose", ["--pred-vis"])])
def test_train_mp_aug_subcommand_runs_an_epoch(data, tmp_path, model, extra):
    """`train --mp-aug` on the CPU, one epoch of the location files at
    batch 4, validating on labels.json without mp-aug: finite losses, a
    checkpoint, and the dataset each flag asks for (--stream-repeats 2: two
    passes over each shard, so twice the steps; --pred-vis: PoP-Net's
    130-channel prior, no prior for Open-Pose+)."""
    root = os.path.dirname(data["img_dir"])
    out = str(tmp_path / "run")
    trainer = _train(root, out, "--model", model, "--epochs", "1", "--val-labels",
                     "labels.json", *extra)
    hist = trainer.history
    assert len(hist) == 1 and np.isfinite([hist[0]["train_loss"], hist[0]["val_loss"]]).all()
    assert checkpoint.checkpoint_steps(os.path.join(out, "ckpt")) == [0]
    sd = checkpoint.restore_params(os.path.join(out, "ckpt"))[0]
    if model == "popnet":
        assert sd["prior_out.weight"].shape[0] == (130 if "--pred-vis" in extra else 100)


def test_train_resume_with_the_device_bank_equals_one_run(data, tmp_path):
    """1 epoch and `--resume` for 1 more equals 2 epochs in one call, bit
    for bit, with --device-bank (the checkpoint carries the bank dataset's
    generator)."""
    root = os.path.dirname(data["img_dir"])
    args = ["--model", "yolo", "--device-bank"]
    _train(root, str(tmp_path / "a"), *args, "--epochs", "2")
    _train(root, str(tmp_path / "b"), *args, "--epochs", "1")
    _train(root, str(tmp_path / "b"), *args, "--epochs", "1", "--resume")
    a, _, sa = checkpoint.restore_checkpoint(str(tmp_path / "a" / "ckpt"))
    b, _, sb = checkpoint.restore_checkpoint(str(tmp_path / "b" / "ckpt"))
    assert sa == sb == 1 and a["data_rng"] == b["data_rng"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    strip = lambda d: [{k: v for k, v in json.loads(x).items() if k != "train_seconds"}
                       for x in open(d / "history.jsonl")]
    assert strip(tmp_path / "a") == strip(tmp_path / "b")


def test_train_refuses_pred_vis_for_yolo_naming_the_channels(data, tmp_path):
    root = os.path.dirname(data["img_dir"])
    with pytest.raises(SystemExit, match="130 prior channels.*100.*no\\s+visibility-aware Yolo"):
        _train(root, str(tmp_path / "r"), "--model", "yolo", "--pred-vis")
    with pytest.raises(SystemExit, match="no nothing_\\*.json"):
        _train(root, str(tmp_path / "r"), "--model", "yolo", "--mp-label-prefix", "nothing_")


def test_jax_command_line_pred_vis_shapes_do_not_meet(pred_vis_batch):
    """The fault of the reference the port does not copy: the JAX command
    line builds PopNet() (2 x (5 + 3 x 15) = 100 prior channels) and encodes
    pred_vis targets (130), and JAX's popnet_loss refuses the pair."""
    batch = {k: jnp.asarray(v) for k, v in pred_vis_batch.items()}
    rng = np.random.default_rng(4)
    shapes = [(4, 8, 8, 16), (4, 8, 8, 15), (4, 8, 8, 30)] * 2 + [(4, 4, 4, 100)]
    saved = [jnp.asarray(rng.uniform(-1, 1, s).astype(np.float32)) for s in shapes]
    with pytest.raises(TypeError, match="incompatible shapes"):
        jlosses.popnet_loss(saved, batch["heatmaps"], batch["zmaps"], batch["fg_masks_z"],
                            batch["align_maps"], batch["fg_masks_align"], batch["prior_map"],
                            batch["prior_mask_conf"], batch["prior_mask_coord"], 15,
                            prior_weight_map=batch["prior_weight_map"], pred_vis=True)
