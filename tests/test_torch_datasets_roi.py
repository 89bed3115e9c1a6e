"""The ROI slice of the port's training data against the JAX package, on
the CPU: `augment_device.params_from_box` bit for bit, `ROIDataset`'s
batches from one seed (images bit for bit, targets at the encoders' bars,
the generator left in the same state) and `popnet_roi_loss` within the
5e-6 the other losses are held to."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from popnet_tpu import losses as jlosses
from popnet_tpu.core.config import EncoderConfig as JaxEncoderConfig
from popnet_tpu.data import augment_device as jad
from popnet_tpu.data.datasets import ROIDataset as JaxROIDataset
from popnet_tpu_torch.core.config import EncoderConfig
from popnet_tpu_torch.data import augment_device as pad
from popnet_tpu_torch.data.datasets import ROIDataset
from popnet_tpu_torch.losses import losses as plosses

from tests import synthetic_data
from tests.test_torch_train import LOSS_RTOL, _nchw, assert_targets


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_datasets.py's fixture."""
    return synthetic_data.build(str(tmp_path_factory.mktemp("kdh3d_roi")))


@pytest.mark.parametrize("box,out", [
    ((10.7, 20.2, 130.9, 300.5), (224, 224)), ((0, 0, 480, 512), (64, 96)),
    ((5.0, 5.0, 5.0, 5.9), (224, 224)), ((479.99, 7, 3, 511), (32, 32))])
def test_params_from_box_equals_jax(box, out):
    """Every field, dtype included; degenerate and inverted boxes clamp
    their sides to one pixel as JAX's do."""
    ref = jad.params_from_box(box, *out, src_w=480)
    got = pad.params_from_box(box, *out, src_w=480)
    for f in dataclasses.fields(got):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype, f.name
            np.testing.assert_array_equal(g, r, err_msg=f.name)
        else:
            assert type(g) is type(r) and g == r, f.name


def test_roi_batches_equal_jax(data):
    """ROIDataset(seed=5).get_batch([0, 1]) and a second batch: the person
    drawn from the same generator stream, images bit for bit, targets at
    the encoders' bars, no prior; the generator ends in the same state."""
    jds = JaxROIDataset(data["img_dir"], data["labels"], ecfg=JaxEncoderConfig(max_people=6),
                        seed=5)
    pds = ROIDataset(data["img_dir"], data["labels"], ecfg=EncoderConfig(max_people=6), seed=5,
                     device="cpu")
    for idx in ([0, 1], [3, 2, 0]):
        ref, got = jds.get_batch(idx), pds.get_batch(idx)
        assert got["image"].shape == (len(idx), 224, 224, 1) and "prior_map" not in got
        assert_targets(got, ref)
        heat = got["heatmaps"][..., :15]
        assert (heat.amax((1, 2, 3)) > 0.9).all()
    assert jds.rng.bit_generator.state == pds.rng.bit_generator.state


@pytest.mark.parametrize("pose_weights,pred_vis,prior_only", [
    (False, False, False), (True, False, False), (True, True, False), (False, False, True)])
def test_popnet_roi_loss_matches_jax(data, pose_weights, pred_vis, prior_only):
    """The total and every logged part on the ROI batch's targets and
    random outputs and pose vectors, within LOSS_RTOL relative."""
    ref = JaxROIDataset(data["img_dir"], data["labels"], ecfg=JaxEncoderConfig(max_people=6),
                        seed=5).get_batch([0, 1])
    rng = np.random.default_rng(7)
    k = 15

    def like(key, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, np.asarray(ref[key]).shape).astype(np.float32)

    saved = [a for _ in range(2) for a in (like("heatmaps", 0, 1), like("zmaps"),
                                           like("align_maps"))]
    d = (4 if pred_vis else 3) * k
    pose, obj = rng.normal(0, 1, (2, d)).astype(np.float32), rng.normal(0, 1, (2, d)).astype(
        np.float32)
    pw = rng.uniform(0.5, 2.0, (2, 6)).astype(np.float32) if pose_weights else None
    names = ("heatmaps", "zmaps", "fg_masks_z", "align_maps", "fg_masks_align")
    jt, jl = jlosses.popnet_roi_loss(
        [jnp.asarray(a) for a in saved] + [jnp.asarray(pose)], *(ref[n] for n in names),
        jnp.asarray(obj), k, pose_weights=None if pw is None else jnp.asarray(pw),
        prior_subnet_only=prior_only, pred_vis=pred_vis)
    pt, pl = plosses.popnet_roi_loss(
        [_nchw(a) for a in saved] + [torch.from_numpy(pose)],
        *(torch.from_numpy(np.array(ref[n])) for n in names), torch.from_numpy(obj), k,
        pose_weights=None if pw is None else torch.from_numpy(pw),
        prior_subnet_only=prior_only, pred_vis=pred_vis)
    assert set(jl) == set(pl)
    np.testing.assert_allclose(float(pt), float(jt), rtol=LOSS_RTOL)
    for key in jl:
        np.testing.assert_allclose(float(pl[key]), float(jl[key]), rtol=LOSS_RTOL, err_msg=key)
