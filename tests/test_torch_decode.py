"""Port vs JAX: batched greedy assembly (exact), openpose_decode, the prior
(anchor-pose) decode and popnet_decode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from popnet_tpu.core.config import DepthStats as JaxDepthStats
from popnet_tpu.core.camera import KDH3D_INTRINSICS as JAX_CAM
from popnet_tpu.decode.assemble_device import assemble_batched as jax_assemble
from popnet_tpu.decode.device import find_peaks_batched as jax_find_peaks
from popnet_tpu.decode.device import score_limb_pairs_batched as jax_score_pairs
from popnet_tpu.decode.openpose_infer import openpose_decode as jax_decode
from popnet_tpu.decode.popnet_infer import _int_peaks_batched as jax_int_peaks
from popnet_tpu.decode.popnet_infer import popnet_decode as jax_popnet_decode
from popnet_tpu.decode.prior import decode_prior_maps as jax_decode_prior
from popnet_tpu.decode.prior import parse_prior_pose as jax_parse_prior
from popnet_tpu_torch.core.skeleton import LIMBS, NUM_JOINTS
from popnet_tpu_torch.decode.assemble_device import assemble_batched
from popnet_tpu_torch.decode.openpose_infer import openpose_decode
from popnet_tpu_torch.decode.popnet_infer import _int_peaks_batched, popnet_decode
from popnet_tpu_torch.decode.prior import decode_prior_maps, parse_prior_pose, stable_top_k
from tests.test_decode_device import synth


def check_assembly(peaks, valid, scores, ok):
    ref_j, ref_c = jax_assemble(jnp.asarray(peaks), jnp.asarray(valid), jnp.asarray(scores),
                                jnp.asarray(ok))
    got_j, got_c = assemble_batched(*(torch.from_numpy(np.asarray(a)) for a in
                                      (peaks, valid, scores, ok)))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(ref_j))
    return got_c.numpy()


@pytest.mark.parametrize("seed,n_people", [(0, 2), (3, 3), (5, 4), (7, 6)])
def test_assembly_on_synth_scenes(seed, n_people):
    heat, paf = synth(seed, n_people, B=3)
    peaks, valid = jax_find_peaks(jnp.asarray(heat))
    scores, ok = jax_score_pairs(jnp.asarray(paf), peaks, valid)
    counts = check_assembly(*(np.asarray(a) for a in (peaks, valid, scores, ok)))
    assert counts.sum() > 0


@pytest.mark.parametrize("seed,density", [(0, 0.08), (1, 0.3), (2, 0.7), (3, 1.0)])
def test_assembly_adversarial_random(seed, density):
    """Dense random candidates force long merge chains and person-count
    overflow past max_people (tests/test_assemble_device.py's cases)."""
    rng = np.random.default_rng(seed)
    B, K, M, L = 4, NUM_JOINTS, 16, len(LIMBS)
    n_valid = rng.integers(0, M + 1, size=(B, K))
    valid = np.arange(M)[None, None, :] < n_valid[:, :, None]
    peaks = np.zeros((B, K, M, 3), np.float32)
    peaks[..., :2] = rng.uniform(0, 223, size=(B, K, M, 2))
    peaks[..., 2] = rng.uniform(0.1, 1.0, size=(B, K, M))
    peaks[~valid] = 0.0
    scores = rng.uniform(0.01, 2.0, size=(B, 14, M, M)).astype(np.float32)
    ok = rng.uniform(size=(B, L, M, M)) < density
    limbs = np.asarray(LIMBS)
    ok &= valid[:, limbs[:, 0]][:, :, :, None] & valid[:, limbs[:, 1]][:, :, None, :]
    check_assembly(peaks, valid, scores, ok)


def test_assembly_empty():
    B, K, M, L = 2, NUM_JOINTS, 16, len(LIMBS)
    counts = check_assembly(np.zeros((B, K, M, 3), np.float32), np.zeros((B, K, M), bool),
                            np.zeros((B, L, M, M), np.float32), np.zeros((B, L, M, M), bool))
    assert (counts == 0).all()


def test_openpose_decode_matches_jax():
    """Identical numpy maps into both decodes: counts and visibility exact,
    joints within 1e-4."""
    heat, paf = synth(5, 3, B=3)
    rng = np.random.default_rng(0)
    zmap = rng.uniform(-0.5, 0.5, heat.shape[:3] + (15,)).astype(np.float32)
    image = rng.uniform(-1.5, 1.5, (3, 224, 224, 1)).astype(np.float32)
    ref = jax_decode(jnp.asarray(heat), jnp.asarray(paf), jnp.asarray(zmap), jnp.asarray(image),
                     depth=JaxDepthStats(), cam=JAX_CAM)
    got = openpose_decode(*(torch.from_numpy(a) for a in (heat, paf, zmap, image)))
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(ref["counts"]))
    np.testing.assert_array_equal(got["visibility"].numpy(), np.asarray(ref["visibility"]))
    assert got["counts"].sum() > 0
    for k in ("joints2d", "joints3d", "joints3d_raw", "conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)


def test_openpose_decode_with_bf16_z_matches_jax():
    """z maps in bfloat16, as the serving CNN leaves them: the decode's
    readouts take them as they are (no denormalized copy) and agree with
    the JAX decode of the same rounded values: counts and visibility exact,
    joints within 1e-4."""
    heat, paf = synth(7, 3, B=3)
    rng = np.random.default_rng(1)
    zmap = rng.uniform(-0.5, 0.5, heat.shape[:3] + (15,)).astype(np.float32)
    image = rng.uniform(-1.5, 1.5, (3, 224, 224, 1)).astype(np.float32)
    z_bf16 = torch.from_numpy(zmap).to(torch.bfloat16)
    ref = jax_decode(jnp.asarray(heat), jnp.asarray(paf), jnp.asarray(zmap, dtype=jnp.bfloat16),
                     jnp.asarray(image), depth=JaxDepthStats(), cam=JAX_CAM)
    got = openpose_decode(torch.from_numpy(heat), torch.from_numpy(paf), z_bf16,
                          torch.from_numpy(image))
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(ref["counts"]))
    np.testing.assert_array_equal(got["visibility"].numpy(), np.asarray(ref["visibility"]))
    assert got["counts"].sum() > 0
    for k in ("joints2d", "joints3d", "joints3d_raw", "conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)


def test_config_and_skeleton_copies_match_jax():
    import dataclasses

    from popnet_tpu.core import camera as jax_camera
    from popnet_tpu.core import config as jax_config
    from popnet_tpu.core import skeleton as jax_skeleton
    from popnet_tpu_torch.core import camera, config, skeleton

    for name in ("DepthStats", "EncoderConfig", "DecodeConfig"):
        ours, ref = getattr(config, name)(), getattr(jax_config, name)()
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), (name, f.name)
    for prop in ("agrid_w", "agrid_h", "prior_w", "prior_h"):
        assert getattr(config.EncoderConfig(), prop) == getattr(jax_config.EncoderConfig(), prop)
    assert config.DecodeConfig().conf_threshold == 0.5 and config.EncoderConfig().prior_w == 14
    assert config.KDH3D_DEPTH == config.DepthStats(**dataclasses.asdict(jax_config.KDH3D_DEPTH))
    assert dataclasses.asdict(camera.KDH3D_INTRINSICS) == dataclasses.asdict(jax_camera.KDH3D_INTRINSICS)
    assert skeleton.KEYPOINT_NAMES == jax_skeleton.KEYPOINT_NAMES
    assert skeleton.LIMBS == jax_skeleton.LIMBS and skeleton.NUM_LIMBS == 14


ANCHORS = ((6.0, 3.0), (12.0, 6.0))


def prior_maps(seed, B=2, H=14, W=14, K=NUM_JOINTS):
    """(B, H, W, 2 * (5 + 3K)) prior maps in the ranges the model's casting
    gives. Each frame has 18 cells over the 0.5 confidence threshold (more
    than the 16 kept), in descending confidence:
    - places 0-12 and 17: random cells of the upper half, places 0 and 1 equal;
    - places 13, 14, 15: boxes A, B, C side by side in the bottom rows, A
      over B and B over C above the NMS threshold, A and C below it, so the
      sequential NMS drops B and then revives C;
    - place 16: the last cell of the map, equal in confidence to C, so the
      stable top-k decides that C (the lower flat index) is the one kept."""
    rng = np.random.default_rng(seed)
    naf = 5 + 3 * K
    p = np.empty((B, H, W, 2, naf), np.float32)
    p[..., 0:2] = rng.uniform(-1, 1, p[..., 0:2].shape)
    p[..., 2:4] = rng.uniform(0.2, 0.5, p[..., 2:4].shape)
    p[..., 4] = rng.uniform(0.0, 0.45, p[..., 4].shape)
    p[..., 5:] = rng.uniform(-2, 2, p[..., 5:].shape)
    for b in range(B):
        conf = np.sort(rng.uniform(0.55, 0.99, 18))[::-1].astype(np.float32)
        conf[1] = conf[0]
        conf[16] = conf[15]
        cells = rng.choice(7 * W * 2, 14, replace=False)
        flat = p[b].reshape(-1, naf)
        flat[cells, 4] = np.concatenate([conf[:13], conf[17:]])[rng.permutation(14)]
        for i, x in enumerate((2, 3, 4)):        # A, B, C: 5 x 5 cells, one cell apart
            p[b, 12, x, 1, :5] = [0.0, 0.0, 5 / 12, 5 / 6, conf[13 + i]]
        p[b, H - 1, W - 1, 1, 2:5] = [0.2, 0.2, conf[16]]
    return p.reshape(B, H, W, 2 * naf)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_prior_maps_matches_jax(seed):
    """dets within 1e-6, valid exact, with tied confidences (one pair across
    the top-16 cut) and candidates that the sequential NMS revives because
    their suppressor was itself suppressed."""
    prior = prior_maps(seed)
    ref_d, ref_v = jax_decode_prior(jnp.asarray(prior), jnp.asarray(ANCHORS, jnp.float32), 3.0, 2.0,
                                    conf_threshold=0.5, nms_threshold=0.5)
    got_d, got_v = decode_prior_maps(torch.from_numpy(prior), torch.tensor(ANCHORS), 3.0, 2.0,
                                     conf_threshold=0.5, nms_threshold=0.5)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-6)
    d = got_d.numpy()
    assert (d[:, 0, 4] == d[:, 1, 4]).all() and (np.diff(d[..., 4], axis=1) <= 0).all()
    # a one-pass NMS (drop whatever a better box overlaps) must differ: revival happened
    x1, y1 = d[..., 0] - d[..., 2] / 2, d[..., 1] - d[..., 3] / 2
    x2, y2 = d[..., 0] + d[..., 2] / 2, d[..., 1] + d[..., 3] / 2
    iw = np.clip(np.minimum(x2[:, :, None], x2[:, None]) - np.maximum(x1[:, :, None], x1[:, None]), 0, None)
    ih = np.clip(np.minimum(y2[:, :, None], y2[:, None]) - np.maximum(y1[:, :, None], y1[:, None]), 0, None)
    area = d[..., 2] * d[..., 3]
    iou = iw * ih / (area[:, :, None] + area[:, None] - iw * ih)
    one_pass = ~np.triu(iou > 0.5, 1).any(axis=1)
    assert not one_pass[:, 14:].any() and (got_v.numpy()[:, 13:] == [True, False, True]).all()
    assert d[0, 15, 0] == np.float32(4 / 14) and got_v.numpy().sum() >= 8


def test_stable_top_k_takes_the_lower_index_among_equals():
    s = torch.tensor([[0.5, 0.75, 0.5, 0.75, 0.5, 0.1], [0.0] * 6])
    val, idx = stable_top_k(s, 3)
    assert idx.tolist() == [[1, 3, 0], [0, 1, 2]] and val[0].tolist() == [0.75, 0.75, 0.5]


def test_parse_prior_pose_matches_jax():
    from popnet_tpu_torch.core.config import KDH3D_DEPTH

    prior = prior_maps(2, B=2)
    prior[1, ..., 4::5 + 3 * NUM_JOINTS] = 0.1   # second frame: nothing over the threshold
    ref = jax_parse_prior(prior, ANCHORS, NUM_JOINTS, 480.0, 512.0, JaxDepthStats(),
                          conf_threshold=0.5)
    got = parse_prior_pose(prior, ANCHORS, NUM_JOINTS, 480.0, 512.0, KDH3D_DEPTH,
                           conf_threshold=0.5)
    for r_img, g_img in zip(zip(*ref), zip(*got)):
        for r_list, g_list in zip(r_img, g_img):
            assert len(r_list) == len(g_list)
            for r, g in zip(r_list, g_list):
                np.testing.assert_allclose(g, r, atol=1e-4)
    assert len(got[0][0]) >= 2 and got[0][1] == [] and got[2][1] == []


def test_int_peaks_batched_with_more_tied_peaks_than_kept():
    """20 isolated peaks of one value in a plane and max_peaks 16: the 16 of
    lowest flat index stay, in row-major order (exact against JAX)."""
    rng = np.random.default_rng(4)
    heat = rng.uniform(0, 0.3, (2, 28, 28, NUM_JOINTS)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(2, 27, 5), np.arange(3, 27, 6), indexing="ij")
    heat[0, ys.ravel(), xs.ravel(), 0] = 0.75     # 20 equal peaks
    heat[0, 1, 1, 0] = 0.9                       # and one above them all
    heat[1, 10, 10, 3] = heat[1, 10, 11, 3] = 0.8  # a two-cell plateau: both are peaks
    ref = jax_int_peaks(jnp.asarray(heat), 0.5, 16)
    got = _int_peaks_batched(torch.from_numpy(heat), 0.5, 16)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    px, py, valid = (g.numpy() for g in got)
    assert valid[0, 0].all() and (py[0, 0, 0], px[0, 0, 0]) == (1, 1)
    assert py[0, 0].max() == 17                  # the last row of tied peaks (y = 22) is cut
    assert valid[1, 3].sum() == 2 and valid[1, 5].sum() == 0


@pytest.mark.parametrize("readout", ["universe", "gated"])
def test_popnet_decode_matches_jax(readout):
    """The maps of tests/test_universe_readout.py synth_maps, three frames
    (one with a joint plane without any peak), and random prior maps: valid
    exact, boxes, joints and conf within 1e-4."""
    from popnet_tpu.core import config as jax_config
    from tests.test_universe_readout import synth_maps

    maps = [synth_maps(seed) for seed in (0, 1, 2)]
    heat = np.stack([np.concatenate([m[0], np.zeros_like(m[0][..., :1])], -1) for m in maps])
    heat[2, :, :, 6] *= 0.2                      # no peak over 0.5: keeps the align offsets
    align = np.stack([m[1] for m in maps]) / 2.5
    zmap = np.stack([m[2] for m in maps])
    prior = prior_maps(7, B=3)
    ref = jax_popnet_decode(*(jnp.asarray(a) for a in (heat, zmap, align, prior)),
                            jax_config.EncoderConfig(), jax_config.DecodeConfig(),
                            JaxDepthStats(), JAX_CAM, readout=readout)
    got = popnet_decode(*(torch.from_numpy(a) for a in (heat, zmap, align, prior)),
                        readout=readout)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    assert got["valid"].sum() >= 6
    for k in ("boxes", "joints2d", "joints3d", "conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="unknown readout"):
        popnet_decode(*(torch.from_numpy(a) for a in (heat, zmap, align, prior)), readout="x")
