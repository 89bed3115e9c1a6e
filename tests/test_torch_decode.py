"""Port vs JAX: batched greedy assembly (exact) and openpose_decode."""

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
from popnet_tpu_torch.core.skeleton import LIMBS, NUM_JOINTS
from popnet_tpu_torch.decode.assemble_device import assemble_batched
from popnet_tpu_torch.decode.openpose_infer import openpose_decode
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
    assert config.KDH3D_DEPTH == config.DepthStats(**dataclasses.asdict(jax_config.KDH3D_DEPTH))
    assert dataclasses.asdict(camera.KDH3D_INTRINSICS) == dataclasses.asdict(jax_camera.KDH3D_INTRINSICS)
    assert skeleton.KEYPOINT_NAMES == jax_skeleton.KEYPOINT_NAMES
    assert skeleton.LIMBS == jax_skeleton.LIMBS and skeleton.NUM_LIMBS == 14
