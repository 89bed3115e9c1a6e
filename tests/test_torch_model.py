"""Port vs JAX: cv2 resize, depth preprocessing and the RTPoseLight3D CNN
(float32, on the CPU)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu.models import RTPoseLight3D as FlaxRTPoseLight3D
from popnet_tpu.ops.resize import resize_bilinear_cv2 as jax_resize
from popnet_tpu.serving import preproc_depth as jax_preproc
from popnet_tpu.serving import variables_from_npz
from popnet_tpu_torch.interop.from_jax import load_into, load_npz
from popnet_tpu_torch.models import RTPoseLight3D
from popnet_tpu_torch.ops.resize import resize_bilinear_cv2
from popnet_tpu_torch.serving import preproc_depth
from tests.synthetic_data import person_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "results", "bench_weights_openpose.npz")


def person_frames(seed, n_frames=2, people=(2, 3)):
    """(n, 512, 480) raw depth in metres with 2-3 people per frame."""
    rng = np.random.default_rng(seed)
    centers = ([120, 200], [250, 260], [380, 230])
    frames = []
    for b in range(n_frames):
        d = np.zeros((512, 480), np.float32)
        for c in centers[: people[b % len(people)]]:
            dp, seg, _ = person_scene(rng, c, rng.uniform(2.5, 4.0))
            d = np.where(seg > 0, dp, d)
        frames.append(d)
    return np.stack(frames)


@pytest.mark.parametrize("shape,out_hw", [((512, 480), (224, 224)), ((37, 53), (20, 61))])
def test_resize_matches_jax(shape, out_hw):
    img = np.random.default_rng(0).uniform(0, 6, (2, *shape)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(img.transpose(1, 2, 0)), *out_hw)).transpose(2, 0, 1)
    got = resize_bilinear_cv2(torch.from_numpy(img), *out_hw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_preproc_depth_matches_jax():
    raw = np.random.default_rng(1).uniform(-0.5, 8.0, (3, 512, 480)).astype(np.float32)
    ref = np.asarray(jax_preproc(jnp.asarray(raw)))
    got = preproc_depth(torch.from_numpy(raw)).numpy()
    assert got.shape == ref.shape == (3, 224, 224, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _compare(variables, flat, x_nhwc):
    (paf, heat, z), saved = FlaxRTPoseLight3D().apply(variables, jnp.asarray(x_nhwc), train=False)
    model = load_into(RTPoseLight3D(), flat).eval()
    with torch.no_grad():
        (tp, th, tz), tsaved = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    assert len(tsaved) == len(saved) == 6
    outs = []
    for ref, got in zip(saved, tsaved):
        ref = np.asarray(ref)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        outs.append((ref, got))
    return outs


def test_cnn_matches_flax_with_committed_weights():
    x = np.asarray(jax_preproc(jnp.asarray(person_frames(0))))
    outs = _compare(variables_from_npz(WEIGHTS), load_npz(WEIGHTS), x)
    heat_ref = outs[4][0]
    # the outputs must carry signal, or an atol test passes on near-constant maps
    assert heat_ref[..., :15].max() > 0.5 and heat_ref.std() > 0.05
    assert outs[3][0].std() > 0.02                      # stage-2 paf
    for ref, got in outs:
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_cnn_matches_a_fresh_flax_init_carried_across():
    """A fresh Flax init, its BatchNorm statistics randomized and its CPM
    kernels scaled up so the heads are not flat, converted by name."""
    rng = np.random.default_rng(3)
    variables = FlaxRTPoseLight3D().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)),
                                         train=False)
    flat = {"/".join(getattr(k, "key", str(k)) for k in kp): np.asarray(v, np.float32)
            for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]}
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("/kernel") and "/stage" in k:
            flat[k] = v * 5.0
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    x = rng.normal(0, 1, (2, 64, 64, 1)).astype(np.float32)
    outs = _compare(tree, flat, x)
    assert outs[3][0].std() > 0.02 and outs[4][0].std() > 0.02 and outs[5][0].std() > 0.02
    for ref, got in outs:
        np.testing.assert_allclose(got, ref, atol=1e-4)
