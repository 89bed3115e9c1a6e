"""Port vs JAX: cv2 resize, depth preprocessing and the CNNs (RTPoseLight3D,
PopNet, RTPoseAlign3D; float32, on the CPU)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu.models import PopNet as FlaxPopNet
from popnet_tpu.models import RTPoseAlign3D as FlaxRTPoseAlign3D
from popnet_tpu.models import RTPoseLight3D as FlaxRTPoseLight3D
from popnet_tpu.ops.resize import resize_bilinear_cv2 as jax_resize
from popnet_tpu.serving import preproc_depth as jax_preproc
from popnet_tpu.serving import variables_from_npz
from popnet_tpu_torch.interop.from_jax import load_into, load_npz
from popnet_tpu_torch.models import PopNet, RTPoseAlign3D, RTPoseLight3D
from popnet_tpu_torch.ops.resize import resize_bilinear_cv2
from popnet_tpu_torch.serving import preproc_depth
from tests.synthetic_data import person_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "results", "bench_weights_openpose.npz")
WEIGHTS_POPNET = os.path.join(ROOT, "examples", "results", "bench_weights_popnet.npz")


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


def with_background(frames, phase=0):
    """The frames over the smooth background of tests/synthetic_data.py
    build (2.5-5.5 m), which the committed PoP-Net weights were trained on:
    on a zero background its prior subnet fires too often."""
    ys, xs = np.mgrid[0:frames.shape[1], 0:frames.shape[2]]
    bg = (4.0 + 1.5 * np.sin(xs / 60.0 + phase) * np.cos(ys / 80.0)).astype(np.float32)
    return np.where(frames > 0, frames, bg)


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


def _compare(variables, flat, x_nhwc, flax_model=FlaxRTPoseLight3D, port_model=RTPoseLight3D,
             n_saved=6):
    """(reference, port) pairs of every saved map, NHWC; the models' final
    outputs must be the last saved ones."""
    final, saved = flax_model().apply(variables, jnp.asarray(x_nhwc), train=False)
    model = load_into(port_model(), flat).eval()
    with torch.no_grad():
        tfinal, tsaved = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    assert len(tsaved) == len(saved) == n_saved and len(tfinal) == len(final)
    for got, ref in zip(tfinal, final):
        assert tuple(got.permute(0, 2, 3, 1).shape) == ref.shape
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


def fresh_init(flax_model, rng, head_scale=5.0):
    """A fresh Flax init at 64x64, its BatchNorm statistics randomized and
    its head kernels scaled up so the outputs are not flat. Returns the
    variables as a tree and as {'/'-joined path: array}. The init runs as
    one jitted program (op by op, a Flax init compiles each of its ops)."""
    variables = jax.jit(lambda key: flax_model().init(key, jnp.zeros((1, 64, 64, 1)),
                                                      train=False))(jax.random.PRNGKey(0))
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
            flat[k] = v * head_scale
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree, flat


def test_cnn_matches_a_fresh_flax_init_carried_across():
    """A fresh Flax init converted by name."""
    rng = np.random.default_rng(3)
    tree, flat = fresh_init(FlaxRTPoseLight3D, rng)
    x = rng.normal(0, 1, (2, 64, 64, 1)).astype(np.float32)
    outs = _compare(tree, flat, x)
    assert outs[3][0].std() > 0.02 and outs[4][0].std() > 0.02 and outs[5][0].std() > 0.02
    for ref, got in outs:
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_popnet_matches_flax_with_committed_weights():
    """Every saved map (heat, z, align of both stages, prior) within 1e-4,
    after checking that the trained maps carry signal and the prior subnet
    fires on these frames. The trained heat head stays near zero (about 1e-5
    on every joint channel), so the heat maps are also held to 1e-3 relative."""
    x = np.asarray(jax_preproc(jnp.asarray(with_background(person_frames(0)))))
    flat = load_npz(WEIGHTS_POPNET)
    assert len(flat) == 204 and "params/prior_out/bias" not in flat
    assert "params/stage1_heat/ConvBN_0/BatchNorm_0/scale" not in flat
    outs = _compare(variables_from_npz(WEIGHTS_POPNET), flat, x, FlaxPopNet, PopNet, n_saved=7)
    heat_ref, z_ref, align_ref, prior_ref = (outs[i][0] for i in (3, 4, 5, 6))
    assert heat_ref.shape == (2, 28, 28, 16) and prior_ref.shape == (2, 14, 14, 100)
    joints = heat_ref[..., :15]                  # the last channel is the background
    assert 0 < joints.max() < 1e-3 and joints.max() > 4 * joints.min() and heat_ref[..., 15].max() > 0.9
    assert z_ref.std() > 0.02 and align_ref.std() > 0.02
    conf = prior_ref.reshape(2, 14, 14, 2, 50)[..., 4]
    assert conf.max() > 0.5 and conf.std() > 0.02
    for ref, got in outs:
        np.testing.assert_allclose(got, ref, atol=1e-4)
    for i in (0, 3):
        np.testing.assert_allclose(outs[i][1], outs[i][0], rtol=1e-3, atol=1e-30)


@pytest.mark.parametrize("name", ["popnet", "rtpose_align3d"])
def test_fresh_flax_init_of_the_align_models_carried_across(name):
    """PopNet (sigmoid-cast heads and prior) and RTPoseAlign3D (raw heads,
    7x7 PAF convs in stage 2, no BatchNorm on paf and heat) on a fresh init
    at 64x64: every saved map within 1e-4, after a signal check."""
    flax_model, port_model, n_saved, head_scale = {
        "popnet": (FlaxPopNet, PopNet, 7, 5.0),
        "rtpose_align3d": (FlaxRTPoseAlign3D, RTPoseAlign3D, 8, 3.0)}[name]   # raw heads: O(1)
    rng = np.random.default_rng(5)
    tree, flat = fresh_init(flax_model, rng, head_scale)
    x = rng.normal(0, 1, (2, 64, 64, 1)).astype(np.float32)
    outs = _compare(tree, flat, x, flax_model, port_model, n_saved)
    for ref, got in outs[n_saved // 2:]:
        assert ref.std() > 0.02 and np.isfinite(ref).all()
    for ref, got in outs:
        np.testing.assert_allclose(got, ref, atol=1e-4)
