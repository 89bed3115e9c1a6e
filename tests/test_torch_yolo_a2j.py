"""The Yolo-Pose+ and Yolo->A2J slices: the port (float32, CPU) against the
JAX package on inputs made from a numpy seed: YoloPoseNet, A2J, the anchor
tables, the A2J vote, the crop, and both pipelines end to end."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu import serving as jax_serving
from popnet_tpu.data.a2j_crops import crop_resize_batch as jax_crop
from popnet_tpu.data.a2j_crops import crop_resize_grouped as jax_crop_grouped
from popnet_tpu.decode.a2j import a2j_post_process as jax_post_process
from popnet_tpu.decode.prior import decode_prior_maps as jax_decode_prior_maps
from popnet_tpu.models import A2J as FlaxA2J
from popnet_tpu.models import YoloPoseNet as FlaxYoloPoseNet
from popnet_tpu.models import a2j as jax_a2j
from popnet_tpu_torch import build_yolo_a2j_pipeline, build_yolo_pipeline, load_npz
from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, back_project
from popnet_tpu_torch.core.numerics import div_const
from popnet_tpu_torch.data.a2j_crops import CROP, crop_resize_batch
from popnet_tpu_torch.decode.a2j import a2j_post_process
from popnet_tpu_torch.decode.prior import decode_prior_maps
from popnet_tpu_torch.interop.from_jax import load_into
from popnet_tpu_torch.models import A2J, YoloPoseNet
from popnet_tpu_torch.models import a2j as port_a2j
from popnet_tpu_torch.serving import (
    a2j_boxes,
    preproc_depth,
    unpack_outputs,
    unpack_outputs_q16,
    yolo_decode,
)
from tests.test_torch_model import person_frames, with_background

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS_YOLO = os.path.join(ROOT, "examples", "results", "bench_weights_yolo.npz")
P, K = 16, 15


@pytest.fixture(scope="module")
def frames():
    """Two frames of 3 and 2 people over the depth background the committed
    Yolo weights were trained on (on a zero background they find nobody)."""
    return with_background(person_frames(6, n_frames=2, people=(3, 2)))


@pytest.fixture(scope="module")
def a2j_init():
    """A2J's Flax init at PRNGKey(0), as the JAX builder makes it without
    weights (the parameters do not depend on the input size), as a tree and
    as {'/'-joined path: array}."""
    tree = jax.jit(lambda key: FlaxA2J().init(key, jnp.zeros((1, 64, 64, 1)), train=False))(
        jax.random.PRNGKey(0))
    flat = {"/".join(getattr(k, "key", str(k)) for k in kp): np.asarray(v, np.float32)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return tree, flat


def test_yolo_posenet_matches_flax_with_committed_weights(frames):
    """The prior map (B, 14, 14, 2 x 50) within 1e-4, after checking that
    the detector fires on these frames."""
    flat = load_npz(WEIGHTS_YOLO)
    x = np.asarray(jax_serving.preproc_depth(jnp.asarray(frames)))
    ref = np.asarray(FlaxYoloPoseNet().apply(jax_serving.variables_from_npz(WEIGHTS_YOLO),
                                             jnp.asarray(x), train=False))
    model = load_into(YoloPoseNet(), flat).eval()
    assert model.head3.bias is None and model.stem.BasicBlock_3.project
    assert not model.stem.BasicBlock_4.project
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 14, 14, 100)
    conf = ref.reshape(2, 14, 14, 2, 50)[..., 4]
    assert conf.max() > 0.9 and ref.std() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_a2j_matches_flax_init(a2j_init):
    """A2J at a 64x64 crop on the Flax init (343 arrays): all three heads
    within 1e-5 of each head's largest magnitude (the init keeps unit
    BatchNorm statistics, so activations grow to ~1e3 through the trunk)."""
    tree, flat = a2j_init
    assert len(flat) == 343 and "params/backbone/DilatedBottleneck_15/Conv_1/kernel" in flat
    assert "params/classification/Conv_4/bias" in flat
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 64, 1)).astype(np.float32)
    ref = FlaxA2J().apply(tree, jnp.asarray(x), train=False)
    model = load_into(A2J(), flat).eval()
    assert model.backbone.DilatedBottleneck_15.Conv_1.dilation == (2, 2)
    assert model.backbone.DilatedBottleneck_13.project
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    shapes = [(2, 4 * 4 * 16, 15), (2, 4 * 4 * 16, 15, 2), (2, 4 * 4 * 16, 15)]
    for g, r, shape in zip(got, ref, shapes):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape == shape and r.std() > 1.0
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max())


def test_a2j_flatten_is_w_major_like_jax():
    """The heads' (W, H, A) flattening, exact, for one and two trailing axes."""
    rng = np.random.default_rng(1)
    for trailing in ((3,), (3, 2)):
        x = rng.normal(0, 1, (2, 4 * int(np.prod(trailing)), 5, 6)).astype(np.float32)  # NCHW
        ref = np.asarray(jax_a2j._flatten_wha(jnp.asarray(x.transpose(0, 2, 3, 1)), 4, trailing))
        got = port_a2j._flatten_wha(torch.from_numpy(x), 4, trailing).numpy()
        assert got.shape == ref.shape == (2, 6 * 5 * 4, *trailing)
        np.testing.assert_array_equal(got, ref)


def test_anchor_tables_match_jax():
    assert port_a2j.generate_anchors().dtype == jax_a2j.generate_anchors().dtype
    np.testing.assert_array_equal(port_a2j.generate_anchors(), jax_a2j.generate_anchors())
    for shape in ((18, 18), (3, 5)):
        got = port_a2j.shift_anchors(shape, 16, port_a2j.generate_anchors())
        ref = jax_a2j.shift_anchors(shape, 16, jax_a2j.generate_anchors())
        assert got.shape == (shape[0] * shape[1] * 16, 2)
        np.testing.assert_array_equal(got, ref)


def test_a2j_post_process_matches_jax():
    """The softmax vote over 5184 anchors on random heads: (y, x) within
    5e-3 px and z within 1e-4 m. The gap is the port's on the CPU: PyTorch's
    float32 softmax along the non-innermost anchor axis is the less exact
    (`popnet_tpu_torch/tools/measure.py vote` reads it 46-137 eps off the
    float64 weights on the CPU, 10-17 on the card), while XLA's vote stays
    within 2e-4 px and 5e-6 m of the float64 one (asserted here)."""
    rng = np.random.default_rng(2)
    anchors = port_a2j.shift_anchors((18, 18), 16, port_a2j.generate_anchors()).astype(np.float32)
    N = anchors.shape[0]
    cls = rng.normal(0, 3, (3, N, K)).astype(np.float32)
    reg = rng.normal(0, 10, (3, N, K, 2)).astype(np.float32)
    dep = rng.normal(3, 0.5, (3, N, K)).astype(np.float32)
    ref = np.asarray(jax_post_process(tuple(jnp.asarray(a) for a in (cls, reg, dep)),
                                      jnp.asarray(anchors)))
    heads = tuple(torch.from_numpy(a) for a in (cls, reg, dep))
    got = a2j_post_process(heads, torch.from_numpy(anchors)).numpy()
    assert got.shape == ref.shape == (3, K, 3)
    np.testing.assert_allclose(got[..., :2], ref[..., :2], atol=5e-3)
    np.testing.assert_allclose(got[..., 2], ref[..., 2], atol=1e-4)
    exact = a2j_post_process(tuple(h.double() for h in heads),
                             torch.from_numpy(anchors).double()).numpy()
    np.testing.assert_allclose(ref[..., :2], exact[..., :2], atol=2e-4, rtol=0)
    np.testing.assert_allclose(ref[..., 2], exact[..., 2], atol=5e-6, rtol=0)


def crop_boxes():
    """Boxes over (2, 60, 50) images: fractional and integer origins, boxes
    off every edge and wholly outside, and extents that share a factor with
    288 (96, 144, 576), where u * extent / 288 is an exact integer every
    3rd, 2nd or 1st u."""
    boxes = np.array([
        [10.3, 5.7, 41.9, 52.2],      # inside, fractional
        [-12.5, -7.25, 30.0, 40.0],   # off the left and top
        [20.0, 30.0, 116.0, 174.0],   # integer origin, extents 96 x 144
        [-30.0, 10.0, 546.0, 106.0],  # extents 576 x 96, off the right
        [55.0, 70.0, 80.0, 90.0],     # wholly outside
        [0.0, 0.0, 50.0, 60.0],       # the whole image
    ], np.float32)
    return boxes, np.array([0, 1, 0, 1, 0, 1], np.int64)


def test_crop_matches_jax_gather_and_grouped_exactly():
    rng = np.random.default_rng(3)
    images = rng.uniform(0.5, 6.0, (2, 60, 50)).astype(np.float32)
    boxes, idx = crop_boxes()
    got = crop_resize_batch(torch.from_numpy(images), torch.from_numpy(idx),
                            torch.from_numpy(boxes)).numpy()
    assert got.shape == (6, CROP, CROP) and got.dtype == np.float32
    ref = np.asarray(jax_crop(jnp.asarray(images), jnp.asarray(idx), jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, ref[..., 0])
    # the TPU serving twin takes (B, C, 4) boxes, C per image in order
    order = np.argsort(idx, kind="stable")
    grouped = np.asarray(jax_crop_grouped(jnp.asarray(images), jnp.asarray(boxes[order].reshape(2, 3, 4)),
                                          dtype=jnp.float32))
    np.testing.assert_array_equal(got[order], grouped[..., 0])
    assert (got[4] == -1.5).all() and (got[1, :20, :20] == -1.5).any()   # zeros out of bounds


@pytest.mark.parametrize("c", [14, 28, 288, KDH3D_INTRINSICS.fx, KDH3D_INTRINSICS.fy])
def test_division_by_a_constant_rounds_as_xla(c):
    """XLA compiles x / c for a constant c into x * f32(1 / f32(c)), which
    rounds an ulp away from the division on some inputs; `div_const` does
    the same on any device, bit for bit."""
    x = np.random.default_rng(5).uniform(-600, 600, 20000).astype(np.float32)
    x[:288] = np.arange(288, dtype=np.float32) * 96.0      # exact multiples of 288 among them
    ref = np.asarray(jax.jit(lambda a: a / c)(jnp.asarray(x)))
    got = div_const(torch.from_numpy(x), c).numpy()
    np.testing.assert_array_equal(got, ref)
    if c != 288:      # f32(1 / 288) lies above 1 / 288 by less than half an ulp of any quotient
        assert (torch.from_numpy(x) / c).numpy().tolist() != ref.tolist()


def test_back_project_and_prior_decode_match_jax_bit_for_bit():
    """The back-projection and the prior decode round as the JAX package's
    compiled ones: X, Y of the back-projection, and valid and every dets
    column but the joints' x and y of `decode_prior_maps`, bit for bit on
    the same inputs. XLA's CPU compiler fuses a joint's p * a / 2 + g into
    one rounding and the port rounds twice, in plain float32 on every
    device: the joints' x and y are within 2**-22, two ulps of their
    largest magnitude (about 1.36), one from the fused sum (at most 2**-19
    grid units over the grid of 14) and one from the quotient's rounding."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-5, 485, (3, 16, 15)).astype(np.float32)
    y = rng.uniform(-5, 517, (3, 16, 15)).astype(np.float32)
    z = rng.uniform(0.5, 6, (3, 16, 15)).astype(np.float32)
    cam = KDH3D_INTRINSICS
    ref = np.asarray(jax.jit(lambda x, y, z: jnp.stack(
        [(x - cam.cx) / cam.fx * z, (y - cam.cy) / cam.fy * z, z], -1))(x, y, z))
    got = back_project(*(torch.from_numpy(a) for a in (x, y, z)), cam).numpy()
    np.testing.assert_array_equal(got, ref)

    prior = rng.uniform(-1, 1, (6, 14, 14, 2, 50)).astype(np.float32)
    prior[..., 2:5] = rng.uniform(0, 1, (6, 14, 14, 2, 3))
    prior = prior.reshape(6, 14, 14, 100)
    anchors = np.array([[6.0, 3.0], [12.0, 6.0]], np.float32)
    ref_dets, ref_valid = jax_decode_prior_maps(jnp.asarray(prior), jnp.asarray(anchors), 3.0, 2.0,
                                                num_joints=K, conf_threshold=0.5,
                                                nms_threshold=0.5, max_det=P)
    dets, valid = decode_prior_maps(torch.from_numpy(prior), torch.from_numpy(anchors), 3.0, 2.0,
                                    num_joints=K, conf_threshold=0.5, nms_threshold=0.5,
                                    max_det=P)
    assert 0 < int(valid.sum()) < valid.numel()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    dets, ref_dets = dets.numpy(), np.asarray(ref_dets)
    joints = np.zeros(dets.shape[-1], bool)
    joints[5:5 + 2 * K] = True
    np.testing.assert_array_equal(dets[..., ~joints], ref_dets[..., ~joints])
    np.testing.assert_allclose(dets[..., joints], ref_dets[..., joints], atol=2.0 ** -22, rtol=0)


def test_yolo_pipeline_matches_jax_pipeline(frames):
    """Yolo-Pose+ with the committed weights, B = 2: valid exact (people on
    both frames); joints2d within 2e-3 px, joints3d within 1e-4 m, conf
    within 1e-5 (the prior maps agree to ~1e-5; a joint scales a prior
    value by up to 6 / 14 x 512 px). The q16 wire of the same pipeline
    round-trips within one step."""
    ref_pipe = jax_serving.build_yolo_pipeline(jax_serving.variables_from_npz(WEIGHTS_YOLO),
                                               dtype=jnp.float32)
    ref = jax_serving.unpack_outputs(np.asarray(ref_pipe(jnp.asarray(frames))), P, K)
    weights = load_npz(WEIGHTS_YOLO)
    buf = build_yolo_pipeline(weights, dtype=torch.float32, device="cpu")(torch.from_numpy(frames))
    assert buf.dtype == torch.float32 and buf.shape == (2, P * K * 6 + P)
    got = unpack_outputs(buf.numpy(), P, K)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    assert (got["counts"].sum(axis=1) >= 1).all()
    np.testing.assert_allclose(got["joints2d"], ref["joints2d"], atol=2e-3)
    np.testing.assert_allclose(got["joints3d"], ref["joints3d"], atol=1e-4)
    np.testing.assert_allclose(got["conf"], ref["conf"], atol=1e-5)
    q16 = build_yolo_pipeline(weights, dtype=torch.float32, device="cpu", pack="q16")
    b = unpack_outputs_q16(q16(torch.from_numpy(frames)).numpy(), P, K)
    ok = got["counts"] > 0
    np.testing.assert_array_equal(b["counts"], got["counts"].astype(np.int32))
    np.testing.assert_allclose(b["joints2d"][ok], got["joints2d"][ok], atol=1 / 16)
    np.testing.assert_allclose(b["joints3d"][ok][..., 2], got["joints3d"][ok][..., 2], atol=1 / 4096)


def test_yolo_a2j_pipeline_matches_jax_pipeline(frames, a2j_init):
    """Yolo->A2J at B = 2, max_crops = 2, on A2J's Flax init: valid and conf
    exact, every value finite. The detector's boxes agree with JAX's to
    about an ulp (1e-3 px bar), but a nearest-neighbour tap flips where an
    ulp crosses an integer (a few hundred of the 331,776 crop pixels here),
    and the init's unnormalized trunk (activations ~1e3) carries a flipped
    tap into the vote: joints are held within 1% of each output's largest
    magnitude. The stages are held tightly on their own (crop exact, A2J
    1e-5 relative, vote 5e-3 px)."""
    tree, flat = a2j_init
    yolo_vars = jax_serving.variables_from_npz(WEIGHTS_YOLO)
    ref_pipe = jax_serving.build_yolo_a2j_pipeline(yolo_vars, tree, dtype=jnp.float32,
                                                   max_crops=2)
    ref = jax_serving.unpack_outputs(np.asarray(ref_pipe(jnp.asarray(frames))), 2, K)
    weights = load_npz(WEIGHTS_YOLO)
    pipe = build_yolo_a2j_pipeline(weights, flat, dtype=torch.float32, device="cpu",
                                   max_crops=2)
    buf = pipe(torch.from_numpy(frames))
    assert buf.dtype == torch.float32 and buf.shape == (2, 2 * K * 6 + 2)
    assert torch.isfinite(buf).all()
    got = unpack_outputs(buf.numpy(), 2, K)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_array_equal(got["conf"], ref["conf"])
    assert got["counts"].all()
    for k in ("joints2d", "joints3d"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-2 * np.abs(ref[k]).max(), err_msg=k)

    x = np.asarray(jax_serving.preproc_depth(jnp.asarray(frames)))
    prior = FlaxYoloPoseNet().apply(yolo_vars, jnp.asarray(x), train=False)
    dets, _ = jax_decode_prior_maps(prior, jnp.asarray([[6.0, 3.0], [12.0, 6.0]]), 3.0, 2.0,
                                num_joints=K, conf_threshold=0.5, nms_threshold=0.5, max_det=P)
    d = np.asarray(dets)[:, :2]
    cx, cy, bw, bh = d[..., 0] * 480, d[..., 1] * 512, d[..., 2] * 480, d[..., 3] * 512
    ref_boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1).reshape(4, 4)
    model = load_into(YoloPoseNet(), weights).eval()
    with torch.no_grad():
        port_prior = model(preproc_depth(torch.from_numpy(frames)).permute(0, 3, 1, 2))
    det = yolo_decode(port_prior.permute(0, 2, 3, 1), 480, 512)
    boxes = a2j_boxes(det["dets"], 2, 480, 512).numpy()
    np.testing.assert_allclose(boxes, ref_boxes, atol=1e-3)
