"""The Open-Pose+ and PoP-Net slices end to end: the port's pipelines
(float32, CPU) against the JAX pipelines on frames of people, the q16 wire
and serve_stream."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from popnet_tpu import serving as jax_serving
from popnet_tpu_torch import (
    build_openpose_pipeline,
    build_popnet_pipeline,
    load_npz,
    serve_stream,
)
from popnet_tpu_torch.serving import (
    pack_outputs_q16,
    unpack_outputs,
    unpack_outputs_q16,
)
from tests.test_torch_model import person_frames, with_background

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "results", "bench_weights_openpose.npz")
WEIGHTS_POPNET = os.path.join(ROOT, "examples", "results", "bench_weights_popnet.npz")
P, K = 16, 15


@pytest.fixture(scope="module")
def frames():
    return person_frames(4, n_frames=2, people=(2, 3))


@pytest.fixture(scope="module")
def jax_out(frames):
    pipe = jax_serving.build_openpose_pipeline(jax_serving.variables_from_npz(WEIGHTS),
                                               dtype=jnp.float32)
    return jax_serving.unpack_outputs(np.asarray(pipe(jnp.asarray(frames))), P, K)


@pytest.fixture(scope="module")
def port_pipe():
    return build_openpose_pipeline(load_npz(WEIGHTS), dtype=torch.float32, device="cpu")


def test_slice_matches_jax_pipeline(frames, jax_out, port_pipe):
    """Counts and visibility identical; joints2d within one refine step at
    output scale (2.3 px: the 5x5 bicubic argmax is the tie-prone boundary
    between frameworks); z within 1e-3 m."""
    buf = port_pipe(torch.from_numpy(frames))
    assert buf.dtype == torch.float32 and buf.shape == (2, P * K * 6 + 1)
    got = unpack_outputs(buf.numpy(), P, K)
    np.testing.assert_array_equal(got["counts"], jax_out["counts"])
    assert (got["counts"] > 0).all()
    vis, vis_ref = got["joints2d"][..., 0] >= 0, jax_out["joints2d"][..., 0] >= 0
    np.testing.assert_array_equal(vis, vis_ref)
    assert vis.sum() >= 9
    np.testing.assert_allclose(got["joints2d"], jax_out["joints2d"], atol=2.3)
    np.testing.assert_allclose(got["joints3d"][..., 2], jax_out["joints3d"][..., 2], atol=1e-3)
    np.testing.assert_allclose(got["conf"], jax_out["conf"], atol=1e-4)


def test_cnn_stage_matches_jax(frames):
    jax_pipe = jax_serving.build_openpose_pipeline(jax_serving.variables_from_npz(WEIGHTS),
                                                   dtype=jnp.float32, stage="cnn")
    ref = np.asarray(jax_pipe(jnp.asarray(frames)))
    got = build_openpose_pipeline(load_npz(WEIGHTS), dtype=torch.float32, device="cpu",
                                  stage="cnn")(torch.from_numpy(frames)).numpy()
    assert got.shape == ref.shape == (2, 16 + 28)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_q16_wire_matches_jax_pair():
    """The same human tensors pack to the same uint16 buffer in both
    frameworks, and unpack to the same values (holes exactly -1)."""
    rng = np.random.default_rng(2)
    j2 = rng.uniform(0, 480, (3, P, K, 2)).astype(np.float32)
    j2[:, 10:] = -1.0
    j2[0, 0, 0] = [100.03125, 0.5]                   # exactly halfway: round to even
    z = rng.uniform(0.5, 8.0, (3, P, K)).astype(np.float32)
    z[:, 10:] = -1.0
    conf = rng.uniform(0, 3, (3, P, K)).astype(np.float32)
    counts = np.array([10, 0, 3], np.int32)
    ref = np.asarray(jax_serving.pack_outputs_q16(*(jnp.asarray(a) for a in (j2, z, conf, counts))))
    got = pack_outputs_q16(*(torch.from_numpy(a) for a in (j2, z, conf, counts)))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), ref)
    a, b = unpack_outputs_q16(got.numpy(), P, K), jax_serving.unpack_outputs_q16(ref, P, K)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert (a["joints2d"][:, 10:] == -1).all() and (a["joints3d"][:, 10:, :, 2] == -1).all()


def test_q16_pipeline_round_trip(frames, port_pipe):
    q16 = build_openpose_pipeline(load_npz(WEIGHTS), dtype=torch.float32, device="cpu",
                                  pack="q16")
    a = unpack_outputs(port_pipe(torch.from_numpy(frames)).numpy(), P, K)
    b = unpack_outputs_q16(q16(torch.from_numpy(frames)).numpy(), P, K)
    np.testing.assert_array_equal(b["counts"][:, 0], a["counts"][:, 0].astype(np.int32))
    np.testing.assert_allclose(b["joints2d"], a["joints2d"], atol=1 / 32 + 1e-6)
    np.testing.assert_allclose(b["joints3d"][..., 2], a["joints3d"][..., 2], atol=1 / 8192 + 1e-6)
    np.testing.assert_allclose(b["conf"], a["conf"], atol=1 / 1024 + 1e-6)


def test_serve_stream_keeps_order():
    calls = []

    def pipe(batch):
        calls.append(int(batch[0, 0]))
        return torch.as_tensor(batch) * 2

    batches = [np.full((2, 3), i, np.float32) for i in range(7)]
    outs = serve_stream(pipe, iter(batches), queue_depth=3)
    first = next(outs)
    assert calls == [0, 1, 2, 3]                      # three more in flight than yielded
    rest = list(outs)
    assert all(isinstance(o, np.ndarray) for o in [first] + rest)
    np.testing.assert_array_equal(np.stack([first] + rest)[:, 0, 0], 2 * np.arange(7))


@pytest.fixture(scope="module")
def popnet_frames():
    return with_background(person_frames(6, n_frames=2, people=(3, 2)))


@pytest.mark.parametrize("readout", ["universe", "gated"])
def test_popnet_slice_matches_jax_pipeline(popnet_frames, readout):
    """The PoP-Net slice with the committed weights, B = 2: the packed f32
    buffer's valid flags exact, everything else within 1e-3 on the rows that
    are valid (the others hold whatever the decode computed for a rejected
    candidate, also within 1e-3)."""
    jax_pipe = jax_serving.build_popnet_pipeline(jax_serving.variables_from_npz(WEIGHTS_POPNET),
                                                 dtype=jnp.float32, readout=readout)
    ref = jax_serving.unpack_outputs(np.asarray(jax_pipe(jnp.asarray(popnet_frames))), P, K)
    pipe = build_popnet_pipeline(load_npz(WEIGHTS_POPNET), dtype=torch.float32, device="cpu",
                                 readout=readout)
    buf = pipe(torch.from_numpy(popnet_frames))
    assert buf.dtype == torch.float32 and buf.shape == (2, P * K * 6 + P)
    got = unpack_outputs(buf.numpy(), P, K)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    assert got["counts"].shape == (2, P) and (got["counts"].sum(axis=1) >= 1).all()
    for k in ("joints2d", "joints3d", "conf"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-3, err_msg=k)
    z = got["joints3d"][got["counts"] > 0][..., 2]
    assert ((z > 1.0) & (z < 6.0)).mean() > 0.9      # people stand where they were drawn


def test_popnet_q16_wire_within_one_step(popnet_frames):
    """q16 against the f32 buffer of the same pipeline: valid exact, joints
    within one step of 1/16 px, z of 1/4096 m, conf of 1/512 (half a step of
    rounding plus float error)."""
    weights = load_npz(WEIGHTS_POPNET)
    f32 = build_popnet_pipeline(weights, dtype=torch.float32, device="cpu")
    q16 = build_popnet_pipeline(weights, dtype=torch.float32, device="cpu", pack="q16")
    buf = q16(torch.from_numpy(popnet_frames))
    assert buf.dtype == torch.uint16 and buf.shape == (2, P * K * 4 + P)
    a = unpack_outputs(f32(torch.from_numpy(popnet_frames)).numpy(), P, K)
    b = unpack_outputs_q16(buf.numpy(), P, K)
    np.testing.assert_array_equal(b["counts"], a["counts"].astype(np.int32))
    ok = a["counts"] > 0                              # rejected rows may lie off the wire's range
    np.testing.assert_allclose(b["joints2d"][ok], a["joints2d"][ok], atol=1 / 16)
    np.testing.assert_allclose(b["joints3d"][ok][..., 2], a["joints3d"][ok][..., 2], atol=1 / 4096)
    np.testing.assert_allclose(b["conf"][ok], a["conf"][ok], atol=1 / 512)
    with pytest.raises(ValueError, match="unknown pack"):
        build_popnet_pipeline(weights, device="cpu", pack="f16")
    with pytest.raises(ValueError, match="unknown readout"):
        build_popnet_pipeline(weights, device="cpu", readout="nearest")
