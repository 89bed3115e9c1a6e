"""The port's GPipe pipeline (popnet_tpu_torch/parallel/pipeline.py) against
the JAX package's (popnet_tpu/parallel/pipeline.py), on the CPU.

One job of five gloo ranks (two PyTorch threads each, a file store under
the test's temporary directory, a timeout) runs every pipelined check
(`parallel.checks.jobs`; a mesh of four uses the first four ranks), while
this process computes the JAX references on the virtual CPU mesh, from the
port's seeded weights carried across (the ranks make the same weights from
the same seeds). Pins, after `tests/test_pipeline.py`
and `tests/test_pipeline_vgg.py`:

- the pipelined state dict is JAX's `build_pipelined_variables` exactly
  (stage 1's first convs zero-widened at the stem slice), and the round
  trip is exact;
- the forward at pipe=2 (data=2) and at pipe=4 (a 4-stage model), two
  microbatches, is JAX's `pipeline_stages` within 1e-5;
- one pipelined step's loss is JAX's within rtol 1e-5, the weights move,
  and the widened dead slice stays zero; in float64 the whole state after
  the step is that of one step of the sequential eval-mode model within
  1e-12;
- the RTPoseVGG variant (MobileNet trunk, stages 2-6 at pipe=5): the
  forward equals the sequential model, the round trip is exact, and a
  step updates the stages with the sequential objective's loss.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

from popnet_tpu.losses.losses import rtpose_light_loss
from popnet_tpu.models.layers import ResPreprocessStem
from popnet_tpu.models.rtpose_light3d import RTPoseLight3D as FlaxRTPoseLight3D
from popnet_tpu.models.rtpose_vgg import RTPoseVGG as FlaxRTPoseVGG
from popnet_tpu.parallel import pipeline as jpp
from popnet_tpu_torch.interop.from_jax import flat_from_module, state_dict_from_jax
from popnet_tpu_torch.models import RTPoseLight3D, RTPoseVGG
from popnet_tpu_torch.parallel import checks, distributed
from popnet_tpu_torch.parallel import pipeline as pp

TIMEOUT = 240.0
K, L = 18, 19       # RTPoseVGG's parts and limbs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_variables(flat: dict) -> dict:
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def _nchw(x):
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, (4, 32, 32, 1)).astype(np.float32)
    rng = np.random.default_rng(1)
    batch = {"image": x,
             "heatmaps": rng.uniform(0, 1, (4, 4, 4, 16)).astype(np.float32),
             "pafs": rng.uniform(-1, 1, (4, 4, 4, 28)).astype(np.float32),
             "zmaps": rng.uniform(-1, 1, (4, 4, 4, 15)).astype(np.float32)}
    rng = np.random.default_rng(2)
    x_rgb = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    vgg_batch = {"image": x_rgb,
                 "heat": rng.uniform(0, 1, (4, 4, 4, K + 1)).astype(np.float32),
                 "paf": rng.uniform(-1, 1, (4, 4, 4, 2 * L)).astype(np.float32)}
    return {"x": x, "batch": batch, "x4": np.random.default_rng(3).uniform(
                -1.5, 1.5, (4, 32, 32, 1)).astype(np.float32),
            "flat2": flat_from_module(RTPoseLight3D().init_seeded(0)),
            "flat4": flat_from_module(RTPoseLight3D(num_stages=4).init_seeded(1)),
            "x_rgb": x_rgb, "vgg_batch": vgg_batch,
            "flat_vgg": flat_from_module(RTPoseVGG(trunk="mobilenet").init_seeded(0))}


@pytest.fixture(scope="module")
def started(tmp_path_factory, inputs):
    i = inputs
    calls = {
        "pipe2": ("pipeline_job", dict(flat=None, seed=0, x=_nchw(i["x"]), batch=i["batch"],
                                       shape={"data": 2, "pipe": 2}, lr=0.01)),
        "pipe2_f64": ("pipeline_job", dict(flat=None, seed=0, x=_nchw(i["x"]),
                                           batch=i["batch"], shape={"data": 2, "pipe": 2},
                                           lr=0.01, dtype="float64")),
        "pipe4": ("pipeline_job", dict(flat=None, seed=1, x=_nchw(i["x4"]), batch=None,
                                       shape={"data": 1, "pipe": 4}, num_stages=4)),
        "vgg": ("vgg_pipeline_job", dict(flat=None, seed=0, x=_nchw(i["x_rgb"]),
                                         batch=i["vgg_batch"], shape={"data": 1, "pipe": 5})),
    }
    job = distributed.start(checks.jobs, 5, (list(calls.values()),), device="cpu",
                            threads=2, timeout=TIMEOUT,
                            store_dir=str(tmp_path_factory.mktemp("job")))
    return list(calls), job


def _jax_stem(variables, x):
    sv = {"params": variables["params"]["stem"], "batch_stats": variables["batch_stats"]["stem"]}
    return ResPreprocessStem().apply(sv, x, train=False)


def _jax_pipeline(variables, x, num_stages, n_pipe, devices):
    mesh = jpp.make_pipe_mesh(n_pipe, devices=jax.devices()[:devices])
    _, stacked = jpp.build_pipelined_variables(variables, num_stages=num_stages)
    return [np.asarray(t) for t in jax.jit(
        lambda sv, so: jpp.pipeline_stages(mesh, sv, so, n_micro=2))(
        stacked, _jax_stem(variables, x))]


def _jax_step(v2, batch):
    mesh = jpp.make_pipe_mesh(2, devices=jax.devices()[:4])
    state = jpp.create_pipeline_train_state(v2, learning_rate=0.01)
    step = jpp.jit_pipeline_step(jpp.make_pipeline_train_step(
        ResPreprocessStem(), jpp.CPMStageUniform(), mesh, n_micro=2), mesh, state)
    _, logs = step(jpp.shard_pipeline_state(state, mesh), batch)
    return float(logs["loss"])


def _jax_vgg(vv, x, batch):
    _, saved = jax.jit(lambda v, im: FlaxRTPoseVGG(trunk="mobilenet", num_stages=6).apply(
        v, im, train=False))(vv, x)
    loss = float(rtpose_light_loss(saved, batch["heat"], batch["paf"], 6)[0])
    return [np.asarray(t) for t in saved], loss


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """JAX's pipelined forwards and step and its sequential RTPoseVGG,
    compiled on threads at once."""
    i = inputs
    v2, v4 = jax_variables(i["flat2"]), jax_variables(i["flat4"])
    with ThreadPoolExecutor(4) as pool:
        pipe2 = pool.submit(_jax_pipeline, v2, i["x"], 2, 2, 4)
        pipe4 = pool.submit(_jax_pipeline, v4, i["x4"], 4, 4, 8)
        loss = pool.submit(_jax_step, v2, i["batch"])
        vgg = pool.submit(_jax_vgg, jax_variables(i["flat_vgg"]), i["x_rgb"], i["vgg_batch"])
        refs = {"pipe2": pipe2.result(), "pipe4": pipe4.result(), "pipe2_loss": loss.result()}
        refs["vgg"], refs["vgg_loss"] = vgg.result()
    return refs


@pytest.fixture(scope="module")
def got(started, jax_refs):
    names, job = started
    return dict(zip(names, job.result()))


def _stage_state_dict(tree: dict, index: int) -> dict:
    """Stage `index` of JAX's stacked variables as port state-dict keys."""
    flat = {"/".join(k): np.asarray(v)[index] for k, v in traverse_util.flatten_dict(tree).items()}
    return state_dict_from_jax(flat)


def test_pipelined_state_dict_is_build_pipelined_variables(inputs):
    full = RTPoseLight3D().init_seeded(0).state_dict()
    stem, stacked = pp.build_pipelined_state_dict(full)
    jstem, jstacked = jpp.build_pipelined_variables(jax_variables(inputs["flat2"]))
    jstem_flat = {"/".join(k): np.asarray(v) for k, v in
                  traverse_util.flatten_dict(jstem).items()}
    for k, v in state_dict_from_jax(jstem_flat).items():
        np.testing.assert_array_equal(stem[k.removeprefix("stem.")].numpy(), v.numpy(), k)
    c_out = pp.stage_channels()
    for s in range(2):
        want = _stage_state_dict(jstacked, s)
        mine = pp.stage_slice(stacked, s)
        assert set(want) == {k for k in mine if not k.endswith("num_batches_tracked")}
        for k, v in want.items():
            np.testing.assert_array_equal(mine[k].numpy(), v.numpy(), f"stage {s + 1} {k}")
    wide = stacked["paf.ConvBN_0.Conv_0.weight"][0]
    assert wide.shape[1] == c_out + 128 and not wide[:, :c_out].any()
    back = pp.unstack_pipelined_state_dict(stem, stacked)
    assert back.keys() == full.keys()
    for k, v in full.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("case", ["pipe2", "pipe4"])
def test_pipeline_forward_matches_pipeline_stages(got, jax_refs, case):
    saved = got[case]["saved"]
    assert len(saved) == len(jax_refs[case]) == {"pipe2": 6, "pipe4": 12}[case]
    for g, w in zip(saved, jax_refs[case]):
        np.testing.assert_allclose(np.transpose(g, (0, 2, 3, 1)), w, rtol=0, atol=1e-5)


def test_pipeline_step_loss_and_update(got, jax_refs):
    res = got["pipe2"]
    np.testing.assert_allclose(res["loss"], jax_refs["pipe2_loss"], rtol=1e-5)
    assert not np.allclose(res["before"], res["after"])
    np.testing.assert_array_equal(res["wide"][:, :pp.stage_channels()], 0.0)


def test_pipeline_step_updates_as_the_sequential_step(got, inputs):
    """The pipelined step at data=2, pipe=2, two microbatches, in float64:
    every parameter and statistic after it, unstacked to the sequential
    layout, equals one step of the sequential eval-mode model on the whole
    batch (the reverse tick schedule, the microbatch and data scaling, the
    stem's gradient through the pipe)."""
    res = got["pipe2_f64"]
    seq = checks.sequential_pipeline_step(None, inputs["batch"], lr=0.01, seed=0,
                                          dtype="float64")
    np.testing.assert_allclose(res["loss"], seq["loss"], rtol=1e-12)
    assert res["state"].keys() == seq["state"].keys()
    for k, v in seq["state"].items():
        np.testing.assert_allclose(res["state"][k], v, rtol=0, atol=1e-12, err_msg=k)
    init = RTPoseLight3D().init_seeded(0).double().state_dict()
    moved = [k for k, v in seq["state"].items()
             if v.dtype.kind == "f" and not np.array_equal(v, init[k].numpy())]
    assert any(k.startswith("stem.") for k in moved) and any(k.startswith("stage2_") for k in moved)


def test_vgg_pipeline_forward_matches_sequential(got, jax_refs):
    saved = got["vgg"]["saved"]
    assert len(saved) == len(jax_refs["vgg"]) == 12
    for g, w in zip(saved, jax_refs["vgg"]):
        np.testing.assert_allclose(np.transpose(g, (0, 2, 3, 1)), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_vgg_pipeline_roundtrip_state_dict(inputs):
    full = RTPoseVGG(trunk="mobilenet").init_seeded(0).state_dict()
    front, stacked = pp.build_vgg_pipelined_state_dict(full)
    _, jstacked = jpp.build_vgg_pipelined_variables(jax_variables(inputs["flat_vgg"]))
    assert "batch_stats" not in jstacked           # the stage branches are norm-free
    for s in range(5):
        for k, v in _stage_state_dict(jstacked, s).items():
            np.testing.assert_array_equal(pp.stage_slice(stacked, s)[k].numpy(), v.numpy(), k)
    back = pp.unstack_vgg_pipelined_state_dict(front, stacked)
    assert back.keys() == full.keys()
    for k, v in full.items():
        assert torch.equal(back[k], v), k


def test_vgg_pipeline_train_step_updates(got, jax_refs):
    res = got["vgg"]
    assert np.isfinite(res["loss"])
    assert not np.array_equal(res["before"], res["after"]), "pipelined stage weights must update"
    np.testing.assert_allclose(res["loss"], jax_refs["vgg_loss"], rtol=1e-5)


def test_pipe_of_one_runs_every_stage_where_jax_runs_the_first(inputs):
    """A reference fault, kept in the JAX package: its `pipeline_stages`
    applies one stage a pipe device (`a[0]` of the device's stack), so at
    pipe=1 a 2-stage model's pipeline returns stage 1's maps only (3, not
    6) and the pipelined step trains stage 1 alone. The port's rank holds
    S / P consecutive stages: at pipe=1 it runs both, as the sequential
    model does."""
    from popnet_tpu_torch.parallel.mesh import Mesh

    x = inputs["x"]
    v = jax_variables(inputs["flat2"])
    jax_saved = _jax_pipeline(v, x, 2, 1, 1)
    model = RTPoseLight3D().init_seeded(0).eval()
    mesh = Mesh({"data": 1, "pipe": 1})
    state = pp.create_pipeline_train_state(model, mesh)
    xt = torch.as_tensor(_nchw(x))
    with torch.no_grad():
        _, seq = model(xt)
        saved = pp.pipeline_stages(mesh, state.stages, state.front(xt), 2)
    assert len(jax_saved) == 3 and len(saved) == len(seq) == 6
    for got, want in zip(saved, seq):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    for got, want in zip(jax_saved, seq[:3]):
        np.testing.assert_allclose(got, want.permute(0, 2, 3, 1).numpy(), rtol=0, atol=1e-5)
