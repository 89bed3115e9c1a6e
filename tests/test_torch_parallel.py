"""The port's layouts over torch.distributed (popnet_tpu_torch/parallel)
against one device and against the JAX package's layouts, on the CPU.

Ranks are processes over gloo, spawned from `popnet_tpu_torch.parallel.
checks` through a file store under the test's temporary directory: one job
of four ranks, two PyTorch threads each, with a timeout, runs every check
(`checks.jobs`; a mesh of two uses the first two ranks), while this process
computes the JAX references on the 8-device virtual CPU mesh
(`tests/conftest.py`), from the port's seeded weights carried across
(`flat_from_module`; the ranks make the same weights from the same seed),
so no Flax init compiles.
Pins, after `tests/test_tensor_parallel.py` and
`tests/test_spatial_parallel.py`:

- BatchNorm over a group of 2 equals the layer on the global batch;
- a data-parallel step (data=2) in float64 equals the one-device step
  (Open-Pose+), and PoP-Net's in float32 JAX's `jit_step_over_mesh` loss;
- a tensor-parallel step (data=2, model=2) matches JAX's
  `jit_step_tensor_parallel` loss and the data-parallel parameters, with
  convs sharded, each rank's moments its slice, the checkpoint (gathered
  whole) loading back into a sharded state, and a second step lower;
- height bands match JAX's `jit_forward_spatial`, including bands that do
  not fall on a stride (112 rows over 4 into a stride-8 stem) and 7-row
  bands before a 2x2 pool (PopNet at 224 over 4), and a 512x480 frame;
- data-parallel and spatial PopNet steps agree in loss and in the state
  they leave.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from popnet_tpu.models import PopNet as FlaxPopNet
from popnet_tpu.models import RTPoseLight3D as FlaxRTPoseLight3D
from popnet_tpu.parallel import spatial as jsp
from popnet_tpu.parallel.mesh import make_mesh, shard_batch
from popnet_tpu.parallel.tensor import jit_step_tensor_parallel, make_mesh_2d, shard_state
from popnet_tpu.train.state import create_train_state
from popnet_tpu.train.steps import jit_step_over_mesh, make_popnet_train_step
from popnet_tpu_torch.interop.from_jax import flat_from_module
from popnet_tpu_torch.models import PopNet, RTPoseLight3D
from popnet_tpu_torch.models.layers import BatchNorm
from popnet_tpu_torch.parallel import checks, distributed

from tests.test_train_step import make_batch

LR = float(np.float32(0.05))
TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flat_weights(model) -> dict:
    """The port's seeded weights as Flax variables ('/'-joined paths)."""
    return flat_from_module(model.init_seeded(0))


def jax_variables(flat: dict) -> dict:
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def jax_state(flax_model, flat: dict):
    """A JAX train state holding `flat`, at the port's float32 rate."""
    variables = jax_variables(flat)
    stub = types.SimpleNamespace(init=lambda *a, **k: variables, apply=flax_model.apply)
    return create_train_state(stub, None, None, learning_rate=LR)


SPATIAL_CASES = {       # name: (family, flax model, input (B, 1, H, W), mesh)
    "rtpose_64_s2": ("openpose", FlaxRTPoseLight3D, (2, 1, 64, 64), {"data": 2, "spatial": 2}),
    "rtpose_112_s4": ("openpose", FlaxRTPoseLight3D, (2, 1, 112, 112),
                      {"data": 1, "spatial": 4}),
    "popnet_224_s4": ("popnet", FlaxPopNet, (2, 1, 224, 224), {"data": 1, "spatial": 4}),
}


def _spatial_input(shape):
    return np.random.default_rng(0).uniform(-1.5, 1.5, shape).astype(np.float32)


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    batch = make_batch(np.random.default_rng(3), batch=9)
    return {"batch": {k: np.asarray(v)[:8] for k, v in batch.items()},
            "frames": {k: np.asarray(v) for k, v in batch.items()},
            "bn": (rng.normal(size=(6, 4, 5, 3)) * 2 + 1, rng.normal(size=4),
                   rng.normal(size=4)),
            "flat": {"popnet": flat_weights(PopNet()), "openpose": flat_weights(RTPoseLight3D())}}


@pytest.fixture(scope="module")
def started(tmp_path_factory, inputs):
    """Every check's job, started at once; the JAX references run meanwhile."""
    batch, (x, w, b), frames = inputs["batch"], inputs["bn"], inputs["frames"]
    calls = {
        "bn": ("batchnorm_job", dict(x=x, weight=w, bias=b, n=2)),
        "dp64": ("train_job", dict(family="openpose", flat=None, batch=batch,
                                   shape={"data": 2}, lr=LR, dtype="float64")),
        "dp": ("train_job", dict(family="popnet", flat=None, batch=batch,
                                 shape={"data": 2}, lr=LR)),
        "tp": ("train_job", dict(family="popnet", flat=None, batch=batch,
                                 shape={"data": 2, "model": 2}, layout="tp", steps=2, lr=LR)),
        "sp": ("train_job", dict(family="popnet", flat=None, batch=batch,
                                 shape={"data": 2, "spatial": 2}, layout="sp", lr=LR)),
        "trainer_b2": ("trainer_job", dict(batch=_rows(frames, 0, 6), val=_rows(frames, 6, 9),
                                           shape={"data": 2}, batch_size=2)),
        "trainer_b3": ("trainer_job", dict(batch=_rows(frames, 0, 6), val=_rows(frames, 6, 9),
                                           shape={"data": 2}, batch_size=3)),
        "frame_512x480": ("spatial_forward_job", dict(
            family="openpose", flat=None, x=np.zeros((2, 1, 512, 480), np.float32),
            shape={"data": 1, "spatial": 4})),
    }
    for name, (family, _, shape, mesh) in SPATIAL_CASES.items():
        calls[name] = ("spatial_forward_job", dict(family=family, flat=None,
                                                   x=_spatial_input(shape), shape=mesh))
    job = distributed.start(checks.jobs, 4, (list(calls.values()),), device="cpu",
                            threads=2, timeout=TIMEOUT,
                            store_dir=str(tmp_path_factory.mktemp("job")))
    return list(calls), job


def _jax_dp(batch, flat):
    mesh = make_mesh()
    _, logs = jit_step_over_mesh(make_popnet_train_step(), mesh)(
        jax_state(FlaxPopNet(), flat), shard_batch(batch, mesh))
    return float(logs["loss"])


def _jax_tp(batch, flat):
    mesh = make_mesh_2d(n_model=2)
    state = shard_state(jax_state(FlaxPopNet(), flat), mesh)
    step = jit_step_tensor_parallel(make_popnet_train_step(), mesh, state)
    _, logs = step(state, jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))), batch))
    return float(logs["loss"])


def _jax_spatial(case, flat):
    _, flax_cls, shape, mesh_shape = SPATIAL_CASES[case]
    variables, model = jax_variables(flat), flax_cls()
    n_sp = mesh_shape["spatial"]
    mesh = jsp.make_spatial_mesh(n_sp, devices=jax.devices()[:n_sp])
    x = np.transpose(_spatial_input(shape), (0, 2, 3, 1))
    out = jsp.jit_forward_spatial(lambda im: model.apply(variables, im, train=False)[0], mesh)(
        jax.device_put(x, NamedSharding(mesh, P("data", "spatial"))))
    return [np.asarray(t) for t in out]


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """JAX's data-parallel and tensor-parallel step losses, and its
    spatially partitioned forwards, compiled on threads at once."""
    batch, flat = inputs["batch"], inputs["flat"]
    with ThreadPoolExecutor(2 + len(SPATIAL_CASES)) as pool:
        futures = {"dp": pool.submit(_jax_dp, batch, flat["popnet"]),
                   "tp": pool.submit(_jax_tp, batch, flat["popnet"])}
        for case, (family, *_) in SPATIAL_CASES.items():
            futures[case] = pool.submit(_jax_spatial, case, flat[family])
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def got(started, jax_refs):
    names, job = started
    return dict(zip(names, job.result()))


def test_batchnorm_over_a_group_equals_the_global_batch(got, inputs):
    x, w, b = inputs["bn"]
    bn = BatchNorm(4).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(w))
        bn.bias.copy_(torch.as_tensor(b))
    xt = torch.as_tensor(x).requires_grad_()
    y = bn(xt)
    (y * y).sum().backward()
    np.testing.assert_allclose(got["bn"]["y"], y.detach().numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["bn"]["grad"], xt.grad.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(got["bn"]["running_mean"], bn.running_mean.numpy(), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(got["bn"]["running_var"], bn.running_var.numpy(), rtol=1e-14)


def test_data_parallel_float64_step_equals_one_device(got, inputs):
    one = checks.train_job("openpose", None, inputs["batch"], None, lr=LR, dtype="float64")
    np.testing.assert_allclose(got["dp64"]["losses"], one["losses"], rtol=1e-12)
    for k, v in one["state"].items():
        np.testing.assert_allclose(got["dp64"]["state"][k], v, rtol=0, atol=1e-12, err_msg=k)


def test_data_parallel_float32_loss_matches_jit_step_over_mesh(got, jax_refs):
    np.testing.assert_allclose(got["dp"]["losses"][0], jax_refs["dp"], rtol=1e-5)


def test_tensor_parallel_matches_jax_and_data_parallel(got, jax_refs):
    np.testing.assert_allclose(got["tp"]["losses"][0], jax_refs["tp"], rtol=1e-5)
    for k, v in got["tp"]["state"].items():
        np.testing.assert_allclose(v, got["dp"]["state"][k], rtol=0, atol=1e-5, err_msg=k)


def test_tensor_parallel_shards_convs_and_their_moments(got):
    tp = got["tp"]
    assert tp["sharded"], "no conv was sharded"
    assert tp["round_trip"], "the whole checkpoint did not load back into the sharded state"
    for name, (weight, moment) in tp["local_shapes"].items():
        whole = tp["state"][name].shape
        assert weight == moment == (whole[0] // 2,) + whole[1:], name


def test_tensor_parallel_second_step_descends(got):
    losses = got["tp"]["losses"]
    assert np.isfinite(losses).all() and losses[1] < losses[0]


@pytest.mark.parametrize("case", list(SPATIAL_CASES))
def test_spatial_forward_matches_jit_forward_spatial(got, jax_refs, case):
    assert len(got[case]) == len(jax_refs[case])
    for g, w in zip(got[case], jax_refs[case]):
        np.testing.assert_allclose(np.transpose(g, (0, 2, 3, 1)), w, rtol=1e-5, atol=1e-5)


def test_full_resolution_frame_in_four_bands(got):
    heat = got["frame_512x480"][1]
    assert heat.shape == (2, 16, 64, 60)
    assert np.isfinite(heat).all()


def test_data_parallel_and_spatial_losses_agree(got):
    np.testing.assert_allclose(got["sp"]["losses"][0], got["dp"]["losses"][0], rtol=1e-5)


def test_spatial_step_updates_as_data_parallel(got):
    """The spatial step at data=2, spatial=2 leaves the data-parallel step's
    parameters and BatchNorm statistics (the halo's and the gather's
    backward, and the gradient reduced over the whole mesh)."""
    sp, dp = got["sp"]["state"], got["dp"]["state"]
    assert sp.keys() == dp.keys()
    for k, v in sp.items():
        np.testing.assert_allclose(v, dp[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("batch_size,n_data", [(2, 2), (3, 1)])
def test_trainer_over_data_ranks_equals_one_device(got, inputs, batch_size, n_data):
    """The Trainer at data=2 (an epoch of 6 frames, validation of 3 with its
    ragged tail scored whole) logs the one-device Trainer's losses; a batch
    of 3 shrinks the data axis to 1, as JAX's Trainer shrinks its mesh."""
    frames = inputs["frames"]
    one = checks.trainer_job(_rows(frames, 0, 6), _rows(frames, 6, 9), None, batch_size)
    run = got[f"trainer_b{batch_size}"]
    assert run["n_data"] == n_data
    assert len(run["history"]) == len(one["history"]) == 1
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(run["history"][0][k], one["history"][0][k], rtol=1e-5)
