"""One train step of each depth family, the port against the JAX package on
the CPU: the same Flax init carried across, the same batch (4 frames of 64²
input, 4 people, the JAX step test's `make_batch`), two steps of
SGD-Nesterov in each; then a JAX state after one step, momentum included,
continued by the port (popnet_tpu_torch). A file of its own, so that
xdist's `--dist loadfile` spreads the JAX compiles.

The bars hold in float64 on both sides (`jax.enable_x64`, the Flax models
at dtype float64, the port's `.double()`): there the step's arithmetic is
what is compared. In float32 this configuration (BatchNorm over a few
frames of 8x8 cells at a fresh init) is ill-conditioned: measured on 8
frames, the port's float32 step alone moves single parameter tensors by up
to 8.5% of their update from its float64 step, JAX's by 3%, and JAX and
the port stand 0.5-1.7% of the whole update apart after one step, 2.4e-4
apart in loss after two. So in float32 the test holds the first step's
loss and the loss's fall."""

import functools
import types

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

from popnet_tpu.models import PopNet as FlaxPopNet
from popnet_tpu.models import RTPoseLight3D as FlaxRTPoseLight3D
from popnet_tpu.models import YoloPoseNet as FlaxYoloPoseNet
from popnet_tpu.train.state import create_train_state
from popnet_tpu.train.steps import (make_popnet_train_step as jax_popnet_step,
                                    make_rtpose_train_step as jax_rtpose_step,
                                    make_yolo_train_step as jax_yolo_step)
from popnet_tpu_torch.interop.from_jax import load_into, load_sgd_momentum, state_dict_from_jax
from popnet_tpu_torch.models import PopNet, RTPoseLight3D, YoloPoseNet
from popnet_tpu_torch.train import steps
from popnet_tpu_torch.train.state import TrainState, make_optimizer

from tests.test_train_step import make_batch

LR = 0.05
LR32 = float(np.float32(LR))   # the one rate both sides step at: the port rounds its rate
BATCH = 4            # frames of the step's batch
FAMILIES = {
    "openpose": (FlaxRTPoseLight3D, RTPoseLight3D, jax_rtpose_step, steps.make_rtpose_train_step,
                 ["image", "heatmaps", "pafs", "zmaps", "fg_masks_z"]),
    "popnet": (FlaxPopNet, PopNet, jax_popnet_step, steps.make_popnet_train_step, None),
    "yolo": (FlaxYoloPoseNet, YoloPoseNet, jax_yolo_step, steps.make_yolo_train_step,
             ["image", "prior_map", "prior_mask_conf", "prior_mask_coord", "prior_weight_map"]),
}
LOSS_RTOL = 1e-5     # the loss at each step
UPDATE_BAR = 1e-3    # max |d_port - d_jax| over max |d_jax|, each parameter tensor
STATS_RTOL = 1e-5    # BatchNorm running mean and variance
# the SGD steps, both sides at one rate, hold far tighter bars: measured over
# the three families and PoP-Net with pred_vis (tests/test_torch_mpaug.py),
# two steps and the carried one, the loss 1.9e-15 relative at most, the
# updates 7.6e-11 of a tensor's largest, the statistics 4.5e-16 apart
SGD_LOSS_RTOL = 1e-12
SGD_UPDATE_BAR = 1e-8
SGD_STATS_RTOL = 1e-10
# a tensor whose float64 update stays below this is one whose gradient is
# zero in exact arithmetic (a conv bias ahead of a BatchNorm): rounding noise
ZERO_UPDATE = 1e-12


def flat(tree, prefix: str) -> dict:
    return {f"{prefix}/{k}": np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def variables_of(state) -> dict:
    return {**flat(state.params, "params"), **flat(state.batch_stats, "batch_stats")}


def port_state(model_cls, variables: dict, dtype=torch.float32) -> TrainState:
    model = load_into(model_cls().to(dtype), variables)
    return TrainState(model, make_optimizer(model, "sgd", LR, 0.9, 0.0))


def assert_state_close(port: TrainState, jax_state, init: dict, what: str, zero=(),
                       zero_bar: float = ZERO_UPDATE, update_bar: float = UPDATE_BAR,
                       stats_rtol: float = STATS_RTOL) -> int:
    """Each parameter's change from `init` within `update_bar` of JAX's
    largest change of that tensor (both below ZERO_UPDATE where JAX's is);
    the running statistics within `stats_rtol`. The tensors named in `zero`,
    whose gradient is zero in exact arithmetic (a conv bias ahead of a
    BatchNorm), move by at most `zero_bar` on both sides: Adam scales their
    rounding noise up towards its rate. Returns the count of statistics
    compared."""
    ref = state_dict_from_jax(variables_of(jax_state))
    start = state_dict_from_jax(init)
    got = port.model.state_dict()
    n_stats = 0
    for name, r in ref.items():
        g = got[name].detach()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=stats_rtol, atol=1e-12,
                                       err_msg=f"{what} {name}")
            n_stats += 1
            continue
        dj, dp = r - start[name], g - start[name]
        if name in zero:
            moved = max(float(dj.abs().max()), float(dp.abs().max()))
            assert moved <= zero_bar, f"{what} {name}: moved {moved:.3g} > {zero_bar:.3g}"
            continue
        err, scale = float((dp - dj).abs().max()), float(dj.abs().max())
        if scale < ZERO_UPDATE:
            assert float(dp.abs().max()) < ZERO_UPDATE, f"{what} {name}"
            continue
        assert err <= update_bar * scale, f"{what} {name}: {err:.3g} > {update_bar} x {scale:.3g}"
    return n_stats


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def flax_state(family: str):
    """The JAX train state of the family's Flax init (PRNGKey 0, float32),
    made once a file, the init jitted (op by op, a Flax init compiles each
    of its ops), at the float32 rate the port steps at (optax re-initialised
    under `jax.enable_x64` would keep a float64 0.05)."""
    return create_train_state(jitted_init(FAMILIES[family][0]()), jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 1)), learning_rate=LR32)


def jitted_init(model):
    """`model` for create_train_state, its init run as one jitted program."""
    return types.SimpleNamespace(init=jax.jit(model.init, static_argnames="train"),
                                 apply=model.apply)


def family_batch(family: str) -> dict:
    batch = make_batch(np.random.default_rng(0), batch=BATCH)
    keys = FAMILIES[family][4]
    return {k: np.asarray(batch[k]) for k in (keys or batch)}


@functools.lru_cache(maxsize=None)
def jax_float64_steps(family: str):
    """Two JAX steps in float64 (`jax.enable_x64`, the Flax model at dtype
    float64) from the float32 init, exact in float64: (the states after
    each step, their losses)."""
    flax_cls, _, jax_step, _, _ = FAMILIES[family]
    batch, f32 = family_batch(family), flax_state(family)
    with jax.enable_x64(True):
        up = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        jbatch = {k: jnp.asarray(v, jnp.float64) if v.dtype == np.float32 else jnp.asarray(v)
                  for k, v in batch.items()}
        params = up(f32.params)
        jstate = f32.replace(apply_fn=flax_cls(dtype=jnp.float64).apply, params=params,
                             batch_stats=up(f32.batch_stats), opt_state=f32.tx.init(params))
        step_j = jax.jit(jax_step())
        jstates, jlosses = [], []
        for _ in range(2):
            jstate, logs = step_j(jstate, jbatch)
            jstates.append(jstate)
            jlosses.append(float(logs["loss"]))
    return jstates, jlosses


SGD_BARS = {"update_bar": SGD_UPDATE_BAR, "stats_rtol": SGD_STATS_RTOL}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_jax_in_float64(family):
    """Two steps from one Flax init on one batch, float64 on both sides at
    one rate: loss within SGD_LOSS_RTOL relative at each step, every
    parameter's update within SGD_UPDATE_BAR of JAX's largest of the
    tensor, BatchNorm statistics within SGD_STATS_RTOL (Flax's momentum 0.99
    and biased variance); a JAX state after one step, carried across with
    its SGD trace as the momentum buffers, steps on in the port as JAX
    does."""
    _, port_cls, _, port_step, _ = FAMILIES[family]
    batch = family_batch(family)
    tbatch = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v.copy())
              for k, v in batch.items()}
    f32 = flax_state(family)
    jstates, jlosses = jax_float64_steps(family)
    init = variables_of(f32)        # float32 values, exact in float64
    step_p = port_step()
    port = port_state(port_cls, init, torch.float64)
    for k in range(2):
        port, logs = step_p(port, tbatch)
        np.testing.assert_allclose(float(logs["loss"]), jlosses[k], rtol=SGD_LOSS_RTOL)
        assert assert_state_close(port, jstates[k], init, f"step {k + 1}", **SGD_BARS) > 0

    after1 = variables_of(jstates[0])
    cont = port_state(port_cls, after1, torch.float64)
    load_sgd_momentum(cont.model, cont.optimizer,
                      flat(jstates[0].opt_state.inner_state[0].trace, "params"))
    cont, logs = step_p(cont, tbatch)
    np.testing.assert_allclose(float(logs["loss"]), jlosses[1], rtol=SGD_LOSS_RTOL)
    assert_state_close(cont, jstates[1], after1, "continued step 2", **SGD_BARS)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_float32_loss_matches_jax_and_falls(family):
    """float32, TF32 off: the first step's loss within 1e-5 relative of
    JAX's float64 step from the same init (measured: within 3.2e-7); the
    port's loss falls over 3 steps on the fixed batch, as the JAX step test
    asserts."""
    _, port_cls, _, port_step, _ = FAMILIES[family]
    batch = family_batch(family)
    port = port_state(port_cls, variables_of(flax_state(family)))
    step_p = port_step()
    losses = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for _ in range(3):
            port, plogs = step_p(port, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
            losses.append(float(plogs["loss"]))
    np.testing.assert_allclose(losses[0], jax_float64_steps(family)[1][0], rtol=LOSS_RTOL)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_momentum_carry_refuses_a_trace_of_another_model():
    model = YoloPoseNet()
    opt = make_optimizer(model)
    trace = {"params/stem/Conv_0/kernel": np.zeros((7, 7, 1, 64), np.float32)}
    with pytest.raises(ValueError, match="missing"):
        load_sgd_momentum(model, opt, trace)
