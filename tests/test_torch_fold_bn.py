"""BatchNorm folding in the port (popnet_tpu_torch.ops.fold_bn) against the
JAX package's (popnet_tpu.ops.fold_bn), on the CPU.

Each family's BatchNorms are randomized first (scale and var in U(0.5, 2),
bias and mean in U(-0.5, 0.5), as tests/test_fold_bn.py does), so that a
mispaired fold shows. The port's variables go to JAX through the flat
Flax dict both packages read."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from popnet_tpu import models as jm
from popnet_tpu.ops.fold_bn import fold_batchnorm as jax_fold
from popnet_tpu_torch import models as pm
from popnet_tpu_torch.interop.from_jax import flat_from_module, load_into
from popnet_tpu_torch.ops.fold_bn import fold_batchnorm, fold_module, fuse_folded

# family: (port model, JAX model, input (B, H, W, C), Conv -> BatchNorm pairs folded)
FAMILIES = {
    "RTPoseLight3D": (pm.RTPoseLight3D, jm.RTPoseLight3D, (2, 32, 32, 1), 33),
    "PopNet": (pm.PopNet, jm.PopNet, (2, 32, 32, 1), 30),
    "YoloPoseNet": (pm.YoloPoseNet, jm.YoloPoseNet, (2, 32, 32, 1), 23),
    "A2J": (pm.A2J, jm.A2J, (2, 64, 64, 1), 65),
    "RTPoseAlign3D": (pm.RTPoseAlign3D, jm.RTPoseAlign3D, (2, 32, 32, 1), 25),
    "RTPoseVGG-mobilenet": (lambda: pm.RTPoseVGG(trunk="mobilenet"),
                            lambda: jm.RTPoseVGG(trunk="mobilenet"), (2, 32, 32, 3), 9),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomized(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """`model` in eval mode with every BatchNorm's scale and running var in
    U(0.5, 2) and its bias and running mean in U(-0.5, 0.5)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo, hi in ((m.weight, 0.5, 2.0), (m.running_var, 0.5, 2.0),
                                  (m.bias, -0.5, 0.5), (m.running_mean, -0.5, 0.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, t.shape).astype(np.float32)))
    return model.eval()


def to_jax(flat: dict) -> dict:
    return {c: traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): jnp.asarray(v) for k, v in flat.items()
         if k.split("/")[0] == c}) for c in ("params", "batch_stats")}


def from_jax(variables) -> dict:
    """Flax variables -> the flat dict, in the variables' own key order."""
    return {f"{c}/{k}": np.asarray(v) for c in ("params", "batch_stats") if c in variables
            for k, v in traverse_util.flatten_dict(variables[c], sep="/").items()}


def leaves(out) -> list[np.ndarray]:
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in leaves(o)]
    return [out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)]


def assert_close(port_out, jax_out):
    """tests/test_fold_bn.py's bars: rtol 1e-3, atol 1e-4 of max(1, 0.1 x
    the largest magnitude); the port's NCHW maps compared as NHWC."""
    got, ref = leaves(port_out), leaves(jax_out)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        if b.shape != a.shape and b.ndim == 4:
            b = b.transpose(0, 2, 3, 1)
        atol = 1e-4 * max(1.0, float(np.abs(a).max()) * 1e-1)
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=atol)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, the port's randomized model, its flat variables, input NHWC)."""
    make, _, shape, _ = FAMILIES[request.param]
    torch.manual_seed(0)
    model = randomized(make())
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    return request.param, model, flat_from_module(model), x


def test_fold_dict_and_paths_equal_jax_bit_for_bit(family):
    """The folded flat dict equals JAX's fold of the same variables bit for
    bit (eager float32 on both sides), the folded paths equal JAX's in
    order, and their number is the family's count."""
    name, _, flat, _ = family
    folded, paths = fold_batchnorm(flat)
    jax_folded, jax_paths = jax_fold(to_jax(flat))
    ref = from_jax(jax_folded)
    assert paths == jax_paths and len(paths) == FAMILIES[name][3]
    assert folded.keys() == ref.keys() == flat.keys()
    for k in flat:
        assert folded[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(folded[k], ref[k], err_msg=k)


def test_fold_is_idempotent_covers_every_batchnorm_and_leaves_its_input(family):
    name, model, flat, _ = family
    before = {k: v.copy() for k, v in flat.items()}
    once, paths = fold_batchnorm(flat)
    twice, paths2 = fold_batchnorm(once)
    assert paths2 == paths
    for k in once:
        np.testing.assert_array_equal(twice[k], once[k], err_msg=k)
        np.testing.assert_array_equal(flat[k], before[k], err_msg=k)
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert len(paths) == n_bn


def test_fused_model_matches_the_unfused_fold_and_jax(family):
    """The fused module (the BatchNorms gone, their bias in the conv)
    against the unfused folded module, the unfolded one and JAX's folded
    forward, in float32, at tests/test_fold_bn.py's bars."""
    name, model, flat, x = family
    make, make_jax, _, _ = FAMILIES[name]
    folded, paths = fold_batchnorm(flat)
    unfused = load_into(make(), folded).eval()
    fused = fuse_folded(load_into(make(), folded).eval(), paths)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out, out_unfused, out_exact = fused(xt), unfused(xt), model(xt)
    ref = make_jax().apply(jax_fold(to_jax(flat))[0], jnp.asarray(x), train=False)
    assert_close(out, ref)
    assert_close(out, leaves(out_unfused))
    assert_close(out, leaves(out_exact))


def test_fold_module_folds_through_the_flat_dict():
    """fold_module = fold_batchnorm on flat_from_module, load_into,
    fuse_folded; fuse_folded refuses a BatchNorm the fold did not
    neutralize."""
    torch.manual_seed(0)
    model = randomized(pm.YoloPoseNet())
    flat = flat_from_module(model)
    folded, paths = fold_batchnorm(flat)
    assert fold_module(model) == paths
    want = fuse_folded(load_into(pm.YoloPoseNet(), folded).eval(), paths).state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not a folded BatchNorm"):
        fuse_folded(randomized(pm.YoloPoseNet()), paths)


def test_paths_follow_a_flax_init_in_order():
    """On variables as Flax's init orders them, the port's paths list is
    JAX's, in order."""
    variables = jm.YoloPoseNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
                                      train=False)
    flat = from_jax(variables)
    assert fold_batchnorm(flat)[1] == jax_fold(variables)[1]
