"""Dynamic int8 in the port (popnet_tpu_torch.ops.quant) against the JAX
package's (popnet_tpu.ops.quant), on the CPU, where the int32 product is
the plain version (F.conv2d in float64, exact): one conv, the conv counts
of each family, whole models (tests/test_torch_deploy.py holds the
builders and `evaluate`).

The JAX package runs the same arithmetic two ways: its serving pipelines
are jitted, where XLA multiplies by the float32 reciprocal of 127 and
contracts the dequantizing epilogue into one FMA, and its `evaluate` calls
the model op by op (a true division, the epilogue rounded twice). The
port's `rounding="compiled"` and `"eager"` follow each, and one conv
equals JAX's bit for bit both ways. Across a model, the float layers
between the int8 convs round differently in the two frameworks (ulps), and
an ulp that crosses a rounding boundary of x / s_x moves a quantized value
by one step: models and pipelines are held at bars stated beside each."""

import os

import numpy as np
import pytest
import torch

import flax.linen as nn
from flax import traverse_util
import jax
import jax.numpy as jnp

from popnet_tpu import models as jm
from popnet_tpu import serving as jax_serving
from popnet_tpu.ops.fold_bn import fold_batchnorm as jax_fold
from popnet_tpu.ops.quant import int8_conv_interceptor, quantized_apply
from popnet_tpu_torch import models as pm
from popnet_tpu_torch import serving
from popnet_tpu_torch.interop.from_jax import flat_from_module, load_into, load_npz
from popnet_tpu_torch.ops.quant import (
    Int8Conv2d,
    int8_conv,
    int8_conv_plain,
    quantize_activation,
    quantize_convs,
    weight_matrix,
)
from tests.test_torch_coco import flax_init
from tests.test_torch_fold_bn import to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = {m: os.path.join(ROOT, "examples", "results", f"bench_weights_{m}.npz")
           for m in ("openpose", "popnet", "yolo")}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class OneConv(nn.Module):
    """One Flax conv, as the JAX models declare theirs."""
    features: int
    kernel: int
    stride: int
    pad: int
    dilation: int
    bias: bool
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):
        p = self.pad
        return nn.Conv(self.features, (self.kernel, self.kernel), (self.stride, self.stride),
                       padding=((p, p), (p, p)), kernel_dilation=(self.dilation, self.dilation),
                       use_bias=self.bias, dtype=self.dtype)(x)


# (C_in, C_out, kernel, stride, pad, dilation, bias): a stride-2 stem with K = 147
# padded to 152 (A2J's 7x7x3), K = 333 padded to 336 and C_out = 100 padded to 104
# (PoP-Net's prior head), a dilated conv, a stride-2 3x3 without bias, and a 1x1
# head of 38 channels padded to 40 (RTPoseVGG's PAF)
CONVS = [(3, 64, 7, 2, 3, 1, False), (37, 100, 3, 1, 1, 1, True), (32, 40, 3, 1, 2, 2, True),
         (64, 32, 3, 2, 1, 1, False), (128, 38, 1, 1, 0, 1, True)]


def one_conv(spec, seed=0):
    """(Flax module, its variables, the same torch conv, input NHWC)."""
    cin, cout, k, s, p, d, b = spec
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    x = (rng.standard_normal((2, 13, 11, cin)) * 2.3).astype(np.float32)
    params = {"kernel": jnp.asarray(w)}
    conv = torch.nn.Conv2d(cin, cout, k, stride=s, padding=p, dilation=d, bias=b)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        if b:
            params["bias"] = jnp.asarray(bias)
            conv.bias.copy_(torch.from_numpy(bias))
    return OneConv(cout, k, s, p, d, b), {"params": {"Conv_0": params}}, conv, x


@pytest.mark.parametrize("spec", CONVS, ids=[f"{c[0]}-{c[1]}-k{c[2]}s{c[3]}d{c[5]}" for c in CONVS])
def test_int8_conv_equals_jax_bit_for_bit(spec):
    """One conv: rounding="compiled" equals jax.jit(quantized_apply) and
    "eager" equals quantized_apply op by op, bit for bit, in float32; and
    the compiled one in bf16 (float32 weights, scales and epilogue, as the
    Flax module keeps its parameters) equals the jitted bf16 Flax conv."""
    mod, variables, conv, x = one_conv(spec)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    jitted = np.asarray(jax.jit(lambda a: quantized_apply(mod, variables, a))(jnp.asarray(x)))
    eager = np.asarray(quantized_apply(mod, variables, jnp.asarray(x)))
    assert (jitted != eager).any()                # the two JAX programs round apart
    with torch.inference_mode():
        for rounding, ref in (("compiled", jitted), ("eager", eager)):
            got = Int8Conv2d(conv, rounding)(xt).permute(0, 2, 3, 1).numpy()
            np.testing.assert_array_equal(got, ref, err_msg=rounding)
        q = Int8Conv2d(conv).to(torch.bfloat16)
        assert q.weight.dtype == q.weight_scale.dtype == torch.float32
        xb = jnp.asarray(x, jnp.bfloat16)
        mod_b = OneConv(*[getattr(mod, f) for f in ("features", "kernel", "stride", "pad",
                                                    "dilation", "bias")], dtype=jnp.bfloat16)
        ref = np.asarray(jax.jit(lambda a: quantized_apply(mod_b, variables, a))(xb), np.float32)
        got = q(torch.from_numpy(np.asarray(xb, np.float32)).permute(0, 3, 1, 2).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), ref)


def test_plain_product_is_exact_at_the_widest_contraction():
    """int8_conv_plain at RTPoseVGG's 7x7x185 contraction, every value at
    +-127, equals the int64 sum (127**2 * 9065 = 146,210,585)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.choice([-127, 127], (1, 185, 9, 9)).astype(np.int8))
    w = torch.from_numpy(rng.choice([-127, 127], (8, 185, 7, 7)).astype(np.int8))
    got = int8_conv_plain(x, w, (1, 1), (0, 0), (1, 1))
    ref = np.einsum("chw,ochw->o", x[0, :, :7, :7].numpy().astype(np.int64),
                    w.numpy().astype(np.int64))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0, :, 0, 0].numpy(), ref)
    ones = int8_conv_plain(torch.full((1, 185, 7, 7), 127, dtype=torch.int8),
                           torch.full((1, 185, 7, 7), 127, dtype=torch.int8), 1, 0, 1)
    assert int(ones) == 127**2 * 9065


def test_int8_conv_on_the_cpu_is_the_plain_version_in_nhwc():
    """int8_conv on CPU tensors returns the plain version as (N, Ho, Wo,
    C_out); weight_matrix pads K and C_out with zeros to multiples of 8;
    the activation's quantized values stay within +-127."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 37, 9, 7)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (100, 37, 3, 3)).astype(np.int8))
    x_q, s_x = quantize_activation(x)
    assert x_q.dtype == torch.int8 and int(x_q.abs().max()) == 127 and s_x.ndim == 0
    m = weight_matrix(w)
    assert m.shape == (104, 336) and not m[100:].any() and not m[:, 333:].any()
    np.testing.assert_array_equal(m[:100, :333].numpy(),
                                  w.permute(0, 2, 3, 1).reshape(100, -1).numpy())
    got = int8_conv(x_q, m, w, (2, 1), (1, 1), (1, 1))
    assert got.shape == (2, 5, 7, 100)
    torch.testing.assert_close(got, int8_conv_plain(x_q, w, (2, 1), (1, 1), (1, 1))
                               .permute(0, 2, 3, 1), rtol=0, atol=0)


# family: (port model, JAX model, input NHWC, nn.Conv calls, int8-eligible)
COUNTS = {
    "RTPoseLight3D": (pm.RTPoseLight3D, jm.RTPoseLight3D, (1, 32, 32, 1), 39, 32),
    "PopNet": (pm.PopNet, jm.PopNet, (1, 32, 32, 1), 47, 38),
    "YoloPoseNet": (pm.YoloPoseNet, jm.YoloPoseNet, (1, 32, 32, 1), 25, 24),
    "A2J": (pm.A2J, jm.A2J, (1, 64, 64, 1), 68, 68),
    "RTPoseVGG-vgg19": (pm.RTPoseVGG, jm.RTPoseVGG, (1, 32, 32, 3), 92, 85),
    "RTPoseVGG-mobilenet": (lambda: pm.RTPoseVGG(trunk="mobilenet"),
                            lambda: jm.RTPoseVGG(trunk="mobilenet"), (1, 32, 32, 3), 91, 79),
}


@pytest.mark.parametrize("family", sorted(COUNTS))
def test_int8_conv_counts_equal_jax(family):
    """The convs quantize_convs swaps equal those JAX's interceptor takes
    (counted with an nn.intercept_methods hook on one apply), per family."""
    make, make_jax, shape, n_conv, n_int8 = COUNTS[family]
    torch.manual_seed(0)
    model = make().eval()
    variables = to_jax(flat_from_module(model))
    calls, taken = [0], [0]

    def count(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Conv) and context.method_name == "__call__":
            calls[0] += 1
            taken[0] += int8_conv_interceptor(lambda *a, **k: None, args, kwargs,
                                              context) is not None
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(count):               # traced only: shapes, no arithmetic
        jax.eval_shape(lambda: make_jax().apply(variables, jnp.zeros(shape), train=False))
    assert (calls[0], taken[0]) == (n_conv, n_int8)
    n_torch = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert quantize_convs(model) == n_int8 and n_torch == n_conv
    assert sum(isinstance(m, Int8Conv2d) for m in model.modules()) == n_int8


@pytest.fixture(scope="module")
def popnet_case():
    """PopNet with the committed weights, its Flax variables, a frame of
    normal noise at 64x64 and JAX's float forward of it, op by op (made
    once: both roundings of test_int8_model_matches_jax measure against
    it)."""
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 1)).astype(np.float32)
    variables = jax_serving.variables_from_npz(WEIGHTS["popnet"])
    exact = jm.PopNet().apply(variables, jnp.asarray(x), train=False)[0]
    return load_npz(WEIGHTS["popnet"]), variables, x, exact


def test_fallthrough_is_exact_and_int8_stays_near_exact():
    """test_quant_int8.py's two gates on its case (PopNet from Flax's init
    at PRNGKey(0), one frame of normal noise at 64x64): at
    min_contraction=10**9 no conv is swapped and the output is the float
    model's bit for bit; at the defaults the outputs move (int8 ran) by
    less than 0.05. The state dict keeps its keys."""
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 1)).astype(np.float32)
    variables = jax.jit(lambda k: jm.PopNet().init(k, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(0))
    flat = {f"{c}/{k}": np.asarray(v) for c in ("params", "batch_stats")
            for k, v in traverse_util.flatten_dict(variables[c], sep="/").items()}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    exact = load_into(pm.PopNet(), flat).eval()
    none = load_into(pm.PopNet(), flat).eval()
    assert quantize_convs(none, min_contraction=10**9) == 0
    q = load_into(pm.PopNet(), flat).eval()
    keys = q.state_dict().keys()
    assert quantize_convs(q) == 38 and q.state_dict().keys() == keys
    with torch.no_grad():
        (e, n, o) = (m(xt)[0] for m in (exact, none, q))
    diffs = []
    for a, b, c in zip(e, n, o):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        diffs.append(float((c - a).abs().max()))
    assert 0.0 < max(diffs) < 0.05, diffs


@pytest.mark.parametrize("rounding", ["compiled", "eager"])
def test_int8_model_matches_jax(popnet_case, rounding):
    """PopNet int8 against JAX's quantized_apply, jitted for "compiled" and
    op by op for "eager". The float layers between the int8 convs round
    apart by ulps, and where such an ulp crosses a rounding boundary of
    x / s_x one quantized value moves a step and the step spreads through
    the layers after it. So each map of the port's int8 lies closer to
    JAX's int8 on average than JAX's int8 lies to JAX's float forward, and
    within twice that gap at most."""
    flat, variables, x, exact = popnet_case
    net = load_into(pm.PopNet(), flat).eval()
    quantize_convs(net, rounding=rounding)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))[0]

    def apply(a):
        return quantized_apply(jm.PopNet(), variables, a, train=False)[0]

    ref = (jax.jit(apply) if rounding == "compiled" else apply)(jnp.asarray(x))
    for g, r, e in zip(got, ref, exact):
        d = np.abs(g.permute(0, 2, 3, 1).numpy() - np.asarray(r))
        gap = np.abs(np.asarray(r) - np.asarray(e))
        assert d.mean() < gap.mean() and d.max() <= 2 * gap.max(), (d.mean(), gap.mean(),
                                                                    d.max(), gap.max())


@pytest.mark.parametrize("family", ["A2J", "RTPoseVGG-mobilenet"])
def test_folded_int8_model_matches_jax(family):
    """The second stage of Yolo->A2J and the COCO RGB CNN as their builders
    run them (`serving.deploy_model`: folded, then int8), against JAX's
    jitted quantized_apply of the folded Flax variables, on one 32x32 crop
    for A2J's seeded init and two 64x64 frames for test_torch_coco's Flax variables
    that carry signal (`flax_init`): every output within 1e-6 of its
    largest magnitude (measured: equal)."""
    if family == "A2J":
        torch.manual_seed(0)
        model, jax_model, cin = pm.A2J().init_seeded(0), jm.A2J(), 1
        flat = flat_from_module(model)
    else:
        _, flat = flax_init("mobilenet", np.random.default_rng(4))
        model = load_into(pm.RTPoseVGG(trunk="mobilenet"), flat)
        jax_model, cin = jm.RTPoseVGG(trunk="mobilenet"), 3
    net = serving.deploy_model(model, "cpu", torch.float32, fold_bn=True, quant="int8")
    assert sum(isinstance(m, Int8Conv2d) for m in net.modules()) == COUNTS[family][4]
    n, hw = (1, 32) if family == "A2J" else (2, 64)
    x = np.random.default_rng(3).normal(0, 1, (n, hw, hw, cin)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    variables = jax_fold(to_jax(flat))[0]
    ref = jax.jit(lambda v, a: quantized_apply(jax_model, v, a, train=False))(variables,
                                                                             jnp.asarray(x))
    got, ref = jax.tree.leaves(got, is_leaf=lambda t: isinstance(t, torch.Tensor)), \
        jax.tree.leaves(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        if g.shape != r.shape:
            g = g.transpose(0, 2, 3, 1)
        assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max()


@pytest.mark.parametrize("build", [serving.build_openpose_pipeline, serving.build_popnet_pipeline,
                                   serving.build_yolo_pipeline, serving.build_yolo_a2j_pipeline,
                                   serving.build_rtpose_vgg_pipeline])
def test_builders_refuse_an_unknown_quant_mode(build):
    """quant takes None, "none", "" or "int8" (JAX's `_apply_model`)."""
    with pytest.raises(ValueError, match="unknown quant mode 'int4'"):
        if build is serving.build_rtpose_vgg_pipeline:
            build(device="cpu", quant="int4", input_size=32)
        else:
            build(load_npz(WEIGHTS["yolo" if "yolo" in build.__name__ else
                                   build.__name__.split("_")[1]]), device="cpu", quant="int4")
