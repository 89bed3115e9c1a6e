"""The port's reference-checkpoint import (popnet_tpu_torch.interop.
torch_import) against the JAX package's, on the CPU.

A reference-ordered state dict of distinct random tensors goes through
the JAX importer (`ti.import_state_dict` and its per-model entry points,
then `from_jax.state_dict_from_jax`) and through the port's; the two
state dicts must be equal exactly, for Open-Pose+ (RTPoseLight3D),
RTPoseAlign3D, YoloPoseNet (its dead layer3 skipped) and A2J (its heads
reordered, its dead fc skipped). The reference-ordered dicts are built
from the Flax units in their creation order (the order of the first trace,
which the JAX importer pairs in), named as the reference names them where
a prefix matters. The JAX variables are shapes only (`jax.eval_shape`,
re-nested in the trace's order): the import replaces every value. Also:
`use_vgg`, the export round trip against JAX's export, the refusals, and
one Open-Pose+ forward against JAX's forward of JAX's import."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from popnet_tpu import models as jax_models
from popnet_tpu.interop import torch_import as ti
from popnet_tpu_torch import models
from popnet_tpu_torch.interop import torch_import as pti
from popnet_tpu_torch.interop.from_jax import state_dict_from_jax

A2J_NAMES = {"backbone": "Backbone", "classification": "classificationModel",
             "regression": "regressionModel", "depth": "DepthRegressionModel"}
A2J_REFERENCE_ORDER = ("Backbone", "regressionModel", "classificationModel",
                       "DepthRegressionModel")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def creation_ordered_shapes(flax_model, channels: int = 1):
    """The model's variables as ShapeDtypeStructs, nested in the Flax
    creation order (captured while `init` is traced: eval_shape's own
    output is re-sorted by key)."""
    order = {}

    def init(key):
        v = flax_model.init(key, jnp.zeros((1, 64, 64, channels)), train=False)
        for col in v:
            order[col] = list(traverse_util.flatten_dict(v[col]))
        return v

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return {col: traverse_util.unflatten_dict(
        {k: traverse_util.flatten_dict(shapes[col])[k] for k in keys})
        for col, keys in order.items()}


def reference_dict(shapes, rng, name_of=lambda path: ".".join(path), extra=(), order=None):
    """A reference-style state dict of distinct random tensors for the Flax
    units of `shapes`, in creation order: conv {weight OIHW, bias}, bn
    {weight, bias, running_mean, running_var, num_batches_tracked}. `extra`
    adds (name, kind, shape) dead units after the units they follow
    (inserted at the middle); `order` sorts units by the first element of
    their name."""
    funits, params, _ = ti._flax_units(shapes)
    units = []
    for kind, path, group, _ in funits:
        name = name_of(path)
        t = {}
        if kind == "bn":
            c = params[group["scale"]].shape[0]
            t = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.1, c),
                 "running_mean": rng.normal(0, 0.1, c), "running_var": rng.uniform(0.5, 1.5, c)}
        else:
            k = params[group["kernel"]].shape
            t["weight"] = rng.normal(0, 0.05, k[::-1] if len(k) == 2 else
                                     (k[3], k[2], k[0], k[1]))
            if "bias" in group:
                t["bias"] = rng.normal(0, 0.05, params[group["bias"]].shape)
        units.append((name, kind, t))
    for name, kind, shape in extra:
        t = {"weight": rng.normal(0, 0.05, shape), "bias": rng.normal(0, 0.05, shape[0])}
        units.insert(len(units) // 2, (name, kind, t))
    if order is not None:
        units.sort(key=lambda u: order.index(u[0].split(".")[0]))
    sd = {}
    for name, kind, t in units:
        for leaf, v in t.items():
            sd[f"module.{name}.{leaf}"] = torch.from_numpy(np.asarray(v, np.float32))
        if kind == "bn":
            sd[f"module.{name}.num_batches_tracked"] = torch.tensor(7)
    return sd


def jax_flat(variables) -> dict:
    return {"/".join((col,) + k): np.array(v)
            for col in variables for k, v in traverse_util.flatten_dict(variables[col]).items()}


def port_state(model) -> dict:
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def a2j_name(path) -> str:
    return ".".join((A2J_NAMES[path[0]],) + tuple(path[1:]))


FAMILIES = {
    # name: (flax model, port model, JAX importer, port importer, JAX exporter, port exporter,
    #        reference_dict kwargs)
    "rtpose_light3d": (jax_models.RTPoseLight3D, models.RTPoseLight3D, ti.import_rtpose_light3d,
                       pti.import_rtpose_light3d, ti.export_rtpose_light3d,
                       pti.export_rtpose_light3d, {}),
    "rtpose_align3d": (jax_models.RTPoseAlign3D, models.RTPoseAlign3D, ti.import_rtpose_align3d,
                       pti.import_rtpose_align3d, ti.export_rtpose_align3d,
                       pti.export_rtpose_align3d, {}),
    "yolo_posenet": (jax_models.YoloPoseNet, models.YoloPoseNet, ti.import_yolo_posenet,
                     pti.import_yolo_posenet, ti.export_yolo_posenet, pti.export_yolo_posenet,
                     {"extra": (("model0.layer3.0.conv1", "conv", (256, 128, 3, 3)),
                                ("model0.layer3.0.conv2", "conv", (256, 256, 3, 3)))}),
    "a2j": (jax_models.A2J, models.A2J, ti.import_a2j, pti.import_a2j, ti.export_a2j,
            pti.export_a2j,
            {"name_of": a2j_name, "extra": (("Backbone.model.fc", "linear", (1000, 2048)),),
             "order": A2J_REFERENCE_ORDER}),
}


@pytest.fixture(scope="module")
def imported():
    """{family: (reference dict, JAX variables of its import, the port's
    model after its import)}."""
    out = {}
    for i, (name, (flax_cls, port_cls, jax_imp, port_imp, _, _, kw)) in enumerate(
            FAMILIES.items()):
        shapes = creation_ordered_shapes(flax_cls())
        sd = reference_dict(shapes, np.random.default_rng(10 + i), **kw)
        out[name] = (sd, jax_imp(shapes, sd), port_imp(port_cls(), sd))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_equals_jax_import_carried_across(imported, family):
    """Every tensor of the port's import equals the JAX import's, carried
    across by `from_jax`, bit for bit, and each is one of the reference's."""
    sd, jax_vars, model = imported[family]
    ref = state_dict_from_jax(jax_flat(jax_vars))
    got = port_state(model)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    used = {v.numpy().tobytes() for v in got.values()}
    dead = [k for k in sd if k.startswith(("module.model0.layer3.", "module.Backbone.model.fc."))]
    assert all(sd[k].numpy().tobytes() not in used for k in dead)
    assert len(dead) == {"yolo_posenet": 4, "a2j": 2}.get(family, 0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_equals_jax_export_and_round_trips(imported, family):
    """The port's export of its imported model equals JAX's export of its
    imported variables, key for key and bit for bit (the dead branches keep
    the template's values), and imports back to the same model."""
    sd, jax_vars, model = imported[family]
    _, port_cls, _, port_imp, jax_exp, port_exp, _ = FAMILIES[family]
    ref = jax_exp(jax_vars, sd)
    got = port_exp(model, sd)
    assert list(got) == list(ref) == [k[len("module."):] for k in sd]
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype
    back = port_imp(port_cls(), {k: torch.from_numpy(v) for k, v in got.items()})
    for k, v in port_state(back).items():
        assert torch.equal(v, port_state(model)[k]), k


def test_use_vgg_equals_jax_use_vgg():
    """use_vgg puts a torchvision-VGG19-shaped dict's first 20 tensors on the
    trunk's conv1_1..conv4_2, as JAX's does; the CPM convs keep their init."""
    cfgs = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
            (256, 256), (256, 512), (512, 512), (512, 512)]
    rng = np.random.default_rng(2)
    sd = {}
    for i, (cin, cout) in enumerate(cfgs):
        sd[f"features.{2 * i}.weight"] = torch.from_numpy(
            rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32))
        sd[f"features.{2 * i}.bias"] = torch.from_numpy(rng.normal(0, 0.05, cout).astype(np.float32))
    shapes = creation_ordered_shapes(jax_models.RTPoseVGG(num_stages=1), channels=3)
    jax_vars = ti.use_vgg(shapes, sd)
    ref = state_dict_from_jax({k: v for k, v in jax_flat(jax_vars).items()
                               if k.split("/")[2] in pti.VGG_TRUNK})
    model = models.RTPoseVGG(num_stages=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pti.use_vgg(model, sd)
    got = model.state_dict()
    assert len(ref) == 20
    for k, v in got.items():
        if k in ref:
            assert torch.equal(v, ref[k]), k
        else:
            assert torch.equal(v, before[k]), k


def test_refusals_match_jax():
    """A kind, shape, bias or count mismatch is refused by both importers
    with the same message, and leaves the port's model as it was."""
    shapes = creation_ordered_shapes(jax_models.RTPoseLight3D())
    sd = reference_dict(shapes, np.random.default_rng(4))
    keys = list(sd)
    conv = keys[0].rsplit(".", 1)[0]                   # the first unit, a conv
    bn = next(k for k in keys if k.endswith("running_mean")).rsplit(".", 1)[0]
    biased = next(k[:-len(".bias")] for k in keys                    # a conv with a bias
                  if k.endswith(".bias") and sd[k[:-len("bias")] + "weight"].ndim == 4)
    cases = {
        "unit count mismatch": {k: v for k, v in sd.items() if not k.startswith(conv + ".")},
        "shape mismatch": {k: (v[:, :, :1] if k == conv + ".weight" else v)
                           for k, v in sd.items()},
        "bias presence mismatch": {k: v for k, v in sd.items() if k != biased + ".bias"},
        "unit kind mismatch": dict(sorted(sd.items(), key=lambda kv: not kv[0].startswith(bn))),
    }
    model = models.RTPoseLight3D()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for message, bad in cases.items():
        with pytest.raises(ValueError, match=message):
            ti.import_rtpose_light3d(shapes, bad)
        with pytest.raises(ValueError, match=message):
            pti.import_rtpose_light3d(model, bad)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # not strict: the units that pair are loaded, as in JAX
    short = cases["unit count mismatch"]
    with pytest.raises(ValueError, match="unit kind mismatch"):
        pti.import_state_dict(models.RTPoseLight3D(), short, strict=False)
    sd_a2j = {"module.Head.conv.weight": torch.zeros(4, 4, 3, 3)}
    with pytest.raises(ValueError, match="matches no reorder prefix"):
        pti.import_a2j(models.A2J(), sd_a2j)
    with pytest.raises(ValueError, match="matches no reorder prefix"):
        ti.import_a2j(creation_ordered_shapes(jax_models.A2J()), sd_a2j)


def test_strip_prefix_and_load_checkpoint(tmp_path):
    """'module.' is dropped where present; a saved .pth loads back (its
    'state_dict' entry unwrapped)."""
    sd = {"module.a.weight": torch.ones(2), "b.bias": torch.zeros(1)}
    assert list(pti.strip_module_prefix(sd)) == ["a.weight", "b.bias"]
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "ckpt.pth")
    torch.save(sd, tmp_path / "plain.pth")
    for name in ("ckpt.pth", "plain.pth"):
        got = pti.load_torch_checkpoint(tmp_path / name)
        assert list(got) == list(sd) and all(torch.equal(got[k], sd[k]) for k in sd)


def test_openpose_forward_after_import_matches_jax(imported):
    """Open-Pose+ at 64x64 with the imported reference weights: the port's
    forward against JAX's forward of JAX's import, within 1e-5."""
    sd, jax_vars, model = imported["rtpose_light3d"]
    x = np.random.default_rng(6).normal(0, 1, (2, 64, 64, 1)).astype(np.float32)
    ref = jax_models.RTPoseLight3D().apply(jax_vars, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref_maps, got_maps = jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(list(got))
    assert len(ref_maps) == len(got_maps)
    for r, g in zip(ref_maps, got_maps):
        r = np.asarray(r)
        g = g.numpy().transpose(0, 2, 3, 1) if g.ndim == 4 else g.numpy()
        assert r.std() > 1e-3
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)
