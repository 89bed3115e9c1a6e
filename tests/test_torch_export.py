"""Flax -> torch export: the take-your-weights-home direction.

export_state_dict must be the exact inverse of import_state_dict: exporting
this framework's variables into a live reference net and importing them back
reproduces the variables bit-exactly, and the torch net's forward then
matches ours to activation-parity tolerance (the same bound
tests/test_torch_import.py pins for the import direction).
"""

import numpy as np
import pytest
import torch

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from popnet_tpu.interop import torch_import as ti
from popnet_tpu.models import A2J, RTPoseLight3D, YoloPoseNet
from tests.reference_shim import load_cr_module
from tests.test_torch_import import _nchw, _to_nhwc

pytestmark = pytest.mark.reference


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_roundtrip(variables, exported, importer, reference_net):
    reference_net.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in exported.items()}
    )
    back = importer(variables, reference_net.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_a) == len(flat_b)
    for (pa, a), (pb, b) in zip(flat_a, flat_b):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))


def test_rtpose_light3d_export_roundtrip_and_forward():
    ref_mod = load_cr_module("te_rt3d", "third_party_methods/lib/network/rtpose_light3d.py")
    torch.manual_seed(10)
    net = ref_mod.rtpose_light3d(15, 14, 2, input_dim=1)
    net.eval()

    ours = RTPoseLight3D()
    x = np.random.default_rng(10).normal(size=(2, 64, 64, 1)).astype(np.float32)
    variables = ours.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    exported = ti.export_rtpose_light3d(variables, net.state_dict())
    _assert_roundtrip(variables, exported, ti.import_rtpose_light3d, net)

    with torch.no_grad():
        t_outs, _ = net(_nchw(x))
    (paf, heat, z), _ = ours.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(paf), _to_nhwc(t_outs[-3]), atol=1e-4)
    np.testing.assert_allclose(np.asarray(heat), _to_nhwc(t_outs[-2]), atol=1e-4)
    np.testing.assert_allclose(np.asarray(z), _to_nhwc(t_outs[-1]), atol=1e-4)


def test_yolo_posenet_export_roundtrip():
    ref_mod = load_cr_module("te_yolo", "third_party_methods/lib/network/yolo_posenet.py")
    torch.manual_seed(11)
    net = ref_mod.YoloPoseNet(15, input_dim=1)
    net.eval()

    ours = YoloPoseNet()
    variables = ours.init(jax.random.PRNGKey(4),
                          jnp.zeros((1, 64, 64, 1), jnp.float32), train=False)
    exported = ti.export_yolo_posenet(variables, net.state_dict())
    # the dead resnet34 layer3 keeps the template's values verbatim
    for k, v in net.state_dict().items():
        if k.startswith("model0.layer3.") and "num_batches_tracked" not in k:
            np.testing.assert_array_equal(exported[k], v.numpy())
    _assert_roundtrip(variables, exported, ti.import_yolo_posenet, net)


def test_a2j_export_roundtrip():
    import sys

    sys.path.insert(0, "/root/reference/third_party_methods")
    from A2J_experiments import model as ref_model_mod
    from A2J_experiments import resnet as ref_resnet

    ref_resnet.model_zoo.load_url = (
        lambda url, **kw: ref_resnet.resnet50(pretrained=False).state_dict()
    )
    torch.manual_seed(12)
    net = ref_model_mod.A2J_model(num_classes=15)
    net.eval()

    ours = A2J()
    variables = ours.init(jax.random.PRNGKey(5),
                          jnp.zeros((1, 96, 96, 1), jnp.float32), train=False)
    exported = ti.export_a2j(variables, net.state_dict())
    _assert_roundtrip(variables, exported, ti.import_a2j, net)
