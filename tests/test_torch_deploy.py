"""The deployment transforms in the port's serving builders and its
`evaluate` command (BatchNorm folding, dynamic int8) against the JAX
package's, on the CPU: the five builders with fold_bn and quant against
the jitted JAX builders, `evaluate --quant int8` at the benchmark metric,
and the int8 gap the JAX package's own Yolo-Pose+ shows. The float layers
between the int8 convs round apart in the two frameworks, and an ulp that
crosses a rounding boundary of x / s_x moves a quantized value a step:
pipelines are held at the bars stated beside each."""

import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu import models as jm
from popnet_tpu import serving as jax_serving
from popnet_tpu.ops.quant import quantized_apply
from popnet_tpu_torch import models as pm
from popnet_tpu_torch import serving
from popnet_tpu_torch.interop.from_jax import flat_from_module, load_npz
from tests.test_torch_fold_bn import to_jax
from tests.test_torch_model import person_frames, with_background

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = {m: os.path.join(ROOT, "examples", "results", f"bench_weights_{m}.npz")
           for m in ("openpose", "popnet", "yolo")}
P, K = 16, 15


# -- the builders ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def agree(got: dict, ref: dict, people: int, share: float):
    """Decoded outputs of two int8 pipelines: people per frame within
    `people`, the visible flags equal on 99% of the joints, and `share` of
    the joints both see within one refine step (2.3 px) of each other."""
    cg, cr = (o["counts"].sum(axis=1) for o in (got, ref))
    assert np.abs(cg - cr).max() <= people, (cg, cr)
    vg, vr = (o["joints2d"][..., 0] >= 0 for o in (got, ref))
    if ref["counts"].shape[1] > 1:                  # flags per row: its joints count when set
        vg, vr = vg & (got["counts"] > 0)[..., None], vr & (ref["counts"] > 0)[..., None]
    assert (vg == vr).mean() >= 0.99
    both = vg & vr
    assert both.sum() >= 9
    d = np.linalg.norm(got["joints2d"] - ref["joints2d"], axis=-1)[both]
    assert (d <= 2.3).mean() >= share, (d <= 2.3).mean()


@pytest.fixture(scope="module")
def weights():
    """Each family's committed weights, read once: {model: (Flax variables,
    the port's flat dict)}."""
    return {m: (jax_serving.variables_from_npz(p), load_npz(p)) for m, p in WEIGHTS.items()}


@pytest.fixture(scope="module")
def depth_frames():
    return {"openpose": person_frames(4, n_frames=2, people=(2, 3)),
            "bg": with_background(person_frames(6, n_frames=2, people=(3, 2)))}


DENSE = {"openpose": (jax_serving.build_openpose_pipeline, serving.build_openpose_pipeline,
                      "openpose"),
         "popnet": (jax_serving.build_popnet_pipeline, serving.build_popnet_pipeline, "bg"),
         "yolo": (jax_serving.build_yolo_pipeline, serving.build_yolo_pipeline, "bg")}
TRANSFORMS = {"fold": {"fold_bn": True}, "fold+int8": {"fold_bn": True, "quant": "int8"}}
CASES = [(m, t) for m in ("openpose", "popnet", "yolo") for t in ("fold", "fold+int8")]


@pytest.mark.parametrize("model,transform", CASES, ids=[f"{m}-{t}" for m, t in CASES])
def test_depth_builders_match_the_jitted_jax_builders(depth_frames, weights, model, transform):
    """The port's builder (float32, CPU) with the transform against JAX's
    jitted builder on the same frames, the committed weights. Folded: the
    exact path's bars (counts equal, joints2d within 2.3 px, z within 1e-3
    m). With int8 (decoded from maps a quantization step apart here and
    there): PoP-Net's and Yolo's people equal and all their joints within
    2.3 px (measured: 98.7-100%); Open-Pose+'s committed weights localize
    little on these frames and its decode finds one fragment more (3 and 3
    people against 2 and 3; the port's int8 against its float path reads
    the same 2 and 3 as JAX): people within one a frame, joints that both
    see within 2.3 px."""
    jax_build, build, frames_key = DENSE[model]
    frames = depth_frames[frames_key]
    kw = TRANSFORMS[transform]
    jax_vars, flat = weights[model]
    ref = jax_serving.unpack_outputs(np.asarray(jax_build(jax_vars, dtype=jnp.float32, **kw)(
        jnp.asarray(frames))), P, K)
    got = serving.unpack_outputs(build(flat, dtype=torch.float32, device="cpu", **kw)(
        torch.from_numpy(frames)).numpy(), P, K)
    if "quant" not in kw:
        np.testing.assert_array_equal(got["counts"], ref["counts"])
        np.testing.assert_allclose(got["joints2d"], ref["joints2d"], atol=2.3)
        np.testing.assert_allclose(got["joints3d"][..., 2], ref["joints3d"][..., 2], atol=1e-3)
    else:
        agree(got, ref, people=1 if model == "openpose" else 0,
              share=0.95 if model == "openpose" else 0.98)


def test_yolo_a2j_builder_matches_jax_folded(depth_frames, weights):
    """Yolo->A2J with fold_bn on both stages, B = 2, two crops a frame,
    from A2J's seeded init, against JAX's jitted builder: the detector's
    flags exact, every value finite, A2J's joints within 1% of each
    output's largest magnitude (the exact path's bar,
    test_torch_yolo_a2j.py). Its int8 stages are held alone: the detector
    in the Yolo-Pose+ cases above, A2J's heads in
    test_a2j_folded_int8_heads_match_jax."""
    torch.manual_seed(0)
    a2j_flat = flat_from_module(pm.A2J().init_seeded(0))
    frames = depth_frames["bg"]
    ref = jax_serving.unpack_outputs(np.asarray(jax_serving.build_yolo_a2j_pipeline(
        weights["yolo"][0], to_jax(a2j_flat), dtype=jnp.float32, max_crops=2, fold_bn=True)(
        jnp.asarray(frames))), 2, K)
    buf = serving.build_yolo_a2j_pipeline(weights["yolo"][1], a2j_flat,
                                          dtype=torch.float32, device="cpu", max_crops=2,
                                          fold_bn=True)(torch.from_numpy(frames))
    assert torch.isfinite(buf).all()
    got = serving.unpack_outputs(buf.numpy(), 2, K)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    assert got["counts"].all()
    for k in ("joints2d", "joints3d"):
        err = np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()
        assert err <= 1e-2, (k, err)


# -- evaluate --quant int8 at the benchmark metric ------------------------------------------

@pytest.fixture(scope="module")
def frozen_set(tmp_path_factory):
    """test_quant_int8.py's held-out set: frozen mp-aug composites of 16
    scenes at seed 777 (the JAX command line's generate-augset)."""
    from popnet_tpu.cli.main import main as jax_main
    from tests import synthetic_data

    root = tmp_path_factory.mktemp("torch_int8")
    scenes, frozen = os.path.join(str(root), "scenes"), os.path.join(str(root), "frozen")
    synthetic_data.build(scenes, n_images=16, n_locations=5, seed=777)
    jax_main(["generate-augset", "--kind", "mpaug", "--data-root", scenes, "--out-dir", frozen,
              "--seed", "777"])
    return frozen


def test_evaluate_int8_metric_parity(frozen_set, tmp_path):
    """The port's `evaluate --model popnet --quant int8` (on the CPU, the
    committed weights) scores the four metrics within 0.02 of the float32
    run on the same frames, in a regime where they mean something (float32
    pck2d and map2d above 0.9), as test_quant_int8.py holds JAX's."""
    from popnet_tpu_torch.cli.main import main as port_main

    res = {}
    for name, extra in (("exact", []), ("int8", ["--quant", "int8"])):
        res[name] = port_main(["evaluate", "--model", "popnet", "--data-root", frozen_set,
                               "--labels", "labels_test.json", "--device", "cpu",
                               "--weights", WEIGHTS["popnet"], "--batch-size", "8",
                               "--out-dir", str(tmp_path / name), *extra])
    assert res["exact"]["pck2d"] > 0.9 and res["exact"]["map2d"] > 0.9, res["exact"]
    for k in ("pck2d", "pck3d", "map2d", "map3d"):
        assert abs(res["exact"][k] - res["int8"][k]) <= 0.02, (k, res)


def test_int8_moves_yolo_3d_metrics_in_both_packages(tmp_path, weights):
    """Found in the reference: on 64 frames of chip_smoke's "bg" set (people
    over the depth background, the committed Yolo weights), JAX's own
    dynamic int8 (quantized_apply, jitted) moves Yolo-Pose+'s pck3d and
    map3d from float32 by more than test_quant_int8.py's 0.02 bar, which it
    holds PoP-Net to (measured 0.0381 and 0.0464), while the 2D metrics
    stay within it.
    The port's int8 (its evaluate, on the CPU) scores within 0.02 of JAX's
    int8 on each metric."""
    import chip_smoke
    from popnet_tpu.cli import evaluate as jev
    from popnet_tpu.core.config import DecodeConfig, EncoderConfig
    from popnet_tpu.data.datasets import MPRealDataset as JaxDataset
    from popnet_tpu_torch.cli.main import main as port_main

    sets = chip_smoke.eval_sets(np.random.default_rng([0, 7]), "cpu", 64, str(tmp_path))
    data = os.path.dirname(sets["bg"][0])
    ds = JaxDataset(sets["bg"][0], sets["bg"][1], ecfg=EncoderConfig())
    variables = weights["yolo"][0]
    four = ("pck2d", "pck3d", "map2d", "map3d")
    res = {}
    for name, apply in (("exact", jm.YoloPoseNet().apply),
                        ("int8", partial(quantized_apply, jm.YoloPoseNet()))):
        infer = jax.jit(lambda v, x, apply=apply: apply(v, x, train=False))
        m = jev.evaluate_eval_data(jev.run_yolo_eval(lambda x: infer(variables, x), ds, 64,
                                                     EncoderConfig(), DecodeConfig()),
                                   verbose=False)
        res["jax " + name] = {k: float(m[k]) for k in four}
        flags = ["--quant", "int8"] if name == "int8" else []
        res["port " + name] = port_main(["evaluate", "--model", "yolo", "--data-root", data,
                                         "--device", "cpu", "--weights", WEIGHTS["yolo"],
                                         "--batch-size", "64", "--out-dir",
                                         str(tmp_path / name), *flags])
    gap = {k: res["jax exact"][k] - res["jax int8"][k] for k in four}
    assert gap["pck3d"] > 0.02 and gap["map3d"] > 0.02, gap
    assert abs(gap["pck2d"]) <= 0.02 and abs(gap["map2d"]) <= 0.02, gap
    for k in four:
        assert res["port exact"][k] == pytest.approx(res["jax exact"][k], abs=1e-3), (k, res)
        assert abs(res["port int8"][k] - res["jax int8"][k]) <= 0.02, (k, res)
