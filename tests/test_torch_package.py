"""The PyTorch/CUDA port as a package: import rule, weight loader, entry
points and kernel wrappers (popnet_tpu_torch)."""

import ast
import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import popnet_tpu_torch
from popnet_tpu_torch import (
    build_openpose_pipeline,
    build_popnet_pipeline,
    build_yolo_a2j_pipeline,
    build_yolo_pipeline,
    load_npz,
    state_dict_from_jax,
)
from popnet_tpu_torch.interop.from_jax import load_into
from popnet_tpu_torch.models import A2J, PopNet, RTPoseAlign3D, RTPoseLight3D, YoloPoseNet
from popnet_tpu_torch.ops import _build, kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "popnet_tpu_torch")
WEIGHTS = os.path.join(ROOT, "examples", "results", "bench_weights_openpose.npz")
WEIGHTS_POPNET = os.path.join(ROOT, "examples", "results", "bench_weights_popnet.npz")
WEIGHTS_YOLO = os.path.join(ROOT, "examples", "results", "bench_weights_yolo.npz")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_with_jax_and_reference_blocked():
    """Every module of the port (and chip_smoke.py) imports while jax, flax,
    popnet_tpu, the test suite, cv2 and PIL are unimportable; popnet_tpu_torch itself must
    pass the blocker (a bare prefix match would block it too)."""
    code = textwrap.dedent(f"""
        import importlib, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "tests") \\
                        or name == "popnet_tpu" or name.startswith("popnet_tpu."):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        for m in {_port_modules()!r} + ["chip_smoke"]:
            importlib.import_module(m)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "popnet_tpu", "cv2",
                                         "PIL", "tests")]
        assert not leaked, leaked
        for m in ("models.popnet", "models.rtpose_align3d", "models.yolo_posenet", "decode.prior",
                  "decode.popnet_infer", "models.a2j", "decode.a2j", "data.a2j_crops",
                  "core.numerics", "eval.pck", "eval.map", "eval.batched", "cli.evaluate",
                  "cli.yolo_a2j", "cli.main", "data.datasets", "data.labels",
                  "data.augment_device", "decode.readout", "decode.assemble", "core.device",
                  "ops.encoders", "losses.losses", "train.state", "train.schedule",
                  "train.steps", "train.checkpoint", "train.loop", "data.compositing",
                  "data.streaming", "data.augment_host", "ops.fold_bn", "ops.quant",
                  "eval.single", "data.itop_a2j", "cli.itop_eval", "cli.itop_table",
                  "decode.peaks_np", "decode.paf_np", "decode.human_list", "decode.align",
                  "data.image_io", "data.coco", "data.coco_dataset", "data.mpii",
                  "models.rtpose_light", "eval.coco_oks", "data.construction",
                  "data.preprocessing", "core.camera", "data.synthetic", "cli.tables",
                  "cli.method_table", "cli.ablation_table", "parallel.distributed",
                  "parallel.mesh", "parallel.tensor", "parallel.spatial", "parallel.pipeline",
                  "parallel.checks"):
            assert "popnet_tpu_torch." + m in sys.modules, m
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_source_names_the_reference_package():
    """Static check: no import statement of the port or chip_smoke.py names
    jax, flax, optax, orbax, popnet_tpu, cv2 or PIL."""
    files = [os.path.join(ROOT, m.replace(".", os.sep) + ".py") for m in _port_modules()]
    files = [f if os.path.exists(f) else f[:-3] + os.sep + "__init__.py" for f in files]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    for f in files:
        tree = ast.parse(open(f).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "flax", "optax", "orbax", "popnet_tpu", "cv2", "PIL"), \
                    (f, n)


def test_load_npz_maps_every_committed_key():
    flat = load_npz(WEIGHTS)
    assert len(flat) == 201
    assert all(v.dtype == np.float32 for v in flat.values())
    sd = state_dict_from_jax(flat)
    assert len(sd) == 201
    k = flat["params/stage1_heat/ConvBN_0/Conv_0/kernel"]
    w = sd["stage1_heat.ConvBN_0.Conv_0.weight"]
    assert tuple(w.shape) == (k.shape[3], k.shape[2], k.shape[0], k.shape[1])
    np.testing.assert_array_equal(w.numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["stem.BatchNorm_0.running_var"].numpy(),
                                  flat["batch_stats/stem/BatchNorm_0/var"])
    np.testing.assert_array_equal(sd["stem.BatchNorm_0.weight"].numpy(),
                                  flat["params/stem/BatchNorm_0/scale"])
    model = load_into(RTPoseLight3D(), flat)
    np.testing.assert_array_equal(model.stem.BasicBlock_2.Conv_2.weight.detach().numpy(),
                                  flat["params/stem/BasicBlock_2/Conv_2/kernel"].transpose(3, 2, 0, 1))


def test_load_npz_maps_every_committed_popnet_key():
    """The PoP-Net npz: 204 arrays, heat branches without BatchNorm, a prior
    head without bias; a module of another model refuses it."""
    flat = load_npz(WEIGHTS_POPNET)
    assert len(flat) == 204 and len(state_dict_from_jax(flat)) == 204
    model = load_into(PopNet(), flat)
    assert model.prior_out.bias is None and not hasattr(model.stage1_heat.ConvBN_0, "BatchNorm_0")
    np.testing.assert_array_equal(
        model.stage2_heat.ConvBN_5.Conv_0.weight.detach().numpy(),
        flat["params/stage2_heat/ConvBN_5/Conv_0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.prior_tower2.BatchNorm_0.running_mean.numpy(),
                                  flat["batch_stats/prior_tower2/BatchNorm_0/mean"])
    with pytest.raises(ValueError, match="missing"):
        load_into(RTPoseAlign3D(), flat)
    extra = {**flat, "params/prior_out/bias": np.zeros(100, np.float32)}
    with pytest.raises(ValueError, match="unexpected"):
        load_into(PopNet(), extra)


def test_load_npz_maps_every_committed_yolo_key():
    """The Yolo-Pose+ npz: 122 arrays, a ResNet-34 stem whose stride-2
    block projects, bare `tower4` (with bias) and `head3` (without) convs;
    a module of another model refuses it."""
    flat = load_npz(WEIGHTS_YOLO)
    assert len(flat) == 122 and len(state_dict_from_jax(flat)) == 122
    model = load_into(YoloPoseNet(), flat)
    assert model.head3.bias is None and model.tower4.bias is not None
    assert model.stem.BasicBlock_3.Conv_0.stride == (2, 2)
    assert model.stem.BasicBlock_3.Conv_2.stride == (2, 2)
    np.testing.assert_array_equal(model.stem.BasicBlock_3.Conv_2.weight.detach().numpy(),
                                  flat["params/stem/BasicBlock_3/Conv_2/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.tower4.bias.detach().numpy(), flat["params/tower4/bias"])
    np.testing.assert_array_equal(model.head2.BatchNorm_0.running_var.numpy(),
                                  flat["batch_stats/head2/BatchNorm_0/var"])
    with pytest.raises(ValueError, match="missing"):
        load_into(PopNet(), flat)
    with pytest.raises(ValueError, match="missing"):
        load_into(A2J(), flat)


def test_loader_raises_on_unmapped_keys():
    flat = load_npz(WEIGHTS)
    with pytest.raises(ValueError, match="unmapped"):
        state_dict_from_jax({**flat, "params/stem/Conv_0/extra": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        load_into(RTPoseLight3D(), {**flat, "params/stem/Conv_9/kernel": np.zeros((1, 1, 1, 1), np.float32)})
    missing = dict(flat)
    del missing["batch_stats/stem/BatchNorm_1/mean"]
    with pytest.raises(ValueError, match="missing"):
        load_into(RTPoseLight3D(), missing)


def test_entry_point_defaults_to_cuda_and_never_runs_on_cpu_unasked():
    assert inspect.signature(build_openpose_pipeline).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_openpose_pipeline(load_npz(WEIGHTS))
    assert set(popnet_tpu_torch.__all__) >= {"build_openpose_pipeline", "serve_stream", "load_npz"}


def test_popnet_entry_point_defaults_to_cuda_and_never_runs_on_cpu_unasked():
    params = inspect.signature(build_popnet_pipeline).parameters
    assert params["device"].default == "cuda" and params["readout"].default == "universe"
    assert params["dtype"].default == torch.bfloat16 and params["pack"].default == "f32"
    assert "build_popnet_pipeline" in popnet_tpu_torch.__all__
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_popnet_pipeline(load_npz(WEIGHTS_POPNET))


@pytest.mark.parametrize("builder", [build_yolo_pipeline, build_yolo_a2j_pipeline])
def test_yolo_entry_points_default_to_cuda_and_never_run_on_cpu_unasked(builder):
    params = inspect.signature(builder).parameters
    assert params["device"].default == "cuda" and params["dtype"].default == torch.bfloat16
    assert params["pack"].default == "f32"
    if builder is build_yolo_a2j_pipeline:
        assert params["max_crops"].default == 4 and params["a2j_weights"].default is None
    assert builder.__name__ in popnet_tpu_torch.__all__
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        builder(load_npz(WEIGHTS_YOLO))
    with pytest.raises(ValueError, match="unknown pack"):
        builder(load_npz(WEIGHTS_YOLO), device="cpu", pack="f16")


def test_a2j_seeded_init_is_reproducible_and_follows_the_flax_scales():
    """The seeded init: the same seed gives the same weights, another seed
    others; He-normal trunk convs (std sqrt(2 / fan_in)), Glorot-normal head
    convs, zero head biases but the depth output's `depth_prior`, unit
    BatchNorm."""
    a, b, c = A2J(depth_prior=3.0).init_seeded(0), A2J().init_seeded(0), A2J().init_seeded(1)
    w = a.backbone.DilatedBottleneck_4.Conv_1.weight
    assert torch.equal(w, b.backbone.DilatedBottleneck_4.Conv_1.weight)
    assert not torch.equal(w, c.backbone.DilatedBottleneck_4.Conv_1.weight)
    assert abs(float(w.detach().std()) / (2.0 / (9 * 128)) ** 0.5 - 1) < 0.05
    hw = a.regression.Conv_0.weight
    assert abs(float(hw.detach().std()) / (2.0 / (9 * 2048 + 9 * 256)) ** 0.5 - 1) < 0.05
    assert (a.depth.Conv_4.bias == 3.0).all() and (b.depth.Conv_4.bias == 0).all()
    assert (a.classification.Conv_2.bias == 0).all()
    bn = a.backbone.DilatedBottleneck_0.BatchNorm_2
    assert (bn.weight == 1).all() and (bn.running_var == 1).all() and (bn.running_mean == 0).all()


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    kernels.reset_launches()
    rng = np.random.default_rng(0)
    h = torch.as_tensor(rng.uniform(0, 1, (2, 15, 28, 28)).astype(np.float32))
    got = kernels.find_peaks(h)
    ref = kernels.find_peaks_plain(h)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    img = torch.as_tensor(rng.uniform(0, 1, (2, 9, 7)).astype(np.float32))
    cx = torch.tensor([[0, 6, 7, -1]], dtype=torch.int32).repeat(2, 1)
    cy = torch.tensor([[0, 8, 1, 1]], dtype=torch.int32).repeat(2, 1)
    out = kernels.point_readout(img, cx, cy)
    np.testing.assert_array_equal(out[:, 2:].numpy(), 0.0)     # off the image reads 0
    np.testing.assert_array_equal(out[:, 0].numpy(), img[:, 0, 0].numpy())
    heat = torch.as_tensor(rng.uniform(0, 1, (2, 6, 5, 3)).astype(np.float32))
    assert torch.equal(kernels.peak_mask(heat, 0.5),
                       kernels.peak_local_max_plain(heat.permute(0, 3, 1, 2), 0.5).permute(0, 2, 3, 1))
    for a, b in zip(kernels.find_peaks_row(h), ref):
        assert torch.equal(a, b)
    for a, b in zip(kernels.find_peaks_plane(h), ref):
        assert torch.equal(a, b)
    ps = torch.as_tensor(rng.uniform(0.1, 1, (2, 15, 4)).astype(np.float32))
    sm = torch.full((2, 14, 4, 4), float("-inf"))
    sm[:, :, 0, 1] = 1.0
    limbs = popnet_tpu_torch.core.skeleton.LIMBS
    for a, b in zip(kernels.assemble_ids(ps, sm, limbs), kernels.assemble_ids_plain(ps, sm, limbs)):
        assert torch.equal(a, b)
    assert [k.__name__ for k in kernels.KERNELS] == [
        "find_peaks", "find_peaks_row", "find_peaks_plane", "paf_score", "window_readout",
        "point_readout", "assemble_ids", "peak_local_max"]
    assert kernels.launch_counts() == {k.__name__: 0 for k in kernels.KERNELS}


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.find_peaks(torch.empty((1, 15, 28, 28), device="meta"))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.peak_local_max(torch.empty((1, 15, 28, 28), device="meta"))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.find_peaks_row(torch.empty((1, 15, 28, 28), device="meta"))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.find_peaks_plane(torch.empty((1, 1, 300, 9), device="meta"))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.assemble_ids(torch.zeros((1, 15, 16)), torch.zeros((1, 14, 16, 16), device="meta"),
                             popnet_tpu_torch.core.skeleton.LIMBS)
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.point_readout(torch.zeros((1, 4, 4)), torch.zeros((1, 2), dtype=torch.int32,
                                                                  device="meta"),
                              torch.zeros((1, 2), dtype=torch.int32))


def test_build_targets_are_content_hashed_in_an_ignored_directory():
    assert set(_build.SOURCES) == {"find_peaks", "paf_score", "readout", "assemble", "peak_mask"}
    assert {src for src, _ in kernels._SIGNATURES.values()} == set(_build.SOURCES)
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        t = _build._target(name)
        assert t.parent == _build.BUILD_DIR and t.name.startswith(f"lib{name}-")
    assert os.path.relpath(_build.BUILD_DIR, ROOT).split(os.sep)[0] == "build"
    assert "build/" in open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_evaluate_defaults_to_cuda_and_never_runs_on_cpu_unasked(tmp_path):
    """The evaluate subcommand and the evaluation dataset default to the
    card; without one they raise unless the CPU is asked for (--device cpu),
    and the batched metrics likewise."""
    from popnet_tpu_torch.cli.main import build_parser, main
    from popnet_tpu_torch.data.datasets import MPRealDataset
    from popnet_tpu_torch.eval import batched

    args = build_parser().parse_args(["evaluate", "--data-root", str(tmp_path)])
    assert args.device == "cuda" and args.model == "popnet" and not args.device_decode
    assert inspect.signature(MPRealDataset).parameters["device"].default == "cuda"
    assert inspect.signature(batched.eval_ap_batched).parameters["device"].default == "cuda"
    assert {m for m in _port_modules() if m.startswith(("popnet_tpu_torch.eval",
                                                        "popnet_tpu_torch.cli"))} >= {
        "popnet_tpu_torch.eval.pck", "popnet_tpu_torch.eval.map", "popnet_tpu_torch.eval.batched",
        "popnet_tpu_torch.cli.evaluate", "popnet_tpu_torch.cli.yolo_a2j",
        "popnet_tpu_torch.cli.main"}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["evaluate", "--data-root", str(tmp_path), "--model", "yolo"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched.eval_pck2d_batched(np.zeros((1, 1, 15, 2)), np.ones((1, 1), bool),
                                   np.zeros((1, 1, 15, 2)), np.ones((1, 1), bool))
    with pytest.raises(FileNotFoundError):   # asked for the CPU, it goes on to read the labels
        main(["evaluate", "--data-root", str(tmp_path), "--model", "yolo", "--device", "cpu"])


def test_train_defaults_to_cuda_and_never_runs_on_cpu_unasked(tmp_path):
    """The train subcommand, the training dataset and the Trainer default to
    the card; without one they raise unless the CPU is asked for (--device
    cpu); the training modules are in the package."""
    from popnet_tpu_torch.cli.main import build_parser, main
    from popnet_tpu_torch.data.datasets import KDH3DDataset
    from popnet_tpu_torch.train.loop import Trainer

    args = build_parser().parse_args(["train", "--data-root", str(tmp_path)])
    assert args.device == "cuda" and args.model == "popnet" and args.batch_size == 32
    assert args.epochs == 100 and args.lr == 1.0 and args.optimizer == "sgd"
    assert inspect.signature(KDH3DDataset).parameters["device"].default == "cuda"
    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    assert {m for m in _port_modules() if m.startswith(("popnet_tpu_torch.train",
                                                        "popnet_tpu_torch.losses",
                                                        "popnet_tpu_torch.ops"))} >= {
        "popnet_tpu_torch.train.state", "popnet_tpu_torch.train.schedule",
        "popnet_tpu_torch.train.steps", "popnet_tpu_torch.train.checkpoint",
        "popnet_tpu_torch.train.loop", "popnet_tpu_torch.losses.losses",
        "popnet_tpu_torch.ops.encoders"}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--data-root", str(tmp_path), "--model", "yolo"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(YoloPoseNet(), None, None)
    with pytest.raises(FileNotFoundError):   # asked for the CPU, it goes on to read the labels
        main(["train", "--data-root", str(tmp_path), "--model", "yolo", "--device", "cpu"])


def test_itop_entry_points_default_to_cuda_and_never_run_on_cpu_unasked(tmp_path, monkeypatch):
    """`train --dataset itop` (each depth model), `evaluate --dataset itop`
    and the ITOP table default to the card; without one they raise unless
    the CPU is asked for (--device cpu, ITOP_CPU); the exact host decode
    (`run_openpose_eval(fast=False)`) takes the dataset's device, which
    defaults to the card."""
    from popnet_tpu_torch.cli import evaluate, itop_table
    from popnet_tpu_torch.cli.main import build_parser, main

    for cmd in ("train", "evaluate"):
        args = build_parser().parse_args([cmd, "--dataset", "itop", "--data-root", str(tmp_path)])
        assert args.device == "cuda" and args.dataset == "itop"
    assert inspect.signature(evaluate.run_openpose_eval).parameters["fast"].default is True
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for model in ("openpose", "popnet", "yolo", "a2j"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["train", "--dataset", "itop", "--model", model, "--data-root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["evaluate", "--dataset", "itop", "--model", "openpose", "--data-root",
              str(tmp_path)])
    monkeypatch.delenv("ITOP_CPU", raising=False)
    monkeypatch.setenv("ITOP_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        itop_table.main()
    with pytest.raises(FileNotFoundError):   # asked for the CPU, it goes on to read the labels
        main(["train", "--dataset", "itop", "--model", "a2j", "--data-root", str(tmp_path),
              "--device", "cpu"])


def test_table_entry_points_default_to_cuda_and_never_run_on_cpu_unasked(tmp_path,
                                                                         monkeypatch):
    """The four-method table and the readout ablation run on the card;
    without one they raise before they build anything unless the CPU is
    asked for (TABLE_CPU, ABL_CPU)."""
    from popnet_tpu_torch.cli import ablation_table, method_table

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for k in ("TABLE_CPU", "ABL_CPU"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TABLE_DIR", str(tmp_path / "t"))
    monkeypatch.setenv("ABL_DIR", str(tmp_path / "a"))
    for entry in (method_table.main, ablation_table.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert not (tmp_path / "t").exists() and not (tmp_path / "a").exists()


def test_int8_conv_takes_the_plain_version_on_the_cpu_and_refuses_other_devices():
    """int8_conv on CPU tensors is the plain version and counts no launch;
    on a device that is neither CPU nor CUDA it raises."""
    from popnet_tpu_torch.ops import quant

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(-127, 128, (1, 8, 5, 5)), dtype=torch.int8)
    w = torch.as_tensor(rng.integers(-127, 128, (16, 8, 3, 3)), dtype=torch.int8)
    quant.int8_conv.launches = 0
    got = quant.int8_conv(x, quant.weight_matrix(w), w, (1, 1), (1, 1), (1, 1))
    assert quant.int8_conv.launches == 0
    assert torch.equal(got, quant.int8_conv_plain(x, w, 1, 1, 1).permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="no kernel for meta"):
        quant.int8_conv(x.to("meta"), quant.weight_matrix(w), w, (1, 1), (1, 1), (1, 1))


def test_rgb_training_defaults_to_cuda_and_never_runs_on_cpu_unasked(tmp_path):
    """`train --dataset coco|mpii` and the two RGB datasets default to the
    card; without one they raise unless the CPU is asked for (--device
    cpu); the JPEG reader and the uint8 transforms build with the host C++
    compiler into the ignored build directory."""
    from popnet_tpu_torch.cli.main import main
    from popnet_tpu_torch.data.coco_dataset import CocoKeypointsDataset
    from popnet_tpu_torch.data.mpii import MPIIKeypointsDataset

    for cls in (CocoKeypointsDataset, MPIIKeypointsDataset):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert set(_build.HOST_SOURCES) == {"jpeg_decode", "jpeg_encode", "image_u8", "draw_u8"}
    for name in _build.HOST_SOURCES:
        assert (_build.CSRC / f"{name}.cpp").exists()
        assert _build._host_target(name).parent == _build.BUILD_DIR
    assert "-ffp-contract=off" in _build.CXX_FLAGS
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for dataset, model in (("coco", "rtpose_vgg"), ("mpii", "popnet_rgb")):
        argv = ["train", "--dataset", dataset, "--model", model, "--data-root", str(tmp_path)]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
        with pytest.raises(FileNotFoundError):   # asked for the CPU, it goes on to read the labels
            main([*argv, "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CocoKeypointsDataset(str(tmp_path), str(tmp_path / "x.json"))


def test_generate_augset_and_rgb_infer_default_to_cuda_and_never_run_on_cpu_unasked(
        tmp_path, monkeypatch):
    """`generate-augset` and `rgb_infer` default to the card; without one
    they raise unless the CPU is asked for (--device cpu, device="cpu").
    generate-augset composites and transforms on --device: its dataset lies
    there, the freeze takes the dataset's device route by default, and the
    freeze-time transforms get that composite as it lies."""
    from popnet_tpu_torch.cli.main import build_parser, main
    from popnet_tpu_torch.core.config import KDH3D_DATASET
    from popnet_tpu_torch.data import construction, preprocessing
    from tests import synthetic_data

    args = build_parser().parse_args(["generate-augset", "--kind", "bgaug", "--data-root",
                                      str(tmp_path)])
    assert args.device == "cuda" and not args.augment
    assert inspect.signature(preprocessing.rgb_infer).parameters["device"].default == "cuda"
    for fn in (construction._freeze, construction.generate_bgaug_set,
               construction.generate_mpaug_set):
        assert inspect.signature(fn).parameters["device"].default is True

    # _freeze: the device composite itself goes through the transforms
    composite = torch.zeros((4, 4))

    class Frames:
        dcfg, rng = KDH3D_DATASET, np.random.default_rng(0)

        def __len__(self):
            return 1

        def load_composited_device(self, index):
            return composite, []

        def load_composited(self, index):
            raise AssertionError("the default route composites on the dataset's device")

    seen = []
    monkeypatch.setattr(construction, "freeze_augment_pipeline",
                        lambda dcfg, rng: lambda sample: seen.append(sample[0]) or sample)
    construction.generate_bgaug_set(Frames(), str(tmp_path / "frozen"), augment=True)
    assert len(seen) == 1 and seen[0] is composite

    # the command line: the dataset on the card, the freeze on its default route
    data = str(tmp_path / "data")
    synthetic_data.build(data, n_images=2)
    calls = []
    for kind in ("bgaug", "mpaug"):
        monkeypatch.setattr(construction, f"generate_{kind}_set",
                            lambda ds, out, n, **kw: calls.append((ds.device, kw)) or {})
    argv = ["generate-augset", "--data-root", data, "--out-dir", str(tmp_path / "o")]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        for kind in ("bgaug", "mpaug"):
            main([*argv, "--kind", kind])
    assert calls == [(torch.device("cuda"), {"augment": False})] * 2
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = ["generate-augset", "--kind", "bgaug", "--data-root", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(FileNotFoundError):   # asked for the CPU, it goes on to read the labels
        main([*argv, "--device", "cpu"])


def test_parallel_entry_points_default_to_cuda_and_never_run_on_cpu_unasked(monkeypatch):
    """The launcher and the process groups default to the card: a job of
    ranks on a host without cards is refused before a rank starts, and a
    job of one rank raises; asked for the CPU, it runs over gloo."""
    import torch.distributed as dist

    from popnet_tpu_torch.parallel import distributed

    for fn in (distributed.initialize, distributed.single_rank_job, distributed.start,
               distributed.launch):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(SystemExit, match="needs 2 ranks, one a card, and this host has 0"):
            distributed.launch(int, 2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with distributed.single_rank_job():
            pass
    assert not dist.is_initialized()
    with distributed.single_rank_job("cpu"):
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert not dist.is_initialized()


def test_visualize_and_roi_default_to_cuda_and_never_run_on_cpu_unasked(tmp_path):
    """visualize-gt, visualize-pred and ROIDataset default to the card;
    without one they raise unless the CPU is asked for (--device cpu); the
    viewers and the checkpoint import are in the package."""
    from popnet_tpu_torch.cli.main import build_parser, main
    from popnet_tpu_torch.data.datasets import ROIDataset

    for cmd in (["visualize-gt"], ["visualize-pred", "--pred", str(tmp_path / "p.json")]):
        assert build_parser().parse_args([*cmd, "--data-root", str(tmp_path)]).device == "cuda"
    assert inspect.signature(ROIDataset).parameters["device"].default == "cuda"
    assert set(_port_modules()) >= {"popnet_tpu_torch.viz", "popnet_tpu_torch.viz.draw",
                                    "popnet_tpu_torch.viz.raster",
                                    "popnet_tpu_torch.interop.torch_import"}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for cmd in (["visualize-gt"], ["visualize-pred", "--pred", str(tmp_path / "p.json")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([*cmd, "--data-root", str(tmp_path)])
        with pytest.raises(FileNotFoundError):   # asked for the CPU, it goes on to read the labels
            main([*cmd, "--data-root", str(tmp_path), "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ROIDataset(str(tmp_path), str(tmp_path / "x.json"))
