"""Port vs JAX on dataset construction (`data.construction`, `generate-augset`),
on the CPU: the frozen bg-aug and mp-aug sets (plain and with the
freeze-time transforms) byte for byte, the device composite against the
host one, every converter's files byte for byte, and the command line."""

import json
import os

import numpy as np
import pytest
import torch

from popnet_tpu.cli.main import main as jax_main
from popnet_tpu.core.config import EncoderConfig as JaxEncoderConfig
from popnet_tpu.data import construction as jax_con
from popnet_tpu.data.datasets import KDH3DDataset as JaxKDH3DDataset
from popnet_tpu.data.datasets import KDH3DMPAugDataset as JaxKDH3DMPAugDataset
from popnet_tpu_torch.cli.main import main as port_main
from popnet_tpu_torch.core import camera
from popnet_tpu_torch.core.config import EncoderConfig
from popnet_tpu_torch.data import construction
from popnet_tpu_torch.data.datasets import KDH3DDataset, KDH3DMPAugDataset
from popnet_tpu.core import camera as jax_camera
from tests import synthetic_data


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return synthetic_data.build(str(tmp_path_factory.mktemp("src")), n_images=4, seed=3)


def tree_bytes(root: str) -> dict:
    """{relative path: file bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def assert_same_files(a: str, b: str, n_min: int = 2) -> None:
    fa, fb = tree_bytes(a), tree_bytes(b)
    assert sorted(fa) == sorted(fb) and len(fa) >= n_min
    for k in fa:
        assert fa[k] == fb[k], k


def _datasets(paths, kind, seed, device="cpu"):
    scene = dict(bg_file=paths["labels_bg"], bg_dir=paths["bg_dir"], seg_dir=paths["seg_dir"],
                 augment=False, seed=seed)
    if kind == "bgaug":
        jax_ds = JaxKDH3DDataset(paths["img_dir"], paths["labels"], bg_aug=True,
                                 ecfg=JaxEncoderConfig(max_people=6), is_train=False, **scene)
        port_ds = KDH3DDataset(paths["img_dir"], paths["labels"], bg_aug=True,
                               ecfg=EncoderConfig(max_people=6), device=device, **scene)
    else:
        jax_ds = JaxKDH3DMPAugDataset(paths["img_dir"], paths["labels_locs"],
                                      ecfg=JaxEncoderConfig(max_people=6), is_train=False, **scene)
        port_ds = KDH3DMPAugDataset(paths["img_dir"], paths["labels_locs"],
                                    ecfg=EncoderConfig(max_people=6), device=device, **scene)
    return jax_ds, port_ds


@pytest.mark.parametrize("kind", ["bgaug", "mpaug"])
@pytest.mark.parametrize("augment", [False, True])
def test_frozen_sets_equal_jax_byte_for_byte(paths, tmp_path, kind, augment):
    """generate_bgaug_set / generate_mpaug_set from one seed: every
    depth_maps/*.npy and labels_test.json equal JAX's byte for byte, with
    and without the freeze-time Rotate, RenderDepth and Resize."""
    jax_ds, port_ds = _datasets(paths, kind, seed=7)
    gen = {"bgaug": (jax_con.generate_bgaug_set, construction.generate_bgaug_set),
           "mpaug": (jax_con.generate_mpaug_set, construction.generate_mpaug_set)}[kind]
    ref = gen[0](jax_ds, str(tmp_path / "jax"), n_images=5, augment=augment)
    got = gen[1](port_ds, str(tmp_path / "port"), n_images=5, augment=augment)
    assert got == ref and len(got) == 5
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"), 6)
    assert port_ds.rng.bit_generator.state == jax_ds.rng.bit_generator.state


@pytest.mark.parametrize("kind", ["bgaug", "mpaug"])
def test_device_composite_equals_host_composite(paths, tmp_path, kind):
    """The device route (load_composited_device, a tensor on the dataset's
    device, here the CPU) writes the host route's bytes, plain and with the
    freeze-time transforms; KDH3DDataset's device composite equals its
    host one bit for bit."""
    for augment in (False, True):
        outs = []
        for device in (False, True):
            _, ds = _datasets(paths, kind, seed=11)
            out = str(tmp_path / f"{augment}_{device}")
            (construction.generate_bgaug_set if kind == "bgaug"
             else construction.generate_mpaug_set)(ds, out, n_images=4, device=device,
                                                   augment=augment)
            outs.append(out)
        assert_same_files(*outs, 5)
    if kind == "bgaug":
        _, ds = _datasets(paths, kind, seed=0)
        for i in range(len(ds)):
            d, a = ds.load_composited_device(i)
            h, b = ds.load_composited(i)
            assert isinstance(d, torch.Tensor) and a == b
            assert np.array_equal(d.numpy(), h) and d.dtype == torch.float32


def test_pose_weights_orientation_and_boxes_equal_jax():
    rng = np.random.default_rng(0)
    poses = rng.normal(0, 0.3, (1, 15, 3)) + rng.normal(0, 0.12, (40, 15, 3))
    poses[:, :, 2] += 3.0
    poses[3, 4] = np.nan                         # a pose with a missing joint is left out
    for got, ref in zip(construction.compute_pose_weights(poses.copy()),
                        jax_con.compute_pose_weights(poses.copy())):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        camera.approx_root_orientation(poses[:, 10], poses[:, 9], poses[:, 1]),
        jax_camera.approx_root_orientation(poses[:, 10], poses[:, 9], poses[:, 1]))
    j = rng.uniform(-20, 520, (15, 2))
    assert construction.compute_bbox_from_joints(j, 30, 512, 480) == \
        jax_con.compute_bbox_from_joints(j, 30, 512, 480)
    assert construction.KINECT_JOINT_SUBSET == jax_con.KINECT_JOINT_SUBSET
    assert construction.KINECT32_JOINT_NAMES == jax_con.KINECT32_JOINT_NAMES


def _raw_recordings(root, rng):
    """The raw single-person, background and multi-person recordings of
    tests/test_construction_viz.py, in root."""
    os.makedirs(root, exist_ok=True)
    n, h, w = 6, 64, 60
    kin_names = ["PELVIS", "SPINE_NAVAL", "NECK", "HEAD", "SHOULDER_LEFT", "SHOULDER_RIGHT",
                 "ELBOW_LEFT", "ELBOW_RIGHT", "WRIST_LEFT", "WRIST_RIGHT", "HIP_LEFT",
                 "HIP_RIGHT", "KNEE_LEFT", "KNEE_RIGHT", "ANKLE_LEFT", "ANKLE_RIGHT", "NOSE"]
    intr = {"fx": 504.1, "fy": 504.0, "cx": 231.7, "cy": 320.6}
    recs = []
    for r in range(2):
        depth = rng.uniform(500, 5500, (n, h, w)).astype(np.float32)
        seg = (rng.uniform(size=(n, h, w)) > 0.7).astype(np.float32)
        rec = os.path.join(root, f"rec{r}.npy")
        np.save(rec, depth)
        np.save(os.path.join(root, f"rec{r}_mask.npy"), seg)
        with open(os.path.join(root, f"rec{r}_label.json"), "w") as f:
            j3 = rng.normal(0, 300, (n, 17, 3)) + [0, 0, 3000]
            json.dump({"3D_joint_positions": j3.tolist(),
                       "2D_joint_positions": rng.uniform(0, 60, (n, 17, 2)).tolist(),
                       "bounding_boxes": np.tile([5.0, 5.0, 55.0, 55.0], (n, 1)).tolist(),
                       "joint_names": kin_names, "intrinsics": intr}, f)
        with open(os.path.join(root, f"rec{r}_drop.json"), "w") as f:
            json.dump({"drop_list": [r + 1]}, f)
        recs.append(rec)
    P = 2
    kin = list(construction.KINECT_JOINT_SUBSET) + ["NOSE"]
    mp = os.path.join(root, "mp0.npy")
    np.save(mp, rng.uniform(500, 5500, (3, 48, 40)).astype(np.float32))
    with open(os.path.join(root, "mp0_label.json"), "w") as f:
        j3 = rng.normal(0, 300, (3, P, 18, 3)) + [0, 0, 3000]
        json.dump({"3D_joint_positions": j3.tolist(),
                   "2D_joint_positions": rng.uniform(0, 40, (3, P, 18, 2)).tolist(),
                   "bounding_boxes": np.tile([1.0, 1.0, 39.0, 45.0], (3, P, 1)).tolist(),
                   "joint_names": kin, "intrinsics": intr}, f)
    return recs, mp


def _kinect_frames(rng):
    depth = rng.uniform(800, 4800, (2, 576, 640)).astype(np.float32)
    K = np.array([[504.0, 0, 331.7], [0, 504.0, 352.6], [0, 0, 1]])
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    T = np.array([12.0, -30.0, 5.0])
    joints = [[rng.normal(0, 250, (32, 3)) + [0, 0, 3000] for _ in range(2)] for _ in range(2)]
    return depth, joints, K, R, T


@pytest.mark.parametrize("converter", ["kdh3d", "bg", "kdh3d_mp", "kinect_mp", "filter"])
def test_converters_write_jax_bytes(tmp_path, converter):
    """Each converter on the recordings of tests/test_construction_viz.py
    writes the files JAX's writes, byte for byte, and returns what it
    returns."""
    rng = np.random.default_rng(5)
    recs, mp = _raw_recordings(str(tmp_path / "raw"), rng)
    outs = []
    for mod, tag in ((jax_con, "jax"), (construction, "port")):
        out = str(tmp_path / tag)
        if converter == "kdh3d":
            res = mod.convert_raw_kdh3d_recordings(recs, out, train_files=recs[:1])
        elif converter == "bg":
            res = mod.convert_raw_bg_recordings(recs, out)
        elif converter == "kdh3d_mp":
            res = mod.convert_raw_kdh3d_mp_recordings([mp], out)
        elif converter == "kinect_mp":
            res = mod.convert_kinect_raw_mp_frames(*_kinect_frames(np.random.default_rng(7)),
                                                   out)
        else:
            ref_dir = tmp_path / "vis"
            ref_dir.mkdir(exist_ok=True)
            (ref_dir / "00000002.jpg").write_bytes(b"x")
            labels = tmp_path / "labels_test.json"
            labels.write_text(json.dumps({"00000001.npy": [{"2d_joints": [[1.0, 2.0]]}],
                                          "00000002.npy": [{"2d_joints": [[3.0, 4.0]]}],
                                          "intrinsics": {"fx": 500.0}}))
            os.makedirs(out)
            res = mod.filter_labels_by_reference_dir(str(labels), str(ref_dir),
                                                     os.path.join(out, "refined.json"))
        outs.append((out, res))
    (a, ra), (b, rb) = outs
    assert_same_files(a, b, 1)
    if converter == "kdh3d":
        assert ra[0] == rb[0]
        np.testing.assert_array_equal(ra[1], rb[1])
        np.testing.assert_array_equal(ra[2], rb[2])
    else:
        assert ra == rb


def test_convert_itop_h5_writes_jax_bytes(tmp_path):
    """ITOP's h5 release -> per-frame .npy + labels_train.json, byte for
    byte; h5py is imported only inside the converter, and the test is
    skipped where it is absent."""
    h5py = pytest.importorskip("h5py", reason="convert_itop_h5 reads ITOP's h5 files with h5py")
    n, h, w = 5, 240, 320
    rng = np.random.default_rng(1)
    dpath, lpath = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    with h5py.File(dpath, "w") as f:
        f["data"] = rng.uniform(0, 5, (n, h, w)).astype(np.float32)
    with h5py.File(lpath, "w") as f:
        f["is_valid"] = np.array([1, 1, 0, 1, 1])
        f["image_coordinates"] = rng.uniform(40, 200, (n, 15, 2)).astype(np.float32)
        j3 = rng.normal(0, 0.3, (n, 15, 3)).astype(np.float32)
        j3[:, :, 2] += 3
        f["real_world_coordinates"] = j3
        f["id"] = np.array([f"00_{i:05d}".encode() for i in range(n)])
    ref = jax_con.convert_itop_h5(dpath, lpath, str(tmp_path / "jax"))
    got = construction.convert_itop_h5(dpath, lpath, str(tmp_path / "port"))
    assert got == ref and len(got) == 4
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"), 5)


@pytest.mark.parametrize("kind,extra", [("bgaug", []), ("mpaug", ["--augment"]),
                                        ("mpaug", ["--n-images", "3", "--device"])])
def test_generate_augset_equals_the_jax_command_line(paths, tmp_path, kind, extra):
    """`generate-augset --device cpu` of the port, which composites where
    --device says, against the JAX command line on tests/synthetic_data.py's
    layout, compositing on its host and, with its boolean --device, on its
    accelerator: the same files, byte for byte."""
    root = os.path.dirname(paths["img_dir"])
    jax_main(["generate-augset", "--kind", kind, "--data-root", root, "--seed", "4",
              "--out-dir", str(tmp_path / "jax"), *extra])
    port_extra = [a for a in extra if a != "--device"]
    labels = port_main(["generate-augset", "--kind", kind, "--data-root", root, "--seed", "4",
                        "--out-dir", str(tmp_path / "port"), "--device", "cpu", *port_extra])
    assert len(labels) == (3 if "--n-images" in extra else 4)
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"), 4)


@pytest.mark.parametrize("argv", [["--device"], ["--device", "--kind", "bgaug"],
                                  ["--kind", "bgaug", "--device"]])
def test_generate_augset_refuses_the_bare_device_flag(tmp_path, argv, capsys):
    """The JAX command line's boolean --device exits: here --device takes the
    torch device (cuda or cpu), and argparse refuses it without one; it is
    never read as a device or as another flag, and nothing is written."""
    base = ["--data-root", str(tmp_path), "--out-dir", str(tmp_path / "o")]
    if "--kind" not in argv:
        base += ["--kind", "mpaug"]
    with pytest.raises(SystemExit) as e:
        port_main(["generate-augset", *argv, *base])
    assert e.value.code == 2
    assert "argument --device: expected one argument" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")
