"""The port's four-method table and readout ablation
(popnet_tpu_torch.cli.method_table, cli.ablation_table) on the CPU at a tiny
budget, against the JAX package's table and ablation; and the committed
results of the card's runs (examples/results/method_table_torch.json,
ablation_channels_torch.json, ablation_channels_table_torch.json), pinned
as tests/test_method_table.py pins the JAX package's."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from popnet_tpu_torch.cli import ablation_table, method_table
from popnet_tpu_torch.interop.from_jax import load_into, load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "examples", "results")
WEIGHTS = os.path.join(RESULTS, "bench_weights_openpose.npz")
METRICS = ("pck2d", "pck3d", "map2d", "map3d")
CHANNELS = ("pose_depth", "raw_depth", "perfect_2d", "perfect_2d_visible",
            "perfect_2d_raw_depth")
CPU = torch.device("cpu")
# 4 training and 2 validation scenes, one step a dense row, A2J at batch 1
TINY = {"TABLE_CPU": "1", "TABLE_TRAIN": "4", "TABLE_VAL": "2", "TABLE_EPOCHS": "1",
        "TABLE_A2J_EPOCHS": "1", "TABLE_BATCH": "4", "TABLE_A2J_BATCH": "1"}


def load(name):
    with open(os.path.join(RESULTS, name)) as f:
        return json.load(f)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The tiny table's three sets (train/, val/, val_frozen/), made once."""
    work = tmp_path_factory.mktemp("table_sets")
    method_table.prepare_sets(str(work), 4, 2, CPU)
    return work


def run_table(monkeypatch, work, sets, **env) -> dict:
    """method_table.main() on the CPU at TINY (and `env`) in `work`, a copy
    of the prepared sets."""
    if not work.exists():
        shutil.copytree(sets, work)
    for k in [k for k in os.environ if k.startswith("TABLE_")]:
        monkeypatch.delenv(k)
    for k, v in {**TINY, **env, "TABLE_DIR": str(work),
                 "TABLE_OUT": str(work / "table.json")}.items():
        monkeypatch.setenv(k, v)
    return method_table.main()


def test_tiny_table_has_the_jax_keys_and_writes_weights_both_packages_read(monkeypatch,
                                                                           tmp_path, sets):
    """All four rows train and score on the CPU; the JSON carries the JAX
    table's keys (and the port's `device` and the budget's `a2j_batch`), at
    the top, in the budget, in each row, curve point and metrics; every row
    is done. Each row's weights are float16 under the Flax names the JAX
    package wrote for the committed weights, and both packages load them."""
    from popnet_tpu.serving import variables_from_npz

    from popnet_tpu_torch.models import A2J

    out = run_table(monkeypatch, tmp_path / "t", sets)
    jax = load("method_table.json")
    with open(tmp_path / "t" / "table.json") as f:
        assert json.load(f) == out
    assert set(out) == set(jax) | {"device"} and out["device"] == {"platform": "cpu"}
    assert set(out["budget"]) == set(jax["budget"]) | {"a2j_batch"}
    assert out["budget"]["steps_per_epoch"] == 1 and out["budget"]["val_images"] == 2
    assert sorted(out["methods"]) == sorted(jax["methods"])
    for name, rec in out["methods"].items():
        ref = jax["methods"][name]
        assert set(rec) == set(ref), name
        assert rec["done"] and rec["steps"] == (4 if name == "yolo_a2j" else 1)
        assert set(rec["curve"][0]) == set(ref["curve"][0])
        assert set(rec["final"]) == set(ref["final"]) == set(METRICS)
        assert all(0.0 <= v <= 1.0 for v in rec["final"].values())
    for row in ("yolo", "openpose", "popnet"):
        got = np.load(str(tmp_path / "t" / f"table_weights_{row}.npz"))
        ref = np.load(os.path.join(RESULTS, f"bench_weights_{row}.npz"))
        assert sorted(got) == sorted(ref), row
        assert all(got[k].shape == ref[k].shape and got[k].dtype == np.float16 for k in got)
        variables_from_npz(str(tmp_path / "t" / f"table_weights_{row}.npz"))
    load_into(A2J(), load_npz(str(tmp_path / "t" / "table_weights_a2j.npz")))


def test_two_chunked_calls_give_the_json_of_one_call(monkeypatch, tmp_path, sets):
    """Open-Pose+ over 2 chunks of one epoch: in one call, and in two calls
    of one chunk each (TABLE_CHUNKS=1), the second resuming from the first's
    checkpoint. After the first call the row is in progress (`latest`, no
    `final`); in the end the two JSONs are equal but for the wall clock,
    and so are the weights."""
    env = dict(TABLE_METHODS="openpose", TABLE_EPOCHS="2", TABLE_CHUNK="1")
    one = run_table(monkeypatch, tmp_path / "one", sets, **env)
    half = run_table(monkeypatch, tmp_path / "two", sets, TABLE_CHUNKS="1", **env)
    rec = half["methods"]["openpose"]
    assert "latest" in rec and "final" not in rec and not rec.get("done")
    two = run_table(monkeypatch, tmp_path / "two", sets, TABLE_CHUNKS="1", **env)

    def strip(out):
        for p in out["methods"]["openpose"]["curve"]:
            p.pop("wall_s")
        return out

    assert strip(one) == strip(two) and len(one["methods"]["openpose"]["curve"]) == 2
    a = load_npz(str(tmp_path / "one" / "table_weights_openpose.npz"))
    b = load_npz(str(tmp_path / "two" / "table_weights_openpose.npz"))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_ablation_channels_match_jax_on_the_committed_weights(sets):
    """The ablation of the committed Open-Pose+ weights on the table's
    frozen frames: the four metrics and the five pck3d channels within 1e-3
    of the JAX package's `evaluate_ablation_channels` over its driver
    (device decode) on the same frames."""
    import jax

    from popnet_tpu.cli import evaluate as jev
    from popnet_tpu.core.config import DecodeConfig, EncoderConfig
    from popnet_tpu.data.datasets import MPRealDataset
    from popnet_tpu.models import RTPoseLight3D
    from popnet_tpu.serving import variables_from_npz

    frozen = os.path.join(str(sets), "val_frozen")
    got = ablation_table.ablation(WEIGHTS, method_table.frozen_dataset(frozen, CPU))
    ds = MPRealDataset(os.path.join(frozen, "depth_maps"),
                       os.path.join(frozen, "labels_test.json"), ecfg=EncoderConfig())
    model, v = RTPoseLight3D(), variables_from_npz(WEIGHTS)
    infer = jax.jit(lambda x: model.apply(v, x, train=False)[0])
    data = jev.run_openpose_eval(infer, ds, 16, EncoderConfig(), DecodeConfig(),
                                 device_decode=True)
    ref_main = jev.evaluate_eval_data(data, verbose=False)
    ref_ch = jev.evaluate_ablation_channels(data)
    for k in METRICS:
        assert abs(got["main"][k] - ref_main[k]) <= 1e-3, (k, got, ref_main)
    for k in CHANNELS:
        assert abs(got["pck3d_channels"][k] - ref_ch[k]) <= 1e-3, (k, got, ref_ch)
    assert got["main"]["pck2d"] > 0.5


def test_smoke_table_sets_hash_to_the_pinned_constant(tmp_path):
    """chip_smoke.py phase 14 holds its validation and frozen trees against
    TABLE_SMOKE_SHA256: the port's scene generator and `generate-augset` on the CPU
    write those bytes."""
    _, val, frozen = method_table.prepare_sets(str(tmp_path), 0,
                                               int(chip_smoke.TABLE_SMOKE["TABLE_VAL"]), CPU)
    assert chip_smoke.tree_sha256(val, frozen) == chip_smoke.TABLE_SMOKE_SHA256


# -- the committed results of the card --------------------------------------------------------


def test_committed_table_budget_is_the_jax_budget():
    """examples/results/method_table_torch.json ran at the JAX table's
    budget: 512 training scenes of seed 0, 64 frozen frames of seed 777,
    312 epochs (4,992 steps) for the dense rows and 156 (2,496) for A2J."""
    b, jb = load("method_table_torch.json")["budget"], load("method_table.json")["budget"]
    assert {k: b[k] for k in jb} == jb
    assert b["train_seed"] != b["val_seed"] and b["a2j_batch"] == b["batch"] == 32
    assert b["epochs"] * b["steps_per_epoch"] == 4992
    assert method_table.DEFAULT_OUT == os.path.join(RESULTS, "method_table_torch.json")
    assert ablation_table.DEFAULT_OUT == os.path.join(RESULTS, "ablation_channels_torch.json")
    for name in ("method_table.json", "ablation_channels.json"):
        assert "device" not in load(name), name     # the JAX package's files, never overwritten


def test_committed_table_rows_curves_and_floors():
    """Every row: `final` exactly when `done`, metrics in [0, 1], a curve of
    monotone steps at 16 a epoch. The three dense rows are done, and each
    done row clears pck2d 0.90 and pck3d the JAX package's committed value
    less 0.10."""
    art, jax = load("method_table_torch.json"), load("method_table.json")
    assert sorted(art["methods"]) == sorted(jax["methods"])
    for name, rec in art["methods"].items():
        assert ("final" in rec) == bool(rec.get("done")), name
        m = rec.get("final") or rec["latest"]
        assert all(0.0 <= m[k] <= 1.0 for k in METRICS), (name, m)
        steps = [p["step"] for p in rec["curve"]]
        assert steps == sorted(steps) and steps[-1] == rec["steps"], name
        assert all(p["step"] == 16 * p["epoch"] for p in rec["curve"]), name
        if rec.get("done"):
            assert rec["steps"] == (2496 if name == "yolo_a2j" else 4992), name
            assert m["pck2d"] >= 0.90, (name, m)
            assert m["pck3d"] >= jax["methods"][name]["final"]["pck3d"] - 0.10, (name, m)
    for name in ("yolo", "openpose", "popnet"):
        assert art["methods"][name].get("done"), name
    pop = art["methods"]["popnet"]
    assert pop["trained_here"] and pop["readout"] == "universe"


def test_committed_ablations_match_jax_and_name_the_card():
    """The ablation of bench_weights_openpose.npz on the card lies within
    0.01 of the JAX package's ablation_channels.json on each metric and
    channel; the run on the table's own Open-Pose+ weights stands beside it;
    all three files name the card with its power limit."""
    got, ref = load("ablation_channels_torch.json"), load("ablation_channels.json")
    assert got["weights"] == ref["weights"] and got["val_images"] == ref["val_images"] == 64
    for k in METRICS:
        assert abs(got["main"][k] - ref["main"][k]) <= 0.01, (k, got["main"], ref["main"])
    for k in CHANNELS:
        assert abs(got["pck3d_channels"][k] - ref["pck3d_channels"][k]) <= 0.01, k
    own = load("ablation_channels_table_torch.json")
    assert own["weights"].endswith("table_weights_openpose.npz") and own["val_images"] == 64
    assert all(0.0 <= own["pck3d_channels"][k] <= 1.0 for k in CHANNELS)
    for art in (got, own, load("method_table_torch.json")):
        d = art["device"]
        assert d["platform"] == "gpu" and "H100" in d["nvidia_smi"] and "W" in d["nvidia_smi"]
