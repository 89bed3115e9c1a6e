"""The port's synthetic-generalization run (popnet_tpu_torch.cli.syngen) on
the CPU, against the JAX package's scripts/syngen.py: its recipe and
per-epoch learning rates, the frozen set's bytes, a curve point's score
given the same weights, the chunked resume and the JSON's keys at a tiny
budget, the method table's citation of the run; and the committed result
of the card's run (examples/results/syngen_torch.json), held to the floors
that tests/test_syngen.py holds the JAX package's run to."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from popnet_tpu_torch.cli import method_table, syngen
from popnet_tpu_torch.cli.tables import Table
from popnet_tpu_torch.train.schedule import WarmupCosine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "examples", "results")
WEIGHTS = os.path.join(RESULTS, "bench_weights_popnet.npz")
CPU = torch.device("cpu")
# 4 training scenes, 2 validation ones, one step an epoch
TINY = {"SYNGEN_CPU": "1", "SYNGEN_TRAIN": "4", "SYNGEN_VAL": "2", "SYNGEN_EPOCHS": "2",
        "SYNGEN_CHUNK": "1", "SYNGEN_BATCH": "4", "SYNGEN_WARMUP": "1", "SYNGEN_VAL_EVERY": "1"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The Trainer's scalars go nowhere here: torch.utils.tensorboard is
    made unimportable (the Trainer's `try`), which keeps its slow import
    out of these tests."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def jax_defaults() -> dict:
    """{SYNGEN_* variable: default} as scripts/syngen.py reads them."""
    with open(os.path.join(ROOT, "scripts", "syngen.py")) as f:
        src = f.read()
    return dict(re.findall(r'os\.environ\.get\("(SYNGEN_[A-Z_]+)", "([^"]*)"\)', src))


def test_recipe_and_learning_rates_equal_the_jax_script():
    """The port's SYNGEN_* defaults are the JAX script's (its output name
    and run directory aside), and so the recipe: 512 scenes at batch 32, 16
    steps an epoch, 1250 epochs (20,000 steps), Adam 1e-3, warmup 30 +
    cosine; the learning rate of every epoch from WarmupCosine equals JAX's
    schedule's."""
    from popnet_tpu.train.schedule import WarmupCosine as JaxWarmupCosine

    jax = jax_defaults()
    ported = {name: default for name, (_, default, _) in syngen.ENV.items()}
    assert {k: v for k, v in jax.items() if k not in ("SYNGEN_OUT", "SYNGEN_RUN")} == ported
    assert jax["SYNGEN_OUT"] == "syngen_r3.json"
    assert os.path.basename(syngen.DEFAULT_OUT) == "syngen_torch.json"
    s = syngen.settings({})
    r = syngen.recipe(s, 64)
    committed = json.load(open(os.path.join(RESULTS, "syngen_r3.json")))
    assert set(r) == {k for k in committed if k not in ("curve", "gated", "universe")}
    assert r["steps_per_epoch"] == 16 and r["epochs"] * r["steps_per_epoch"] == 20000
    assert (r["optimizer"], r["schedule"], r["train_seed"], r["val_seed"]) == (
        "adam", "warmup(30)+cosine", 0, 777)
    ours = WarmupCosine(s["lr"], total_epochs=s["epochs"], warmup_epochs=s["warmup"])
    ref = JaxWarmupCosine(s["lr"], total_epochs=s["epochs"], warmup_epochs=s["warmup"])
    assert ours.initial_lr == ref.initial_lr
    for e in range(s["epochs"] + 3):
        assert ours.step(0.1) == ref.step(0.1), e


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The tiny run's three sets (train/, val/, val_frozen/), made once."""
    work = tmp_path_factory.mktemp("syngen_sets")
    method_table.prepare_sets(str(work), 4, 2, CPU)
    return work


def test_frozen_set_equals_the_jax_scripts(sets, tmp_path):
    """The validation scenes (seed 777) and their frozen mp-aug set
    (`generate-augset --kind mpaug --seed 777`) byte for byte as the JAX
    script writes them (tests/synthetic_data.build and the JAX command
    line)."""
    import chip_smoke
    from popnet_tpu.cli.main import main as jax_main

    from tests import synthetic_data

    val = tmp_path / "val"
    synthetic_data.build(str(val), n_images=2, n_locations=5, seed=777)
    jax_main(["generate-augset", "--kind", "mpaug", "--data-root", str(val),
              "--out-dir", str(tmp_path / "val_frozen"), "--seed", "777"])
    assert chip_smoke.tree_sha256(str(val), str(tmp_path / "val_frozen")) == \
        chip_smoke.tree_sha256(str(sets / "val"), str(sets / "val_frozen"))


def test_score_equals_the_jax_scripts_on_the_same_weights(tmp_path):
    """A curve point's score: the committed PoP-Net weights on a frozen set
    of 8 frames, the port's `syngen.score` (run_popnet_eval at batch 16,
    both readouts, rounded to 4 places) against the JAX script's `score`
    (its run_popnet_eval + evaluate_eval_data on the Flax model), equal."""
    import jax

    from popnet_tpu.cli import evaluate as jev
    from popnet_tpu.core.config import DecodeConfig, EncoderConfig
    from popnet_tpu.data.datasets import MPRealDataset
    from popnet_tpu.models import PopNet as JaxPopNet
    from popnet_tpu.serving import variables_from_npz

    from popnet_tpu_torch.interop.from_jax import load_into, load_npz
    from popnet_tpu_torch.models import PopNet

    _, _, frozen = method_table.prepare_sets(str(tmp_path), 0, 8, CPU)
    net = load_into(PopNet(), load_npz(WEIGHTS)).eval()
    with torch.inference_mode():
        got = syngen.score(net, method_table.frozen_dataset(frozen, CPU))
    ds = MPRealDataset(os.path.join(frozen, "depth_maps"),
                       os.path.join(frozen, "labels_test.json"), ecfg=EncoderConfig())
    assert len(ds) == 8
    model, v = JaxPopNet(), variables_from_npz(WEIGHTS)
    infer = jax.jit(lambda x: model.apply(v, x, train=False)[0])
    ref = {}
    for readout in ("gated", "universe"):
        m = jev.evaluate_eval_data(jev.run_popnet_eval(infer, ds, 16, EncoderConfig(),
                                                       DecodeConfig(), readout=readout),
                                   verbose=False)
        ref[readout] = {k: round(float(x), 4) for k, x in m.items() if not k.startswith("per_")}
    assert got == ref
    assert got["universe"]["pck2d"] > 0.5


def run_syngen(monkeypatch, work, sets, **env) -> dict:
    """syngen.main() on the CPU at TINY (and `env`) in `work`, a copy of the
    prepared sets."""
    if not work.exists():
        shutil.copytree(sets, work)
    for k in [k for k in os.environ if k.startswith("SYNGEN_")]:
        monkeypatch.delenv(k)
    for k, v in {**TINY, **env, "SYNGEN_DIR": str(work),
                 "SYNGEN_OUT": str(work / "syngen.json")}.items():
        monkeypatch.setenv(k, v)
    return syngen.main()


def test_two_chunked_calls_give_the_json_of_one_call(monkeypatch, tmp_path, sets):
    """Two epochs in one call, and in two calls of one chunk each
    (SYNGEN_CHUNKS=1), the second resuming from the first's checkpoint: the
    JSONs equal but for the wall clock, with the JAX script's keys at the
    top and in each curve point (and the port's `device` and `done`), both
    readouts' metrics in [0, 1]; the trained weights equal. A call at
    another recipe on the same run directory is refused."""
    one = run_syngen(monkeypatch, tmp_path / "one", sets)
    half = run_syngen(monkeypatch, tmp_path / "two", sets, SYNGEN_CHUNKS="1")
    assert len(half["curve"]) == 1 and not half["done"]
    two = run_syngen(monkeypatch, tmp_path / "two", sets, SYNGEN_CHUNKS="1")
    committed = json.load(open(os.path.join(RESULTS, "syngen_r3.json")))
    assert set(one) == set(committed) | {"device", "done"} and one["device"] == {"platform": "cpu"}
    assert one["done"] and two["done"] and len(one["curve"]) == 2
    assert [p["step"] for p in one["curve"]] == [1, 2]
    for p in one["curve"]:
        assert set(p) == set(committed["curve"][0])
        assert all(0.0 <= x <= 1.0 for r in ("gated", "universe") for x in p[r].values())
    assert one["gated"] == one["curve"][-1]["gated"]

    def strip(out):
        for p in out["curve"]:
            p.pop("wall_s")
        return out

    assert strip(one) == strip(two)
    a = torch.load(sorted((tmp_path / "one" / "run" / "ckpt").glob("*/state.pt"))[-1])["model"]
    b = torch.load(sorted((tmp_path / "two" / "run" / "ckpt").glob("*/state.pt"))[-1])["model"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(SystemExit, match="another recipe"):
        run_syngen(monkeypatch, tmp_path / "two", sets, SYNGEN_EPOCHS="3")


def test_entry_point_defaults_to_cuda_and_never_runs_on_cpu_unasked(tmp_path, monkeypatch):
    """Without SYNGEN_CPU the run needs a card; without one it raises before
    it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.delenv("SYNGEN_CPU", raising=False)
    monkeypatch.setenv("SYNGEN_DIR", str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        syngen.main()
    assert not (tmp_path / "s").exists()


def test_method_table_cites_the_syngen_run_only_when_popnet_is_not_trained(tmp_path):
    """With `popnet` left out of TABLE_METHODS, the table's PoP-Net row cites
    the syngen run's last curve point within its budget (universe readout),
    as the JAX script cites syngen_r3.json; with `popnet` trained, or a row
    trained here already, or no point within the budget, nothing is cited."""
    syn = {"curve": [{"step": s, "universe": {"pck2d": s / 1e4}, "gated": {}}
                     for s in (2000, 4000, 6000)], "universe": {"pck2d": 0.9}}
    path = tmp_path / "syngen_torch.json"
    path.write_text(json.dumps(syn))

    def table():
        return Table(str(tmp_path / "t.json"), {"epochs": 312}, CPU, "table")

    t = table()
    method_table.cite_syngen(t, ["yolo", "openpose"], 4992, str(path))
    row = t.methods["popnet"]
    assert row["steps"] == 4000 and row["final"] == {"pck2d": 0.4}
    assert row["full_budget_steps"] == 6000 and row["full_budget_final"] == {"pck2d": 0.9}
    assert row["readout"] == "universe" and "syngen_torch.json curve @ step 4000" in row["source"]
    assert json.load(open(tmp_path / "t.json"))["methods"]["popnet"] == row
    for methods, steps in ((["popnet"], 4992), (["yolo"], 1000)):
        t = Table(str(tmp_path / "u.json"), {"epochs": 1}, CPU, "table")
        method_table.cite_syngen(t, methods, steps, str(path))
        assert "popnet" not in t.methods
    t = table()
    t.methods["popnet"] = {"trained_here": True}
    method_table.cite_syngen(t, ["yolo"], 4992, str(path))
    assert t.methods["popnet"] == {"trained_here": True}
    assert method_table.SYNGEN == syngen.DEFAULT_OUT


# -- the committed result of the card ------------------------------------------------------


def test_committed_run_clears_the_jax_floors_and_names_its_card():
    """examples/results/syngen_torch.json ran at the JAX script's default
    budget (20,000 steps), is done, clears tests/test_syngen.py's FLOORS
    under both readouts, keeps universe.map3d >= gated.map3d, and names the
    card with its power limit; its curve's steps rise by a chunk each."""
    from tests.test_syngen import FLOORS

    s = json.load(open(os.path.join(RESULTS, "syngen_torch.json")))
    assert s == {**s, **syngen.recipe(syngen.settings({}), 64)}
    assert s["done"] and s["curve"][-1]["step"] == 20000
    assert [p["step"] for p in s["curve"]] == [2000 * (i + 1) for i in range(10)]
    assert s["gated"] == s["curve"][-1]["gated"] and s["universe"] == s["curve"][-1]["universe"]
    for readout, floors in FLOORS.items():
        for k, floor in floors.items():
            assert s[readout][k] >= floor, (readout, k, s[readout][k], floor)
    assert s["universe"]["map3d"] >= s["gated"]["map3d"]
    d = s["device"]
    assert d["platform"] == "gpu" and "H100" in d["name"]
    assert re.search(r"H100.*, \d+\.\d+ W", d["nvidia_smi"]), d
    assert np.isfinite([p["train_loss"] for p in s["curve"]]).all()
