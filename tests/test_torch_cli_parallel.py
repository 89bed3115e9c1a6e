"""The parallel layouts through the port's command line, on the CPU: the five
tests of `tests/test_cli_parallel.py` through `popnet_tpu_torch.cli.main`
with `--device cpu` (the ranks are processes over gloo that the command
starts itself, two PyTorch threads each, as this process runs), at most
two ranks a job: data=1,model=2 where the JAX test has data=2,model=4
and data=1,spatial=2 where it has data=2,spatial=4; then the command
line's refusals and its "ignored" message for A2J. The commands run
at once, on threads (`runs`), and each test reads its own."""

import json
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from popnet_tpu_torch.cli import main as cli
from popnet_tpu_torch.cli.main import main as port_main

from tests import synthetic_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = {m: os.path.join(ROOT, "examples", "results", f"bench_weights_{m}.npz")
           for m in ("openpose", "yolo")}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process (and a rank): the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clip_ds"))
    synthetic_data.build(root, n_images=8, n_locations=2, seed=7)
    return root


def _history(out):
    with open(os.path.join(out, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def _train(data, out, *extra):
    return port_main(["train", "--model", "yolo", "--data-root", data, "--out-dir", out,
                      "--epochs", "1", "--batch-size", "4", "--input-size", "64",
                      "--device", "cpu", *extra])


def _pipelined_then_evaluate(data, out):
    port_main(["train", "--model", "openpose", "--data-root", data, "--out-dir", out,
               "--epochs", "1", "--batch-size", "4", "--input-size", "64", "--mesh",
               "data=1,pipe=2", "--n-micro", "2", "--lr", "0.05", "--device", "cpu"])
    pred = out + "_preds"
    port_main(["evaluate", "--model", "openpose", "--data-root", data, "--ckpt",
               os.path.join(out, "ckpt"), "--input-size", "64", "--batch-size", "4",
               "--out-dir", pred, "--device", "cpu"])
    return json.load(open(os.path.join(pred, "openpose_results.json")))


def _evaluate(data, out, model, *extra):
    size = {"yolo": "64", "openpose": "224"}[model]
    port_main(["evaluate", "--model", model, "--data-root", data, "--batch-size", "4",
               "--input-size", size, "--weights", WEIGHTS[model], "--out-dir", out,
               "--device", "cpu", *extra])
    return json.load(open(os.path.join(out, f"{model}_results.json")))


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Every command of the tests below, started at once on threads of this
    process (each launched job's ranks are processes of their own): name ->
    (out dir, future of the command's result)."""
    root = tmp_path_factory.mktemp("runs")
    cmds = {"tp": (_train, "--mesh", "data=1,model=2"),
            "sp": (_train, "--mesh", "data=1,spatial=2"),
            "pp": (_pipelined_then_evaluate,),
            "stream": (_train, "--mp-aug", "--stream-bank", "4")}
    for model in ("yolo", "openpose"):
        cmds[f"{model}_plain"] = (_evaluate, model)
        cmds[f"{model}_spatial"] = (_evaluate, model, "--spatial", "2")
    pool = ThreadPoolExecutor(len(cmds))
    out = {name: (str(root / name), pool.submit(fn, data, str(root / name), *extra))
           for name, (fn, *extra) in cmds.items()}
    yield out
    pool.shutdown()


def test_cli_train_tensor_parallel(runs):
    """train --mesh data=1,model=2: channel-sharded convs and moments (with
    a data axis too in tests/test_torch_parallel.py)."""
    out, run = runs["tp"]
    hist = run.result()
    h = _history(out)
    assert len(h) == 1 and np.isfinite(h[0]["train_loss"])
    assert [r["train_loss"] for r in hist] == [h[0]["train_loss"]]
    assert os.path.isdir(os.path.join(out, "ckpt"))


def test_cli_train_spatial(runs):
    """train --mesh data=1,spatial=2: the image's height in bands in the step
    (with a data axis too in tests/test_torch_parallel.py)."""
    out, run = runs["sp"]
    run.result()
    h = _history(out)
    assert len(h) == 1 and np.isfinite(h[0]["train_loss"])


def test_cli_train_pipelined_then_evaluate(runs):
    """train --model openpose --mesh data=1,pipe=2 saves a checkpoint in the
    sequential layout that evaluate --ckpt restores and scores."""
    out, run = runs["pp"]
    res = run.result()
    h = _history(out)
    assert len(h) == 1 and np.isfinite(h[0]["train_loss"])
    meta = json.load(open(os.path.join(out, "ckpt", "0", "metadata.json")))
    assert meta == {"pipelined": True, "n_pipe": 2}
    assert "human_pred_set_2d" in res


@pytest.mark.parametrize("model", ["yolo", "openpose"])
def test_cli_evaluate_spatial_matches_plain(runs, model):
    """evaluate --spatial 2 predicts what the plain path predicts (the
    committed weights: Open-Pose+ at 224 finds people on these frames,
    Yolo-Pose+ at 64 nobody, on both paths)."""
    a, b = runs[f"{model}_plain"][1].result(), runs[f"{model}_spatial"][1].result()
    assert (sum(len(p) for p in a["human_pred_set_2d"]) > 0) == (model == "openpose")
    for key in ("human_pred_set_2d", "human_pred_set_3d"):
        assert len(a[key]) == len(b[key])
        for ia, ib in zip(a[key], b[key]):
            np.testing.assert_allclose(np.asarray(ia, np.float64), np.asarray(ib, np.float64),
                                       atol=1e-4)


def test_cli_train_stream_bank(runs):
    """train --mp-aug --stream-bank N streams the scene bank in shards."""
    out, run = runs["stream"]
    run.result()
    h = _history(out)
    assert len(h) == 1 and np.isfinite(h[0]["train_loss"])


@pytest.mark.parametrize("argv,match", [
    (["train", "--mesh", "data=2,model"], "bad --mesh spec"),
    (["train", "--mesh", "data=1,model=2,pipe=2"], "data plus ONE of model"),
    (["train", "--mesh", "data=1,depth=2"], "unknown mesh axis 'depth'"),
    (["train", "--model", "yolo", "--mesh", "data=1,pipe=2"], "use --model openpose"),
    (["train", "--model", "openpose", "--mesh", "data=2,pipe=2", "--batch-size", "6"],
     r"batch 6 must divide data axis \(2\) x n_micro \(2\)"),
    (["evaluate", "--spatial", "3"], "--spatial 3 must divide --input-size 224"),
    (["evaluate", "--spatial", "2", "--quant", "int8"], "--spatial: the int8 convs"),
])
def test_cli_parallel_refusals(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        port_main([*argv, "--data-root", str(tmp_path), "--out-dir", str(tmp_path),
                   "--device", "cpu"])


def test_cli_refuses_more_ranks_than_cards(tmp_path):
    """On CUDA a rank takes a card: a mesh larger than the host's cards is refused."""
    cards = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"needs {cards + 1} ranks, one a card, and this host "
                                         f"has {cards} card"):
        port_main(["train", "--model", "yolo", "--mesh", f"data={cards + 1}", "--data-root",
                   str(tmp_path), "--out-dir", str(tmp_path)])


def test_cli_a2j_ignores_mesh_and_says_so(tmp_path, monkeypatch, capsys):
    """As the JAX command line, A2J trains on one device whatever --mesh says."""
    ran = []
    stub = types.SimpleNamespace(fit=lambda *a, **k: ran.append(k), resume=lambda: None)
    monkeypatch.setattr(cli, "_a2j_trainer", lambda args, ecfg, device: (stub, None, None))
    port_main(["train", "--model", "a2j", "--mesh", "data=2,model=2", "--data-root",
               str(tmp_path), "--out-dir", str(tmp_path), "--device", "cpu"])
    assert "--mesh is ignored" in capsys.readouterr().out and len(ran) == 1
