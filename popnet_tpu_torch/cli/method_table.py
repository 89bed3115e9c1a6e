"""The four-method table: four method families trained from scratch on one
synthetic mp-aug training set and scored through their whole inference,
decode and evaluation pipelines on a frozen validation set of another seed
(generalization, not memorization), by the four best-match metrics.

- yolo      Yolo-Pose+: YoloPoseNet -> the prior decode -> `run_yolo_eval`;
- openpose  Open-Pose+: RTPoseLight3D -> the decode on the device (K1, K3,
            K6, the fused K4 + K5) -> `run_openpose_eval(device_decode=True)`;
- popnet    PoP-Net: PopNet -> the universe readout (K7) ->
            `run_popnet_eval(readout="universe")`;
- yolo_a2j  Yolo->A2J: the table's own trained Yolo-Pose+ as the detector
            -> A2J's person crops -> the anchor vote -> `run_yolo_a2j_eval`.

Data: the training set is `data.synthetic.build(..., n_locations=5,
seed=0)`, the validation set the same at seed 777, and the frozen set its
mp-aug composite frozen by the port's `generate-augset --kind mpaug --seed
777` (the bytes of the JAX package's). The dense rows train on the device
bank (`DeviceMPAugDataset`, uint16-millimetre transfer, cached frames);
A2J trains on `A2JCropDataset` over the host composite
(`KDH3DMPAugDataset`), since its recipe augments each person before the
crop.

Recipes, those of the JAX package's `scripts/method_table.py`: the dense
rows Adam at TABLE_LR with a warmup-cosine schedule, A2J with its depth
head at the dataset's depth prior and Adam 3.5e-4 with L2 1e-4 on the same
schedule; every row scored at batch 16. The JAX script may cite PoP-Net's
row from its syngen run instead of training it; the port has no syngen run
to cite, and the JAX package's committed PoP-Net row was itself trained by
the table, so here all four rows train (`cli/tables.py` holds the
resumable JSON and the chunked training).

    python -m popnet_tpu_torch.cli.method_table

Env: TABLE_METHODS=yolo,openpose,popnet,yolo_a2j TABLE_TRAIN=512
TABLE_VAL=64 TABLE_EPOCHS=312 TABLE_A2J_EPOCHS=156 (the budget of the JAX
package's examples/results/method_table.json: 4,992 and 2,496 steps)
TABLE_CHUNK=78 TABLE_CHUNKS (the most chunks a row trains in this call;
default all, and a later call resumes) TABLE_BATCH=32 TABLE_A2J_BATCH
(default TABLE_BATCH)
TABLE_LR=1e-3 TABLE_WARMUP=30 TABLE_DIR=<workdir> TABLE_OUT=<json path>
(default examples/results/method_table_torch.json) TABLE_CPU=1 (run on
the CPU). Each trained row's weights go to TABLE_DIR as
table_weights_<row>.npz in float16 under Flax names, which both packages'
`evaluate --weights` read.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from popnet_tpu_torch.cli.tables import Table, metrics
from popnet_tpu_torch.data.synthetic import build

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "examples", "results", "method_table_torch.json")
METHODS = ("yolo", "openpose", "popnet", "yolo_a2j")
SCORE_BATCH = 16


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def save_weights(model: torch.nn.Module, path: str) -> None:
    """`model`'s variables as float16 under Flax names, the keys and values
    of the JAX package's `variables_to_npz` of its float16-cast variables;
    stored, not deflated (trained weights hardly compress)."""
    from popnet_tpu_torch.interop.from_jax import flat_from_module

    np.savez(path, **{k: v.astype(np.float16) for k, v in flat_from_module(model).items()})


def infer_fn(family: str, net: torch.nn.Module):
    """infer(images or crops NHWC) -> the maps (heads) `family`'s driver
    takes, from `net` in eval mode."""
    if family == "openpose":
        def infer(images):
            (paf, heat, z), _ = net(_nchw(images))
            return _nhwc(paf), _nhwc(heat), _nhwc(z)
    elif family == "popnet":
        def infer(images):
            maps, _ = net(_nchw(images))
            return tuple(_nhwc(t) for t in maps)
    elif family == "yolo":
        def infer(images):
            return _nhwc(net(_nchw(images)))
    else:
        def infer(crops):
            return net(_nchw(crops))
    return infer


def prepare_sets(work: str, n_train: int, n_val: int, device: torch.device) -> tuple:
    """The table's three sets under `work` (made once, reused after):
    train/ (seed 0; none where `n_train` is 0), val/ (seed 777) and
    val_frozen/, the frozen mp-aug composite of val/ by `generate-augset
    --seed 777` on `device`. Returns (train_root, val_root, frozen_root)."""
    from popnet_tpu_torch.cli.main import main as cli

    train_root, val_root = os.path.join(work, "train"), os.path.join(work, "val")
    frozen = os.path.join(work, "val_frozen")
    if n_train and not os.path.exists(os.path.join(train_root, "labels_loc4.json")):
        build(train_root, n_images=n_train, n_locations=5, seed=0)
    if not os.path.exists(os.path.join(val_root, "labels_loc4.json")):
        build(val_root, n_images=n_val, n_locations=5, seed=777)
    if not os.path.exists(os.path.join(frozen, "labels_test.json")):
        cli(["generate-augset", "--kind", "mpaug", "--data-root", val_root, "--out-dir", frozen,
             "--seed", "777", "--device", str(device)])
    return train_root, val_root, frozen


def frozen_dataset(frozen: str, device: torch.device):
    from popnet_tpu_torch.core.config import EncoderConfig
    from popnet_tpu_torch.data.datasets import MPRealDataset

    return MPRealDataset(os.path.join(frozen, "depth_maps"),
                         os.path.join(frozen, "labels_test.json"), ecfg=EncoderConfig(),
                         device=device)


def main() -> dict:
    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.cli.yolo_a2j import run_yolo_a2j_eval
    from popnet_tpu_torch.core.config import KDH3D_DATASET, DecodeConfig, EncoderConfig
    from popnet_tpu_torch.core.device import resolve_device
    from popnet_tpu_torch.data.a2j_crops import CROP, A2JCropDataset
    from popnet_tpu_torch.data.datasets import (DeviceMPAugDataset, KDH3DDataset,
                                                KDH3DMPAugDataset)
    from popnet_tpu_torch.interop.from_jax import load_into, load_npz
    from popnet_tpu_torch.models import A2J, PopNet, RTPoseLight3D, YoloPoseNet
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors
    from popnet_tpu_torch.train import steps
    from popnet_tpu_torch.train.loop import Trainer
    from popnet_tpu_torch.train.schedule import WarmupCosine

    env = os.environ
    out_path = env.get("TABLE_OUT", DEFAULT_OUT)
    device = resolve_device("cpu" if env.get("TABLE_CPU") else "cuda")
    methods = env.get("TABLE_METHODS", ",".join(METHODS)).split(",")
    unknown = sorted(set(methods) - set(METHODS))
    if unknown:
        raise SystemExit(f"TABLE_METHODS: unknown rows {unknown}; the rows are {METHODS}")
    n_train = int(env.get("TABLE_TRAIN", "512"))
    n_val = int(env.get("TABLE_VAL", "64"))
    epochs = int(env.get("TABLE_EPOCHS", "312"))
    a2j_epochs = int(env.get("TABLE_A2J_EPOCHS", "156"))
    chunk = int(env.get("TABLE_CHUNK", "78"))
    max_chunks = int(env["TABLE_CHUNKS"]) if env.get("TABLE_CHUNKS") else None
    batch = int(env.get("TABLE_BATCH", "32"))
    a2j_batch = int(env.get("TABLE_A2J_BATCH", str(batch)))
    lr = float(env.get("TABLE_LR", "1e-3"))
    warmup = int(env.get("TABLE_WARMUP", "30"))

    work = env.get("TABLE_DIR") or tempfile.mkdtemp(prefix="mtable_")
    print(f"[table] workdir {work} on {device}", flush=True)
    train_root, val_root, frozen = prepare_sets(work, n_train, n_val, device)
    ecfg, dcfg = EncoderConfig(), DecodeConfig()
    frozen_ds = frozen_dataset(frozen, device)
    ann_files = sorted(os.path.join(train_root, f) for f in os.listdir(train_root)
                       if f.startswith("labels_loc") and f.endswith(".json"))

    def mp_train_ds(pose_align, with_prior, device_bank=True):
        cls = DeviceMPAugDataset if device_bank else KDH3DMPAugDataset
        return cls(os.path.join(train_root, "depth_maps"), ann_files,
                   bg_file=os.path.join(train_root, "labels_bg.json"),
                   bg_dir=os.path.join(train_root, "bg_maps"),
                   seg_dir=os.path.join(train_root, "seg_maps"), seed=0, ecfg=ecfg,
                   dcfg=KDH3D_DATASET, pose_align=pose_align, with_prior=with_prior,
                   transfer="u16mm", cache_images=True, device=device)

    def val_loss_ds(pose_align, with_prior):
        return KDH3DDataset(os.path.join(val_root, "depth_maps"),
                            os.path.join(val_root, "labels.json"), seed=1, ecfg=ecfg,
                            dcfg=KDH3D_DATASET, pose_align=pose_align, with_prior=with_prior,
                            augment=False, transfer="u16mm", cache_images=True, device=device)

    table = Table(out_path, {
        "train_images": n_train, "val_images": len(frozen_ds), "epochs": epochs,
        "a2j_epochs": a2j_epochs, "batch": batch, "a2j_batch": a2j_batch,
        "steps_per_epoch": n_train // batch, "lr": lr, "schedule": f"warmup({warmup})+cosine",
        "train_seed": 0, "val_seed": 777}, device, "table")
    t_session = time.time()

    def trainer_for(name, model, step, eval_loss, rate, total, **kw):
        run_dir = os.path.join(work, f"run_{name}")
        trainer = Trainer(model, step, eval_loss, learning_rate=rate, optimizer="adam",
                          scheduler=WarmupCosine(rate, total_epochs=total, warmup_epochs=warmup),
                          out_dir=run_dir, seed=0, device=device, **kw)
        if os.path.exists(os.path.join(run_dir, "ckpt")):
            trainer.resume()
        return trainer

    def export(name, trainer):
        path = os.path.join(work, f"table_weights_{name}.npz")
        save_weights(trainer.state.model, path)
        table.say(f"weights -> {path}")
        return path

    # the dense rows: (row, model, step, eval loss, pose_align, with_prior, driver)
    dense = {
        "yolo": (YoloPoseNet, steps.make_yolo_train_step, steps.make_yolo_eval_loss, False,
                 True, lambda infer: ev.run_yolo_eval(infer, frozen_ds, SCORE_BATCH, ecfg,
                                                      dcfg)),
        "openpose": (RTPoseLight3D, steps.make_rtpose_train_step, steps.make_rtpose_eval_loss,
                     False, False,
                     lambda infer: ev.run_openpose_eval(infer, frozen_ds, SCORE_BATCH, ecfg,
                                                        dcfg, device_decode=True)),
        "popnet": (PopNet, steps.make_popnet_train_step, steps.make_popnet_eval_loss, True,
                   True, lambda infer: ev.run_popnet_eval(infer, frozen_ds, SCORE_BATCH, ecfg,
                                                          dcfg, readout="universe")),
    }
    for name in (m for m in METHODS if m in methods and m in dense):
        make_model, make_step, make_loss, pose_align, with_prior, driver = dense[name]
        if name == "popnet":
            table.methods.setdefault("popnet", {"curve": []}).update(trained_here=True,
                                                                     readout="universe")

        def score(trainer, name=name, driver=driver):
            return metrics(ev.evaluate_eval_data(
                driver(infer_fn(name, trainer.state.model.eval())), verbose=False))

        trainer = trainer_for(name, make_model(), make_step(), make_loss(), lr, epochs)
        table.train_chunked(name, trainer, mp_train_ds(pose_align, with_prior),
                            val_loss_ds(pose_align, with_prior), epochs, chunk, batch, score,
                            n_train // batch, max_chunks=max_chunks)
        export(name, trainer)

    if "yolo_a2j" in methods:
        yolo_weights = os.path.join(work, "table_weights_yolo.npz")
        if not os.path.exists(yolo_weights):
            raise SystemExit("yolo_a2j needs the trained detector: run the yolo row first "
                             "(the same TABLE_DIR)")
        yolo_net = load_into(YoloPoseNet(), load_npz(yolo_weights)).eval().to(device)
        anchors = torch.as_tensor(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
                                  dtype=torch.float32)

        def a2j_score(trainer):
            data = run_yolo_a2j_eval(infer_fn("yolo", yolo_net),
                                     infer_fn("a2j", trainer.state.model.eval()), frozen_ds,
                                     SCORE_BATCH, ecfg, dcfg)
            return metrics(ev.evaluate_eval_data(data, verbose=False))

        # the depth head starts at the dataset's depth prior, as in the JAX recipe
        trainer = trainer_for("a2j", A2J(depth_prior=KDH3D_DATASET.depth.mean),
                              steps.make_a2j_train_step(anchors),
                              steps.make_a2j_eval_loss(anchors), 3.5e-4, a2j_epochs,
                              weight_decay=1e-4)
        crops = A2JCropDataset(mp_train_ds(False, False, device_bank=False), seed=0)
        table.train_chunked("yolo_a2j", trainer, crops, None, a2j_epochs, chunk, a2j_batch,
                            a2j_score, n_train // a2j_batch, max_chunks=max_chunks)
        export("a2j", trainer)

    table.say(f"session wall {time.time() - t_session:.1f} s; wrote {out_path}")
    return table.out


if __name__ == "__main__":
    main()
