"""The synthetic ITOP table: the two ITOP recipes trained from scratch on a
synthetic ITOP-geometry set (320x240, f = 1 / 0.0035, 5 m clip;
`build_itop`) and scored through their whole pipelines by the
single-person 10-cm protocol on a frozen validation set of another seed:

- a2j       torso-box crops (xy_thres 120, depth_thres 0.4, normalized by
            the measured relative statistics, `itop_relative_stats`), Adam
            3.5e-4 with L2 1e-4 and a warmup-cosine schedule -> the anchor
            vote -> uncrop -> the flipped-Y camera -> acc@10cm
            (`cli/itop_eval.run_itop_a2j_eval`);
- openpose  RTPoseLight3D at ITOP geometry (uint16-millimetre transfer,
            cached frames), Adam 1e-3 with a warmup-cosine schedule -> the
            whole decode -> the best person -> acc@10cm
            (`run_itop_openpose_eval`).

The port of the JAX package's `scripts/itop_table.py`, with its budget and
environment variables. It writes its JSON after every chunk of epochs and
resumes from the runs under ITOP_DIR, so the two rows may run in separate
calls. The JSON also names the device it ran on (with a card, its name and
power limit).

    python -m popnet_tpu_torch.cli.itop_table

Env: ITOP_METHODS=a2j,openpose ITOP_TRAIN=256 ITOP_VAL=64 ITOP_EPOCHS=500
ITOP_A2J_EPOCHS=300 ITOP_CHUNK=100 ITOP_BATCH=32 ITOP_WARMUP=20
ITOP_DIR=<workdir> ITOP_OUT=<json path> (default
examples/results/itop_syngen_torch.json) ITOP_CPU=1 (run on the CPU).
"""

from __future__ import annotations

import os
import tempfile

import torch

from popnet_tpu_torch.cli.tables import Table
from popnet_tpu_torch.data.synthetic import build_itop

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "examples", "results", "itop_syngen_torch.json")


def _strip(m: dict) -> dict:
    return {"acc_10cm": round(m["acc_10cm"], 4), "per_joint": [round(x, 4) for x in m["per_joint"]]}


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def main() -> dict:
    from popnet_tpu_torch.cli.itop_eval import run_itop_a2j_eval, run_itop_openpose_eval
    from popnet_tpu_torch.core.config import ITOP_DATASET, EncoderConfig
    from popnet_tpu_torch.core.device import resolve_device
    from popnet_tpu_torch.data.a2j_crops import CROP, ITOPA2JCropDataset
    from popnet_tpu_torch.data.datasets import KDH3DDataset, MPRealDataset
    from popnet_tpu_torch.data.itop_a2j import itop_relative_stats
    from popnet_tpu_torch.models import A2J, RTPoseLight3D
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors
    from popnet_tpu_torch.train import steps
    from popnet_tpu_torch.train.loop import Trainer
    from popnet_tpu_torch.train.schedule import WarmupCosine

    env = os.environ
    out_path = env.get("ITOP_OUT", DEFAULT_OUT)
    device = resolve_device("cpu" if env.get("ITOP_CPU") else "cuda")
    methods = env.get("ITOP_METHODS", "a2j,openpose").split(",")
    n_train = int(env.get("ITOP_TRAIN", "256"))
    n_val = int(env.get("ITOP_VAL", "64"))
    epochs = int(env.get("ITOP_EPOCHS", "500"))
    a2j_epochs = int(env.get("ITOP_A2J_EPOCHS", "300"))
    chunk = int(env.get("ITOP_CHUNK", "100"))
    batch = int(env.get("ITOP_BATCH", "32"))
    warmup = int(env.get("ITOP_WARMUP", "20"))

    work = env.get("ITOP_DIR") or tempfile.mkdtemp(prefix="itop_")
    train_root, val_root = os.path.join(work, "train"), os.path.join(work, "val")
    print(f"[itop] workdir {work} on {device}", flush=True)
    if not os.path.exists(os.path.join(train_root, "labels.json")):
        build_itop(train_root, n_images=n_train, seed=0)
    if not os.path.exists(os.path.join(val_root, "labels.json")):
        build_itop(val_root, n_images=n_val, seed=777)

    ecfg = EncoderConfig()
    table = Table(out_path, {
        "train_images": n_train, "val_images": n_val, "epochs": epochs, "a2j_epochs": a2j_epochs,
        "batch": batch, "train_seed": 0, "val_seed": 777,
        "protocol": "single-person acc@10cm (eval_pose_single.py / itop_test.py)"},
        device, "itop")

    def dataset(cls, root, **kw):
        return cls(os.path.join(root, "depth_maps"), os.path.join(root, "labels.json"),
                   dcfg=ITOP_DATASET, device=device, **kw)

    val_a2j = dataset(KDH3DDataset, val_root, ecfg=EncoderConfig(max_people=2), seed=1)

    if "a2j" in methods:
        # ITOP's labels carry torso-relative depths near 0: the A2J default depth head
        # (no prior) starts the vote there, and the crops take the relative statistics
        anchors = torch.as_tensor(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
                                  dtype=torch.float32)
        inner = dataset(KDH3DDataset, train_root, ecfg=EncoderConfig(max_people=2), seed=0,
                        cache_images=True)
        rel_mean, rel_std = itop_relative_stats(inner)
        print(f"[itop] a2j relative stats: mean {rel_mean:.6f} std {rel_std:.6f}", flush=True)
        rec = table.methods.setdefault("a2j", {"curve": []})
        rec["rel_stats"] = [round(rel_mean, 6), round(rel_std, 6)]

        def a2j_score(trainer):
            net = trainer.state.model.eval()
            return _strip(run_itop_a2j_eval(lambda crops: net(_nchw(crops)), val_a2j, 16,
                                            mean=rel_mean, std=rel_std))

        train_ds = ITOPA2JCropDataset(inner, seed=0, mean=rel_mean, std=rel_std)
        run_dir = os.path.join(work, "run_a2j")
        trainer = Trainer(A2J(), steps.make_a2j_train_step(anchors),
                          steps.make_a2j_eval_loss(anchors), learning_rate=3.5e-4,
                          weight_decay=1e-4, optimizer="adam",
                          scheduler=WarmupCosine(3.5e-4, total_epochs=a2j_epochs,
                                                 warmup_epochs=warmup),
                          out_dir=run_dir, seed=0, device=device)
        if os.path.exists(os.path.join(run_dir, "ckpt")):
            trainer.resume()
        table.train_chunked("a2j", trainer, train_ds, None, a2j_epochs, chunk, batch, a2j_score,
                            n_train // batch, latest=False)

    if "openpose" in methods:
        val_mp = dataset(MPRealDataset, val_root, ecfg=ecfg)

        def op_score(trainer):
            net = trainer.state.model.eval()

            def infer(images):
                (paf, heat, z), _ = net(_nchw(images))
                return tuple(t.permute(0, 2, 3, 1) for t in (paf, heat, z))

            return _strip(run_itop_openpose_eval(infer, val_mp, 16, ecfg))

        train_ds = dataset(KDH3DDataset, train_root, ecfg=ecfg, seed=0, pose_align=False,
                           with_prior=False, transfer="u16mm", cache_images=True)
        run_dir = os.path.join(work, "run_openpose")
        trainer = Trainer(RTPoseLight3D(), steps.make_rtpose_train_step(),
                          steps.make_rtpose_eval_loss(), learning_rate=1e-3, optimizer="adam",
                          scheduler=WarmupCosine(1e-3, total_epochs=epochs, warmup_epochs=warmup),
                          out_dir=run_dir, seed=0, device=device)
        if os.path.exists(os.path.join(run_dir, "ckpt")):
            trainer.resume()
        table.train_chunked("openpose", trainer, train_ds, None, epochs, chunk, batch, op_score,
                            n_train // batch, latest=False)

    print(f"[itop] wrote {out_path}", flush=True)
    return table.out


if __name__ == "__main__":
    main()
