"""The synthetic-generalization run: PoP-Net trained from scratch on a
procedural mp-aug training set and scored, after every chunk of epochs, on
a frozen mp-aug validation set built from a disjoint seed, under both
alignment readouts ("gated" and "universe"): the metric-against-step curve
of the JAX package's `scripts/syngen.py`, on the card.

Data: the training set is `data.synthetic.build(..., n_locations=5,
seed=0)`, the validation set the same at seed 777, and the frozen set its
mp-aug composite frozen by `generate-augset --kind mpaug --seed 777` (the
sets of `cli/method_table.py`, made once in the work directory and reused).
Training runs on the device bank (`DeviceMPAugDataset`, uint16-millimetre
transfer, cached frames); the validation loss on `KDH3DDataset` without
augmentation; each curve point scores the frozen set (`MPRealDataset`)
through `run_popnet_eval` at batch 16 under each readout (K7 on the card).

Recipe, the JAX script's defaults: Adam at SYNGEN_LR with a warmup-cosine
schedule over the whole budget, float32 without TF32, the validation loss
every SYNGEN_VAL_EVERY epochs.

    python -m popnet_tpu_torch.cli.syngen

Env: SYNGEN_TRAIN=512 SYNGEN_VAL=64 SYNGEN_EPOCHS=1250 (16 steps an epoch
at batch 32: 20,000 steps) SYNGEN_CHUNK=125 (epochs between curve points)
SYNGEN_BATCH=32 SYNGEN_LR=1e-3 SYNGEN_WARMUP=30 SYNGEN_VAL_EVERY=10
SYNGEN_CHUNKS (the most chunks this call trains; default all, and a later
call with the same SYNGEN_DIR resumes from its checkpoint) SYNGEN_DIR=<work
directory> SYNGEN_RUN=run (the run's directory in it) SYNGEN_OUT=<json
path> (default examples/results/syngen_torch.json) SYNGEN_PROFILE=<epoch>
(a torch.profiler trace of that epoch under <run>/trace/) SYNGEN_CPU=1 (run
on the CPU).

The JSON has the JAX script's keys (the recipe, `curve`, and the last
point's `gated` and `universe`), the card's name and power limit under
`device`, and `done`; it is rewritten after every chunk, and a call at
another recipe starts it anew. A run directory trained under another recipe
is refused, not mixed: remove it or name another SYNGEN_RUN.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from popnet_tpu_torch.cli.tables import Table, metrics

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "examples", "results", "syngen_torch.json")
ROW = "popnet"
READOUTS = ("gated", "universe")
SCORE_BATCH = 16
# SYNGEN_* variable -> (recipe key, default, type): the JAX script's defaults
ENV = {"SYNGEN_TRAIN": ("train_images", "512", int), "SYNGEN_VAL": ("n_val", "64", int),
       "SYNGEN_EPOCHS": ("epochs", "1250", int), "SYNGEN_CHUNK": ("chunk", "125", int),
       "SYNGEN_BATCH": ("batch", "32", int), "SYNGEN_LR": ("lr", "1e-3", float),
       "SYNGEN_WARMUP": ("warmup", "30", int), "SYNGEN_VAL_EVERY": ("val_every", "10", int)}


def settings(env=None) -> dict:
    """The run's settings from the SYNGEN_* variables of `env` (the
    process's by default), the JAX script's defaults where unset."""
    env = os.environ if env is None else env
    return {key: cast(env.get(name, default)) for name, (key, default, cast) in ENV.items()}


def recipe(s: dict, val_images: int) -> dict:
    """The JSON's recipe keys (the JAX script's), for settings `s` and a
    frozen set of `val_images` frames."""
    return {"train_images": s["train_images"], "val_images": val_images, "epochs": s["epochs"],
            "batch": s["batch"], "lr": s["lr"], "optimizer": "adam",
            "schedule": f"warmup({s['warmup']})+cosine",
            "steps_per_epoch": s["train_images"] // s["batch"], "train_seed": 0,
            "val_seed": 777}


class SyngenTable(Table):
    """`cli/tables.py`'s resumable JSON with its one row in the JAX
    script's layout: the recipe's keys at the top, then `curve`, the last
    point's `gated` and `universe`, `device` and `done`."""

    def __init__(self, path: str, budget: dict, device):
        super().__init__(path, budget, device, "syngen")    # a flat file is not taken up here
        try:
            with open(path) as f:
                prev = json.load(f)
        except (OSError, ValueError):
            prev = None
        if prev and {k: prev.get(k) for k in budget} == budget and "curve" in prev:
            self.methods[ROW] = {"curve": prev["curve"], "done": bool(prev.get("done"))}

    def save(self) -> None:
        rec = self.methods.get(ROW, {"curve": []})
        out = {**self.out["budget"], "curve": rec["curve"]}
        if rec["curve"]:
            out.update({r: rec["curve"][-1][r] for r in READOUTS})
        out.update(device=self.out["device"], done=bool(rec.get("done")))
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(out, f, indent=2)


def score(net, frozen_ds) -> dict:
    """A curve point's metrics: `net` (PopNet, eval mode) on the frozen set
    through `run_popnet_eval` at batch 16 under each readout -> {readout:
    the four metrics rounded to 4 places}."""
    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.cli.method_table import infer_fn
    from popnet_tpu_torch.core.config import DecodeConfig, EncoderConfig

    infer = infer_fn("popnet", net)
    return {r: metrics(ev.evaluate_eval_data(
        ev.run_popnet_eval(infer, frozen_ds, SCORE_BATCH, EncoderConfig(), DecodeConfig(),
                           readout=r), verbose=False)) for r in READOUTS}


def main() -> dict:
    """Train and score as the environment says; returns the JSON written."""
    from popnet_tpu_torch.cli.method_table import frozen_dataset, prepare_sets
    from popnet_tpu_torch.core.config import KDH3D_DATASET, EncoderConfig
    from popnet_tpu_torch.core.device import resolve_device
    from popnet_tpu_torch.data.datasets import DeviceMPAugDataset, KDH3DDataset
    from popnet_tpu_torch.models import PopNet
    from popnet_tpu_torch.train import steps
    from popnet_tpu_torch.train.loop import Trainer
    from popnet_tpu_torch.train.schedule import WarmupCosine

    env = os.environ
    device = resolve_device("cpu" if env.get("SYNGEN_CPU") else "cuda")
    s = settings()
    out_path = env.get("SYNGEN_OUT", DEFAULT_OUT)
    max_chunks = int(env["SYNGEN_CHUNKS"]) if env.get("SYNGEN_CHUNKS") else None
    profile = int(env["SYNGEN_PROFILE"]) if env.get("SYNGEN_PROFILE") else None
    work = env.get("SYNGEN_DIR") or tempfile.mkdtemp(prefix="syngen_")
    run_dir = os.path.join(work, env.get("SYNGEN_RUN", "run"))
    print(f"[syngen] workdir {work} on {device}", flush=True)
    t_session = time.time()

    train_root, val_root, frozen = prepare_sets(work, s["train_images"], s["n_val"], device)
    frozen_ds = frozen_dataset(frozen, device)
    budget = recipe(s, len(frozen_ds))
    mark = os.path.join(run_dir, "recipe.json")
    if os.path.exists(mark):
        with open(mark) as f:
            had = json.load(f)
        if had != budget:
            raise SystemExit(f"{run_dir} was trained under another recipe ({had}), not "
                             f"{budget}: remove it or set SYNGEN_RUN to another name")
    os.makedirs(run_dir, exist_ok=True)
    with open(mark, "w") as f:
        json.dump(budget, f)

    ecfg = EncoderConfig()
    ann_files = sorted(os.path.join(train_root, f) for f in os.listdir(train_root)
                       if f.startswith("labels_loc") and f.endswith(".json"))
    common = dict(ecfg=ecfg, dcfg=KDH3D_DATASET, pose_align=True, with_prior=True,
                  transfer="u16mm", cache_images=True, device=device)
    train_ds = DeviceMPAugDataset(os.path.join(train_root, "depth_maps"), ann_files,
                                  bg_file=os.path.join(train_root, "labels_bg.json"),
                                  bg_dir=os.path.join(train_root, "bg_maps"),
                                  seg_dir=os.path.join(train_root, "seg_maps"), seed=0, **common)
    val_ds = KDH3DDataset(os.path.join(val_root, "depth_maps"),
                          os.path.join(val_root, "labels.json"), seed=1, augment=False, **common)
    trainer = Trainer(PopNet(), steps.make_popnet_train_step(), steps.make_popnet_eval_loss(),
                      learning_rate=s["lr"], optimizer="adam", out_dir=run_dir, seed=0,
                      scheduler=WarmupCosine(s["lr"], total_epochs=s["epochs"],
                                             warmup_epochs=s["warmup"]),
                      device=device, profile_epoch=profile)
    if os.path.exists(os.path.join(run_dir, "ckpt")):
        trainer.resume()

    table = SyngenTable(out_path, budget, device)
    table.train_chunked(ROW, trainer, train_ds, val_ds, s["epochs"], s["chunk"], s["batch"],
                        lambda t: score(t.state.model.eval(), frozen_ds),
                        budget["steps_per_epoch"], max_chunks=max_chunks,
                        val_every=s["val_every"], spread=True)
    table.save()
    table.say(f"session wall {time.time() - t_session:.1f} s; wrote {out_path}")
    with open(out_path) as f:
        return json.load(f)


if __name__ == "__main__":
    main()
