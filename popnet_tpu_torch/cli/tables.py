"""The harness of the port's result tables (`cli/method_table.py`,
`cli/ablation_table.py`, `cli/itop_table.py`): the device a table ran on,
its resumable JSON, and the chunked training of one row.

A table's JSON is rewritten after every chunk of epochs, so a run that is
cut keeps what it finished; a later run reuses it only when its `budget` is
equal, and skips the rows marked `done`. Each chunk appends a point to its
row's `curve` (epoch, step, train loss, the wall seconds since this call
took the row up, the metrics) and publishes the metrics as `latest`; the last
chunk moves them to `final` and sets `done`, so a reader of `final` never
sees a half-trained score.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch


def device_description(device: torch.device) -> dict:
    """The device a run used: with a card, its name and power limit as
    nvidia-smi gives them."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    desc = {"platform": "gpu", "name": torch.cuda.get_device_name(device)}
    try:
        desc["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        desc["nvidia_smi"] = "not available"
    return desc


def metrics(m: dict) -> dict:
    """The four metrics of an evaluation, rounded to 4 places, without the
    per-joint lists."""
    return {k: round(float(v), 4) for k, v in m.items() if not k.startswith("per_")}


class Table:
    """A table's JSON at `path`: {"budget", "methods", "device"}. The rows
    of an earlier run at the same budget are kept."""

    def __init__(self, path: str, budget: dict, device: torch.device, tag: str):
        self.path, self.tag = path, tag
        self.out = {"budget": budget, "methods": {}}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("budget") == budget:
                    self.out = prev
            except (OSError, ValueError):
                pass
        self.out["device"] = device_description(device)

    @property
    def methods(self) -> dict:
        return self.out["methods"]

    def save(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.out, f, indent=2)

    def say(self, msg: str) -> None:
        print(f"[{self.tag}] {msg}", flush=True)

    def train_chunked(self, name: str, trainer, train_ds, val_ds, total_epochs: int, chunk: int,
                      batch: int, score_fn, steps_per_epoch: int, latest: bool = True,
                      max_chunks: int | None = None) -> dict:
        """Train row `name` to `total_epochs` in chunks of `chunk` epochs,
        scoring it with `score_fn(trainer)` (in inference mode) after each
        and saving the JSON, with cuDNN's TF32 off throughout; at most
        `max_chunks` chunks in this call (a later call resumes the row from
        the trainer's checkpoint). With `latest=False` (the ITOP table's
        way) every chunk writes `final`. Returns the row."""
        rec = self.methods.setdefault(name, {"curve": []})
        if rec.get("done"):
            self.say(f"{name}: already done")
            return rec
        t0 = time.time()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        chunks = 0
        try:
            while trainer.epoch < total_epochs and (max_chunks is None or chunks < max_chunks):
                chunks += 1
                n = min(chunk, total_epochs - trainer.epoch)
                trainer.fit(train_ds, val_ds, epochs=n, batch_size=batch, checkpoint_every=n,
                            val_every=max(1, n // 2))
                with torch.inference_mode():
                    m = score_fn(trainer)
                point = {"epoch": trainer.epoch, "step": trainer.epoch * steps_per_epoch,
                         "train_loss": trainer.history[-1]["train_loss"],
                         "wall_s": round(time.time() - t0, 1), "metrics": m}
                rec["curve"].append(point)
                rec["latest" if latest else "final"] = m
                rec["steps"] = point["step"]
                self.save()
                self.say(f"{name} epoch {trainer.epoch} ({point['step']} steps, "
                         f"{point['wall_s']} s): {m}")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        if trainer.epoch < total_epochs:
            return rec
        if "latest" in rec:
            rec["final"] = rec.pop("latest")
        rec["done"] = True
        self.save()
        return rec
