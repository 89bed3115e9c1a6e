"""Full-state checkpoints with `torch.save`.

A checkpoint directory holds one subdirectory a saved step,
`<directory>/<step>/state.pt` (a dict: the model's and the optimizer's
state dicts, and whatever else the caller saves, such as the scheduler and
the data generator) beside `metadata.json`; `keep` bounds how many steps
stay. The format is the port's own: the JAX package's orbax checkpoints are
not read.
"""

from __future__ import annotations

import json
import os
import shutil

import torch


def checkpoint_steps(directory: str) -> list[int]:
    """The saved steps of a checkpoint directory, in order (none if it is absent)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(os.path.join(directory, d, "state.pt")))


def save_checkpoint(directory: str, payload: dict, step: int, metadata: dict | None = None,
                    keep: int = 3) -> str:
    """Write `payload` and `metadata` as step `step` of `directory`,
    replacing a step of that number; then drop the oldest steps beyond
    `keep`. Returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(metadata if metadata is not None else {}, f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in checkpoint_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return final


def restore_checkpoint(directory: str, step: int | None = None):
    """(payload, metadata, step) of `step`, or of the latest step; tensors
    come back on the CPU. Loaded with `weights_only`: a payload of tensors
    and plain Python values restores, and one that would run pickled code
    is refused."""
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {directory!r}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, str(step))
    payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
    with open(os.path.join(path, "metadata.json")) as f:
        metadata = json.load(f)
    return payload, metadata, step


def restore_params(directory: str, step: int | None = None):
    """(model state dict, metadata, step): the model's tensors only, for
    evaluation and serving, whatever optimizer wrote the checkpoint."""
    payload, metadata, step = restore_checkpoint(directory, step)
    return payload["model"], metadata, step
