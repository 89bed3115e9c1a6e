"""The Open-Pose+ readout ablation: one trained Open-Pose+ scored through
five 3D channels, to share its 3D error between the 2D localizer and the
depth readout:

- pose_depth            predicted 2D + the learned pose-depth readout (the main row)
- raw_depth             predicted 2D + the raw depth map at the 2D point
- perfect_2d            GT 2D + the learned pose-depth readout
- perfect_2d_visible    the visible GT 2D + the learned pose-depth readout
- perfect_2d_raw_depth  GT 2D + the raw depth map (the ceiling)

The port of the JAX package's `scripts/ablation_table.py`: the frozen
validation set of the four-method table (`cli/method_table.py`, seed 777),
one `run_openpose_eval(device_decode=True)` pass at batch 16 on the card
(K1, K3, K6 and the fused K4 + K5), whose prediction JSON carries every
channel, scored by `evaluate_ablation_channels`. The JSON also names the
device it ran on.

    python -m popnet_tpu_torch.cli.ablation_table

Env: ABL_DIR=<the table's workdir> (its val/ and val_frozen/ are made there
if missing) ABL_WEIGHTS=<npz> (default
examples/results/bench_weights_openpose.npz) ABL_VAL=64 ABL_OUT=<json
path> (default examples/results/ablation_channels_torch.json) ABL_CPU=1
(run on the CPU).
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "examples", "results", "ablation_channels_torch.json")
DEFAULT_WEIGHTS = os.path.join(REPO, "examples", "results", "bench_weights_openpose.npz")


def ablation(weights: str, frozen_ds) -> dict:
    """The main metrics and the five pck3d channels of the Open-Pose+ npz
    `weights` on `frozen_ds`, on its device, float32 with cuDNN's TF32 off."""
    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.cli.method_table import SCORE_BATCH, infer_fn
    from popnet_tpu_torch.cli.tables import metrics
    from popnet_tpu_torch.core.config import DecodeConfig, EncoderConfig
    from popnet_tpu_torch.interop.from_jax import load_into, load_npz
    from popnet_tpu_torch.models import RTPoseLight3D

    net = load_into(RTPoseLight3D(), load_npz(weights)).eval().to(frozen_ds.device)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        data = ev.run_openpose_eval(infer_fn("openpose", net), frozen_ds, SCORE_BATCH,
                                    EncoderConfig(), DecodeConfig(), device_decode=True)
    return {"main": metrics(ev.evaluate_eval_data(data, verbose=False)),
            "pck3d_channels": {k: round(float(v), 4)
                               for k, v in ev.evaluate_ablation_channels(data).items()}}


def main() -> dict:
    from popnet_tpu_torch.cli.method_table import frozen_dataset, prepare_sets
    from popnet_tpu_torch.cli.tables import device_description
    from popnet_tpu_torch.core.device import resolve_device

    env = os.environ
    out_path = env.get("ABL_OUT", DEFAULT_OUT)
    device = resolve_device("cpu" if env.get("ABL_CPU") else "cuda")
    weights = env.get("ABL_WEIGHTS", DEFAULT_WEIGHTS)
    n_val = int(env.get("ABL_VAL", "64"))
    work = env.get("ABL_DIR") or tempfile.mkdtemp(prefix="mtable_")
    # the table's validation and frozen sets; its training set is not needed here
    frozen = prepare_sets(work, 0, n_val, device)[2]
    frozen_ds = frozen_dataset(frozen, device)
    rel = os.path.relpath(os.path.abspath(weights), REPO)
    out = {"weights": rel if not rel.startswith("..") else os.path.abspath(weights),
           "val_images": len(frozen_ds), "val_seed": 777, **ablation(weights, frozen_ds),
           "device": device_description(device)}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    print(f"[ablation] wrote {out_path}", flush=True)
    return out


if __name__ == "__main__":
    main()
