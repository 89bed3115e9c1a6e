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

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from popnet_tpu_torch.core.camera import ITOP_INTRINSICS, CameraIntrinsics

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "examples", "results", "itop_syngen_torch.json")
K = 15


def person_scene(rng: np.random.Generator, center, z_base: float, H: int, W: int,
                 intr: CameraIntrinsics, scale: float = 1.0, block: int = 18):
    """One person of the kinematic template: (depth (H, W) float32, seg
    mask (H, W) float32, annotation). The joints follow an articulated
    skeleton (head above neck, shoulders either side, limbs hanging with
    random articulation) in the benchmark's keypoint order; each joint is a
    block of side 2 * block * scale at its depth. The draws, their order and
    the arithmetic are those of the test suite's synthetic builder, so a
    seed gives the same frames."""
    s = rng.uniform(0.85, 1.25) * scale
    lean = rng.normal(0.0, 0.12)

    def rot(vx, vy, a):
        return np.array([vx * np.cos(a) - vy * np.sin(a), vx * np.sin(a) + vy * np.cos(a)])

    torso = np.asarray(center, np.float64) + rng.normal(0, 8, 2)
    neck = torso + rot(0, -62 * s, lean)
    head = neck + rot(0, -34 * s, lean + rng.normal(0, 0.1))
    pts = np.zeros((K, 2))
    pts[8], pts[1], pts[0] = torso, neck, head
    for side, sh_i, el_i, wr_i, hip_i, kn_i, an_i in ((+1, 2, 4, 6, 9, 11, 13),
                                                       (-1, 3, 5, 7, 10, 12, 14)):
        sh = neck + rot(side * 30 * s, 6 * s, lean)
        el = sh + rot(0, 42 * s, lean + rng.normal(0, 0.5))
        wr = el + rot(0, 40 * s, lean + rng.normal(0, 0.7))
        hip = torso + rot(side * 20 * s, 46 * s, lean)
        kn = hip + rot(0, 50 * s, lean + rng.normal(0, 0.25))
        an = kn + rot(0, 48 * s, lean + rng.normal(0, 0.25))
        for i, p in ((sh_i, sh), (el_i, el), (wr_i, wr), (hip_i, hip), (kn_i, kn), (an_i, an)):
            pts[i] = p
    pts += rng.normal(0, 2.0 * scale, size=(K, 2))
    pts = np.clip(pts, 10 * scale, [W - 10 * scale, H - 10 * scale])
    z = z_base + rng.normal(0, 0.05, K)
    depth = np.zeros((H, W), np.float32)
    seg = np.zeros((H, W), np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    blk = max(4, int(round(block * scale)))
    for k in range(K):
        m = (np.abs(xs - pts[k, 0]) < blk) & (np.abs(ys - pts[k, 1]) < blk)
        depth[m] = z[k]
        seg[m] = 1.0
    j3 = np.stack([(pts[:, 0] - intr.cx) / intr.fx * z, (pts[:, 1] - intr.cy) / intr.fy * z, z], 1)
    margin = 20 * scale
    ann = {
        "2d_joints": pts.tolist(),
        "3d_joints": j3.tolist(),
        "bbox": [float(pts[:, 0].min() - margin), float(pts[:, 1].min() - margin),
                 float(pts[:, 0].max() + margin), float(pts[:, 1].max() + margin)],
        "pose_weight": float(rng.uniform(0.8, 1.5)),
    }
    return depth, seg, ann


def build_itop(root: str, n_images: int = 6, seed: int = 0) -> dict:
    """A synthetic ITOP-geometry set under `root`: depth_maps/itop_NNNN.npy,
    320x240 single-person frames at the ITOP camera over a flat 4.5 m
    background, and labels.json (with its "intrinsics"). Returns
    {"img_dir", "labels"}."""
    rng = np.random.default_rng(seed)
    h, w = 240, 320
    img_dir = os.path.join(root, "depth_maps")
    os.makedirs(img_dir, exist_ok=True)
    cam = ITOP_INTRINSICS
    labels = {"intrinsics": {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy}}
    for i in range(n_images):
        center = np.array([w / 2, h / 2]) + rng.uniform(-25, 25, 2)
        depth, _, ann = person_scene(rng, center, rng.uniform(1.8, 3.6), H=h, W=w, intr=cam,
                                     scale=0.42, block=16)
        depth[depth == 0] = 4.5
        name = f"itop_{i:04d}.npy"
        np.save(os.path.join(img_dir, name), depth)
        labels[name] = [ann]
    path = os.path.join(root, "labels.json")
    with open(path, "w") as f:
        json.dump(labels, f)
    return {"img_dir": img_dir, "labels": path}


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
    out = {"budget": {"train_images": n_train, "val_images": n_val, "epochs": epochs,
                      "a2j_epochs": a2j_epochs, "batch": batch, "train_seed": 0,
                      "val_seed": 777,
                      "protocol": "single-person acc@10cm (eval_pose_single.py / itop_test.py)"},
           "methods": {}}
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                prev = json.load(f)
            if prev.get("budget") == out["budget"]:
                out = prev
        except (OSError, ValueError):
            pass
    out["device"] = device_description(device)

    def save():
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)

    def train_chunked(name, trainer, train_ds, total, score_fn, spe):
        rec = out["methods"].setdefault(name, {"curve": []})
        if rec.get("done"):
            print(f"[itop] {name}: already done", flush=True)
            return
        t0 = time.time()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            while trainer.epoch < total:
                n = min(chunk, total - trainer.epoch)
                trainer.fit(train_ds, None, epochs=n, batch_size=batch, checkpoint_every=n,
                            val_every=max(1, n // 2))
                with torch.inference_mode():
                    m = score_fn(trainer)
                point = {"epoch": trainer.epoch, "step": trainer.epoch * spe,
                         "train_loss": trainer.history[-1]["train_loss"],
                         "wall_s": round(time.time() - t0, 1), "metrics": m}
                rec["curve"].append(point)
                rec["final"] = m
                rec["steps"] = point["step"]
                save()
                print(f"[itop] {name} epoch {trainer.epoch}: {m}", flush=True)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        rec["done"] = True
        save()

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
        rec = out["methods"].setdefault("a2j", {"curve": []})
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
        train_chunked("a2j", trainer, train_ds, a2j_epochs, a2j_score, n_train // batch)

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
        train_chunked("openpose", trainer, train_ds, epochs, op_score, n_train // batch)

    print(f"[itop] wrote {out_path}", flush=True)
    return out


if __name__ == "__main__":
    main()
