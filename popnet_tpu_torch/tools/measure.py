"""Measurements of the port on one CUDA card, beside what chip_smoke.py prints.

    python3 popnet_tpu_torch/tools/measure.py decodes [--root CHECKOUT]
    python3 popnet_tpu_torch/tools/measure.py paf_score [--root CHECKOUT]
    python3 popnet_tpu_torch/tools/measure.py vote

decodes: imports popnet_tpu_torch from CHECKOUT (default: the checkout
that holds this script), builds its kernels, runs the bf16 CNNs of its
serving paths on chip_smoke.py's frames (batch 256, seed 0) and times
each eager decode of the maps the pipeline hands it: Open-Pose+ and
PoP-Net, and Yolo-Pose+ where the checkout has it. One JSON line a
decode: CUDA-event ms a call, the device operations one call issues and
their summed device time (torch.profiler). Run on two checkouts in turn
(A B B A, one call) to compare them on one card.

paf_score: the PAF scoring kernel (K3) of CHECKOUT on the Open-Pose+
path's inputs (the bf16 CNN's maps of chip_smoke.py's frames, batch 256,
seed 0, and the peaks found on them) and, where the checkout's kernel
takes them, on COCO's (this checkout's chip_smoke.py painted people, batch
64, 46x46, 19 limbs): device ms a call from CUDA-graph replays, one JSON
line each. Run on two checkouts in turn (A B B A, one call).

vote: the A2J vote (`decode.a2j.a2j_post_process`) of random heads made
as tests/test_torch_cuda.py makes them from seeds 0-39, on the card and
on the CPU,
against the same vote in float64: each device's error in float32 ulps of
the result, split into the softmax's and the weighted sums'.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

SELF_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BATCH = 256


def _smoke():
    """This checkout's chip_smoke.py, for its frames and timers."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(SELF_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profile(fn) -> tuple[int, float]:
    """(device operations, their summed device ms) of one eager fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3


def decodes(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from popnet_tpu_torch import load_npz, serving
    from popnet_tpu_torch.decode.openpose_infer import openpose_decode
    from popnet_tpu_torch.decode.popnet_infer import popnet_decode
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import PopNet, RTPoseLight3D
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32
    from popnet_tpu_torch.ops import _build

    smoke = _smoke()
    _build.build_all()
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    weights = os.path.join(SELF_ROOT, "examples", "results", "bench_weights_{}.npz")

    def cnn(cls, name):
        model = load_into(cls(), load_npz(weights.format(name))).eval().to(dev, bf16)
        return keep_batchnorm_float32(model)

    def report(path, fn):
        ms = smoke.time_ms(fn, reps=20)
        n_ops, busy_ms = _profile(fn)
        print(json.dumps({"tree": root, "decode": path, "eager_ms": ms, "device_ops": n_ops,
                          "device_busy_ms": busy_ms}), flush=True)

    nhwc = lambda t: t.permute(0, 2, 3, 1)
    nchw = lambda t: t.permute(0, 3, 1, 2)
    with torch.inference_mode():
        frames = smoke.person_frames(np.random.default_rng(0), BATCH, dev)
        x = serving.preproc_depth(frames)
        (paf, heat, z), _ = cnn(RTPoseLight3D, "openpose")(nchw(x).to(bf16))
        report("Open-Pose+", lambda: openpose_decode(nhwc(heat).float(), nhwc(paf).float(),
                                                     nhwc(z), x))
        frames = smoke.person_frames(np.random.default_rng([0, 2]), BATCH, dev, background=True)
        x = serving.preproc_depth(frames)
        maps, _ = cnn(PopNet, "popnet")(nchw(x).to(bf16))
        maps = [t.float().permute(0, 2, 3, 1) for t in maps]
        report("PoP-Net", lambda: popnet_decode(*maps))
        if hasattr(serving, "yolo_decode"):
            from popnet_tpu_torch.models import YoloPoseNet

            prior = nhwc(cnn(YoloPoseNet, "yolo")(nchw(x).to(bf16)).float())
            report("Yolo-Pose+", lambda: serving.yolo_decode(prior, w_out=480, h_out=512))


def paf_score(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from popnet_tpu_torch import load_npz, serving
    from popnet_tpu_torch.core.skeleton import LIMBS
    from popnet_tpu_torch.decode.device import find_peaks_batched
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32
    from popnet_tpu_torch.ops import _build, kernels

    smoke = _smoke()
    _build.build_all(("find_peaks", "paf_score"))
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    weights = load_npz(os.path.join(SELF_ROOT, "examples", "results",
                                    "bench_weights_openpose.npz"))
    model = keep_batchnorm_float32(load_into(RTPoseLight3D(), weights).eval().to(dev, bf16))

    def report(shape, fn):
        print(json.dumps({"tree": root, "paf_score": shape, "ms": smoke.graph_ms(fn)}),
              flush=True)

    with torch.inference_mode():
        frames = smoke.person_frames(np.random.default_rng(0), BATCH, dev)
        x = serving.preproc_depth(frames)
        (paf, heat, _), _ = model(x.permute(0, 3, 1, 2).to(bf16))
        heat, paf = (t.float().permute(0, 2, 3, 1) for t in (heat, paf))
        peaks, valid = find_peaks_batched(heat)
        report("depth", lambda: kernels.paf_score(paf, peaks, valid, LIMBS))
        if hasattr(kernels, "paf_score_groups"):
            from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS

            h, f, _ = smoke.coco_people_maps(np.random.default_rng([0, 6]), 64)
            h, f = (torch.as_tensor(a, device=dev) for a in (h, f))
            pk, v = find_peaks_batched(h, num_joints=18)
            report("coco", lambda: kernels.paf_score(f, pk, v, COCO_LIMBS))


def vote() -> None:
    sys.path.insert(0, SELF_ROOT)
    import torch

    from popnet_tpu_torch.decode.a2j import a2j_post_process
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors

    dev = torch.device("cuda", 0)
    anchors = torch.as_tensor(shift_anchors((18, 18), 16, generate_anchors()), dtype=torch.float32)
    N = anchors.shape[0]

    def ulps(err, ref):
        return (err / np.spacing(np.abs(ref).astype(np.float32))).max()

    for seed in range(40):
        rng = np.random.default_rng(seed)
        heads = (rng.normal(0, 3, (8, N, 15)), rng.normal(0, 10, (8, N, 15, 2)),
                 rng.normal(3, 0.5, (8, N, 15)))
        heads = [torch.as_tensor(h, dtype=torch.float32) for h in heads]
        card = a2j_post_process([h.to(dev) for h in heads], anchors.to(dev)).cpu().numpy()
        cpu = a2j_post_process(heads, anchors).numpy()
        exact = a2j_post_process([h.double() for h in heads], anchors.double()).numpy()
        # the softmax alone, and the weighted sums alone of one set of float32 weights
        w64 = torch.softmax(heads[0].double(), dim=1)
        on = {"cpu": torch.device("cpu"), "card": dev}
        w_err = {k: float(((torch.softmax(heads[0].to(d), dim=1).cpu().double() - w64).abs()
                           / w64).max() / 2.0 ** -23) for k, d in on.items()}
        w32 = w64.float()
        pos = anchors[None, :, None, :] + heads[1]
        sums = {k: (w32.to(d)[..., None] * pos.to(d)).sum(dim=1).cpu().numpy()
                for k, d in on.items()}
        sum_exact = (w32.double()[..., None] * pos.double()).sum(dim=1).numpy()
        row = {"seed": seed,
               "card_vs_cpu_px": float(np.abs(card - cpu)[..., :2].max()),
               "card_vs_cpu_m": float(np.abs(card - cpu)[..., 2].max()),
               "card_vs_cpu_ulps_yx": float(ulps(np.abs(card - cpu)[..., :2], cpu[..., :2])),
               "card_ulps_yx": float(ulps(np.abs(card - exact)[..., :2], exact[..., :2])),
               "cpu_ulps_yx": float(ulps(np.abs(cpu - exact)[..., :2], exact[..., :2])),
               "softmax_rel_err_in_eps_cpu": w_err["cpu"],
               "softmax_rel_err_in_eps_card": w_err["card"],
               "sum_ulps_cpu": float(ulps(np.abs(sums["cpu"] - sum_exact), sum_exact)),
               "sum_ulps_card": float(ulps(np.abs(sums["card"] - sum_exact), sum_exact))}
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    for what in ("decodes", "paf_score"):
        d = sub.add_parser(what)
        d.add_argument("--root", default=SELF_ROOT, help="checkout whose popnet_tpu_torch to time")
    sub.add_parser("vote")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 2
    if args.what == "decodes":
        decodes(args.root)
    elif args.what == "paf_score":
        paf_score(args.root)
    else:
        vote()
    return 0


if __name__ == "__main__":
    sys.exit(main())
