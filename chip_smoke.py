#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (popnet_tpu_torch) on one NVIDIA card.

Drives Open-Pose+ depth serving, the port's main path, at the model's full
width (RTPoseLight3D, 28 PAF / 16 heat / 15 z channels on a 28x28 grid)
with the committed trained weights, batch 256 of (512, 480) depth frames
made from --seed with a few person-like blobs each. Phases, one or more
lines each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles the kernels of csrc/ in parallel; ptxas's register
   and shared-memory lines are printed;
3. kernels: each kernel against its plain PyTorch version, on the card, at
   the main-path shapes plus the edge cases of the tests (exact ties,
   border peaks, window centres off the map);
4. slice: the float32 pipeline on 256 frames with launch counts reset just
   before and read just after; the same CNN maps decoded through the
   kernels and through the plain versions (on the host) must agree, and
   people must be found on most frames;
5. timing: the default bf16 pipeline with the q16 wire through
   serve_stream(queue_depth=3): its output against the float32 slice's on
   the same frames, frames/s, CUDA-event times per batch of the CNN and
   assembly, and each kernel's, its plain version's and the library call's
   device time (calls captured in a CUDA graph, so host dispatch is not
   counted) beside the kernel's bound.

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises and exits nonzero. Run
from the root of a checkout: python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "examples", "results", "bench_weights_openpose.npz")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores (data sheet)
BATCH = 256                 # the serving batch of bench.py's Open-Pose+ row
TIMED_BATCHES = 10          # batches in the timed serve_stream window

KERNEL_META = {
    "find_peaks": ("popnet_tpu_torch/csrc/find_peaks.cu", "popnet_tpu/ops/pallas_kernels.py:457"),
    "paf_score": ("popnet_tpu_torch/csrc/paf_score.cu", "popnet_tpu/ops/pallas_kernels.py:132"),
    "window_readout": ("popnet_tpu_torch/csrc/readout.cu", "popnet_tpu/ops/pallas_kernels.py:546"),
    "point_readout": ("popnet_tpu_torch/csrc/readout.cu", "popnet_tpu/ops/pallas_kernels.py:598"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int = 20, warm: int = 2) -> float:
    """Mean CUDA-event time of fn() over `reps` back-to-back eager calls:
    the card's time, or the host's where issuing the calls takes longer."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 3) -> float:
    """Device time of one fn() call: `reps` calls captured in one CUDA
    graph, whose replays are timed with CUDA events, so the host's dispatch
    of the calls is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the default stream, as capture asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def person_frames(rng: np.random.Generator, B: int, device, H: int = 512, W: int = 480):
    """(B, H, W) depth frames in metres: 2-3 people per frame, each a
    kinematic 15-joint template (the layout of tests/synthetic_data.py
    person_scene) drawn as 36-px depth blocks, on a zero background."""
    import torch

    n_people = 3
    pts = np.zeros((B, n_people, 15, 2))
    for b in range(B):
        for p in range(n_people):
            s = rng.uniform(0.85, 1.25)
            lean = rng.normal(0.0, 0.12)

            def rot(vx, vy, a):
                return np.array([vx * np.cos(a) - vy * np.sin(a), vx * np.sin(a) + vy * np.cos(a)])

            torso = np.array([110 + 130 * p, rng.uniform(190, 260)]) + rng.normal(0, 8, 2)
            neck = torso + rot(0, -62 * s, lean)
            pts[b, p, 8], pts[b, p, 1] = torso, neck
            pts[b, p, 0] = neck + rot(0, -34 * s, lean + rng.normal(0, 0.1))
            for side, sh_i, el_i, wr_i, hip_i, kn_i, an_i in (
                    (+1, 2, 4, 6, 9, 11, 13), (-1, 3, 5, 7, 10, 12, 14)):
                sh = neck + rot(side * 30 * s, 6 * s, lean)
                el = sh + rot(0, 42 * s, lean + rng.normal(0, 0.5))
                wr = el + rot(0, 40 * s, lean + rng.normal(0, 0.7))
                hip = torso + rot(side * 20 * s, 46 * s, lean)
                kn = hip + rot(0, 50 * s, lean + rng.normal(0, 0.25))
                an = kn + rot(0, 48 * s, lean + rng.normal(0, 0.25))
                for i, q in ((sh_i, sh), (el_i, el), (wr_i, wr), (hip_i, hip),
                             (kn_i, kn), (an_i, an)):
                    pts[b, p, i] = q
    pts += rng.normal(0, 2.0, size=pts.shape)
    pts = np.clip(pts, 10, [W - 10, H - 10])
    present = np.arange(n_people)[None, :] < rng.integers(2, n_people + 1, size=B)[:, None]
    z = rng.uniform(2.5, 4.5, size=(B, n_people, 1)) + rng.normal(0, 0.05, size=(B, n_people, 15))

    pts_t = torch.as_tensor(pts, dtype=torch.float32, device=device)
    z_t = torch.as_tensor(z, dtype=torch.float32, device=device)
    pres_t = torch.as_tensor(present, device=device)
    ys = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    depth = torch.zeros((B, H, W), device=device)
    for p in range(n_people):
        for k in range(15):
            m = ((xs - pts_t[:, p, k, 0, None, None]).abs() < 18) \
                & ((ys - pts_t[:, p, k, 1, None, None]).abs() < 18) \
                & pres_t[:, p, None, None]
            depth = torch.where(m, z_t[:, p, k, None, None], depth)
    return depth


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from popnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    say("build", f"nvcc built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(reports.items()):
        fn = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "Used" in line and "registers" in line:
                say("build", f"{name}.cu {fn}: {line.split(':', 1)[1].strip()}")


def _exact(name: str, a, b) -> None:
    import torch

    require(torch.equal(a.cpu(), b.cpu()), f"{name}: kernel and plain version differ")


def _maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernels(rng: np.random.Generator, dev, B: int) -> dict[str, float]:
    """Each kernel against its plain version on the card; returns max |err|."""
    import torch

    from popnet_tpu_torch.core.skeleton import LIMBS
    from popnet_tpu_torch.ops import kernels

    errs = {}
    # K1 at the main-path layout: the first 15 of 16 heat channels of NCHW maps
    heat16 = rng.uniform(0, 1, (B, 16, 28, 28)).astype(np.float32)
    heat16[0, 0, 5, 5] = heat16[0, 0, 5, 9] = 1.5      # exact tie
    heat16[0, 1, 0, 3] = heat16[0, 2, 27, 27] = heat16[1, 3, 5, 0] = 5.0  # border peaks
    heat16[2, 4] *= 0.09                                # no peak above threshold
    h = torch.as_tensor(heat16, device=dev)[:, :15]
    got = kernels.find_peaks(h)
    ref = kernels.find_peaks_plain(h)
    for i, n in ((0, "px"), (1, "py"), (2, "loc"), (4, "valid")):
        _exact(f"find_peaks {n}", got[i], ref[i])
    errs["find_peaks"] = _maxerr(got[3], ref[3])
    require(errs["find_peaks"] <= 1e-5, f"find_peaks score err {errs['find_peaks']}")
    say("kernels", f"find_peaks (B,K,H,W)={tuple(h.shape)}: px/py/loc/valid exact, "
        f"score max|err| {errs['find_peaks']:.3g} (bar 1e-5)")

    # K3 on the peaks of that heat and a PAF map in the CNN's NCHW memory
    paf = torch.as_tensor(rng.uniform(-1, 1, (B, 28, 28, 28)).astype(np.float32),
                          device=dev).permute(0, 2, 3, 1)
    from popnet_tpu_torch.decode.device import find_peaks_batched

    peaks, valid = find_peaks_batched(h.permute(0, 2, 3, 1))
    s_k, ok_k = kernels.paf_score(paf, peaks, valid, LIMBS)
    s_p, ok_p = kernels.paf_score_plain(paf, peaks, valid, LIMBS)
    _exact("paf_score ok", ok_k, ok_p)
    errs["paf_score"] = _maxerr(s_k, s_p)
    require(errs["paf_score"] <= 1e-5, f"paf_score err {errs['paf_score']}")
    say("kernels", f"paf_score paf={tuple(paf.shape)} peaks={tuple(peaks.shape)}: ok exact "
        f"({int(ok_k.sum())} pairs ok), score max|err| {errs['paf_score']:.3g} (bar 1e-5)")

    # K4 with centres off the map
    z = torch.as_tensor(rng.uniform(0.5, 6, (B, 15, 28, 28)).astype(np.float32),
                        device=dev).permute(0, 2, 3, 1)
    hz = torch.as_tensor(rng.uniform(-0.2, 1, (B, 15, 28, 28)).astype(np.float32),
                         device=dev).permute(0, 2, 3, 1)
    cx = torch.as_tensor(rng.integers(-3, 31, (B, 16, 15)), dtype=torch.int32, device=dev)
    cy = torch.as_tensor(rng.integers(-3, 31, (B, 16, 15)), dtype=torch.int32, device=dev)
    errs["window_readout"] = _maxerr(kernels.window_readout(z, hz, cx, cy),
                                     kernels.window_readout_plain(z, hz, cx, cy))
    require(errs["window_readout"] <= 1e-5, f"window_readout err {errs['window_readout']}")
    say("kernels", f"window_readout z={tuple(z.shape)} c={tuple(cx.shape)}: max|err| "
        f"{errs['window_readout']:.3g} (bar 1e-5)")

    # K5 at (256, 224, 224) with 16*15 points per frame
    img = torch.as_tensor(rng.uniform(0.5, 6, (B, 224, 224)).astype(np.float32), device=dev)
    px = torch.as_tensor(rng.integers(0, 224, (B, 240)), dtype=torch.int32, device=dev)
    py = torch.as_tensor(rng.integers(0, 224, (B, 240)), dtype=torch.int32, device=dev)
    a, b = kernels.point_readout(img, px, py), kernels.point_readout_plain(img, px, py)
    _exact("point_readout", a, b)
    errs["point_readout"] = _maxerr(a, b)
    say("kernels", f"point_readout img={tuple(img.shape)} p={tuple(px.shape)}: exact")
    torch.cuda.synchronize()
    return errs


def phase_slice(rng, dev, B, weights):
    """The float32 slice on B frames; returns the frames, the main path's
    launch counts and its unpacked output."""
    import torch

    from popnet_tpu_torch import build_openpose_pipeline
    from popnet_tpu_torch.decode.openpose_infer import openpose_decode
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.serving import preproc_depth, unpack_outputs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = person_frames(rng, B, dev)
    pipe = build_openpose_pipeline(weights, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    buf = pipe(frames)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("slice", f"main-path launches per kernel: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    out = unpack_outputs(buf.cpu().numpy(), 16, 15)
    require(buf.shape == (B, 16 * 15 * 6 + 1), f"packed buffer shape {tuple(buf.shape)}")
    require(bool(np.isfinite(out["joints2d"]).all() and np.isfinite(out["joints3d"]).all()),
            "non-finite values in the packed output")
    counts = out["counts"][:, 0].astype(int)
    found = float((counts > 0).mean())
    say("slice", f"B={B}: people found on {found:.1%} of frames, counts histogram "
        f"{np.bincount(counts, minlength=4).tolist()}")
    require(found >= 0.5, "people found on fewer than half of the frames")

    model = load_into(RTPoseLight3D(), weights).eval().to(dev)
    with torch.inference_mode():
        x = preproc_depth(frames)
        (paf, heat, z), _ = model(x.permute(0, 3, 1, 2))
        nhwc = [t.permute(0, 2, 3, 1) for t in (heat, paf, z)]
        dk = openpose_decode(*nhwc, x)
        dp = openpose_decode(*[t.cpu() for t in nhwc], x.cpu())
    require(np.array_equal(dk["counts"].cpu().numpy(), dp["counts"].numpy()),
            "kernel and plain decode disagree on counts")
    require(np.array_equal(dk["counts"].cpu().numpy(), counts), "pipeline counts differ")
    require(torch.equal(dk["visibility"].cpu(), dp["visibility"]), "visibility differs")
    e2 = _maxerr(dk["joints2d"].cpu(), dp["joints2d"])
    e3 = _maxerr(dk["joints3d"].cpu(), dp["joints3d"])
    say("slice", f"kernel decode vs plain decode (host) on the same maps: counts and "
        f"visibility exact, joints2d max|err| {e2:.3g} px, joints3d {e3:.3g} m (bar 1e-4)")
    require(e2 <= 1e-4 and e3 <= 1e-4, "kernel and plain decode joints differ")
    return frames, launches, out


def _bounds(name: str, inputs: dict) -> tuple[float, float, float]:
    """(bytes, ops, bound_ms) of one call at this run's inputs: each input
    byte read once, each output byte written once; ops at the float32 rate."""
    import torch
    import torch.nn.functional as F

    if name == "find_peaks":
        h, px, py, thresh = inputs["heat"], inputs["px"], inputs["py"], inputs["thresh"]
        B, K, H, W = h.shape
        M = px.shape[-1]
        size, factor = 5, 8
        nbytes = h.numel() * 4 + B * K * M * (4 * 4 + 1)
        # NMS once: 4 neighbour maxima, 2 compares and a select per cell; the
        # top-M pick: a compare and a select per NMS survivor
        pad = F.pad(h, (1, 1, 1, 1), value=-1e30)
        nbr = torch.maximum(torch.maximum(pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]),
                            torch.maximum(pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]))
        survivors = float(((h >= nbr) & (h > thresh)).sum())
        # refine of every slot over its window of win_h x win_w upsampled
        # cells: U.patch for the window's rows (win_h x size x size), then
        # their products with U^T in the window (win_h x win_w x size)
        win_w = ((px.clamp(max=2) + (W - 1 - px).clamp(max=2) + 1) * factor).double()
        win_h = ((py.clamp(max=2) + (H - 1 - py).clamp(max=2) + 1) * factor).double()
        refine = float((2 * size * win_h * (size + win_w)).sum())
        ops = 6.0 * h.numel() + 2.0 * survivors + refine
    elif name == "paf_score":
        paf, peaks, score = inputs["paf"], inputs["peaks"], inputs["score"]
        nbytes = paf.numel() * 4 + peaks.numel() * 4 + peaks.numel() // 3 + score.numel() * 5
        # per pair and point: 2 channels x 16 taps multiply-add, 8 cubic weights
        # of 11 ops, coordinates and projection about 17
        ops = float(score.numel() * 10 * (2 * 16 * 2 + 8 * 11 + 17))
    elif name == "window_readout":
        cx, cy, H, W = inputs["cx"], inputs["cy"], inputs["H"], inputs["W"]
        cells = (((cx + 1).clamp(0, W - 1) - (cx - 1).clamp(0, W - 1) + 1)
                 * ((cy + 1).clamp(0, H - 1) - (cy - 1).clamp(0, H - 1) + 1)).double()
        nbytes = float(cells.sum()) * 8 + cx.numel() * 12
        ops = float(cells.sum()) * 6 + cx.numel() * 6.0
    else:  # point_readout: index pair, the value read, the value written
        nbytes = inputs["cx"].numel() * 16
        ops = 0.0
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    return nbytes, ops, bound_ms


def phase_timing(frames, weights, dev, B: int, iters: int, errs, launches, f32_out):
    import torch

    from popnet_tpu_torch import build_openpose_pipeline, serve_stream
    from popnet_tpu_torch.core.config import DecodeConfig
    from popnet_tpu_torch.core.skeleton import LIMBS
    from popnet_tpu_torch.decode.assemble_device import assemble_batched
    from popnet_tpu_torch.decode.device import (find_peaks_batched, peak_planes,
                                                score_limb_pairs_batched)
    from popnet_tpu_torch.decode.openpose_infer import readout_inputs
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.serving import preproc_depth, unpack_outputs_q16

    pipe = build_openpose_pipeline(weights, pack="q16")     # bf16 CNN, the default
    warm = list(serve_stream(pipe, (frames for _ in range(3)), queue_depth=3))
    check_bf16(unpack_outputs_q16(warm[0], 16, 15), f32_out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = 0
    for buf in serve_stream(pipe, (frames for _ in range(iters)), queue_depth=3):
        n += buf.shape[0]
    wall = time.perf_counter() - t0
    fps = n / wall
    peak_mem = torch.cuda.max_memory_allocated()
    say("timing", f"serve_stream bf16 q16 queue_depth=3: {iters} batches of {B} in "
        f"{wall:.3f} s = {fps:.1f} frames/s ({wall / iters * 1e3:.2f} ms/batch); "
        f"max_memory_allocated {peak_mem / 2**20:.1f} MiB")

    # each kernel's inputs as the bf16 main path makes them, from its helpers
    model = keep_batchnorm_float32(load_into(RTPoseLight3D(), weights).eval().to(dev, torch.bfloat16))
    with torch.inference_mode():
        x = preproc_depth(frames)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        cnn_ms = time_ms(lambda: model(xb), reps=10)
        (paf, heat, z), _ = model(xb)
        heat_n, paf_n, z_n = (t.float().permute(0, 2, 3, 1) for t in (heat, paf, z))
        h = peak_planes(heat_n)
        px, py, _, _, _ = kernels.find_peaks(h)
        peaks, pvalid = find_peaks_batched(heat_n)
        scores, ok = score_limb_pairs_batched(paf_n, peaks, pvalid)
        joints, counts = assemble_batched(peaks, pvalid, scores, ok)
        (zmap, hk, gx, gy), (raw, rx, ry) = readout_inputs(joints, heat_n, z_n, x)
        bi, ryl, rxl = torch.arange(B, device=dev)[:, None], ry.long(), rx.long()
        calls = {
            "find_peaks": (lambda: kernels.find_peaks(h), lambda: kernels.find_peaks_plain(h),
                           None, {"heat": h, "px": px, "py": py,
                                  "thresh": DecodeConfig().thresh_heatmap}),
            "paf_score": (lambda: kernels.paf_score(paf_n, peaks, pvalid, LIMBS),
                          lambda: kernels.paf_score_plain(paf_n, peaks, pvalid, LIMBS),
                          None, {"paf": paf_n, "peaks": peaks, "score": scores}),
            "window_readout": (lambda: kernels.window_readout(zmap, hk, gx, gy),
                               lambda: kernels.window_readout_plain(zmap, hk, gx, gy),
                               None, {"cx": gx, "cy": gy, "H": 28, "W": 28}),
            "point_readout": (lambda: kernels.point_readout(raw, rx, ry),
                              lambda: kernels.point_readout_plain(raw, rx, ry),
                              lambda: raw[bi, ryl, rxl], {"cx": rx}),
        }
        rows = []
        for name, (kern, plain, lib, inputs) in calls.items():
            ms = graph_ms(kern)
            eager_ms = time_ms(kern)
            plain_ms = graph_ms(plain, reps=5)
            lib_ms = graph_ms(lib) if lib is not None else None
            nbytes, ops, bound_ms = _bounds(name, inputs)
            bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
            say("timing", f"{name}: {ms:.4f} ms/batch on the card (CUDA graph; "
                f"{eager_ms:.4f} ms per eager call), plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)"
                + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""))
            src, rep = KERNEL_META[name]
            rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                         "launches": launches[name], "max_abs_err": errs[name],
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms})
        asm_ms = time_ms(lambda: assemble_batched(peaks, pvalid, scores, ok), reps=3, warm=1)
    say("timing", f"CNN bf16 {cnn_ms:.3f} ms/batch; assembly (plain torch, eager, "
        f"{len(LIMBS) * 16} merge steps) {asm_ms:.3f} ms/batch; people in the timed "
        f"batch {int(counts.sum())}")
    return rows


def check_bf16(q16: dict, f32: dict) -> None:
    """The timed configuration (bf16 CNN, q16 wire) against the float32
    slice on the same frames: person counts equal on at least 80% of the
    frames, and people and visible joints in all within 10% (bars wide of
    bf16's rounding, tight enough to catch a broken bf16 path)."""
    cq, cf = q16["counts"][:, 0].astype(int), f32["counts"][:, 0].astype(int)
    vq = int((q16["joints2d"][..., 0] >= 0).sum())
    vf = int((f32["joints2d"][..., 0] >= 0).sum())
    same = float((cq == cf).mean())
    say("timing", f"bf16+q16 vs f32 on the same {len(cf)} frames: counts equal on "
        f"{same:.1%} (bar 80%), people {cq.sum()} vs {cf.sum()}, visible joints {vq} vs "
        f"{vf} (bar 10%)")
    require(bool(np.isfinite(q16["joints3d"]).all()), "non-finite values in the q16 output")
    require(same >= 0.80, "bf16 and f32 person counts differ on more than 20% of frames")
    require(abs(int(cq.sum()) - int(cf.sum())) <= 0.10 * cf.sum(), "bf16 people differ by over 10%")
    require(abs(vq - vf) <= 0.10 * vf, "bf16 visible joints differ by over 10%")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the frames and test inputs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from popnet_tpu_torch import load_npz

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    phase_device()
    phase_build()
    errs = phase_kernels(rng, dev, BATCH)
    weights = load_npz(WEIGHTS)
    frames, launches, f32_out = phase_slice(rng, dev, BATCH, weights)
    rows = phase_timing(frames, weights, dev, BATCH, TIMED_BATCHES, errs, launches, f32_out)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
