#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (popnet_tpu_torch) on one NVIDIA card.

Drives the port's five serving paths at the models' full width, and its
MP-3DHP evaluation drivers for the four depth families: the four
depth paths at batch 256 of (512, 480) depth frames made from --seed with
two or three person-like figures each, and COCO RGB at batch 64 of
(480, 640, 3) BGR frames uniform in [0, 255):

- Open-Pose+ (RTPoseLight3D, 28 PAF / 16 heat / 15 z channels on a 28x28
  grid), frames on a zero background;
- PoP-Net (PopNet: heat 16 / z 15 / align 30 channels on 28x28 and a prior
  subnet of 2 anchors x 50 channels on 14x14), the same figures over the
  smooth 2.5-5.5 m background its weights were trained on;
- Yolo-Pose+ (YoloPoseNet, 2 anchors x 50 channels on 14x14), the
  committed weights, frames over the same background;
- Yolo->A2J: that detector's 4 best boxes a frame cropped to 288x288 and
  refined by A2J (dilated ResNet-50, 16 anchors on 18x18) from its seeded
  init, as no A2J weights are committed;
- COCO RGB: RTPoseVGG (VGG19 trunk, 6 stages, 38 PAF / 19 heat channels on
  46x46 at 368 px) from its seeded init with the stage-6 heads scaled
  (coco_weights), as no COCO weights are committed, and the 2D decode with
  the COCO-18 tables (K1, K3 in two groups of limbs a frame, K6).

Phases, one or more lines each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles the kernels of csrc/ in parallel, and find_peaks,
   paf_score and assemble once more with stage clocks; ptxas's register,
   shared-memory and spill lines are printed;
3. kernels: each of the seven kernels against its plain PyTorch version,
   on the card, at the main-path shapes plus edge cases (exact ties, border
   peaks, plateaus, a plane with no peak, sparse heat in two memory orders,
   the per-frame peak kernel at K = 1, 5, 15, 16 on three grids and three
   memory layouts, peaks that share coordinates, window centres on the
   borders and off the map at radius 1 and 2 on channels-last and sliced
   maps, an image of signed zeros, assembly from no candidate to every pair
   a candidate, on tied scores with +0.0 and -0.0, with 56 slots a frame and
   at 20 peaks a joint), the two peak kernels against each other, and the
   decode's fused readouts (K4 and K5 in one launch from the normalized
   maps) against their plain version, on every value of a batch's input;
   then K1, K3 and K6 at the COCO shapes on painted people (2-4 a frame,
   coco_people_maps) in two memory orders, and the COCO decode of those
   maps on the card against the host's and against the painted people;
4. slices, float32, 256 frames each, launch counts reset just before a path
   is driven and read just after: Open-Pose+ (then the assembly kernel
   against its plain version on that batch's candidates, and the same maps
   decoded once more through the per-frame peak kernel), PoP-Net,
   Yolo-Pose+, Yolo->A2J and COCO RGB (64 frames; its MobileNet trunk on
   8). The same CNN maps decoded on the card (through the kernels) and on
   the host (through the plain versions) must agree bit for bit, and people
   must be found on most frames; Yolo->A2J's crops on
   card and host bit for bit, its A2J heads and vote against the host's on
   a few crops, the bf16 A2J against the float32 one on every crop, and the
   Yolo paths' outputs against their stages run one by one, bit for bit;
5. timing: each path's default bf16 pipeline with the q16 wire through
   serve_stream(queue_depth=3): its output against the float32 slice's on
   the same frames (Yolo->A2J's also against its stages run one by one in
   bf16), frames/s, CUDA-event times per batch of the CNN and the decode
   (Yolo->A2J: the detector, the crop, the A2J CNN, the vote), and each
   kernel's, its plain version's and the library call's
   device time (calls captured in a CUDA graph, so host dispatch is not
   counted) beside the kernel's bound, counted from the work these inputs
   need; the plain assembler eager and as a CUDA graph beside the assembly
   kernel; the main path's valid peaks per plane and distinct coordinate
   pairs per limb, the blocks an SM holds (K1, K2, K3, K6) and the
   clusters of K2 the card places at once, the copy width of K1 and K3, the
   time by stage of K1, K2, K3 and K6 from per-block clock64() stamps (and
   how K1's and K2's blocks were scheduled, from their spans on the global
   timer), the fused readouts beside K4 and K5 alone, the launch floor (a one-element
   fill in a CUDA graph), the decode's readout stage as a CUDA graph, and
   the device operations that it and the eager decode issue (torch.profiler);
   COCO RGB's stream on the f32 wire, its CNN's TFLOP/s from its conv
   shapes, its decode and its device operations, and K1, K3 and K6 at the
   COCO shapes on the painted maps beside their bounds (a "coco" entry in
   their rows of the kernels line), with K3's stages.

6. eval: the MP-3DHP evaluation drivers (popnet_tpu_torch.cli) on two
   labelled sets of 256 frames written to a temporary directory (.npy depth
   and an MP-3DHP labels.json; zero and depth backgrounds), batch 64,
   float32 CNNs with the committed weights (A2J seeded): Open-Pose+ with the
   host decode and with device_decode, PoP-Net, Yolo-Pose+ and Yolo->A2J,
   launch counts reset just before and read just after; each driver run
   once more on the host with the same CNN outputs (plain versions): JSON
   equal bit for bit (A2J joints within the vote's 64-ulp bar) and metrics
   equal; the batched metrics on the card against NumPy's; each family's
   four metrics and eval frames/s; the painted Open-Pose+ oracle
   (openpose_painted_maps) over pck2d 0.95, pck3d 0.9, map2d 0.9, map3d
   0.85 and perfect_2d 0.95; the evaluate and benchmark subcommands once.

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
WEIGHTS_POPNET = os.path.join(ROOT, "examples", "results", "bench_weights_popnet.npz")
WEIGHTS_YOLO = os.path.join(ROOT, "examples", "results", "bench_weights_yolo.npz")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores (data sheet)
SMEM_ROUND_TRIP_CYCLES = 30  # one dependent shared-memory load, about, on sm_90
BATCH = 256                 # the serving batch of bench.py's Open-Pose+ row
TIMED_BATCHES = 10          # batches in each timed serve_stream window
MAX_CROPS = 4               # A2J crops a frame, as bench.py's Yolo->A2J row
COCO_BATCH = 64             # the batch of bench.py's COCO RGB row (BENCH_MODEL=rtpose_vgg)
COCO_FRAME = (480, 640)     # its BGR frames, (H, W)
COCO_HEAD_SCALE = 2.0 ** 35  # the seeded RTPoseVGG's stage-6 heads (coco_weights)
# bf16 RTPoseVGG's maps against float32 on the same frames, over the largest
# magnitude: about 2.5 times the 2.0% (heat) and 1.7% (PAF) read on the CPU
# (16 frames of the seeded init)
COCO_BF16_MAP_BAR = 0.05
A2J_SEED = 0                # the seeded A2J init (no A2J weights are committed)
EVAL_FRAMES = 256           # labelled frames of each set of the eval phase
EVAL_BATCH = 64             # the eval phase's batch
A2J_HOST_FRAMES = 16        # frames whose crops' A2J vote is also run on the host
A2J_HOST_CNN_CROPS = 2      # crops whose A2J heads are also computed on the host
# bf16 A2J against float32 on the same crops (bf16_heads): about twice the
# readings on an H100 80GB HBM3 at 700 W (each head within 1.4-1.7% of its
# largest magnitude; the vote's (y, x) median 2.3, 99th percentile 34.1 crop px)
A2J_BF16_BARS = {"classification": 0.03, "regression": 0.03, "depth": 0.03,
                 "vote_median": 5.0, "vote_p99": 70.0}

# name: (source, the TPU kernel it replaces)
KERNEL_META = {
    "find_peaks": ("popnet_tpu_torch/csrc/find_peaks.cu", "popnet_tpu/ops/pallas_kernels.py:457"),
    "find_peaks_row": ("popnet_tpu_torch/csrc/find_peaks.cu",
                       "popnet_tpu/ops/pallas_kernels.py:278"),
    "paf_score": ("popnet_tpu_torch/csrc/paf_score.cu", "popnet_tpu/ops/pallas_kernels.py:132"),
    "window_readout": ("popnet_tpu_torch/csrc/readout.cu", "popnet_tpu/ops/pallas_kernels.py:546"),
    "point_readout": ("popnet_tpu_torch/csrc/readout.cu", "popnet_tpu/ops/pallas_kernels.py:598"),
    "assemble_ids": ("popnet_tpu_torch/csrc/assemble.cu",
                     "popnet_tpu/decode/assemble_pallas.py:200"),
    "peak_local_max": ("popnet_tpu_torch/csrc/peak_mask.cu",
                       "popnet_tpu/ops/pallas_kernels.py:49"),
}
PEAK_OUTPUTS = ("px", "py", "loc", "score", "valid")
OPENPOSE_PATH = ("find_peaks", "paf_score", "assemble_ids", "window_readout", "point_readout")
COCO_PATH = ("find_peaks", "paf_score", "assemble_ids")
# the stages between a kernel's STAGE_STAMPs, in order (csrc/common.cuh)
STAGES = {"find_peaks": ("load", "NMS", "top-M", "refine"),
          "find_peaks_row": ("load", "NMS", "top-M", "refine"),
          "paf_score": ("copies issued", "peaks", "load wait", "integrals", "fill"),
          "assemble_ids": ("load", "match", "merge", "pack")}
# the kernels that stamp each block's span on the global timer in stamp slots 6 and 7
SPANS = ("find_peaks", "find_peaks_row")


def source_of(name: str) -> str:
    """The csrc/ source name of a kernel (its library, its stage-clock build)."""
    return os.path.splitext(os.path.basename(KERNEL_META[name][0]))[0]


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


def person_frames(rng: np.random.Generator, B: int, device, H: int = 512, W: int = 480,
                  background: bool = False, people: bool = False):
    """(B, H, W) depth frames in metres: 2-3 people per frame, each a
    kinematic 15-joint template (the layout of tests/synthetic_data.py
    person_scene) drawn as 36-px depth blocks, on a zero background or, with
    `background`, on that module's smooth 2.5-5.5 m one (a phase per frame).
    With `people`, also the drawn people: {"joints2d": (B, 3, 15, 2) px,
    "z": (B, 3, 15) metres, "present": (B, 3) bool}."""
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
    if background:
        phase = torch.as_tensor(rng.uniform(0, 2 * np.pi, (B, 1, 1)), dtype=torch.float32,
                                device=device)
        bg = 4.0 + 1.5 * torch.sin(xs / 60.0 + phase) * torch.cos(ys / 80.0)
        depth = torch.where(depth > 0, depth, bg)
    if people:
        return depth, {"joints2d": pts, "z": z, "present": present}
    return depth


def phase_device() -> float:
    """Print the card's name and power limit; return its top SM clock in MHz."""
    import torch

    def smi(fields: str) -> str:
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip()

    print(smi("name,power.limit"), flush=True)
    clock = float(smi("clocks.max.sm").splitlines()[0].split()[0])
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}, "
        f"top SM clock {clock:.0f} MHz")
    return clock


def phase_build():
    from popnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all(stamps=tuple(sorted({source_of(n) for n in STAGES})))
    say("build", f"nvcc built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(reports.items()):
        if name.endswith("-stamps"):
            continue
        fn = spill = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                say("build", f"{name}.cu {fn}: {line.split(':', 1)[1].strip()}; {spill}")


def _exact(name: str, a, b) -> None:
    import torch

    require(torch.equal(a.cpu(), b.cpu()), f"{name}: kernel and plain version differ")


def _maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def dense_candidates(rng: np.random.Generator, B: int, K: int = 15, M: int = 16):
    """Assembly inputs (peak_score (B, K, M), s_masked (B, L, M, M)) whose
    candidate density steps through 0, 0.08, 0.3, 0.7 and 1 from frame to
    frame: from no candidate at all to every pair a candidate, which forces
    long merge chains and slots created well past max_people. Some pair
    scores tie exactly."""
    from popnet_tpu_torch.core.skeleton import LIMBS

    L = len(LIMBS)
    density = np.asarray((0.0, 0.08, 0.3, 0.7, 1.0))[np.arange(B) % 5]
    n_valid = rng.integers(0, M + 1, size=(B, K))
    valid = np.arange(M)[None, None, :] < n_valid[:, :, None]
    peak_score = np.where(valid, rng.uniform(0.1, 1.0, size=(B, K, M)), 0.0).astype(np.float32)
    scores = rng.uniform(0.01, 2.0, size=(B, L, M, M)).astype(np.float32)
    scores[:, 3, 2, 5] = scores[:, 3, 7, 1] = scores[:, 3, 7, 9] = 1.75
    ok = rng.uniform(size=(B, L, M, M)) < density[:, None, None, None]
    limbs = np.asarray(LIMBS)
    ok &= valid[:, limbs[:, 0]][:, :, :, None] & valid[:, limbs[:, 1]][:, :, None, :]
    return peak_score, np.where(ok, scores, -np.inf).astype(np.float32)


def tied_candidates(rng: np.random.Generator, B: int, K: int = 15, M: int = 16):
    """Assembly inputs whose pair scores are quantized to 1/8, so equal
    scores are common, with +0.0 and -0.0 among them (a tie that falls to
    the lower flat index); every peak valid, half the pairs candidates, and
    all 256 pairs of limb 4 candidates."""
    from popnet_tpu_torch.core.skeleton import LIMBS

    L = len(LIMBS)
    peak_score = rng.uniform(0.1, 1.0, (B, K, M)).astype(np.float32)
    scores = (np.round(rng.uniform(-0.25, 1.0, (B, L, M, M)) * 8) / 8).astype(np.float32)
    zero = scores == 0
    scores[zero] = np.where(rng.uniform(size=int(zero.sum())) < 0.5, -0.0, 0.0)
    ok = rng.uniform(size=(B, L, M, M)) < 0.5
    ok[:, 4] = True
    return peak_score, np.where(ok, scores, -np.inf).astype(np.float32)


def many_slot_candidates(rng: np.random.Generator, B: int, K: int = 15, M: int = 16):
    """Assembly inputs on which every accepted connection opens a slot of its
    own: limb l's candidates are a 4x4 block of pairs of peaks that no limb
    before it used at its joints, so a frame creates 56 slots (more than one
    warp's 32) of two joints each."""
    from popnet_tpu_torch.core.skeleton import LIMBS

    L = len(LIMBS)
    peak_score = rng.uniform(0.1, 1.0, (B, K, M)).astype(np.float32)
    scores = rng.uniform(0.01, 2.0, (B, L, M, M)).astype(np.float32)
    ok = np.zeros((B, L, M, M), bool)
    used = np.zeros(K, int)
    for l, (a, c) in enumerate(LIMBS):
        ok[:, l, used[a]:used[a] + 4, used[c]:used[c] + 4] = True
        used[a] += 4
        used[c] += 4
    return peak_score, np.where(ok, scores, -np.inf).astype(np.float32)


def sparse_heat(rng: np.random.Generator, B: int, K: int = 16, H: int = 28, W: int = 28):
    """(B, K, H, W) heat in the main path's regime: noise below the
    threshold and up to four bumps a plane, anywhere (borders included);
    about a quarter of the planes have none."""
    heat = rng.uniform(0, 0.08, (B, K, H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    for p in (0.45, 0.3, 0.2, 0.1):
        amp = np.where(rng.uniform(size=(B, K)) < p, rng.uniform(0.3, 1.0, (B, K)), 0.0)
        cy, cx = rng.integers(0, H, (B, K)), rng.integers(0, W, (B, K))
        d2 = (ys - cy[..., None, None]) ** 2 + (xs - cx[..., None, None]) ** 2
        heat = np.maximum(heat, (amp[..., None, None] * np.exp(-d2 / 2.0)).astype(np.float32))
    return heat


def shared_coordinates(peaks, valid):
    """Copies of K1's (peaks, valid) edited so that slots share coordinates
    beyond the empty slots, which share theirs by K1's contract: two valid
    slots at one point, x or y of +0.0 against -0.0, and a limb's two ends at
    one point (limb 0 is torso 8 -> right hip 9); and two peaks so far off the
    map (x = +-1e8) that their line's taps fall beyond the pad."""
    import torch

    peaks, valid = peaks.clone(), valid.clone()
    peaks[0, 8, 1, :2] = peaks[0, 8, 0, :2]
    peaks[0, 9, 0, :2] = torch.tensor([0.0, 5.0])
    peaks[0, 9, 1, :2] = torch.tensor([-0.0, 5.0])
    peaks[1, 8, 0, :2] = torch.tensor([7.0, 0.0])
    peaks[1, 8, 1, :2] = torch.tensor([7.0, -0.0])
    peaks[1, 9, 0, :2] = peaks[1, 8, 0, :2]
    peaks[2, 8, 0, :2] = torch.tensor([1e8, 3.0])
    peaks[2, 9, 0, :2] = torch.tensor([-1e8, 5.0])
    valid[0:3, 8:10, :2] = True
    return peaks, valid


def distinct_per_plane(peaks):
    """(B, K, M, 3) peaks -> (B, K) count of distinct (x, y) bit patterns."""
    import torch

    bits = peaks[..., :2].contiguous().view(torch.int32).long()
    key, _ = ((bits[..., 0] << 32) | (bits[..., 1] & 0xFFFFFFFF)).sort(dim=-1)
    return 1 + (key[..., 1:] != key[..., :-1]).sum(-1)


def distinct_pairs(peaks, limbs=None):
    """(B, L) count of distinct (src, dst) coordinate pairs per limb of
    `limbs` (the depth skeleton's by default)."""
    import torch

    from popnet_tpu_torch.core.skeleton import LIMBS

    nd = distinct_per_plane(peaks)
    la = torch.as_tensor(LIMBS if limbs is None else limbs, device=peaks.device)
    return nd[:, la[:, 0]] * nd[:, la[:, 1]]


def phase_kernels(rng: np.random.Generator, rng_new: np.random.Generator,
                  rng3: np.random.Generator, rng4: np.random.Generator, dev,
                  B: int) -> dict[str, float]:
    """Each kernel against its plain version on the card; returns max |err|.
    `rng` feeds the four kernels of the first slice as it always did,
    `rng_new` the later ones, `rng3` the sparse and shared-coordinate cases,
    `rng4` the readout's other radii and maps and the assembly's ties and
    many slots."""
    import torch

    from popnet_tpu_torch.core.skeleton import LIMBS
    from popnet_tpu_torch.ops import kernels

    def maps(a):
        """(B, C, H, W) values as the serving path's CNN leaves them: in
        channels-last memory."""
        return torch.as_tensor(a, device=dev).contiguous(memory_format=torch.channels_last)

    errs = {}
    # K1 at the main-path layout: the first 15 of 16 heat channels of the maps
    heat16 = rng.uniform(0, 1, (B, 16, 28, 28)).astype(np.float32)
    heat16[0, 0, 5, 5] = heat16[0, 0, 5, 9] = 1.5      # exact tie
    heat16[0, 1, 0, 3] = heat16[0, 2, 27, 27] = heat16[1, 3, 5, 0] = 5.0  # border peaks
    heat16[2, 4] *= 0.09                                # no peak above threshold
    h = maps(heat16)[:, :15]
    got = kernels.find_peaks(h)
    ref = kernels.find_peaks_plain(h)
    for i, n in enumerate(PEAK_OUTPUTS):
        _exact(f"find_peaks {n}", got[i], ref[i])
    errs["find_peaks"] = _maxerr(got[3], ref[3])
    # sparse heat, the main path's regime, in channels-last and in NCHW memory
    sparse = maps(sparse_heat(rng3, B))
    for tag, hs in (("channels-last", sparse[:, :15]), ("NCHW", sparse.contiguous()[:, :15])):
        sp, sp_ref = kernels.find_peaks(hs), kernels.find_peaks_plain(hs)
        for i, n in enumerate(PEAK_OUTPUTS):
            _exact(f"find_peaks {n} on sparse heat, {tag} memory", sp[i], sp_ref[i])
    nv = sp[4].sum(-1)
    say("kernels", f"find_peaks (B,K,H,W)={tuple(h.shape)}: px/py/loc/score/valid exact on "
        f"uniform heat; so on sparse heat in channels-last and NCHW memory (valid peaks per "
        f"plane mean {float(nv.float().mean()):.2f}, max {int(nv.max())}, "
        f"{float((nv == 0).float().mean()):.1%} of planes without one)")

    # K2 on the same planes: the plain version and K1, all five outputs bit for bit
    row = kernels.find_peaks_row(h)
    for i, n in enumerate(PEAK_OUTPUTS):
        _exact(f"find_peaks_row {n}", row[i], ref[i])
        _exact(f"find_peaks_row {n} against find_peaks", row[i], got[i])
    errs["find_peaks_row"] = _maxerr(row[3], ref[3])
    for a, b in zip(kernels.find_peaks_row(sparse[:, :15]), sp_ref):
        _exact("find_peaks_row on sparse heat", a, b)
    small = np.round(rng_new.uniform(0, 1, (8, 15, 12, 10)) * 16).astype(np.float32) / 16
    small[0, 0] *= 0.09                                 # plateaus everywhere, one empty plane
    hs = torch.as_tensor(small, device=dev)
    for a, b, c in zip(kernels.find_peaks_row(hs, max_peaks=32),
                       kernels.find_peaks_plain(hs, max_peaks=32),
                       kernels.find_peaks(hs, max_peaks=32)):
        _exact("find_peaks_row on a 12x10 grid, 32 peaks", a, b)
        _exact("find_peaks_row against find_peaks on a 12x10 grid", a, c)
    say("kernels", f"find_peaks_row (B,K,H,W)={tuple(h.shape)}: px/py/loc/score/valid exact "
        f"against the plain version and against find_peaks, on uniform and sparse heat; so "
        f"on a 12x10 grid of plateaus with 32 peaks")
    n_k2 = k2_cases(rng4, dev)
    say("kernels", f"find_peaks_row: px/py/loc/score/valid exact against the plain version and "
        f"find_peaks in {n_k2} more cases: K = 1, 5, 15, 16 on 12x10, 28x28 and 46x46 grids, NCHW, "
        f"NHWC and sliced planes, dense heat (a plane of at least 12 peaks, 32 kept), sparse "
        f"heat and a flat plane")

    # K3 on the peaks of that heat and a PAF map, then on peaks that share coordinates
    paf = maps(rng.uniform(-1, 1, (B, 28, 28, 28)).astype(np.float32)).permute(0, 2, 3, 1)
    from popnet_tpu_torch.decode.device import find_peaks_batched

    peaks, valid = find_peaks_batched(h.permute(0, 2, 3, 1))
    s_k, ok_k = kernels.paf_score(paf, peaks, valid, LIMBS)
    s_p, ok_p = kernels.paf_score_plain(paf, peaks, valid, LIMBS)
    _exact("paf_score ok", ok_k, ok_p)
    _exact("paf_score score", s_k, s_p)
    errs["paf_score"] = _maxerr(s_k, s_p)
    pk_sh, v_sh = shared_coordinates(*find_peaks_batched(sparse[:, :15].permute(0, 2, 3, 1)))
    for a, b, n in zip(kernels.paf_score(paf, pk_sh, v_sh, LIMBS),
                       kernels.paf_score_plain(paf, pk_sh, v_sh, LIMBS), ("score", "ok")):
        _exact(f"paf_score {n} with shared coordinates", a, b)
    pairs = distinct_pairs(pk_sh)
    say("kernels", f"paf_score paf={tuple(paf.shape)} peaks={tuple(peaks.shape)}: ok and score "
        f"exact ({int(ok_k.sum())} pairs ok); so on sparse peaks that share coordinates (empty "
        f"slots, two valid slots at one point, x and y of +0.0 against -0.0; distinct pairs "
        f"per limb mean {float(pairs.float().mean()):.2f} of 256)")

    # K4 with centres on the borders and off the map, bit for bit
    z = maps(rng.uniform(0.5, 6, (B, 15, 28, 28)).astype(np.float32)).permute(0, 2, 3, 1)
    hz = maps(rng.uniform(-0.2, 1, (B, 15, 28, 28)).astype(np.float32)).permute(0, 2, 3, 1)
    cx = torch.as_tensor(rng.integers(-3, 31, (B, 16, 15)), dtype=torch.int32, device=dev)
    cy = torch.as_tensor(rng.integers(-3, 31, (B, 16, 15)), dtype=torch.int32, device=dev)
    got, ref = kernels.window_readout(z, hz, cx, cy), kernels.window_readout_plain(z, hz, cx, cy)
    _exact("window_readout", got, ref)
    errs["window_readout"] = _maxerr(got, ref)
    # radius 2 (the kernel's loop) beside radius 1 (its unrolled window), on
    # the channels-last maps and on slices of larger NHWC maps
    big = [torch.as_tensor(rng4.uniform(lo, hi, (B, 31, 30, 17)).astype(np.float32), device=dev)
           for lo, hi in ((0.5, 6), (-0.2, 1))]
    zs, hs = (t[:, 2:30, 1:29, 1:16] for t in big)
    for radius in (1, 2):
        for tag, zz, hh in (("channels-last", z, hz), ("sliced", zs, hs)):
            _exact(f"window_readout radius {radius}, {tag} maps",
                   kernels.window_readout(zz, hh, cx, cy, radius),
                   kernels.window_readout_plain(zz, hh, cx, cy, radius))
    say("kernels", f"window_readout z={tuple(z.shape)} c={tuple(cx.shape)}: exact, centres on the "
        f"borders and off the map included; so at radius 1 and 2 on channels-last maps and on "
        f"slices of larger NHWC maps")

    # K5 at (256, 224, 224) with 16*15 points per frame
    img = torch.as_tensor(rng.uniform(0.5, 6, (B, 224, 224)).astype(np.float32), device=dev)
    px = torch.as_tensor(rng.integers(0, 224, (B, 240)), dtype=torch.int32, device=dev)
    py = torch.as_tensor(rng.integers(0, 224, (B, 240)), dtype=torch.int32, device=dev)
    a, b = kernels.point_readout(img, px, py), kernels.point_readout_plain(img, px, py)
    _exact("point_readout", a, b)
    errs["point_readout"] = _maxerr(a, b)
    signed = torch.where(img > 3.0, 0.0, -0.0)          # +0.0 and -0.0 read as they are
    s_k = kernels.point_readout(signed, px, py)
    _exact("point_readout on signed zeros", s_k, kernels.point_readout_plain(signed, px, py))
    require(bool(torch.signbit(s_k).any()), "point_readout lost the sign of -0.0")
    say("kernels", f"point_readout img={tuple(img.shape)} p={tuple(px.shape)}: exact; so on an "
        f"image of +0.0 and -0.0")
    readouts_cases(rng4, dev, B, maps)

    # K7 on quantized heat (equal neighbours are common) with plateaus inside
    # and on the borders, corner maxima and a constant plane, in the main
    # path's channels-last memory and in NCHW memory, through a channel slice
    q = np.round(rng_new.uniform(0, 1, (B, 16, 28, 28)) * 8) / 8
    q[0, 0, 4:7, 4:8] = q[0, 0, 0:2, 25:] = 2.0
    q[1, 1, 0, 0] = q[1, 1, 27, 27] = q[1, 1, 27, 5] = q[1, 1, 9, 0] = 3.0
    q[2, 2] = 0.5
    hq = maps(q.astype(np.float32))
    marked = 0
    nchw_memory = hq.contiguous()[:, :15]
    for thresh in (float("-inf"), 0.5):
        ref = kernels.peak_local_max_plain(hq[:, :15], thresh)
        m_k = kernels.peak_local_max(hq[:, :15], thresh)
        _exact(f"peak_local_max thresh={thresh}", m_k, ref)
        _exact(f"peak_local_max thresh={thresh}, NCHW memory (walked x fastest)",
               kernels.peak_local_max(nchw_memory, thresh), ref)
        errs["peak_local_max"] = max(errs.get("peak_local_max", 0.0), _maxerr(m_k, ref))
        marked = int(m_k.sum())
    nhwc = hq.permute(0, 2, 3, 1)[..., :15]
    m_k = kernels.peak_mask(nhwc, 0.5)
    _exact("peak_mask", m_k, kernels.peak_local_max_plain(hq[:, :15], 0.5).permute(0, 2, 3, 1))
    require(bool(m_k[0, 4:7, 4:8, 0].all()) and int(m_k[2, :, :, 2].sum()) == 0,
            "peak_mask: a plateau marks every cell; 0.5 is not above 0.5")
    say("kernels", f"peak_local_max (B,K,H,W)={tuple(hq[:, :15].shape)}: exact with and "
        f"without the threshold, plateaus and borders included, in channels-last and in NCHW memory "
        f"({marked} cells marked at 0.5)")

    # K6 from no candidate to every pair a candidate
    ps, sm = (torch.as_tensor(a, device=dev) for a in dense_candidates(rng_new, B))
    ids_k, cnt_k = kernels.assemble_ids(ps, sm, LIMBS)
    ids_p, cnt_p = kernels.assemble_ids_plain(ps, sm, LIMBS)
    _exact("assemble_ids ids", ids_k, ids_p)
    _exact("assemble_ids counts", cnt_k, cnt_p)
    require(bool((cnt_k[0::5] == 0).all()) and bool((cnt_k[4::5] > 0).all()),
            "assemble_ids: the empty frames hold nobody, the densest ones somebody")
    for a, b in zip(kernels.assemble_ids(ps, sm, LIMBS, max_people=3, min_parts=2, min_score=0.5),
                    kernels.assemble_ids_plain(ps, sm, LIMBS, max_people=3, min_parts=2,
                                               min_score=0.5)):
        _exact("assemble_ids with max_people=3", a, b)
    errs["assemble_ids"] = _maxerr(ids_k, ids_p)
    # tied scores with +0.0 and -0.0 and a limb of 256 candidates; 56 slots a
    # frame, kept by min_parts=2 and 40 rows; a peak count other than 16
    n_slots = {}
    for tag, (a, b), kw in (
            ("on tied scores", tied_candidates(rng4, B), {}),
            ("with 56 slots a frame", many_slot_candidates(rng4, B),
             dict(max_people=40, min_parts=2, min_score=0.0)),
            ("at M=20 (the kernel's general build)", dense_candidates(rng4, B, M=20), {})):
        pa, sa = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
        got, ref = kernels.assemble_ids(pa, sa, LIMBS, **kw), kernels.assemble_ids_plain(pa, sa, LIMBS, **kw)
        _exact(f"assemble_ids ids {tag}", got[0], ref[0])
        _exact(f"assemble_ids counts {tag}", got[1], ref[1])
        n_slots[tag] = int(got[1].sum())
    require(n_slots["with 56 slots a frame"] == 40 * B, "assemble_ids: 56 slots kept as 40 rows")
    say("kernels", f"assemble_ids peak_score={tuple(ps.shape)} s_masked={tuple(sm.shape)}: ids "
        f"and counts exact at candidate densities 0, 0.08, 0.3, 0.7, 1 ({int(cnt_k.sum())} "
        f"people kept); so on tied scores with +0.0 and -0.0 and a limb of 256 candidates, with "
        f"56 slots a frame (40 rows kept) and at M=20; people kept {n_slots}")
    torch.cuda.synchronize()
    return errs


def k2_cases(rng, dev) -> int:
    """K2 (a cluster of 2 CTAs a frame) against the plain version and K1,
    all five outputs bit for bit: K = 1, 5, 15 and 16 (fewer planes than
    CTAs, odd, even); 12x10, 28x28 and 46x46 grids;
    planes of NCHW and NHWC memory and slices of larger maps; dense heat
    (uniform, with a lattice of at least 12 peaks in one plane, 32 kept),
    sparse heat, and a flat plane below the threshold. Returns the number
    of cases."""
    import torch

    from popnet_tpu_torch.ops import kernels

    n = 0
    for K in (1, 5, 15, 16):
        for H, W in ((12, 10), (28, 28), (46, 46)):
            dense = rng.uniform(0, 1, (3, K + 1, H + 3, W + 4)).astype(np.float32)
            dense[0, 0, 1:H:3, 1:W:3] = 2.0 + rng.uniform(0, 1, dense[0, 0, 1:H:3, 1:W:3].shape)
            dense[1, 0] = 0.05                                    # flat, below the threshold
            sparse = np.zeros_like(dense)
            sparse[:, :, :H, :W] = sparse_heat(rng, 3, K + 1, H, W)
            for heat, M in ((dense, 32), (sparse, 16)):
                t = torch.as_tensor(heat, device=dev)
                for tag, h in (("NCHW", t[:, :K, :H, :W].contiguous()),
                               ("NHWC", t[:, :K, :H, :W].contiguous(
                                   memory_format=torch.channels_last)),
                               ("sliced", t[:, 1:, 2:H + 2, 3:W + 3])):
                    got = kernels.find_peaks_row(h, max_peaks=M)
                    ref = kernels.find_peaks_plain(h, max_peaks=M)
                    k1 = kernels.find_peaks(h, max_peaks=M)
                    for i, name in enumerate(PEAK_OUTPUTS):
                        what = f"find_peaks_row {name}, K={K}, {H}x{W}, {tag}, M={M}"
                        _exact(what, got[i], ref[i])
                        _exact(what + " against find_peaks", got[i], k1[i])
                    n += 1
                    if M == 32 and tag == "NCHW":
                        require(int(got[4][0, 0].sum()) >= 12,
                                "find_peaks_row: the dense plane holds at least 12 peaks")
    return n


def readouts_cases(rng4, dev, B: int, maps) -> None:
    """The fused readouts against their plain version, torch.equal: z and
    image in float32 and bfloat16, radius 1 and 2, channels-last and sliced
    maps, joints on the borders and off the maps, B = 256 and B = 1; then
    every one of the B x 224 x 224 input values read once, so the kernel's
    denormalization is held bit for bit against the eager one on all of
    them."""
    import torch

    from popnet_tpu_torch.ops import kernels

    std, mean = 2.0, 3.0
    z32 = maps(rng4.uniform(-1.5, 1.5, (B, 15, 28, 28)).astype(np.float32)).permute(0, 2, 3, 1)
    heat = maps(rng4.uniform(-0.2, 1, (B, 16, 28, 28)).astype(np.float32)).permute(0, 2, 3, 1)
    img32 = torch.as_tensor(rng4.uniform(-1.5, 1.5, (B, 224, 224, 1)).astype(np.float32),
                            device=dev)[..., 0]
    big = torch.as_tensor(rng4.uniform(-1.5, 1.5, (B, 31, 30, 17)).astype(np.float32), device=dev)
    joints = torch.as_tensor(rng4.uniform(-20, 250, (B, 16, 15, 3)).astype(np.float32), device=dev)
    joints[:, 0, :, :2] = -1.0                          # holes, as the assembly leaves them
    joints[:, 1, :3, 0] = torch.tensor([0.0, 223.0, 223.99])
    n = 0
    for radius in (1, 2):
        for zt, it in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                       (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)):
            for tag, zz in (("channels-last", z32), ("sliced", big[:, 2:30, 1:29, 1:16])):
                z, img = zz.to(zt), img32.to(it)
                for bsz in (B, 1):
                    args = (z[:bsz], heat[:bsz, ..., :15], joints[:bsz], img[:bsz], std, mean, 8,
                            radius)
                    kernels.reset_launches()
                    got = kernels.readouts(*args)
                    torch.cuda.synchronize()
                    require(kernels.readouts.launches == 1
                            and kernels.launch_counts()["window_readout"] == 1
                            and kernels.launch_counts()["point_readout"] == 1,
                            "readouts: one launch, counted once for K4 and once for K5")
                    ref = kernels.readouts_plain(*args)
                    _exact(f"readouts z_pose, radius {radius}, z {zt}, img {it}, {tag}, B={bsz}",
                           got[0], ref[0])
                    _exact(f"readouts z_raw, radius {radius}, z {zt}, img {it}, {tag}, B={bsz}",
                           got[1], ref[1])
                    n += 1
    # every input value read once: 3346 x 15 points a frame cover the 50,176 pixels
    P = 3346
    i = torch.arange(P * 15, device=dev).clamp(max=224 * 224 - 1)
    every = torch.stack([(i % 224).float() + 0.25, (i // 224).float() + 0.5,
                         torch.zeros_like(i, dtype=torch.float32)], -1)
    every = every.reshape(1, P, 15, 3).expand(B, P, 15, 3)
    got = kernels.readouts(z32, heat[..., :15], every, img32, std, mean)
    ref = kernels.readouts_plain(z32, heat[..., :15], every, img32, std, mean)
    _exact("readouts z_raw over every input value", got[1], ref[1])
    _exact("readouts z_pose at every input point", got[0], ref[0])
    covered = got[1].reshape(B, -1)[:, :224 * 224].reshape(B, 224, 224)
    _exact("readouts denormalization against the eager one", covered, img32 * std + mean)
    say("kernels", f"readouts z={tuple(z32.shape)} img={tuple(img32.shape)} joints="
        f"{tuple(joints.shape)}: z_pose and z_raw exact in {n} cases (radius 1 and 2; z and "
        f"image float32 or bfloat16; channels-last and sliced maps; joints on the borders, off "
        f"the maps and at holes; B={B} and 1), one launch each; and on all "
        f"{B * 224 * 224} input values: the kernel's v * {std} + {mean} equals the eager one")


def phase_slice(rng, dev, B, weights):
    """The float32 Open-Pose+ slice on B frames; returns the frames, the
    launch counts of its path (and of the per-frame peak kernel's decode)
    and its unpacked output."""
    import torch

    from popnet_tpu_torch import build_openpose_pipeline
    from popnet_tpu_torch.core.skeleton import LIMBS
    from popnet_tpu_torch.decode.assemble_device import assemble_batched, assemble_inputs
    from popnet_tpu_torch.decode.device import find_peaks_batched, score_limb_pairs_batched
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
    fused = kernels.readouts.launches
    say("openpose", f"main-path launches per kernel: {launches}; of them, launches of K4 and K5 "
        f"together (readouts): {fused}")
    for name in OPENPOSE_PATH:
        require(launches[name] == 1, f"kernel {name}: {launches[name]} launches for one batch")
    require(fused == 1, f"readouts: {fused} launches for one batch")
    out = unpack_outputs(buf.cpu().numpy(), 16, 15)
    require(buf.shape == (B, 16 * 15 * 6 + 1), f"packed buffer shape {tuple(buf.shape)}")
    require(bool(np.isfinite(out["joints2d"]).all() and np.isfinite(out["joints3d"]).all()),
            "non-finite values in the packed output")
    counts = out["counts"][:, 0].astype(int)
    found = float((counts > 0).mean())
    say("openpose", f"B={B}: people found on {found:.1%} of frames, counts histogram "
        f"{np.bincount(counts, minlength=4).tolist()}")
    require(found >= 0.5, "people found on fewer than half of the frames")

    model = load_into(RTPoseLight3D(), weights).eval().to(dev)
    with torch.inference_mode():
        x = preproc_depth(frames)
        (paf, heat, z), _ = model(x.permute(0, 3, 1, 2))
        heat_n, paf_n, z_n = (t.permute(0, 2, 3, 1) for t in (heat, paf, z))
        dk = openpose_decode(heat_n, paf_n, z_n, x)
        dp = openpose_decode(heat_n.cpu(), paf_n.cpu(), z_n.cpu(), x.cpu())
        require(np.array_equal(dk["counts"].cpu().numpy(), dp["counts"].numpy()),
                "kernel and plain decode disagree on counts")
        require(np.array_equal(dk["counts"].cpu().numpy(), counts), "pipeline counts differ")
        require(torch.equal(dk["visibility"].cpu(), dp["visibility"]), "visibility differs")
        for k in ("joints2d", "joints3d", "joints3d_raw"):
            _exact(f"Open-Pose+ decode {k}, card against host", dk[k], dp[k])
        say("openpose", "kernel decode vs plain decode (host) on the same maps: counts, "
            "visibility, joints2d, joints3d and joints3d_raw bit for bit")

        # the assembly kernel on this batch's candidates (decoded synthetic scenes)
        pk1, v1 = find_peaks_batched(heat_n)
        s1, ok1 = score_limb_pairs_batched(paf_n, pk1, v1)
        j1, c1 = assemble_batched(pk1, v1, s1, ok1)
        ps, sm = assemble_inputs(pk1, s1, ok1)
        for a, b in zip(kernels.assemble_ids(ps, sm, LIMBS), kernels.assemble_ids_plain(ps, sm, LIMBS)):
            _exact("assemble_ids on the slice's candidates", a, b)
        require(np.array_equal(c1.cpu().numpy(), counts), "assembly counts differ")

        # the same maps through the per-frame peak kernel
        kernels.reset_launches()
        pk2, v2 = find_peaks_batched(heat_n, refine="kernel_row")
        s2, ok2 = score_limb_pairs_batched(paf_n, pk2, v2)
        j2, c2 = assemble_batched(pk2, v2, s2, ok2)
        torch.cuda.synchronize()
        row = kernels.launch_counts()
    require(row["find_peaks_row"] == 1 and row["find_peaks"] == 0,
            f"refine='kernel_row' launched {row}")
    for name, a, b in (("peaks", pk2, pk1), ("valid", v2, v1), ("pair scores", s2, s1),
                       ("pair ok", ok2, ok1), ("joints", j2, j1), ("counts", c2, c1)):
        _exact(f"refine='kernel_row' {name}", a, b)
    say("openpose", f"assemble_ids equals its plain version on the batch's candidates "
        f"({int(ok1.sum())} candidate pairs); the decode with refine='kernel_row' launched "
        f"{row} and equals the find_peaks decode exactly (peaks, pair scores, joints, counts)")
    launches["find_peaks_row"] = row["find_peaks_row"]
    return frames, launches, out


def phase_popnet_slice(rng, dev, B, weights):
    """The float32 PoP-Net slice on B frames; returns the frames, the main
    path's launch counts and its unpacked output."""
    import torch

    from popnet_tpu_torch import build_popnet_pipeline
    from popnet_tpu_torch.decode.popnet_infer import popnet_decode
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import PopNet
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.serving import preproc_depth, unpack_outputs

    frames = person_frames(rng, B, dev, background=True)
    pipe = build_popnet_pipeline(weights, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    buf = pipe(frames)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("popnet", f"main-path launches per kernel: {launches}")
    require(launches["peak_local_max"] >= 1, "peak_local_max was not launched on the PoP-Net path")
    require(buf.shape == (B, 16 * 15 * 6 + 16), f"packed buffer shape {tuple(buf.shape)}")
    out = unpack_outputs(buf.cpu().numpy(), 16, 15)
    require(bool(np.isfinite(buf.cpu().numpy()).all()), "non-finite values in the packed output")
    people = (out["counts"] > 0).sum(axis=1)
    found = float((people > 0).mean())
    say("popnet", f"B={B}: people valid on {found:.1%} of frames, people-per-frame histogram "
        f"{np.bincount(people, minlength=4).tolist()}")
    require(found >= 0.5, "people valid on fewer than half of the frames")

    model = load_into(PopNet(), weights).eval().to(dev)
    with torch.inference_mode():
        x = preproc_depth(frames)
        maps, _ = model(x.permute(0, 3, 1, 2))
        nhwc = [t.permute(0, 2, 3, 1) for t in maps]
        dk = popnet_decode(*nhwc)
        dp = popnet_decode(*[t.cpu() for t in nhwc])
    require(torch.equal(dk["valid"].cpu(), dp["valid"]), "kernel and plain decode disagree on valid")
    require(np.array_equal(dk["valid"].cpu().numpy(), out["counts"] > 0), "pipeline valid differs")
    for k in ("joints2d", "joints3d"):
        _exact(f"PoP-Net decode {k}, card against host", dk[k], dp[k])
    say("popnet", "kernel decode vs plain decode (host) on the same maps: valid, joints2d and "
        "joints3d bit for bit")
    return frames, launches, out


def phase_yolo_slice(rng, dev, B, weights):
    """The float32 Yolo-Pose+ slice on B frames over the background; returns
    the frames, the path's launch counts and its unpacked output."""
    import torch

    from popnet_tpu_torch import build_yolo_pipeline
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import YoloPoseNet
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.serving import preproc_depth, unpack_outputs, yolo_decode

    torch.backends.cudnn.allow_tf32 = False
    frames = person_frames(rng, B, dev, background=True)
    pipe = build_yolo_pipeline(weights, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    buf = pipe(frames)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("yolo", f"main-path launches per kernel: {launches} (no hand kernel is on this path)")
    require(buf.shape == (B, 16 * 15 * 6 + 16), f"packed buffer shape {tuple(buf.shape)}")
    require(bool(torch.isfinite(buf).all()), "non-finite values in the packed output")
    out = unpack_outputs(buf.cpu().numpy(), 16, 15)
    people = (out["counts"] > 0).sum(axis=1)
    found = float((people > 0).mean())
    say("yolo", f"B={B}: people valid on {found:.1%} of frames, people-per-frame histogram "
        f"{np.bincount(people, minlength=4).tolist()}")
    require(found >= 0.5, "people valid on fewer than half of the frames")

    H, W = frames.shape[-2:]
    model = load_into(YoloPoseNet(), weights).eval().to(dev)
    with torch.inference_mode():
        prior = model(preproc_depth(frames).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dk, dp = yolo_decode(prior, W, H), yolo_decode(prior.cpu(), W, H)
    for k in ("valid", "dets", "joints2d", "joints3d", "conf"):
        _exact(f"Yolo-Pose+ decode {k}, card against host", dk[k], dp[k])
    require(np.array_equal(dk["valid"].cpu().numpy(), out["counts"] > 0), "pipeline valid differs")
    for k in ("joints2d", "joints3d", "conf"):
        require(np.array_equal(out[k], dk[k].cpu().numpy()),
                f"Yolo-Pose+ pipeline {k} differs from its CNN and decode run one by one")
    say("yolo", "card decode vs host decode on the same prior maps: valid, dets, joints2d, "
        "joints3d and conf bit for bit; the pipeline's own output equals its stages run one by "
        "one, bit for bit")
    return frames, launches, out


def phase_a2j_slice(frames, dev, weights, yolo_out):
    """The float32 Yolo->A2J slice on the Yolo slice's frames, max_crops
    boxes a frame, A2J from its seeded init: the path's launch counts, its
    crops against the host's from the same boxes (bit for bit, every crop),
    its A2J heads against the host's on a few crops, its vote against the
    host's on the crops of the first A2J_HOST_FRAMES frames, and its flags
    against the detector's. Returns the launch counts and the output."""
    import torch

    from popnet_tpu_torch import build_yolo_a2j_pipeline
    from popnet_tpu_torch.data.a2j_crops import CROP, crop_resize_batch
    from popnet_tpu_torch.decode.a2j import a2j_post_process
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import A2J, YoloPoseNet
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, back_project
    from popnet_tpu_torch.serving import (a2j_boxes, a2j_uncrop, preproc_depth, unpack_outputs,
                                          yolo_decode)

    torch.backends.cudnn.allow_tf32 = False
    B, C = frames.shape[0], MAX_CROPS
    pipe = build_yolo_a2j_pipeline(weights, dtype=torch.float32, device="cuda", max_crops=C,
                                   seed=A2J_SEED)
    torch.cuda.synchronize()
    kernels.reset_launches()
    buf = pipe(frames)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("a2j", f"main-path launches per kernel: {launches} (no hand kernel is on this path)")
    require(buf.shape == (B, C * 15 * 6 + C), f"packed buffer shape {tuple(buf.shape)}")
    require(bool(torch.isfinite(buf).all()), "non-finite values in the packed output")
    out = unpack_outputs(buf.cpu().numpy(), C, 15)
    require(np.array_equal(out["counts"], yolo_out["counts"][:, :C]),
            "A2J valid differs from the detector's first max_crops flags")
    require(np.array_equal(out["conf"], np.broadcast_to(out["counts"][..., None], out["conf"].shape)),
            "A2J conf differs from valid")
    say("a2j", f"B={B}, {C} crops a frame: valid equals the detector's first {C} flags on every "
        f"frame ({int(out['counts'].sum())} of {B * C} slots), conf equals valid, all finite")

    H, W = frames.shape[-2:]
    yolo = load_into(YoloPoseNet(), weights).eval().to(dev)
    a2j = A2J().init_seeded(A2J_SEED).eval().to(dev)
    anchors = torch.as_tensor(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
                              dtype=torch.float32, device=dev)
    n_host = A2J_HOST_FRAMES * C
    with torch.inference_mode():
        det = yolo_decode(yolo(preproc_depth(frames).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
                          W, H)
        boxes = a2j_boxes(det["dets"], C, W, H)
        idx = torch.arange(B, device=dev).repeat_interleave(C)
        crops = crop_resize_batch(frames, idx, boxes, 3.0, 2.0)
        _exact("A2J crops, card against host", crops,
               crop_resize_batch(frames.cpu(), idx.cpu(), boxes.cpu(), 3.0, 2.0))
        heads = a2j(crops[:, None])
        host_heads = A2J().init_seeded(A2J_SEED).eval()(crops[:A2J_HOST_CNN_CROPS, None].cpu())
        for name, h, r in zip(("classification", "regression", "depth"), heads, host_heads):
            err = _maxerr(h[:A2J_HOST_CNN_CROPS].cpu(), r)
            scale = float(r.abs().max())
            say("a2j", f"A2J {name} head, card (cuDNN, no TF32) vs host on "
                f"{A2J_HOST_CNN_CROPS} crops: max|err| {err:.4g} of max|value| {scale:.4g} "
                f"(bar 1e-4 of it)")
            require(err <= 1e-4 * scale, f"A2J {name} head differs between card and host")
        kp_all = a2j_post_process(heads, anchors)
        jx, jy, jz = (t.reshape(B, C, -1) for t in a2j_uncrop(kp_all, boxes))
        stages = {"joints2d": torch.stack([jx, jy], dim=-1),
                  "joints3d": back_project(jx, jy, jz, KDH3D_INTRINSICS)}
        for k, v in stages.items():
            require(np.array_equal(out[k], v.cpu().numpy()),
                    f"Yolo->A2J pipeline {k} differs from its stages run one by one")
        say("a2j", "the pipeline's joints2d and joints3d equal its stages run one by one (detector, "
            "boxes, crops, A2J, vote, uncrop, back-projection), bit for bit, on all "
            f"{B * C} slots")
        bf16_heads(crops, heads, kp_all, anchors, det["valid"][:, :C].reshape(-1))
        kp = kp_all[:n_host].cpu()
        kp_host = a2j_post_process([h[:n_host].cpu() for h in heads], anchors.cpu())
    for name, sl in (("(y, x)", slice(0, 2)), ("z", slice(2, 3))):
        err = _maxerr(kp[..., sl], kp_host[..., sl])
        bar = 2.0 ** -18 * float(kp_host[..., sl].abs().max())
        say("a2j", f"A2J vote {name}, card vs host on the crops of frames 0-"
            f"{A2J_HOST_FRAMES - 1} ({n_host} crops): max|err| {err:.4g} (bar {bar:.4g}: 64 "
            f"float32 ulps of the largest magnitude; the host's float32 softmax over the "
            f"{anchors.shape[0]} anchors is the less exact, `tools/measure.py vote`)")
        require(err <= bar, f"A2J vote {name} differs between card and host")
    return launches, out


def _refine_ops(px, py, H: int, W: int, size: int = 5, factor: int = 8):
    """Operations of the windowed refine at each (px, py): U.patch for the
    window's win_h rows (win_h x size x size multiply-adds), then their
    products with U^T in the window (win_h x win_w x size)."""
    win = size // 2
    win_w = ((px.clamp(max=win) + (W - 1 - px).clamp(max=win) + 1) * factor).double()
    win_h = ((py.clamp(max=win) + (H - 1 - py).clamp(max=win) + 1) * factor).double()
    return 2 * size * win_h * (size + win_w)


PAIR_OPS = 10 * (2 * 16 * 2 + 8 * 11 + 17)  # a line integral: 10 points x (taps, weights, rest)


def _bounds(name: str, inputs: dict) -> tuple[float, float, float, str]:
    """(bytes, ops, bound_ms, how the count changed) of one call at this
    run's inputs: each input byte read once, each output byte written once;
    ops at the float32 rate, counting the work these inputs need."""
    import torch
    import torch.nn.functional as F

    note = ""
    if name in ("find_peaks", "find_peaks_row"):      # two designs of one function
        h, px, py, valid = inputs["heat"], inputs["px"], inputs["py"], inputs["valid"]
        B, K, H, W = h.shape
        M = px.shape[-1]
        nbytes = h.numel() * 4 + B * K * M * (4 * 4 + 1)
        # NMS once: 4 neighbour maxima, 2 compares and a select per cell; the
        # top-M pick: a compare and a select per NMS survivor
        pad = F.pad(h, (1, 1, 1, 1), value=-1e30)
        nbr = torch.maximum(torch.maximum(pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]),
                            torch.maximum(pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]))
        survivors = float(((h >= nbr) & (h > inputs["thresh"])).sum())
        # each valid slot's refine, and one refine at the corner (0, 0) for
        # each plane with an empty slot: every empty slot takes its result
        per_slot = _refine_ops(px, py, H, W)
        corner = float(_refine_ops(torch.zeros(()), torch.zeros(()), H, W))
        refine = float((per_slot * valid).sum()) + corner * float((~valid).any(-1).sum())
        ops = 6.0 * h.numel() + 2.0 * survivors + refine
        note = (f"; refines {refine / 1e9:.4f} GFLOP, one corner refine per plane with an empty "
                f"slot (a refine of every slot would be {float(per_slot.sum()) / 1e9:.4f})")
    elif name == "paf_score":
        paf, peaks, score = inputs["paf"], inputs["peaks"], inputs["score"]
        nbytes = paf.numel() * 4 + peaks.numel() * 4 + peaks.numel() // 3 + score.numel() * 5
        # a line integral per distinct (src, dst) coordinate pair of a limb:
        # 10 points x (2 channels x 16 taps multiply-add, 8 cubic weights of
        # 11 ops, coordinates and projection about 17)
        pairs = float(distinct_pairs(peaks, inputs.get("limbs")).sum())
        ops = pairs * PAIR_OPS
        note = (f"; {pairs:.0f} distinct pairs integrated (every pair would be "
                f"{score.numel()}, {score.numel() * PAIR_OPS / 1e9:.3f} GFLOP)")
    elif name == "window_readout":
        cx, cy, H, W = inputs["cx"], inputs["cy"], inputs["H"], inputs["W"]
        cells = (((cx + 1).clamp(0, W - 1) - (cx - 1).clamp(0, W - 1) + 1)
                 * ((cy + 1).clamp(0, H - 1) - (cy - 1).clamp(0, H - 1) + 1)).double()
        nbytes = float(cells.sum()) * 8 + cx.numel() * 12
        ops = float(cells.sum()) * 6 + cx.numel() * 6.0
    elif name == "point_readout":  # index pair, the value read, the value written
        nbytes = inputs["cx"].numel() * 16
        ops = 0.0
    elif name == "assemble_ids":
        ps, sm, ids = inputs["peak_score"], inputs["s_masked"], inputs["ids"]
        nbytes = (ps.numel() + sm.numel() + ids.numel() + ids.shape[0]) * 4
        # a compare and a select per pair score, a row of K ids per connection
        ops = 2.0 * sm.numel() + float(inputs["connections"].sum()) * ps.shape[1]
    else:  # peak_local_max: a float read and a flag written per cell, 5 compares
        nbytes = inputs["heat"].numel() * 5
        ops = 5.0 * inputs["heat"].numel()
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    return nbytes, ops, bound_ms, note


def stage_breakdown(name: str, call, ms: float, tag: str = "") -> None:
    """Per-block stage clocks of a call of the kernel's stage-clock build,
    the second of two back to back (the first warms the instruction and data
    caches, as the timed replays have them): each stage's mean cycles over
    the blocks, its share of a block's time, and that share of the kernel's
    device time `ms` (the normal build's)."""
    from popnet_tpu_torch.ops import kernels

    labels = STAGES[name]
    stamps = kernels.stage_clocks(source_of(name), lambda: (call(), call()))
    st, spans = stamps[:, : len(labels) + 1], stamps[:, 6:8]
    st = st[st[:, -1] != 0]
    per_block = np.diff(st, axis=1).astype(np.float64)
    cyc = per_block.mean(axis=0)
    total = float(cyc.sum())
    parts = ", ".join(f"{lab} {c:.0f} ({c / total:.1%}, {ms * c / total:.4f} ms)"
                      for lab, c in zip(labels, cyc))
    say("timing", f"{tag}{name} stages, clock64 cycles per block (mean over {len(st)} blocks of "
        f"{total:.0f}, the longest block {per_block.sum(axis=1).max():.0f}; share; that share "
        f"of {ms:.4f} ms): {parts}")
    if name in SPANS:
        block_spans(name, spans[spans[:, 1] != 0])


def block_spans(name: str, span) -> None:
    """How the blocks of a call were scheduled, from each block's start and
    end on the card's global timer (ns): the spread of their starts, their
    mean life, and how many were resident at once at most."""
    start, end = span[:, 0].astype(np.float64), span[:, 1].astype(np.float64)
    t0 = start.min()
    events = np.concatenate([np.stack([start, np.ones_like(start)], 1),
                             np.stack([end, -np.ones_like(end)], 1)])
    events = events[np.lexsort((events[:, 1], events[:, 0]))]
    resident = int(np.cumsum(events[:, 1]).max())
    say("timing", f"{name} block spans (global timer): {len(span)} blocks start over "
        f"{(start.max() - t0) / 1e3:.2f} us, each lives {(end - start).mean() / 1e3:.2f} us on "
        f"average, the call spans {(end.max() - t0) / 1e3:.2f} us, at most {resident} blocks "
        f"resident at once")


def greedy_connections(s_masked):
    """(B,) connections that the assembly's stage 1 accepts on these pair
    scores (B, L, M, M): per limb, rounds of argmax that kill the picked row
    and column until no candidate is left. They are the steps of the
    dependent merge chain that a frame needs."""
    import torch

    B, L, M, _ = s_masked.shape
    s = s_masked.reshape(B, L, M * M).clone()
    ar = torch.arange(M, device=s.device)
    n = torch.zeros((B,), dtype=torch.long, device=s.device)
    for _ in range(M):
        val, idx = s.max(dim=-1)
        n += torch.isfinite(val).sum(dim=1)
        kill = ((idx // M)[..., None, None] == ar[:, None]) | ((idx % M)[..., None, None] == ar)
        s = s.masked_fill(kill.reshape(B, L, M * M), float("-inf"))
    return n


def time_kernels(calls: dict, launches: dict, errs: dict, tag: str = "") -> list[dict]:
    """Time each kernel, its plain version and its library call (device
    time, CUDA-graph replays) and set them beside the bound; `calls` maps a
    kernel's name to (kernel, plain, library or None, inputs for _bounds)."""
    rows = []
    for name, (kern, plain, lib, inputs) in calls.items():
        ms = graph_ms(kern)
        eager_ms = time_ms(kern)
        # the plain assembler is about 10,000 small kernels a call: one call a graph
        plain_ms = graph_ms(plain, reps=1 if name == "assemble_ids" else 5)
        lib_ms = graph_ms(lib) if lib is not None else None
        nbytes, ops, bound_ms, note = _bounds(name, inputs)
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
        say("timing", f"{tag}{name}: {ms:.4f} ms/batch on the card (CUDA graph; "
            f"{eager_ms:.4f} ms per eager call), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} GFLOP{note})"
            + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""))
        src, rep = KERNEL_META[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    return rows


def device_ops(fn) -> str:
    """The device operations (kernels, copies, fills) that one eager fn()
    issues, counted from a torch.profiler trace of the card; "not measured"
    where the trace holds no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        return "not measured (no device event in the trace)"
    kernels = [e for e in ops if not e.name.startswith(("Memcpy", "Memset"))]
    return f"{len(ops)} ({len(kernels)} kernels)"


def readout_timing(stage, decode, ms: dict, dev) -> None:
    """The decode's readout stage (depth_readouts: its inputs, then K4 and
    K5) as one CUDA graph, the launch floor beside it (the graph-replay time
    of a one-element fill), and the device operations that the stage and
    the whole eager decode issue."""
    import torch

    one = torch.zeros(1, device=dev)
    floor_ms = graph_ms(lambda: one.fill_(0.0))
    stage_ms = graph_ms(stage)
    say("timing", f"launch floor (one-element fill_, CUDA graph) {floor_ms:.4f} ms; "
        f"window_readout {ms['window_readout']:.4f} ms = {ms['window_readout'] / floor_ms:.2f}x "
        f"the floor; point_readout {ms['point_readout']:.4f} ms = "
        f"{ms['point_readout'] / floor_ms:.2f}x the floor")
    say("timing", f"readout stage (depth_readouts, CUDA graph) {stage_ms:.4f} ms; device "
        f"operations per call: readout stage {device_ops(stage)}, eager decode "
        f"{device_ops(decode)}")


def time_stream(tag: str, pipe, frames, iters: int, check, wire: str = "q16") -> None:
    """frames/s of `pipe` through serve_stream(queue_depth=3), after a warm
    window whose first batch goes to `check`."""
    import torch

    from popnet_tpu_torch import serve_stream

    warm = list(serve_stream(pipe, (frames for _ in range(3)), queue_depth=3))
    check(warm[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = 0
    for buf in serve_stream(pipe, (frames for _ in range(iters)), queue_depth=3):
        n += buf.shape[0]
    wall = time.perf_counter() - t0
    say("timing", f"{tag} serve_stream bf16 {wire} queue_depth=3: {iters} batches of "
        f"{frames.shape[0]} in {wall:.3f} s = {n / wall:.1f} frames/s "
        f"({wall / iters * 1e3:.2f} ms/batch); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


def phase_timing(frames, weights, dev, B: int, iters: int, errs, launches, f32_out,
                 sm_clock_mhz: float):
    """Open-Pose+: the timed bf16+q16 stream and the six kernels of its two
    decodes, at the inputs the bf16 main path makes."""
    import torch

    from popnet_tpu_torch import build_openpose_pipeline
    from popnet_tpu_torch.core.config import DecodeConfig
    from popnet_tpu_torch.core.skeleton import LIMBS
    from popnet_tpu_torch.decode.assemble_device import assemble_batched, assemble_inputs
    from popnet_tpu_torch.decode.device import (find_peaks_batched, peak_planes,
                                                score_limb_pairs_batched)
    from popnet_tpu_torch.decode.openpose_infer import (depth_readouts, openpose_decode,
                                                        readout_inputs)
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.serving import preproc_depth, unpack_outputs_q16

    pipe = build_openpose_pipeline(weights, pack="q16")     # bf16 CNN, the default
    time_stream("Open-Pose+", pipe, frames, iters,
                lambda buf: check_bf16("Open-Pose+", unpack_outputs_q16(buf, 16, 15), f32_out))

    # each kernel's inputs as the bf16 main path makes them, from its helpers
    model = keep_batchnorm_float32(load_into(RTPoseLight3D(), weights).eval().to(dev, torch.bfloat16))
    with torch.inference_mode():
        x = preproc_depth(frames)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        cnn_ms = time_ms(lambda: model(xb), reps=10)
        (paf, heat, z), _ = model(xb)
        # as the pipeline hands them to the decode: heat and PAF in float32, z as the CNN left it
        heat_n, paf_n = (t.float().permute(0, 2, 3, 1) for t in (heat, paf))
        z_n = z.permute(0, 2, 3, 1)
        decode_ms = time_ms(lambda: openpose_decode(heat_n, paf_n, z_n, x), reps=10)
        h = peak_planes(heat_n)
        say("timing", f"Open-Pose+ heat planes as the kernels get them: shape "
            f"{tuple(h.shape)}, strides {tuple(h.stride())}")
        K, M, L = h.shape[1], 16, len(LIMBS)
        per_sm = {"find_peaks": kernels.blocks_per_sm("find_peaks", K, 28, 28, M),
                  "find_peaks_row": kernels.blocks_per_sm("find_peaks", K, 28, 28, M,
                                                          kernel="find_peaks_row"),
                  "paf_score": kernels.blocks_per_sm("paf_score", K, L, M, 28, 28),
                  "assemble_ids": kernels.blocks_per_sm("assemble", K, L, M, 16)}
        clusters = kernels.occupancy("find_peaks", "popnet_find_peaks_row_clusters", K, 28, 28, M)
        say("timing", f"blocks (one per frame; find_peaks_row: half a frame) that one SM holds "
            f"at the main-path sizes: {per_sm}; find_peaks_row clusters (a frame each) the card "
            f"places at once: {clusters} for {B} frames; elements per shared-memory copy: "
            f"find_peaks {kernels.copy_width('find_peaks', h)}, "
            f"paf_score {kernels.copy_width('paf_score', paf_n)}")
        require(min(per_sm.values()) >= 2, f"a frame's block does not fit two to an SM: {per_sm}")
        px, py, _, _, slot_valid = kernels.find_peaks(h)
        peaks, pvalid = find_peaks_batched(heat_n)
        scores, ok = score_limb_pairs_batched(paf_n, peaks, pvalid)
        ps, sm = assemble_inputs(peaks, scores, ok)
        ids, _ = kernels.assemble_ids(ps, sm, LIMBS)
        joints, counts = assemble_batched(peaks, pvalid, scores, ok)
        ro_in = readout_inputs(joints, heat_n, z_n, x)
        # the standalone K4 and K5 read maps in metres at integer points
        z_in, hk, jts, img_in, std, mean, ds = ro_in
        gx, gy, rx, ry = kernels.readout_points(jts, img_in.shape[1], img_in.shape[2], ds)
        zmap, raw = z_in.float() * std + mean, img_in * std + mean
        rx, ry = rx.reshape(B, -1), ry.reshape(B, -1)
        bi, ryl, rxl = torch.arange(B, device=dev)[:, None], ry.long(), rx.long()
        conn = greedy_connections(sm)
        peak_in = {"heat": h, "px": px, "py": py, "valid": slot_valid,
                   "thresh": DecodeConfig().thresh_heatmap}
        calls = {
            "find_peaks": (lambda: kernels.find_peaks(h), lambda: kernels.find_peaks_plain(h),
                           None, peak_in),
            "find_peaks_row": (lambda: kernels.find_peaks_row(h),
                               lambda: kernels.find_peaks_plain(h), None, peak_in),
            "paf_score": (lambda: kernels.paf_score(paf_n, peaks, pvalid, LIMBS),
                          lambda: kernels.paf_score_plain(paf_n, peaks, pvalid, LIMBS),
                          None, {"paf": paf_n, "peaks": peaks, "score": scores}),
            "window_readout": (lambda: kernels.window_readout(zmap, hk, gx, gy),
                               lambda: kernels.window_readout_plain(zmap, hk, gx, gy),
                               None, {"cx": gx, "cy": gy, "H": 28, "W": 28}),
            "point_readout": (lambda: kernels.point_readout(raw, rx, ry),
                              lambda: kernels.point_readout_plain(raw, rx, ry),
                              lambda: raw[bi, ryl, rxl], {"cx": rx}),
            "assemble_ids": (lambda: kernels.assemble_ids(ps, sm, LIMBS),
                             lambda: kernels.assemble_ids_plain(ps, sm, LIMBS), None,
                             {"peak_score": ps, "s_masked": sm, "ids": ids,
                              "connections": conn}),
        }
        rows = time_kernels(calls, launches, errs)
        fused_ms = graph_ms(lambda: kernels.readouts(*ro_in))
        fused_plain_ms = graph_ms(lambda: kernels.readouts_plain(*ro_in), reps=5)
        for r in rows:
            if r["name"] in ("window_readout", "point_readout"):
                r["launched_by"] = "readouts"       # the main path's one launch of K4 and K5
                r["fused_ms"] = fused_ms
        apart = sum(r["ms"] for r in rows if r["name"] in ("window_readout", "point_readout"))
        say("timing", f"readouts (K4 and K5 in one launch, as the decode calls them, z "
            f"{z_in.dtype}): {fused_ms:.4f} ms/batch on the card (CUDA graph), plain "
            f"{fused_plain_ms:.4f} ms; standalone K4 + K5 {apart:.4f} ms")
        scan_ms = time_ms(lambda: kernels.assemble_ids_plain(ps, sm, LIMBS), reps=3, warm=1)
        nv, pairs = pvalid.sum(-1), distinct_pairs(peaks)
        say("timing", f"Open-Pose+ main path: valid peaks per plane mean "
            f"{float(nv.float().mean()):.3f}, max {int(nv.max())}; planes with an empty slot "
            f"{int((~pvalid).any(-1).sum())} of {nv.numel()}; distinct coordinate pairs per limb "
            f"mean {float(pairs.float().mean()):.3f}, max {int(pairs.max())} of "
            f"{peaks.shape[2] ** 2}; per frame mean {float(pairs.sum(1).float().mean()):.1f}, "
            f"max {int(pairs.sum(1).max())}")
        ms = {r["name"]: r["ms"] for r in rows}
        stage_breakdown("find_peaks", lambda: kernels.find_peaks(h), ms["find_peaks"])
        stage_breakdown("find_peaks_row", lambda: kernels.find_peaks_row(h),
                        ms["find_peaks_row"])
        stage_breakdown("paf_score", lambda: kernels.paf_score(paf_n, peaks, pvalid, LIMBS),
                        ms["paf_score"])
        stage_breakdown("assemble_ids", lambda: kernels.assemble_ids(ps, sm, LIMBS),
                        ms["assemble_ids"])
        readout_timing(lambda: depth_readouts(joints, heat_n, z_n, x),
                       lambda: openpose_decode(heat_n, paf_n, z_n, x), ms, dev)
    asm = next(r for r in rows if r["name"] == "assemble_ids")
    chain = int(conn.max())
    floor_ms = chain * SMEM_ROUND_TRIP_CYCLES / (sm_clock_mhz * 1e3)
    say("timing", f"Open-Pose+ CNN bf16 {cnn_ms:.3f} ms/batch; decode (eager, through the "
        f"kernels) {decode_ms:.3f} ms/batch; people in the timed batch {int(counts.sum())}")
    say("timing", f"assembly of one batch: kernel {asm['ms']:.4f} ms; plain scan "
        f"({len(LIMBS) * 16} merge steps) eager {scan_ms:.3f} ms, as a CUDA graph "
        f"{asm['plain_ms']:.3f} ms. Its bound_ms is the bytes'; the latency floor beside it: "
        f"the longest frame's chain of {chain} connections (mean {float(conn.float().mean()):.1f}) "
        f"x one shared-memory round trip of {SMEM_ROUND_TRIP_CYCLES} cycles at "
        f"{sm_clock_mhz:.0f} MHz = {floor_ms:.5f} ms")
    return rows


def phase_popnet_timing(frames, weights, dev, iters: int, errs, launches, f32_out):
    """PoP-Net: the timed bf16+q16 stream, CNN and decode times, and K7 at
    the planes the bf16 main path gives it."""
    import torch

    from popnet_tpu_torch import build_popnet_pipeline
    from popnet_tpu_torch.decode.device import peak_planes
    from popnet_tpu_torch.decode.popnet_infer import popnet_decode
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import PopNet
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.serving import preproc_depth, unpack_outputs_q16

    pipe = build_popnet_pipeline(weights, pack="q16")       # bf16 CNN, the default
    time_stream("PoP-Net", pipe, frames, iters,
                lambda buf: check_bf16("PoP-Net", unpack_outputs_q16(buf, 16, 15), f32_out))
    model = keep_batchnorm_float32(load_into(PopNet(), weights).eval().to(dev, torch.bfloat16))
    with torch.inference_mode():
        xb = preproc_depth(frames).permute(0, 3, 1, 2).to(torch.bfloat16)
        cnn_ms = time_ms(lambda: model(xb), reps=10)
        maps, _ = model(xb)
        heat_n, z_n, align_n, prior_n = (t.float().permute(0, 2, 3, 1) for t in maps)
        decode_ms = time_ms(lambda: popnet_decode(heat_n, z_n, align_n, prior_n), reps=10)
        h = peak_planes(heat_n)                 # what peak_mask hands the kernel
        say("timing", f"PoP-Net heat planes as the kernel gets them: shape {tuple(h.shape)}, "
            f"strides {tuple(h.stride())}")
        rows = time_kernels({"peak_local_max": (
            lambda: kernels.peak_local_max(h, 0.5), lambda: kernels.peak_local_max_plain(h, 0.5),
            None, {"heat": h})}, launches, errs)
    say("timing", f"PoP-Net CNN bf16 {cnn_ms:.3f} ms/batch; decode (eager, through the "
        f"kernel) {decode_ms:.3f} ms/batch")
    return rows


def phase_yolo_timing(frames, weights, dev, iters: int, f32_out) -> None:
    """Yolo-Pose+: the timed bf16+q16 stream, and the CNN and decode times."""
    import torch

    from popnet_tpu_torch import build_yolo_pipeline
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import YoloPoseNet
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32
    from popnet_tpu_torch.serving import preproc_depth, unpack_outputs_q16, yolo_decode

    pipe = build_yolo_pipeline(weights, pack="q16")          # bf16 CNN, the default
    time_stream("Yolo-Pose+", pipe, frames, iters,
                lambda buf: check_bf16("Yolo-Pose+", unpack_outputs_q16(buf, 16, 15), f32_out))
    model = keep_batchnorm_float32(load_into(YoloPoseNet(), weights).eval().to(dev, torch.bfloat16))
    with torch.inference_mode():
        xb = preproc_depth(frames).permute(0, 3, 1, 2).to(torch.bfloat16)
        cnn_ms = time_ms(lambda: model(xb), reps=10)
        prior = model(xb).float().permute(0, 2, 3, 1)
        decode_ms = time_ms(lambda: yolo_decode(prior, frames.shape[-1], frames.shape[-2]),
                            reps=10)
    say("timing", f"Yolo-Pose+ CNN bf16 {cnn_ms:.3f} ms/batch; decode (eager) "
        f"{decode_ms:.3f} ms/batch")


def conv_flops(model, x) -> float:
    """Operations of the convolutions of one model(x) call, 2 per
    multiply-add, counted from each conv's output shape."""
    import torch

    total = [0.0]

    def hook(m, _, out):
        kh, kw = m.kernel_size
        total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) * kh * kw

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_a2j_timing(frames, weights, dev, iters: int, f32_out) -> None:
    """Yolo->A2J: the timed bf16+q16 stream, its output against its stages
    run one by one in bf16 and against the float32 slice, and the times of
    its stages: the detector (CNN and decode), the crop, the A2J CNN and
    the vote."""
    import torch

    from popnet_tpu_torch import build_yolo_a2j_pipeline
    from popnet_tpu_torch.core.config import KDH3D_DEPTH
    from popnet_tpu_torch.data.a2j_crops import CROP, crop_resize_batch
    from popnet_tpu_torch.decode.a2j import a2j_post_process
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import A2J, YoloPoseNet
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32
    from popnet_tpu_torch.serving import (a2j_boxes, a2j_uncrop, pack_outputs_q16, preproc_depth,
                                          unpack_outputs_q16, yolo_decode)

    (B, H, W), C = frames.shape, MAX_CROPS
    mean, std = KDH3D_DEPTH.mean, KDH3D_DEPTH.std
    bf16 = torch.bfloat16
    yolo = keep_batchnorm_float32(load_into(YoloPoseNet(), weights).eval().to(dev, bf16))
    a2j = keep_batchnorm_float32(A2J().init_seeded(A2J_SEED).eval().to(dev, bf16))
    anchors = torch.as_tensor(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
                              dtype=torch.float32, device=dev)
    with torch.inference_mode():
        xb = preproc_depth(frames).permute(0, 3, 1, 2).to(bf16)
        det = yolo_decode(yolo(xb).float().permute(0, 2, 3, 1), W, H)
        boxes = a2j_boxes(det["dets"], C, W, H)
        idx = torch.arange(B, device=dev).repeat_interleave(C)

        def a2j_heads():
            cb = crop_resize_batch(frames, idx, boxes, mean, std)[:, None].to(bf16)
            return cb, [h.float() for h in a2j(cb)]

        def stages_q16():
            _, heads = a2j_heads()
            jx, jy, jz = (t.reshape(B, C, -1)
                          for t in a2j_uncrop(a2j_post_process(heads, anchors), boxes))
            valid = det["valid"][:, :C]
            return pack_outputs_q16(torch.stack([jx, jy], dim=-1), jz,
                                    valid[..., None].float().expand_as(jz), valid)

        stages = stages_q16()      # its heads are freed before the stream's memory is read

    def check(buf):
        steps = buf.astype(np.int32) - stages.cpu().numpy().astype(np.int32)
        flags = slice(C * 15 * 3, None)                  # conf and valid
        say("timing", f"Yolo->A2J bf16+q16 buffer vs its stages run one by one in bf16: "
            f"{int((steps != 0).sum())} of {steps.size} codes differ, by at most "
            f"{int(np.abs(steps).max())} q16 step (bar 1; conf and valid exact)")
        require(np.abs(steps).max() <= 1 and not steps[:, flags].any(),
                "the timed Yolo->A2J output differs from its stages run one by one")
        check_a2j_bf16(unpack_outputs_q16(buf, C, 15), f32_out)

    pipe = build_yolo_a2j_pipeline(weights, pack="q16", max_crops=C, seed=A2J_SEED)
    time_stream("Yolo->A2J", pipe, frames, iters, check)
    with torch.inference_mode():
        cb, heads = a2j_heads()
        det_ms = time_ms(lambda: yolo_decode(yolo(xb).float().permute(0, 2, 3, 1), W, H), reps=10)
        crop_ms = time_ms(lambda: crop_resize_batch(frames, idx, boxes, mean, std), reps=10)
        cnn_ms = time_ms(lambda: a2j(cb), reps=5)
        flops = conv_flops(a2j, cb[:1]) * cb.shape[0]
        vote_ms = time_ms(lambda: a2j_post_process(heads, anchors), reps=10)
    say("timing", f"Yolo->A2J per batch of {B} frames, {B * C} crops: detector (bf16 CNN and "
        f"decode) {det_ms:.3f} ms; crop {crop_ms:.3f} ms; A2J CNN bf16 {cnn_ms:.3f} ms "
        f"({flops / (B * C) / 1e9:.2f} GFLOP a crop in its convolutions, {flops / 1e12:.2f} "
        f"TFLOP a batch: {flops / cnn_ms / 1e9:.1f} TFLOP/s); vote {vote_ms:.3f} ms")


# COCO joints of a standing person in grid cells (46x46 at 368 px), from the neck
COCO_TEMPLATE = np.array([
    (0.0, -3.0), (0.0, 0.0), (-2.5, 0.5), (-3.5, 4.0), (-4.0, 7.5), (2.5, 0.5), (3.5, 4.0),
    (4.0, 7.5), (-1.5, 9.0), (-1.8, 14.0), (-2.0, 19.0), (1.5, 9.0), (1.8, 14.0), (2.0, 19.0),
    (-0.8, -3.8), (0.8, -3.8), (-1.8, -3.4), (1.8, -3.4)])


def coco_people_maps(rng: np.random.Generator, B: int, H: int = 46, W: int = 46):
    """Painted COCO maps: per frame 2-4 standing people of 18 joints side by
    side (COCO_TEMPLATE, scaled 0.75-1, jittered), Gaussian heat blobs of
    sigma 7/8 cell (the encoders' 7 px at stride 8) in 18 joint channels and
    a background channel, and the unit limb vector of each of the 19 limbs
    on the cells within one cell of the limb's line and box (averaged where
    people overlap). Returns heat (B, H, W, 19) and paf (B, H, W, 38)
    float32 and the people a frame (B,)."""
    from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS

    limbs = np.asarray(COCO_LIMBS)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    heat = np.zeros((B, H, W, 19))
    paf = np.zeros((B, H, W, 38))
    n_paint = np.zeros((B, H, W, 19))
    people = rng.integers(2, 5, size=B)
    for b in range(B):
        n = people[b]
        for p in range(n):
            neck = np.array([(p + 0.5) * W / n + rng.uniform(-1, 1), rng.uniform(10, 14)])
            j = neck + COCO_TEMPLATE * rng.uniform(0.75, 1.0) + rng.normal(0, 0.25, (18, 2))
            d2 = (xs[..., None] - j[:, 0]) ** 2 + (ys[..., None] - j[:, 1]) ** 2
            heat[b, ..., :18] = np.maximum(heat[b, ..., :18], np.exp(-d2 / (2 * 0.875 ** 2)))
            a, c = j[limbs[:, 0]], j[limbs[:, 1]]                      # (19, 2) each
            v = (c - a) / np.linalg.norm(c - a, axis=1, keepdims=True)
            rx, ry = xs[..., None] - a[:, 0], ys[..., None] - a[:, 1]  # (H, W, 19)
            on = ((np.abs(rx * v[:, 1] - ry * v[:, 0]) <= 1.0)
                  & (xs[..., None] >= np.minimum(a[:, 0], c[:, 0]) - 1)
                  & (xs[..., None] <= np.maximum(a[:, 0], c[:, 0]) + 1)
                  & (ys[..., None] >= np.minimum(a[:, 1], c[:, 1]) - 1)
                  & (ys[..., None] <= np.maximum(a[:, 1], c[:, 1]) + 1))
            paf[b, ..., 0::2] += on * v[:, 0]
            paf[b, ..., 1::2] += on * v[:, 1]
            n_paint[b] += on
    paf /= np.repeat(np.maximum(n_paint, 1), 2, axis=-1)
    heat[..., 18] = np.maximum(1.0 - heat[..., :18].max(-1), 0.0)
    return heat.astype(np.float32), paf.astype(np.float32), people


def coco_weights(seed: int = 0) -> dict:
    """RTPoseVGG.init_seeded(seed) as Flax-named variables, the stage-6 PAF
    and heat heads scaled by COCO_HEAD_SCALE: the seeded init's maps are
    about 1e-11 (normal(0.01) kernels through 51 convs without a norm), and
    the network is linear in each head's kernel, so the scaled maps cross
    thresh_heatmap and the decode does real work."""
    from popnet_tpu_torch.models import RTPoseVGG

    model = RTPoseVGG().init_seeded(seed)
    flat = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        a = t.numpy()
        if leaf == "weight":
            a = a.transpose(2, 3, 1, 0)                             # OIHW -> HWIO
            if path[0] in ("stage6_paf", "stage6_heat") and path[1] == "Conv_0":
                a = a * COCO_HEAD_SCALE
        flat["/".join(["params", *path, "kernel" if leaf == "weight" else leaf])] = a
    return flat


def phase_coco_kernels(rng, dev, B: int):
    """K1, K3 (two groups of limbs a frame) and K6 against their plain
    versions at the COCO shapes, on painted people in both memory orders of
    the maps; K3 at the depth shapes keeps one group; the COCO decode of the
    painted maps on the card against the host's, bit for bit, and its
    people against the painted ones. Returns max |err| per kernel and the
    painted maps (channels-last)."""
    import torch

    from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS
    from popnet_tpu_torch.decode.assemble_device import assemble_inputs
    from popnet_tpu_torch.decode.device import find_peaks_batched, peak_planes
    from popnet_tpu_torch.decode.openpose_infer import paf_decode_2d
    from popnet_tpu_torch.ops import kernels

    K, L, M = COCO_NUM_JOINTS, len(COCO_LIMBS), 16
    groups, smem = kernels.paf_score_groups(K, L, M, 46, 46)
    depth_groups = kernels.paf_score_groups(15, 14, M, 28, 28)
    require(groups == 2, f"paf_score takes {groups} groups of limbs at COCO sizes, not 2")
    require(depth_groups[0] == 1, f"paf_score takes {depth_groups[0]} groups at depth sizes")
    heat_np, paf_np, people = coco_people_maps(rng, B)
    errs, maps = {}, {}
    for tag, fmt in (("NCHW memory", torch.contiguous_format),
                     ("channels-last", torch.channels_last)):
        heat, paf = (torch.as_tensor(a, device=dev).permute(0, 3, 1, 2).contiguous(
            memory_format=fmt).permute(0, 2, 3, 1) for a in (heat_np, paf_np))
        h = peak_planes(heat, K)
        got, ref = kernels.find_peaks(h), kernels.find_peaks_plain(h)
        for i, n in enumerate(PEAK_OUTPUTS):
            _exact(f"find_peaks {n} at COCO shapes, {tag}", got[i], ref[i])
        peaks, valid = find_peaks_batched(heat, num_joints=K)
        s_k, ok_k = kernels.paf_score(paf, peaks, valid, COCO_LIMBS)
        s_p, ok_p = kernels.paf_score_plain(paf, peaks, valid, COCO_LIMBS)
        _exact(f"paf_score score at COCO shapes, {tag}", s_k, s_p)
        _exact(f"paf_score ok at COCO shapes, {tag}", ok_k, ok_p)
        ps, sm = assemble_inputs(peaks, s_k, ok_k)
        ids, cnt = kernels.assemble_ids(ps, sm, COCO_LIMBS)
        ids_p, cnt_p = kernels.assemble_ids_plain(ps, sm, COCO_LIMBS)
        _exact(f"assemble_ids ids at COCO shapes, {tag}", ids, ids_p)
        _exact(f"assemble_ids counts at COCO shapes, {tag}", cnt, cnt_p)
        for name, err in (("find_peaks", _maxerr(got[3], ref[3])), ("paf_score",
                          _maxerr(s_k, s_p)), ("assemble_ids", _maxerr(ids, ids_p))):
            errs[name] = max(errs.get(name, 0.0), err)
        maps = {"heat": heat, "paf": paf}
    nv = valid.sum(-1)
    say("coco", f"find_peaks (B,K,H,W)={tuple(h.shape)} strides {tuple(h.stride())}, paf_score "
        f"paf={tuple(paf.shape)} with {L} limbs in {groups} groups a frame ({smem} bytes of "
        f"shared memory a block; {depth_groups[0]} group, {depth_groups[1]} bytes at the depth "
        f"shapes), assemble_ids with {L} limbs: all outputs exact against the plain versions "
        f"on painted people, in NCHW and channels-last memory; valid peaks per plane mean "
        f"{float(nv.float().mean()):.3f}, {int(ok_k.sum())} pairs ok")
    per_sm = {"find_peaks": kernels.blocks_per_sm("find_peaks", K, 46, 46, M),
              "paf_score": kernels.blocks_per_sm("paf_score", K, L, M, 46, 46),
              "assemble_ids": kernels.blocks_per_sm("assemble", K, L, M, 16)}
    say("coco", f"blocks that one SM holds at the COCO sizes: {per_sm}; elements per "
        f"shared-memory copy: find_peaks {kernels.copy_width('find_peaks', h)}, paf_score "
        f"{kernels.copy_width('paf_score', paf, K, M)}")

    # the COCO decode of the painted maps, scaled to a 640x480 frame
    heat, paf = maps["heat"], maps["paf"]
    sx, sy = COCO_FRAME[1] / 368, COCO_FRAME[0] / 368
    kernels.reset_launches()
    dk = paf_decode_2d(heat, paf, K, limbs=COCO_LIMBS, sx=sx, sy=sy)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    for name in COCO_PATH:
        require(launched[name] == 1, f"the COCO decode launched {name} {launched[name]} times")
    dp = paf_decode_2d(heat.cpu(), paf.cpu(), K, limbs=COCO_LIMBS, sx=sx, sy=sy)
    for k in ("joints2d", "conf", "visibility", "counts"):
        _exact(f"COCO decode {k}, card against host on painted people", dk[k], dp[k])
    counts = dk["counts"].cpu().numpy()
    found = float((counts == people).mean())
    say("coco", f"COCO decode of painted people (B={B}, 2-4 a frame, 18 joints): card equals "
        f"host bit for bit (joints2d, conf, visibility, counts); people found as painted on "
        f"{found:.1%} of frames (bar 90%), {int(counts.sum())} of {int(people.sum())}, "
        f"visible joints a person "
        f"{float(dk['visibility'].sum()) / max(int(counts.sum()), 1):.2f}")
    require(found >= 0.9, "the COCO decode finds the painted people on fewer than 90% of frames")
    torch.cuda.synchronize()
    return errs, maps


def phase_coco_slice(rng, dev, B: int):
    """The float32 COCO RGB slice on B frames of 480x640x3 BGR, RTPoseVGG
    from its seeded init with scaled stage-6 heads: the path's launch
    counts, its output against its CNN and decode run one by one, the
    decode of its maps on the card against the host's, bit for bit; the
    MobileNet trunk on 8 frames. Returns frames, launch counts, output, the
    float32 maps and the weights."""
    import torch

    from popnet_tpu_torch import build_rtpose_vgg_pipeline
    from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS
    from popnet_tpu_torch.decode.device import find_peaks_batched
    from popnet_tpu_torch.decode.openpose_infer import paf_decode_2d
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseVGG
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.serving import preproc_rgb, unpack_outputs_2d

    torch.backends.cudnn.allow_tf32 = False
    Hf, Wf = COCO_FRAME
    frames = torch.as_tensor(rng.uniform(0, 255, (B, Hf, Wf, 3)).astype(np.float32), device=dev)
    weights = coco_weights()
    pipe = build_rtpose_vgg_pipeline(weights, dtype=torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launches()
    buf = pipe(frames)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("coco", f"main-path launches per kernel: {launches}")
    for name, n in launches.items():
        require(n == int(name in COCO_PATH), f"kernel {name}: {n} launches on the COCO path")
    require(buf.shape == (B, 16 * 18 * 3 + 1) and buf.dtype == torch.float32,
            f"packed buffer {tuple(buf.shape)} {buf.dtype}")
    require(bool(torch.isfinite(buf).all()), "non-finite values in the packed output")
    out = unpack_outputs_2d(buf.cpu().numpy(), 16, 18)

    model = load_into(RTPoseVGG(), weights).eval().to(dev)
    with torch.inference_mode():
        (paf, heat), _ = model(preproc_rgb(frames))
        heat_n, paf_n = heat.permute(0, 2, 3, 1), paf.permute(0, 2, 3, 1)
        sx, sy = Wf / 368, Hf / 368
        dk = paf_decode_2d(heat_n, paf_n, COCO_NUM_JOINTS, limbs=COCO_LIMBS, sx=sx, sy=sy)
        dp = paf_decode_2d(heat_n.cpu(), paf_n.cpu(), COCO_NUM_JOINTS, limbs=COCO_LIMBS,
                           sx=sx, sy=sy)
    for k in ("joints2d", "conf", "visibility", "counts"):
        _exact(f"COCO decode {k}, card against host", dk[k], dp[k])
    for k in ("joints2d", "conf"):
        require(np.array_equal(out[k], dk[k].cpu().numpy()),
                f"COCO pipeline {k} differs from its CNN and decode run one by one")
    require(np.array_equal(out["counts"][:, 0], dk["counts"].cpu().numpy()),
            "COCO pipeline counts differ from its CNN and decode run one by one")
    counts = out["counts"][:, 0].astype(int)
    peaks, valid = find_peaks_batched(heat_n, num_joints=COCO_NUM_JOINTS)
    nv = valid.sum(-1)
    say("coco", f"B={B} frames of {Hf}x{Wf}: heat max {float(heat.max()):.3f}, paf |max| "
        f"{float(paf.abs().max()):.3f}; valid peaks per plane mean "
        f"{float(nv.float().mean()):.2f}, "
        f"max {int(nv.max())}; people per frame histogram "
        f"{np.bincount(counts, minlength=4).tolist()}, visible joints a person "
        f"{float(dk['visibility'].sum()) / max(int(counts.sum()), 1):.2f}; the pipeline's "
        f"output equals its CNN and decode run one by one, and the decode of its maps on the "
        f"card equals the host's, bit for bit")
    require(int(counts.sum()) > 0, "the COCO slice found nobody: the decode did no work")

    mobile = build_rtpose_vgg_pipeline(dtype=torch.float32, trunk="mobilenet")
    mb = mobile(frames[:8])
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(mb).all())
    require(mb.shape == (8, 16 * 18 * 3 + 1) and finite,
            f"MobileNet trunk: packed buffer {tuple(mb.shape)}, finite {finite}")
    say("coco", "MobileNet trunk (seeded init), float32, 8 frames: packed buffer "
        f"{tuple(mb.shape)}, all finite")
    return frames, launches, out, {"heat": heat, "paf": paf}, weights


def phase_coco_timing(frames, weights, dev, iters: int, launches, f32_out, f32_maps, painted,
                      errs) -> dict:
    """COCO RGB: the timed bf16 + f32-wire stream and the bf16 CNN's maps
    against the float32 slice's, the CNN's time and rate from its conv
    shapes, the eager decode and its device operations, and K1, K3 and K6
    at the COCO shapes on the painted maps (CUDA-graph replays) beside
    their bounds. Returns the kernels' rows by name."""
    import torch

    from popnet_tpu_torch import build_rtpose_vgg_pipeline
    from popnet_tpu_torch.core.config import DecodeConfig
    from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS
    from popnet_tpu_torch.decode.assemble_device import assemble_inputs
    from popnet_tpu_torch.decode.device import (find_peaks_batched, peak_planes,
                                                score_limb_pairs_batched)
    from popnet_tpu_torch.decode.openpose_infer import paf_decode_2d
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseVGG
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.serving import preproc_rgb, unpack_outputs_2d

    B, Hf, Wf, _ = frames.shape
    K, sx, sy = COCO_NUM_JOINTS, Wf / 368, Hf / 368
    pipe = build_rtpose_vgg_pipeline(weights)                 # bf16 CNN, the default
    time_stream("COCO RGB", pipe, frames, iters,
                lambda buf: check_coco_bf16(unpack_outputs_2d(buf, 16, K), f32_out), wire="f32")
    model = load_into(RTPoseVGG(), weights).eval().to(dev, torch.bfloat16)
    with torch.inference_mode():
        xb = preproc_rgb(frames).to(torch.bfloat16)
        cnn_ms = time_ms(lambda: model(xb), reps=5)
        flops = conv_flops(model, xb[:1]) * B
        (paf, heat), _ = model(xb)
        for name, b16, f32 in (("heat", heat, f32_maps["heat"]), ("paf", paf, f32_maps["paf"])):
            rel = _maxerr(b16, f32) / float(f32.abs().max())
            say("timing", f"COCO RGB {name} maps, bf16 CNN vs float32 on the same {B} frames: "
                f"max|err| {rel:.4g} of max|value| (bar {COCO_BF16_MAP_BAR})")
            require(rel <= COCO_BF16_MAP_BAR,
                    f"COCO RGB bf16 {name} maps are off the float32 ones")
        heat_n, paf_n = heat.permute(0, 2, 3, 1), paf.permute(0, 2, 3, 1)

        def decode():
            return paf_decode_2d(heat_n, paf_n, K, limbs=COCO_LIMBS, sx=sx, sy=sy)

        decode_ms = time_ms(decode, reps=10)
        say("timing", f"COCO RGB per batch of {B} frames: CNN bf16 {cnn_ms:.3f} ms "
            f"({flops / B / 1e9:.2f} GFLOP a frame in its convolutions, {flops / 1e12:.2f} "
            f"TFLOP a batch: {flops / cnn_ms / 1e9:.1f} TFLOP/s); decode (eager, through the "
            f"kernels) {decode_ms:.3f} ms, device operations per call {device_ops(decode)}; "
            f"the maps as the decode gets them: heat strides {tuple(heat_n.stride())}, paf "
            f"strides {tuple(paf_n.stride())}")

        # the kernels at the COCO shapes, on the painted people
        heat, paf = painted["heat"], painted["paf"]
        h = peak_planes(heat, K)
        px, py, _, _, slot_valid = kernels.find_peaks(h)
        peaks, pvalid = find_peaks_batched(heat, num_joints=K)
        scores, ok = score_limb_pairs_batched(paf, peaks, pvalid, limbs=COCO_LIMBS)
        ps, sm = assemble_inputs(peaks, scores, ok)
        ids, _ = kernels.assemble_ids(ps, sm, COCO_LIMBS)
        calls = {
            "find_peaks": (lambda: kernels.find_peaks(h), lambda: kernels.find_peaks_plain(h),
                           None, {"heat": h, "px": px, "py": py, "valid": slot_valid,
                                  "thresh": DecodeConfig().thresh_heatmap}),
            "paf_score": (lambda: kernels.paf_score(paf, peaks, pvalid, COCO_LIMBS),
                          lambda: kernels.paf_score_plain(paf, peaks, pvalid, COCO_LIMBS),
                          None, {"paf": paf, "peaks": peaks, "score": scores,
                                 "limbs": COCO_LIMBS}),
            "assemble_ids": (lambda: kernels.assemble_ids(ps, sm, COCO_LIMBS),
                             lambda: kernels.assemble_ids_plain(ps, sm, COCO_LIMBS), None,
                             {"peak_score": ps, "s_masked": sm, "ids": ids,
                              "connections": greedy_connections(sm)}),
        }
        rows = {r["name"]: r for r in time_kernels(calls, launches, errs, tag="COCO ")}
        pairs = distinct_pairs(peaks, COCO_LIMBS)
        say("timing", f"COCO painted maps: distinct coordinate pairs per limb mean "
            f"{float(pairs.float().mean()):.3f}, max {int(pairs.max())}; per frame mean "
            f"{float(pairs.sum(1).float().mean()):.1f}")
        stage_breakdown("paf_score", lambda: kernels.paf_score(paf, peaks, pvalid, COCO_LIMBS),
                        rows["paf_score"]["ms"], tag="COCO ")
    return rows


def bf16_heads(crops, heads, kp, anchors, valid) -> None:
    """A2J in bf16, as the timed pipeline runs it, on the float32 slice's
    crops against the float32 heads: each head's largest error over its
    largest magnitude, and the vote's crop-space (y, x) on the valid slots,
    at A2J_BF16_BARS. The seeded init's softmax is sharp, so a bf16 rounding
    can move a joint's vote by whole anchors: its bars are a median and a
    99th percentile, not a maximum."""
    import torch

    from popnet_tpu_torch.decode.a2j import a2j_post_process
    from popnet_tpu_torch.models import A2J
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32

    a2j = A2J().init_seeded(A2J_SEED).eval().to(crops.device, torch.bfloat16)
    a2j = keep_batchnorm_float32(a2j)
    hb = [h.float() for h in a2j(crops[:, None].to(torch.bfloat16))]
    for name, b, f in zip(("classification", "regression", "depth"), hb, heads):
        rel = _maxerr(b, f) / float(f.abs().max())
        say("a2j", f"A2J {name} head, bf16 vs float32 on the same {len(f)} crops: max|err| "
            f"{rel:.4g} of max|value| (bar {A2J_BF16_BARS[name]:.4g})")
        require(rel <= A2J_BF16_BARS[name], f"A2J {name} head in bf16 is off the float32 one")
    d = (a2j_post_process(hb, anchors) - kp)[valid][..., :2].norm(dim=-1)
    q50, q99, top = (float(v) for v in (d.median(), torch.quantile(d, 0.99), d.max()))
    say("a2j", f"A2J vote (y, x) in crop pixels, bf16 vs float32 heads on the {int(valid.sum())} "
        f"valid crops' {d.numel()} joints: median {q50:.4g}, 99th percentile {q99:.4g}, max "
        f"{top:.4g} (bars {A2J_BF16_BARS['vote_median']:.4g}, {A2J_BF16_BARS['vote_p99']:.4g})")
    require(q50 <= A2J_BF16_BARS["vote_median"] and q99 <= A2J_BF16_BARS["vote_p99"],
            "the A2J vote of bf16 heads is off the float32 one")


def check_a2j_bf16(q16: dict, f32: dict) -> None:
    """The timed Yolo->A2J configuration against the float32 slice on the
    same frames: the flags are the detector's, so people per frame equal on
    at least 80% of the frames and people in all within 10% (as
    check_bf16); every value finite. The joints come from an A2J init and
    are not compared."""
    cq, cf = (o["counts"].astype(int).sum(axis=1) for o in (q16, f32))
    same = float((cq == cf).mean())
    say("timing", f"Yolo->A2J bf16+q16 vs f32 on the same {len(cf)} frames: people per frame "
        f"equal on {same:.1%} (bar 80%), people {cq.sum()} vs {cf.sum()}")
    require(bool(np.isfinite(q16["joints3d"]).all()), "non-finite values in the q16 output")
    require(same >= 0.80, "bf16 and f32 person counts differ on more than 20% of frames")
    require(abs(int(cq.sum()) - int(cf.sum())) <= 0.10 * cf.sum(), "bf16 people differ by over 10%")


def check_coco_bf16(b16: dict, f32: dict) -> None:
    """The timed COCO RGB configuration (bf16 CNN, f32 wire) against the
    float32 slice on the same frames: people and visible joints within 10%,
    every value finite. The seeded init's maps are noise whose many peaks
    and pairs sit near the decode's thresholds, and the bf16 CNN moves the
    maps by about 2% of their range: people per frame is printed, not held
    to a bar (on these maps it is a count of near-ties; check_bf16's 80% is
    for trained weights' peaked maps). The maps themselves are held at
    COCO_BF16_MAP_BAR in phase_coco_timing."""
    cq, cf = (o["counts"].astype(int).sum(axis=1) for o in (b16, f32))
    vq, vf = (int((o["joints2d"][..., 0] >= 0).sum()) for o in (b16, f32))
    say("timing", f"COCO RGB bf16+f32 vs f32 on the same {len(cf)} frames: people per frame "
        f"equal on {float((cq == cf).mean()):.1%} (within one on "
        f"{float((np.abs(cq - cf) <= 1).mean()):.1%}; no bar), people {cq.sum()} vs "
        f"{cf.sum()}, visible joints {vq} vs {vf} (bar 10%)")
    require(bool(np.isfinite(b16["joints2d"]).all()), "non-finite values in the f32 output")
    require(abs(int(cq.sum()) - int(cf.sum())) <= 0.10 * cf.sum(),
            "bf16 people differ by over 10%")
    require(abs(vq - vf) <= 0.10 * vf, "bf16 visible joints differ by over 10%")


def check_bf16(tag: str, q16: dict, f32: dict) -> None:
    """The timed configuration (bf16 CNN, q16 wire) against the float32
    slice on the same frames: people per frame equal on at least 80% of the
    frames, and people and visible joints in all within 10% (bars wide of
    bf16's rounding, tight enough to catch a broken bf16 path). Open-Pose+
    packs one count per frame and marks holes with -1; PoP-Net packs a flag
    per row, and its visible joints are those of flagged rows that lie
    inside the (480, 512) frame."""
    def visible(out):
        x, y = out["joints2d"][..., 0], out["joints2d"][..., 1]
        if out["counts"].shape[1] == 1:
            return x >= 0
        return (out["counts"] > 0)[..., None] & (x >= 0) & (x <= 479) & (y >= 0) & (y <= 511)

    cq, cf = (o["counts"].astype(int).sum(axis=1) for o in (q16, f32))
    vq, vf = int(visible(q16).sum()), int(visible(f32).sum())
    same = float((cq == cf).mean())
    say("timing", f"{tag} bf16+q16 vs f32 on the same {len(cf)} frames: people per frame "
        f"equal on {same:.1%} (bar 80%), people {cq.sum()} vs {cf.sum()}, visible joints "
        f"{vq} vs {vf} (bar 10%)")
    require(bool(np.isfinite(q16["joints3d"]).all()), "non-finite values in the q16 output")
    require(same >= 0.80, "bf16 and f32 person counts differ on more than 20% of frames")
    require(abs(int(cq.sum()) - int(cf.sum())) <= 0.10 * cf.sum(), "bf16 people differ by over 10%")
    require(abs(vq - vf) <= 0.10 * vf, "bf16 visible joints differ by over 10%")


def write_eval_set(root: str, frames, people: dict) -> tuple[str, str]:
    """Write (B, H, W) depth frames as root/depth_maps/<b>.npy and their
    people as root/labels.json in the MP-3DHP label format: per frame a list
    of {"2d_joints", "3d_joints" (back-projected with the KDH3D camera),
    "bbox" (the joints' box with a 20 px margin)}, and the camera under
    "intrinsics". Returns (image directory, label path)."""
    from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS as cam, back_project_np

    img_dir = os.path.join(root, "depth_maps")
    os.makedirs(img_dir, exist_ok=True)
    labels = {"intrinsics": {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy}}
    host = frames.cpu().numpy()
    for b in range(host.shape[0]):
        name = f"frame_{b:04d}.npy"
        np.save(os.path.join(img_dir, name), host[b])
        anns = []
        for p in np.flatnonzero(people["present"][b]):
            j2, z = people["joints2d"][b, p], people["z"][b, p]
            anns.append({"2d_joints": j2.tolist(),
                         "3d_joints": back_project_np(j2[:, 0], j2[:, 1], z, cam).tolist(),
                         "bbox": [float(j2[:, 0].min() - 20), float(j2[:, 1].min() - 20),
                                  float(j2[:, 0].max() + 20), float(j2[:, 1].max() + 20)]})
        labels[name] = anns
    path = os.path.join(root, "labels.json")
    with open(path, "w") as f:
        json.dump(labels, f)
    return img_dir, path


def openpose_painted_maps(frame_anns, w_org: int = 480, h_org: int = 512, size: int = 224,
                          stride: int = 8, depth_mean: float = 3.0, depth_std: float = 2.0):
    """Open-Pose+ maps painted from labels, as a trained CNN would give
    them: for each frame's list of annotations, 15 Gaussian heat blobs of
    sigma 7/8 cell at the joints (in grid cells, whose centres lie at
    (c + 0.5) * stride - 0.5 input px) and a background channel; the unit
    vector of each of the 14 limbs on the cells within one cell of the
    limb's line and box (averaged where people overlap); and each joint's
    normalized GT depth in its channel on the 5x5 cells around the joint's
    cell. Returns heat (B, g, g, 16), paf (B, g, g, 28) and z (B, g, g, 15)
    float32 for g = size / stride."""
    from popnet_tpu_torch.core.skeleton import LIMBS

    limbs = np.asarray(LIMBS)
    g = size // stride
    ys, xs = np.mgrid[0:g, 0:g].astype(np.float64)
    B = len(frame_anns)
    heat = np.zeros((B, g, g, 16))
    paf = np.zeros((B, g, g, 28))
    z = np.zeros((B, g, g, 15))
    n_paint = np.zeros((B, g, g, 14))
    for b, anns in enumerate(frame_anns):
        for a in anns:
            px = np.asarray(a["2d_joints"], np.float64) * [size / w_org, size / h_org]
            j = (px + 0.5) / stride - 0.5                               # (15, 2) grid cells
            d2 = (xs[..., None] - j[:, 0]) ** 2 + (ys[..., None] - j[:, 1]) ** 2
            heat[b, ..., :15] = np.maximum(heat[b, ..., :15], np.exp(-d2 / (2 * 0.875 ** 2)))
            p0, p1 = j[limbs[:, 0]], j[limbs[:, 1]]
            v = (p1 - p0) / np.maximum(np.linalg.norm(p1 - p0, axis=1, keepdims=True), 1e-9)
            rx, ry = xs[..., None] - p0[:, 0], ys[..., None] - p0[:, 1]
            on = ((np.abs(rx * v[:, 1] - ry * v[:, 0]) <= 1.0)
                  & (xs[..., None] >= np.minimum(p0[:, 0], p1[:, 0]) - 1)
                  & (xs[..., None] <= np.maximum(p0[:, 0], p1[:, 0]) + 1)
                  & (ys[..., None] >= np.minimum(p0[:, 1], p1[:, 1]) - 1)
                  & (ys[..., None] <= np.maximum(p0[:, 1], p1[:, 1]) + 1))
            paf[b, ..., 0::2] += on * v[:, 0]
            paf[b, ..., 1::2] += on * v[:, 1]
            n_paint[b] += on
            zn = (np.asarray(a["3d_joints"], np.float64)[:, 2] - depth_mean) / depth_std
            cell = np.clip(np.floor(px / stride).astype(int), 0, g - 1)
            for k in range(15):
                x0, y0 = cell[k]
                z[b, max(y0 - 2, 0):y0 + 3, max(x0 - 2, 0):x0 + 3, k] = zn[k]
    paf /= np.repeat(np.maximum(n_paint, 1), 2, axis=-1)
    heat[..., 15] = np.maximum(1.0 - heat[..., :15].max(-1), 0.0)
    return heat.astype(np.float32), paf.astype(np.float32), z.astype(np.float32)


# the families of the eval phase: (tag, model, frame set, run_evaluation options)
EVAL_FAMILIES = (("openpose", "openpose", "zero", {"device_decode": False}),
                 ("openpose_device_decode", "openpose", "zero", {"device_decode": True}),
                 ("popnet", "popnet", "bg", {"readout": "universe"}),
                 ("yolo", "yolo", "bg", {}),
                 ("a2j", "a2j", "bg", {}))
EVAL_PATH = ("find_peaks", "paf_score", "assemble_ids", "window_readout", "point_readout",
             "peak_local_max")
ORACLE_BARS = {"pck2d": 0.95, "pck3d": 0.9, "map2d": 0.9, "map3d": 0.85}


def eval_sets(rng, dev, n: int, root: str) -> dict:
    """Two labelled sets of n person frames under root: "zero" on the zero
    background (Open-Pose+'s weights), "bg" over the smooth depth background
    (PoP-Net's and Yolo's). Returns {name: (image directory, label path)}."""
    sets = {}
    for name, bg in (("zero", False), ("bg", True)):
        frames, people = person_frames(rng, n, dev, background=bg, people=True)
        sets[name] = write_eval_set(os.path.join(root, name), frames, people)
    return sets


def _to_cpu(out):
    return tuple(t.cpu() for t in out) if isinstance(out, tuple) else out.cpu()


class Recorder:
    """Wraps an infer function of a driver: keeps each call's input and
    output (on the card) and the call's time (synchronized CUDA clock);
    `replay()` is an infer function for the host run, which hands back the
    kept outputs on the CPU after requiring its input to equal the kept one
    bit for bit (the dataset's images, or the A2J crops, made on the CPU)."""

    def __init__(self, fn, what: str):
        self.fn, self.what = fn, what
        self.inputs, self.outputs, self.seconds = [], [], 0.0

    def __call__(self, x):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(x)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.inputs.append(x)
        self.outputs.append(out)
        return out

    def replay(self):
        import torch

        calls = iter(zip(self.inputs, self.outputs))

        def infer(x):
            xin, out = next(calls)
            require(torch.equal(x, xin.cpu()), f"{self.what}: the host's input differs from "
                    "the card's")
            return _to_cpu(out)

        return infer


def eval_family(tag: str, model: str, opts: dict, paths, dev, batch: int, weights: dict):
    """One family's driver (cli.main.run_evaluation) on the card with the
    committed weights (A2J from its seeded init), then on the host with the
    same CNN outputs, through the plain versions of the kernels. Returns
    (card JSON, host JSON, timing {seconds: the card run, cnn_seconds,
    data_seconds: get_batch, load_seconds: the .npy loads of get_batch and
    of A2J's frames, host_seconds: the host run}, the host's A2J vote inputs
    or None)."""
    import torch

    from popnet_tpu_torch.cli.main import make_infers, run_evaluation
    from popnet_tpu_torch.data.datasets import MPRealDataset

    infer, infer_yolo = make_infers(model, weights.get(model), weights.get("yolo_for_a2j"),
                                    seed=A2J_SEED, device=dev)
    rec = Recorder(infer, f"{tag} {'crops' if model == 'a2j' else 'images'}")
    rec_yolo = Recorder(infer_yolo, f"{tag} detector images") if infer_yolo else None
    ds = MPRealDataset(*paths, device=dev)
    get_batch, load, data_s, load_s = ds.get_batch, ds.load_composited, [0.0], [0.0]

    def timed_get_batch(idx):
        t0 = time.perf_counter()
        out = get_batch(idx)
        torch.cuda.synchronize()
        data_s[0] += time.perf_counter() - t0
        return out

    def timed_load(i):
        t0 = time.perf_counter()
        out = load(i)
        load_s[0] += time.perf_counter() - t0
        return out

    ds.get_batch, ds.load_composited = timed_get_batch, timed_load
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run_evaluation(model, rec, ds, batch, infer_yolo=rec_yolo, **opts)
    seconds = time.perf_counter() - t0
    cnn = rec.seconds + (rec_yolo.seconds if rec_yolo else 0.0)
    host_ds = MPRealDataset(*paths, device="cpu")
    t0 = time.perf_counter()
    host = run_evaluation(model, rec.replay(), host_ds, batch,
                          infer_yolo=rec_yolo.replay() if rec_yolo else None, **opts)
    timing = {"seconds": seconds, "cnn_seconds": cnn, "data_seconds": data_s[0],
              "load_seconds": load_s[0], "host_seconds": time.perf_counter() - t0}
    a2j = None
    if model == "a2j":
        a2j = {"heads": rec.outputs, "yolo": rec_yolo, "host_ds": host_ds, "batch": batch}
    return card, host, timing, a2j


def a2j_bars(a2j: dict):
    """The A2J JSON's bars, card against host, per box row in the JSON's
    order: the vote's 64-ulp bar (2**-18 of the largest |(y, x)| and |z| of
    the host's vote, `phase_a2j_slice`) carried through the uncrop to image
    pixels (times the box's extent / 288) and through the back-projection.
    Also requires the card's vote within that bar of the host's."""
    import torch

    from popnet_tpu_torch.cli.yolo_a2j import stage1_detect_boxes
    from popnet_tpu_torch.data.a2j_crops import CROP
    from popnet_tpu_torch.decode.a2j import a2j_post_process
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors

    anchors = torch.as_tensor(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
                              dtype=torch.float32)
    kp_card = torch.cat([a2j_post_process(h, anchors.cuda()).cpu() for h in a2j["heads"]])
    kp_host = torch.cat([a2j_post_process(_to_cpu(h), anchors) for h in a2j["heads"]])
    bar_yx = 2.0 ** -18 * float(kp_host[..., :2].abs().max())
    bar_z = 2.0 ** -18 * float(kp_host[..., 2].abs().max())
    err_yx = _maxerr(kp_card[..., :2], kp_host[..., :2])
    err_z = _maxerr(kp_card[..., 2], kp_host[..., 2])
    require(err_yx <= bar_yx and err_z <= bar_z,
            f"A2J vote, card against host: {err_yx:.4g} (bar {bar_yx:.4g}), {err_z:.4g} "
            f"(bar {bar_z:.4g})")
    idx, boxes = stage1_detect_boxes(a2j["yolo"].replay(), a2j["host_ds"], a2j["batch"])
    ext = np.stack([boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]], 1) / CROP
    rows = [[] for _ in range(int(idx.max()) + 1 if len(idx) else 0)]
    for n, i in enumerate(idx):
        rows[i].append(ext[n])
    return rows, bar_yx, bar_z, err_yx, err_z


def compare_eval_json(tag: str, card: dict, host: dict, a2j_rows=None) -> None:
    """Card JSON against host JSON: the same keys, images and people; every
    value equal bit for bit, but the A2J joints, within the bars of
    `a2j_bars` (a2j_rows: (rows, bar_yx, bar_z, ...))."""
    from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS as cam

    require(set(card) == set(host), f"{tag}: keys differ")
    for key in card:
        require(len(card[key]) == len(host[key]), f"{tag} {key}: image count differs")
        for i, (a, b) in enumerate(zip(card[key], host[key])):
            require(len(a) == len(b), f"{tag} {key} image {i}: person count differs")
            if a2j_rows is None or key not in ("human_pred_set_2d", "human_pred_set_3d"):
                require(a == b, f"{tag} {key} image {i}: card and host differ")
                continue
            rows, bar_yx, bar_z = a2j_rows[:3]
            for p, (ha, hb) in enumerate(zip(a, b)):
                ha, hb = np.asarray(ha), np.asarray(hb)
                dxy = bar_yx * rows[i][p][None, :] * (1 + 1e-9) + 1e-9
                if key == "human_pred_set_2d":
                    ok = np.all(np.abs(ha - hb) <= dxy)
                else:
                    z = np.abs(hb[:, 2])
                    centre = np.stack([(hb[:, 0] / np.maximum(z, 1e-12)) * cam.fx,
                                       (hb[:, 1] / np.maximum(z, 1e-12)) * cam.fy], 1)
                    f = np.array([cam.fx, cam.fy])
                    bound = dxy / f * (z[:, None] + bar_z) + np.abs(centre) / f * bar_z + 1e-9
                    ok = (np.all(np.abs(ha[:, :2] - hb[:, :2]) <= bound)
                          and np.all(np.abs(ha[:, 2] - hb[:, 2]) <= bar_z * (1 + 1e-9)))
                require(bool(ok), f"{tag} {key} image {i} person {p}: card and host differ "
                        "beyond the vote's bar")


def check_batched_twin(tag: str, data: dict, dev) -> tuple[float, float]:
    """The batched metrics (eval/batched.py) on the card against the NumPy
    metrics on the same JSON: 2D PCKh and 3D PCK per joint within 1e-6, the
    2D and 3D APs within 1e-6. Returns the largest errors (pck, AP)."""
    from popnet_tpu_torch.eval import batched, map as np_map, pck as np_pck

    al = "_aligned" if "human_pred_set_2d_aligned" in data else ""
    p2l, p3l = data["human_pred_set_2d" + al], data["human_pred_set_3d" + al]
    conf, g2l, g3l = data["human_pred_set_part_conf"], data["human_gt_set_2d"], data[
        "human_gt_set_3d"]
    g2, g3, _, gv = batched.pack_human_sets(g2l, g3l)
    p2, p3, cf, pv = batched.pack_human_sets(p2l, p3l, conf=conf)
    names = [str(k) for k in range(15)]
    _, pckh = batched.eval_pckh2d_batched(g2, gv, p2, pv, device=dev)
    _, pck3 = batched.eval_pck3d_batched(g2, g3, gv, p2, p3, pv, dist_th=0.1, device=dev)
    hsz = 2.0 * np.sqrt(((g2[:, :, 0] - g2[:, :, 1]) ** 2).sum(-1))
    gvis = np.ones(g2.shape[:3], np.float32)
    ap2 = batched.eval_ap_batched(p2, cf, pv, g2, gvis, gv, hsz, thresh=0.5, device=dev)
    ap3 = batched.eval_ap_batched(p3, cf, pv, g3, gvis, gv, np.ones(gv.shape, np.float32),
                                  thresh=0.1, device=dev)
    ref_pckh = np_pck.eval_human_dataset_2d_pckh(p2l, g2l, head_id=0, neck_id=1)[1]
    ref_pck3 = np_pck.eval_human_dataset_3d(p2l, g2l, p3l, g3l, dist_th=0.1)[1]
    ref_ap2 = np_map.eval_ap_mpii_v2(p2l, list(conf), g2l, [], 0, 1, names, verbose=False)
    ref_ap3 = np_map.eval_ap_3d(p3l, list(conf), g3l, [], names, verbose=False)
    e_pck = max(_maxerr_np(pckh, ref_pckh), _maxerr_np(pck3, ref_pck3))
    e_ap = max(_maxerr_np(ap2, ref_ap2), _maxerr_np(ap3, ref_ap3))
    require(e_pck <= 1e-6 and e_ap <= 1e-6,
            f"{tag}: batched metrics on the card differ from NumPy's (pck {e_pck:.3g}, AP "
            f"{e_ap:.3g})")
    return e_pck, e_ap


def _maxerr_np(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def painted_oracle(paths, dev, batch: int, device_decode: bool) -> tuple[dict, dict]:
    """The painted Open-Pose+ oracle (openpose_painted_maps from the set's
    labels) fed to run_openpose_eval on `dev`: (metrics, ablation channels)."""
    import torch

    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.data.datasets import MPRealDataset

    ds = MPRealDataset(*paths, device=dev)
    pos = {"i": 0}

    def infer(images):
        idx = range(pos["i"], pos["i"] + images.shape[0])
        pos["i"] += images.shape[0]
        heat, paf, z = openpose_painted_maps([ds.anno_dic[ds.ids[i]] for i in idx])
        return tuple(torch.from_numpy(a).to(dev) for a in (paf, heat, z))

    data = ev.run_openpose_eval(infer, ds, batch, device_decode=device_decode)
    return ev.evaluate_eval_data(data, verbose=False), ev.evaluate_ablation_channels(data)


def phase_eval(rng, dev, n: int = 256, batch: int = 64) -> dict:
    """The MP-3DHP evaluation drivers on the card (the port's eval path):
    two labelled sets of n frames, each family's driver with the committed
    weights (A2J seeded) at `batch`, float32 CNNs; the same CNN outputs
    through the drivers on the host (plain versions), JSON equal (A2J within
    the vote's bar) and metrics equal; the batched metrics on the card
    against NumPy's; the painted Open-Pose+ oracle over its bars; the
    `evaluate` and `benchmark` subcommands once. Returns the eval path's
    launch counts."""
    import tempfile

    import torch

    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.ops import kernels

    weights = {"openpose": WEIGHTS, "popnet": WEIGHTS_POPNET, "yolo": WEIGHTS_YOLO,
               "yolo_for_a2j": WEIGHTS_YOLO}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sets = eval_sets(rng, dev, n, tmp)
        people = {}
        for name, (_, labels) in sets.items():
            with open(labels) as f:
                people[name] = sum(len(v) for k, v in json.load(f).items() if k != "intrinsics")
        say("eval", f"wrote two labelled sets of {n} frames (.npy and labels.json; GT people: "
            f"{people}) in {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        runs = {tag: eval_family(tag, model, opts, sets[s], dev, batch, weights)
                for tag, model, s, opts in EVAL_FAMILIES}
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        fused = kernels.readouts.launches
        say("eval", f"eval path launches per kernel: {launches}; of them, readouts (K4 and K5 "
            f"together): {fused}")
        for name in EVAL_PATH:
            require(launches[name] >= 1, f"kernel {name} was not launched on the eval path")
        require(fused >= 1, "the fused readouts were not launched on the eval path")

        for tag, model, _, _ in EVAL_FAMILIES:
            card, host, timing, a2j = runs[tag]
            people = sum(len(h) for h in card["human_pred_set_2d"])
            bars = None
            if a2j is not None:
                bars = a2j_bars(a2j)
                say("eval", f"{tag}: A2J vote card vs host max|err| (y, x) {bars[3]:.4g} (bar "
                    f"{bars[1]:.4g}), z {bars[4]:.4g} (bar {bars[2]:.4g})")
            compare_eval_json(tag, card, host, bars)
            m_card, m_host = ev.evaluate_eval_data(card, verbose=False), \
                ev.evaluate_eval_data(host, verbose=False)
            four = ("pck2d", "pck3d", "map2d", "map3d")
            require(all(m_card[k] == m_host[k] or (np.isnan(m_card[k]) and np.isnan(m_host[k]))
                        for k in four), f"{tag}: card and host metrics differ")
            e_pck, e_ap = check_batched_twin(tag, card, dev)
            s = timing["seconds"]
            say("eval", f"{tag}: {n} frames in {s:.3f} s = {n / s:.1f} eval frames/s "
                f"(batch {batch}, float32 CNN); CNN {timing['cnn_seconds']:.3f} s "
                f"({timing['cnn_seconds'] / s:.1%}), .npy loads {timing['load_seconds']:.3f} s "
                f"({timing['load_seconds'] / s:.1%}), batches made on the card (loads, copy, "
                f"warp) {timing['data_seconds']:.3f} s, decode and host JSON the rest; the "
                f"host run {timing['host_seconds']:.3f} s; {people} people predicted; metrics "
                + json.dumps({k: m_card[k] for k in four}) + "; JSON card = host"
                + (" (A2J joints within the vote's bar)" if a2j else " bit for bit")
                + f", metrics equal; batched metrics on the card vs NumPy max|err| pck "
                f"{e_pck:.3g}, AP {e_ap:.3g}")
            if model == "openpose":
                say("eval", f"{tag} ablation 3D-PCK channels: "
                    + json.dumps(ev.evaluate_ablation_channels(card)))

        say("eval", f"the five families, card and host runs, in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for dd in (False, True):
            m, abl = painted_oracle(sets["zero"], dev, batch, dd)
            say("eval", f"painted Open-Pose+ oracle on the card (device_decode={dd}): "
                + json.dumps({k: m[k] for k in ORACLE_BARS}) + f", perfect_2d "
                f"{abl['perfect_2d']:.4f}; bars {ORACLE_BARS}, perfect_2d > 0.95")
            require(all(m[k] > bar for k, bar in ORACLE_BARS.items())
                    and abl["perfect_2d"] > 0.95, "the painted oracle falls short of its bars")

        say("eval", f"painted oracle, both decodes, in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out = os.path.join(tmp, "out")
        root = os.path.dirname(sets["zero"][0])
        res = cli_main(["evaluate", "--model", "openpose", "--data-root", root, "--out-dir", out,
                        "--batch-size", str(batch), "--weights", WEIGHTS])
        got = cli_main(["benchmark", "--gt", sets["zero"][1],
                        "--pred", os.path.join(out, "openpose_results.json")])
        require(all(res[k] == got[k] for k in ("pck2d", "pck3d", "map2d", "map3d")),
                "benchmark's scores of evaluate's JSON differ from evaluate's")
        say("eval", "python -m popnet_tpu_torch.cli.main evaluate --model openpose (on the card) "
            "wrote openpose_results.json, and benchmark scores it as evaluate did, in "
            f"{time.perf_counter() - t0:.1f} s")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the frames and test inputs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from popnet_tpu_torch import load_npz

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)           # the first slice's inputs, as ever
    rng_new = np.random.default_rng([args.seed, 2])  # the later kernels' and PoP-Net's
    sm_clock_mhz = phase_device()
    phase_build()
    rng3 = np.random.default_rng([args.seed, 3])    # the sparse and shared-coordinate cases
    rng4 = np.random.default_rng([args.seed, 4])    # the readout's and the assembly's new cases
    errs = phase_kernels(rng, rng_new, rng3, rng4, dev, BATCH)
    rng_coco = np.random.default_rng([args.seed, 6])  # the COCO painted maps and frames
    errs_coco, painted = phase_coco_kernels(rng_coco, dev, COCO_BATCH)
    weights, weights_pn = load_npz(WEIGHTS), load_npz(WEIGHTS_POPNET)
    frames, launches, f32_out = phase_slice(rng, dev, BATCH, weights)
    frames_pn, launches_pn, f32_out_pn = phase_popnet_slice(rng_new, dev, BATCH, weights_pn)
    weights_yolo = load_npz(WEIGHTS_YOLO)
    rng_yolo = np.random.default_rng([args.seed, 5])  # the Yolo-Pose+ and Yolo->A2J frames
    # the Yolo slices' pipelines and their stages run one by one pick the same cuDNN algorithms
    torch.backends.cudnn.deterministic = True
    frames_y, _, f32_out_y = phase_yolo_slice(rng_yolo, dev, BATCH, weights_yolo)
    _, f32_out_a2j = phase_a2j_slice(frames_y, dev, weights_yolo, f32_out_y)
    # so do the COCO pipeline and its CNN run alone
    frames_c, launches_c, f32_out_c, f32_maps_c, weights_c = phase_coco_slice(rng_coco, dev,
                                                                              COCO_BATCH)
    torch.backends.cudnn.deterministic = False
    rows = phase_timing(frames, weights, dev, BATCH, TIMED_BATCHES, errs, launches, f32_out,
                        sm_clock_mhz)
    rows += phase_popnet_timing(frames_pn, weights_pn, dev, TIMED_BATCHES, errs, launches_pn,
                                f32_out_pn)
    phase_yolo_timing(frames_y, weights_yolo, dev, TIMED_BATCHES, f32_out_y)
    phase_a2j_timing(frames_y, weights_yolo, dev, TIMED_BATCHES, f32_out_a2j)
    coco = phase_coco_timing(frames_c, weights_c, dev, TIMED_BATCHES, launches_c, f32_out_c,
                             f32_maps_c, painted, errs_coco)
    for r in rows:                  # K1, K3 and K6 at the COCO shapes, beside their depth rows
        if r["name"] in coco:
            r["coco"] = {k: v for k, v in coco[r["name"]].items()
                         if k not in ("name", "route", "source", "replaces")}
    rng_eval = np.random.default_rng([args.seed, 7])  # the eval phase's labelled frames
    eval_launches = phase_eval(rng_eval, dev, EVAL_FRAMES, EVAL_BATCH)
    for r in rows:                  # launches on the eval path, beside the serving path's
        r["eval_launches"] = eval_launches[r["name"]]
    require(sorted(r["name"] for r in rows) == sorted(KERNEL_META), "a kernel has no row")
    require(all(r["launches"] >= 1 for r in rows), "a kernel was launched on no path")
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
