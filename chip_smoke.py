#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (popnet_tpu_torch) on one NVIDIA card.

Drives the port's five serving paths at the models' full width, its
MP-3DHP evaluation drivers for the four depth families, the training
of three of them on single-person frames (phase 7) and on mp-aug
multi-person composites (phase 8), A2J's training (phase 9), each
serving path folded and in dynamic int8 (phase 10), ITOP's training,
evaluation and table with the exact host decode (phase 11), COCO and
MPII RGB training from JPEG files (phase 12), COCO evaluation at the
evaluation canvas with MP-3DHP set construction (phase 13), and the
four-method table and the readout ablation (phase 14), the parallel
layouts over torch.distributed (phase 15), and the visualizers and the
reference-checkpoint import (phase 16): the four
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
3. kernels: each of the eight kernels against its plain PyTorch version,
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
   and find_peaks_plane through find_peaks against the plain version
   (plane_cases: maps K1 and K2 cannot hold, one frame of two COCO
   canvases and of 46x276, and a 2048x2048 plane, with peaks, plateaus and
   ties where its bands meet);
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
   time by stage of K1, K2, find_peaks_plane, K3 and K6 from per-block
   clock64() stamps (and
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

7. train: the training path of Open-Pose+, PoP-Net and Yolo-Pose+
   (popnet_tpu_torch.train, cli.main train) at full width, 224², float32:
   a KDH3D-format set (write_train_set: 256 training and 64 validation
   frames of person_frames' people, their masks, 8 backgrounds) in a
   temporary directory; the prior encoder's "last person wins" on the card
   (shared_prior_check); for each family (a) a batch of 32 made on the card
   (bg_aug, augmented, f32 and u16mm transfer) against the CPU's (image,
   z-maps and masks bit for bit, other maps within 2e-6); (b) one step from
   the committed weights on 8 of its frames, card against CPU, in float64
   at the step bars (loss 1e-5, updates 1e-3 of a tensor's largest,
   BatchNorm statistics 1e-5) and in float32 (loss 1e-5, and the card's
   float32 step no further from its float64 step, in whole-update norm,
   than F32_GAP_FACTOR times the CPU's float32 step from the CPU's float64
   one), TF32 off; (c) `train --bg-aug --batch-size 32 --epochs 2
   --val-labels labels_val.json --lr 0.05`: each epoch's losses, e2e train
   frames/s over the second epoch (8 steps, the pipeline's fill included)
   and over 3 further epochs of the Trainer's loop (24 steps), the input
   pipeline and its host stage alone over 3 epochs, the step's ms (CUDA
   events), max_memory_allocated, and no kernel launched; (d) the loss falls over 5 steps on one batch; (e) 1 epoch and
   `--resume` for 1 more equal 2 epochs in one call bit for bit (cuDNN
   deterministic); then (f) `evaluate --ckpt` of each family's checkpoint
   (Open-Pose+ with and without --device-decode) with the launch counts of
   K1, K3, K6, the readouts and K7.

8. mpaug: mp-aug training (popnet_tpu_torch.data.datasets' mp-aug classes,
   data.streaming, cli.main train --mp-aug) at full width, 224², float32:
   (a) 5 location files of 96 single-person recordings (512x480 depth
   and masks, write_mpaug_bank: 480 layers, a 0.35 GB bank on the card)
   beside phase 7's backgrounds and 64 validation frames; (b) for
   KDH3DMPAugDataset (f32 and u16mm transfer), DeviceMPAugDataset,
   KDH3DMPAugAdvDataset and a staged stream shard, a batch of 32 with
   PoP-Net's targets and the visibility prior made on the card against the
   CPU's from the same seed (image, z-maps, masks and visibility channels
   bit for bit, other maps within TARGETS_BAR, the generators in
   lockstep); (f) the PoP-Net --pred-vis step, card against CPU
   (train_step_checks; the 130-channel prior head seeded); (c) the device
   bank against the host path with uint16 mm transfer on the card (label
   rows equal, image and z-maps within 2e-3, other maps within 1e-5, the
   generators' next draws equal); (d) a streamed batch over a staged shard
   against the full bank's bit for bit, one streamed epoch at 64 indices a
   shard covering every index once with at most two shards resident, the
   staging rate and, from it, a reckoning of the real split's epoch; (e)
   `train --mp-aug` for each family on the host composite, --device-bank
   and --stream-bank 64 --stream-repeats 2, and PoP-Net with --device-bank
   --pred-vis, 2 epochs at batch 32 (--lr 0.05): the losses falling, e2e
   train frames/s over the second epoch, the input pipeline and its host
   stage alone over one epoch, the step's ms (CUDA events),
   max_memory_allocated, and no kernel launched; (g) `evaluate --ckpt` of
   the --device-bank checkpoints (Open-Pose+ both decodes, PoP-Net) with
   their kernel launches (a "mpaug_ckpt_eval_launches" entry in each row
   of the kernels line).

9. a2j: A2J training (popnet_tpu_torch.data.augment_host, the training
   half of data.a2j_crops, cli.main train --model a2j) at full width, 288²
   crops, float32: phase 8's writers again (5 location files of 96
   recordings, 8 backgrounds, 64 validation frames); (a) an A2JCropDataset
   batch of 32 over KDH3DMPAugDataset made on the card against the CPU's
   from the same seed (the augmented frames, boxes, joints, crops and
   labels bit for bit, the erasing bit for bit on the card's draws, both
   generators' next draws equal); (b) the warps alone on 32 frames,
   Rotate and RenderDepth + Resize, card against CPU bit for bit, with
   their ms on the card; (c) one Adam-L2 step from the seeded init on 8
   crops, card against CPU (train_step_checks), and the train-mode
   BatchNorm statistics at Flax's momentum 0.99 (a2j_batchnorm_check); (d)
   `train --model a2j --mp-aug --bg-aug --batch-size 32 --epochs 2
   --val-labels labels_val.json` (cuDNN deterministic), `--resume` for one
   more epoch against 3 epochs in one call, bit for bit: the losses, e2e
   train crops/s over epoch 2, the input pipeline, its frames stage and
   the host composite alone over an epoch, the step's ms and TFLOP/s,
   max_memory_allocated, and no kernel launched; (e) `evaluate --model
   a2j --ckpt` of that run with phase 7's Yolo-Pose+ checkpoint as the
   detector, on phase 6's "bg" set, and the driver with those checkpoints
   on the card against the host (compare_eval_json), with their kernel
   launches (the "a2j_train_launches" and "a2j_ckpt_eval_launches"
   entries of each row, 0 expected).

10. deploy: the deployment transforms (popnet_tpu_torch.ops.fold_bn,
    ops.quant; the builders' fold_bn and quant, evaluate --fold-bn and
    --quant int8) on phase 5's frames and weights: (a) every int8 conv
    shape of the five families (82 shapes; the int8 CNNs in bf16 on 8 of
    the path's inputs, 2 for COCO) as the int32 product on the card
    (im2col and torch._int_mm) against its plain version (F.conv2d in
    float64) bit for bit, and one epilogue against its single rounding;
    (b) the fused fold against the unfused one in float32 (TF32 off) at
    tests/test_fold_bn.py's bars, COCO's MobileNet trunk too; (c) each
    serving path exact, folded, int8 and both, bf16 with the q16 wire
    (COCO f32), through serve_stream(queue_depth=3): frames/s, the CNNs'
    ms (CUDA events), the output against the float32 slice (check_bf16
    and its A2J and COCO twins; the int8 paths at INT8_BARS), and every
    eligible conv run in int8 on the card; (d) each int8 conv alone on the
    full batch: its GEMM's ms and TOPS against the int8 peak, the whole
    int8 conv, and the bf16 cuDNN conv it replaces; (e) `evaluate` of
    PoP-Net and Yolo-Pose+ on phase 6's "bg" set, float32, --fold-bn and
    --quant int8, each metric against float32 at EVAL_DEPLOY_BARS (Yolo's
    3D metrics under int8 at YOLO_INT8_3D_BAR), and the kernels' launches
    over (c) and (e) (a "deploy_launches" entry in each row).

11. itop: ITOP (popnet_tpu_torch.data.itop_a2j, ITOPA2JCropDataset,
    cli.itop_eval, cli.main --dataset itop, cli.itop_table, the exact host
    decode): (a) the synthetic ITOP sets (cli.itop_table.build_itop, 320x240
    at the ITOP camera: 64 training frames of seed 0, 64 validation frames
    of seed 777); (b) an ITOPA2JCropDataset batch of 32 with its box shifts
    made on the card against the CPU's bit for bit (crops, labels, the
    erasing on the card's draws, the generator's next draw), and
    itop_relative_stats card against CPU within 1e-12; (c) the A2J and
    Open-Pose+ oracle drivers (itop_a2j_oracle, itop_openpose_oracle) on
    the card over acc@10cm 0.995 and 0.9, the A2J predictions within the
    vote's 64-ulp bar of the host's and the Open-Pose+ JSON equal to the
    host's, and the painted Open-Pose+ oracle through the exact host decode
    (fast=False) on 32 KDH3D frames over the eval phase's bars; (d) `train --model a2j
    --dataset itop` and `train --model openpose --dataset itop`, 2 epochs
    at batch 32 validating on the validation frames: finite, falling
    losses, e2e train crops/s and frames/s, no kernel launched; (e) the
    Open-Pose+ (both decodes) and PoP-Net drivers at ITOP geometry with the
    committed weights, card against host bit for bit, eval frames/s, and
    `evaluate --dataset itop` on the card against --device cpu on the 64
    validation frames: Open-Pose+ with the committed weights (the same
    people, the joints within ITOP_OP_CLI_BARS), and A2J with --gt-boxes
    and (d)'s checkpoint, whose diverged heads magnify float32 rounding
    (itop_a2j_gaps: the joints within ITOP_A2J_F32_BARS in float32 and
    ITOP_A2J_F64_BARS in float64, the 3D ones as a share of the largest
    |joint|, and the card's float32 joints at most ITOP_A2J_F32_RATIO times
    as far from the CPU's float64 ones as the CPU's float32 joints are); (f) `python -m
    popnet_tpu_torch.cli.itop_table` at a tiny budget; and the kernels'
    launches over (c), (e) and (f) (an "itop_launches" entry in each row).

12. rgb: COCO and MPII RGB training (popnet_tpu_torch.data.image_io, the
    uint8 transforms of data.augment_host, data.coco_dataset, data.mpii,
    PopNetRGB, cli.main train --dataset coco|mpii) at full width, 368²,
    float32: (a) the JPEG reader on the committed fixtures
    (tests/fixtures/jpeg, written by cv2) against the sha256 of cv2.imread's
    output recorded beside them, the progressive fixture refused; (b)
    64 training and 16 validation frames of 640x480 BGR with 1-3 painted
    people each (rgb_frames), written as baseline 4:2:0 JPEG at quality 90
    by data.image_io.encode_jpeg (cv2.imencode's bytes, held so by the CPU
    tests) with COCO and MPII labels, and the host
    transforms' ms an image (decode, rotation, blur, resize); then for COCO
    (RTPoseVGG, VGG19 trunk) and MPII (PopNetRGB, 16 parts): a batch of 32
    made on the card against the CPU's (COCO with rotation, scale jitter,
    blur and flips; the image, scales, masks and prior targets bit for bit,
    the maps within TARGETS_BAR, the generators equal), one step from the
    seeded init on 4 frames at 64², card against CPU (train_step_checks),
    `train --dataset coco --model rtpose_vgg --trunk vgg19` (and `--dataset
    mpii --model popnet_rgb`) --input-size 368 --batch-size 32 --epochs 2
    --lr 0.05 (cuDNN deterministic): the losses falling, and 1 epoch +
    --resume 1 against 2 in one call bit for bit; (d) e2e train frames/s
    over the second epoch, the input pipeline and its host stage alone,
    the step's ms (CUDA events) and TFLOP/s from its conv shapes,
    max_memory_allocated, and no kernel launched (a "rgb_train_launches"
    entry in each row of the kernels line).

13. coco_eval: COCO evaluation at the evaluation canvas and MP-3DHP set
    construction (popnet_tpu_torch.data.preprocessing crop_with_factor and
    rgb_infer, ops.kernels.find_peaks' route to find_peaks_plane,
    data.coco coco_eval_results and run_coco_eval, eval.coco_oks,
    data.construction, cli.main generate-augset): (a) 4 images of 640x480,
    480x640, 640x427 and 427x640 with 2-3 painted people each
    (eval_images), written as baseline JPEG and read by the port's reader;
    RTPoseVGG (VGG19, 6 stages, coco_weights) float32 without TF32:
    rgb_infer on the card (canvases 368x496, 496x368, 368x552, 552x368;
    maps 46x62, 62x46, 46x69, 69x46, where K1 cannot hold a frame's 18
    planes and find_peaks launches find_peaks_plane) and paf_decode_2d,
    launch counts reset just before and read just after each image; the
    decode on the card against the host's bit for bit; the card's maps
    against the CPU's within EVAL_MAP_BAR of their largest magnitude (flip
    off at each canvas, flip on at the first); find_peaks_plane, K3 and K6
    against their plain versions on the CNN's maps and on the oracle's;
    (b) the GT-map oracle (ops.encoders at each canvas) through
    paf_decode_2d -> coco_eval_results -> run_coco_eval (the vendored
    scorer): the results JSON on the card equals the CPU's, AP over
    ORACLE_AP_BAR; find_peaks_plane and K2 at the four canvases and at
    46x70 and 46x82 (640x426 and 640x360 images, EVAL_CROP_ROWS), batch 1,
    and at 46x62 at ROUTE_BATCH frames, as CUDA-graph replays beside their
    bound and the launch floor (the route's premise, that find_peaks_plane
    is the faster wherever K1 cannot hold the maps, is required at each),
    find_peaks, find_peaks_plane and K2 exact against the plain version at
    each canvas at batch 1 and 2, and find_peaks_plane's stage clocks at
    the first; (c) `generate-augset --kind bgaug|mpaug --augment` on a
    KDH3D layout of 48 frames (write_train_set, write_mpaug_bank), on the
    card (its default: composite and transforms there) against --device
    cpu byte for byte, and `evaluate --model openpose` of the frozen
    mp-aug set on the card; (d) images/s of rgb_infer + decode at each
    canvas, flip off and on, float32 and bf16 CNN, the decode's ms,
    generate-augset frames/s on each route; the kernels' launches at each
    canvas (a "coco_eval" entry in each row); (e) a 2304x384 panorama
    (canvas 368x2208, maps 46x276: over 255 cells wide, where only
    find_peaks_plane, the third find_peaks kernel, takes them): rgb_infer
    + paf_decode_2d on the card with the launch counts reset just before
    and read just after, the decode against the host's, the kernels
    against their plain versions on the CNN's and the oracle's maps, the
    oracle's AP, and find_peaks_plane at batch 1 against its bound, with
    its stage clocks (its row of the kernels line takes these numbers and
    this path's launches; its times at the depth planes and (b)'s beside
    K2's stand beside them, (a)'s launches in its "coco_eval" entry).

14. tables: `cli.method_table` at a smoke budget (TABLE_SMOKE: 32
    training scenes, 8 frozen, 2 steps a row in two calls, the second a
    resume), all four rows trained and scored on the card, the launch
    counts reset just before and read just after; the validation and
    frozen trees' sha256 against the constant the CPU tests pin; every row
    done with its metrics in [0, 1]; then `cli.ablation_table`'s ablation
    of the committed Open-Pose+ weights on the frozen set, card against
    CPU (a "table_launches" entry in each row).

15. parallel: the layouts of popnet_tpu_torch/parallel on the one card
    (training launches no kernel): (a) PoP-Net's Trainer over a mesh of
    one rank (data=1, NCCL) against the plain Trainer, an epoch of 64
    frames at 224², batch 32, float32, TF32 off, cuDNN deterministic: the
    losses and parameters bit for bit; (b) data=2 over gloo, two processes
    both on cuda:0, 16 frames a rank, one step against world size 1 (loss
    rtol 1e-5, parameters 1e-5), or gloo's refusal recorded; (c) at group
    size 1 over NCCL: Open-Pose+'s step under model=1 = the plain step bit
    for bit, RTPoseLight3D's forward of 512x480 frames under spatial=1 =
    the plain forward bit for bit, the pipelined Open-Pose+ at pipe=1,
    n_micro=2 (224², batch 32) within 1e-5 of the sequential eval-mode
    model, its step's loss within rtol 1e-5 of the sequential one and the
    state after it within 1e-5 of the sequential step's; (d)
    `evaluate --spatial 1` of Open-Pose+ (--device-decode) and PoP-Net on
    phase 6's sets: each JSON = the plain evaluate's, the launches over
    the spatial runs counted (a "parallel_launches" entry in each row);
    (e) the data-parallel step's ms at world size 1 beside the plain
    step's, and (b)'s, with the card's name and power limit.

16. viz: the visualizers and the reference checkpoints (phase_viz): (a)
    the committed Open-Pose+ weights exported as a 'module.'-prefixed
    reference state dict (interop.torch_import) and imported into a fresh
    RTPoseLight3D on the card, one batch of 64 served through
    build_openpose_pipeline with cuDNN deterministic: the wire buffer equal
    to the committed weights' bit for bit, K1, K3 and K6 launched; (b)
    `visualize-pred` on phase 6's Open-Pose+ evaluate JSON and
    `visualize-gt` with seg maps, 64 frames each, on the card and with
    --device cpu: the files equal byte for byte, each the JPEG
    (encode_jpeg) of the frame drawn in the phase and within 20 dB PSNR of
    it, no kernel launched; (c) a ROIDataset batch of 8 made on the card
    against the CPU's; (d) visualize-pred's images/s, with the card's name
    and power limit.

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises and exits nonzero. Run
from the root of a checkout: python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
    "find_peaks_plane": ("popnet_tpu_torch/csrc/find_peaks.cu",
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
          "find_peaks_plane": ("load", "NMS", "top-M", "merge", "refine"),
          "paf_score": ("copies issued", "peaks", "load wait", "integrals", "fill"),
          "assemble_ids": ("load", "match", "merge", "pack")}
# the kernels that stamp each block's span on the global timer in stamp slots 6 and 7
SPANS = ("find_peaks", "find_peaks_row", "find_peaks_plane")


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


def _skeleton(rng: np.random.Generator, x: float, y_lo: float, y_hi: float) -> np.ndarray:
    """(15, 2) joints of the kinematic template (tests/synthetic_data.py
    person_scene's layout), its torso at x and a y drawn in [y_lo, y_hi)."""
    s = rng.uniform(0.85, 1.25)
    lean = rng.normal(0.0, 0.12)

    def rot(vx, vy, a):
        return np.array([vx * np.cos(a) - vy * np.sin(a), vx * np.sin(a) + vy * np.cos(a)])

    pts = np.zeros((15, 2))
    torso = np.array([x, rng.uniform(y_lo, y_hi)]) + rng.normal(0, 8, 2)
    neck = torso + rot(0, -62 * s, lean)
    pts[8], pts[1] = torso, neck
    pts[0] = neck + rot(0, -34 * s, lean + rng.normal(0, 0.1))
    for side, sh_i, el_i, wr_i, hip_i, kn_i, an_i in (
            (+1, 2, 4, 6, 9, 11, 13), (-1, 3, 5, 7, 10, 12, 14)):
        sh = neck + rot(side * 30 * s, 6 * s, lean)
        el = sh + rot(0, 42 * s, lean + rng.normal(0, 0.5))
        wr = el + rot(0, 40 * s, lean + rng.normal(0, 0.7))
        hip = torso + rot(side * 20 * s, 46 * s, lean)
        kn = hip + rot(0, 50 * s, lean + rng.normal(0, 0.25))
        an = kn + rot(0, 48 * s, lean + rng.normal(0, 0.25))
        for i, q in ((sh_i, sh), (el_i, el), (wr_i, wr), (hip_i, hip), (kn_i, kn), (an_i, an)):
            pts[i] = q
    return pts


def _draw_people(pts, z, present, device, H: int, W: int):
    """(B, H, W) depth: each present person's joints (B, N, 15, 2) drawn as
    36-px blocks at their depths z (B, N, 15), the later person over the
    earlier, on a zero background."""
    import torch

    pts_t = torch.as_tensor(pts, dtype=torch.float32, device=device)
    z_t = torch.as_tensor(z, dtype=torch.float32, device=device)
    pres_t = torch.as_tensor(present, device=device)
    ys = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    depth = torch.zeros((pts.shape[0], H, W), device=device)
    for p in range(pts.shape[1]):
        for k in range(15):
            m = ((xs - pts_t[:, p, k, 0, None, None]).abs() < 18) \
                & ((ys - pts_t[:, p, k, 1, None, None]).abs() < 18) \
                & pres_t[:, p, None, None]
            depth = torch.where(m, z_t[:, p, k, None, None], depth)
    return depth


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
    pts = np.stack([np.stack([_skeleton(rng, 110 + 130 * p, 190, 260) for p in range(n_people)])
                    for _ in range(B)])
    pts += rng.normal(0, 2.0, size=pts.shape)
    pts = np.clip(pts, 10, [W - 10, H - 10])
    present = np.arange(n_people)[None, :] < rng.integers(2, n_people + 1, size=B)[:, None]
    z = rng.uniform(2.5, 4.5, size=(B, n_people, 1)) + rng.normal(0, 0.05, size=(B, n_people, 15))
    depth = _draw_people(pts, z, present, device, H, W)
    if background:
        ys = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
        xs = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
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


# maps that K1 and K2 cannot take (a side over 255 cells, a plane over K2's CTA):
# find_peaks routes them to find_peaks_plane; and the COCO canvases, which it
# routes there too (the cases with band edges below, PLANE_EDGE_SHAPES)
PLANE_SHAPES = ((1, 18, 46, 256), (1, 1, 255, 255), (2, 3, 300, 300))
PLANE_EDGE_SHAPES = ((1, 18, 46, 62), (1, 18, 69, 46), (1, 18, 46, 276), (1, 1, 2048, 2048))


def plane_edges(B: int, K: int, H: int, W: int, M: int = 16) -> list[int]:
    """The rows where two of find_peaks_plane's bands meet at these sizes:
    the first row of every CTA's share of the rows but the first, and of
    every band after the first within a share
    (kernels.find_peaks_plane_config)."""
    from popnet_tpu_torch.ops import kernels

    cfg = kernels.find_peaks_plane_config(B, K, H, W, M)
    share = -(-H // cfg["cluster"])
    return [y for y0 in range(0, H, share)
            for y in range(y0, min(H, y0 + share), cfg["rows"]) if y > 0]


def band_edge_heat(rng, B: int, K: int, H: int, W: int, edges) -> np.ndarray:
    """(B, K, H, W) float32 heat under the threshold (uniform below 0.09)
    but at each of the rows `edges` where two bands meet: a peak on the
    row above, a peak on the row, a plateau of two equal cells across the
    edge, and a cell of 0.8, the same at every edge, so that equal values
    lie in different bands and CTAs. Their columns move along the edges;
    W >= 12."""
    heat = rng.uniform(0, 0.09, (B, K, H, W)).astype(np.float32)
    for j, y in enumerate(edges):
        x = 7 * j % (W - 11)
        heat[:, :, y - 1, x] = 0.5 + 0.001 * j
        heat[:, :, y, x + 3] = 0.6 + 0.001 * j
        heat[:, :, y - 1:y + 1, x + 6] = 0.7
        heat[:, :, y, x + 9] = 0.8
    return heat


def plane_cases(rng, dev) -> tuple[int, float]:
    """find_peaks_plane, the third find_peaks kernel, through find_peaks
    (one launch counted on it, none on K1 or K2) against the plain version,
    all five outputs bit for bit: at PLANE_SHAPES and PLANE_EDGE_SHAPES (one
    frame), planes of NCHW and NHWC memory and slices of larger maps; dense
    heat (a lattice of peaks and an exact tie, 32 kept), sparse heat, and
    at PLANE_EDGE_SHAPES peaks, plateaus and ties on the rows where bands
    meet (band_edge_heat; the 2048x2048 plane in bands taken in turn).
    Returns (cases, max |err| of the score)."""
    import torch

    from popnet_tpu_torch.ops import kernels

    n, err = 0, 0.0
    for B, K, H, W in PLANE_SHAPES + PLANE_EDGE_SHAPES:
        require(kernels.find_peaks_route(K, H, W, 16) == "find_peaks_plane",
                f"find_peaks_route at {(B, K, H, W)}")
        dense = rng.uniform(0, 1, (B, K + 1, H + 3, W + 4)).astype(np.float32)
        dense[0, 0, 1:H:5, 1:W:5] = 2.0 + rng.uniform(0, 1, dense[0, 0, 1:H:5, 1:W:5].shape)
        dense[0, 0, 7, 9] = dense[0, 0, H - 2, W - 1] = 4.0      # an exact tie
        sparse = np.zeros_like(dense)
        sparse[:, :, :H, :W] = sparse_heat(rng, B, K + 1, H, W)
        heats = [(dense, 32, (0, 0, 0)), (sparse, 16, (0, 0, 0))]
        if (B, K, H, W) in PLANE_EDGE_SHAPES:   # the edges where the views put them
            edge = np.zeros_like(dense)
            edge[:, 1:, 2:H + 2, 3:W + 3] = band_edge_heat(rng, B, K, H, W,
                                                           plane_edges(B, K, H, W))
            heats.append((edge, 32, (1, 2, 3)))
        for heat, M, (k0, y0, x0) in heats:
            t = torch.as_tensor(heat, device=dev)
            at = t[:, k0:k0 + K, y0:y0 + H, x0:x0 + W]
            for tag, h in (("NCHW", at.contiguous()),
                           ("NHWC", at.contiguous(memory_format=torch.channels_last)),
                           ("sliced", t[:, 1:, 2:H + 2, 3:W + 3])):
                kernels.reset_launches()
                got = kernels.find_peaks(h, max_peaks=M)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                require((counts["find_peaks_plane"], counts["find_peaks"],
                         counts["find_peaks_row"]) == (1, 0, 0),
                        f"find_peaks at {(B, K, H, W)} launched {counts}")
                ref = kernels.find_peaks_plain(h, max_peaks=M)
                for i, name in enumerate(PEAK_OUTPUTS):
                    _exact(f"find_peaks_plane {name}, {(B, K, H, W)}, {tag}, M={M}", got[i],
                           ref[i])
                err = max(err, _maxerr(got[3], ref[3]))
                n += 1
            if heat is not sparse:
                require(int(got[4].sum(-1).max()) == 32,
                        f"find_peaks_plane at {(B, K, H, W)}: a plane keeps 32 peaks")
    return n, err


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
    if name in ("find_peaks", "find_peaks_row", "find_peaks_plane"):  # one function, 3 designs
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


def time_stream(tag: str, pipe, frames, iters: int, check, wire: str = "q16",
                warm: int = 3) -> float:
    """frames/s of `pipe` through serve_stream(queue_depth=3), after a warm
    window of `warm` batches whose first goes to `check`; returns it."""
    import torch

    from popnet_tpu_torch import serve_stream

    warm = list(serve_stream(pipe, (frames for _ in range(warm)), queue_depth=3))
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
    return n / wall


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
        for a, b, n in zip(kernels.find_peaks_plane(h), kernels.find_peaks(h), PEAK_OUTPUTS):
            _exact(f"find_peaks_plane {n} against find_peaks on the main path's planes", a, b)
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
            # at the depth planes beside K1 and K2; its own path's maps are phase 13 (e)'s
            "find_peaks_plane": (lambda: kernels.find_peaks_plane(h),
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
        stage_breakdown("find_peaks_plane", lambda: kernels.find_peaks_plane(h),
                        ms["find_peaks_plane"], tag="at the depth planes, ")
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
        for a, b, n in zip(kernels.find_peaks_plane(h), kernels.find_peaks(h), PEAK_OUTPUTS):
            _exact(f"find_peaks_plane {n} against find_peaks on the main path's planes", a, b)
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


def check_a2j_bf16(q16: dict, f32: dict, bars: tuple = (0.80, 0.10), what: str = "bf16") -> None:
    """The timed Yolo->A2J configuration against the float32 slice on the
    same frames: the flags are the detector's, so people per frame equal on
    at least 80% of the frames and people in all within 10% (as
    check_bf16); every value finite. The joints come from an A2J init and
    are not compared."""
    cq, cf = (o["counts"].astype(int).sum(axis=1) for o in (q16, f32))
    same = float((cq == cf).mean())
    frac, rel = bars
    say("timing", f"Yolo->A2J {what}+q16 vs f32 on the same {len(cf)} frames: people per frame "
        f"equal on {same:.1%} (bar {frac:.0%}), people {cq.sum()} vs {cf.sum()} (bar {rel:.0%})")
    require(bool(np.isfinite(q16["joints3d"]).all()), "non-finite values in the q16 output")
    require(same >= frac, f"{what} and f32 person counts differ on too many frames")
    require(abs(int(cq.sum()) - int(cf.sum())) <= rel * cf.sum(),
            f"{what} people differ by over {rel:.0%}")


def check_coco_bf16(b16: dict, f32: dict, rel: float = 0.10, what: str = "bf16") -> None:
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
    say("timing", f"COCO RGB {what}+f32 vs f32 on the same {len(cf)} frames: people per frame "
        f"equal on {float((cq == cf).mean()):.1%} (within one on "
        f"{float((np.abs(cq - cf) <= 1).mean()):.1%}; no bar), people {cq.sum()} vs "
        f"{cf.sum()}, visible joints {vq} vs {vf} (bar {rel:.0%})")
    require(bool(np.isfinite(b16["joints2d"]).all()), "non-finite values in the f32 output")
    require(abs(int(cq.sum()) - int(cf.sum())) <= rel * cf.sum(),
            f"{what} people differ by over {rel:.0%}")
    require(abs(vq - vf) <= rel * vf, f"{what} visible joints differ by over {rel:.0%}")


def check_bf16(tag: str, q16: dict, f32: dict, bars: tuple = (0.80, 0.10),
               what: str = "bf16") -> None:
    """The timed configuration (bf16 CNN, q16 wire) against the float32
    slice on the same frames: people per frame equal on at least 80% of the
    frames, and people and visible joints in all within 10% (bars wide of
    bf16's rounding, tight enough to catch a broken bf16 path; phase 10's
    int8 paths pass their own `bars`). Open-Pose+
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
    frac, rel = bars
    say("timing", f"{tag} {what}+q16 vs f32 on the same {len(cf)} frames: people per frame "
        f"equal on {same:.1%} (bar {frac:.0%}), people {cq.sum()} vs {cf.sum()}, visible "
        f"joints {vq} vs {vf} (bar {rel:.0%})")
    require(bool(np.isfinite(q16["joints3d"]).all()), "non-finite values in the q16 output")
    require(same >= frac, f"{what} and f32 person counts differ on too many frames")
    require(abs(int(cq.sum()) - int(cf.sum())) <= rel * cf.sum(),
            f"{what} people differ by over {rel:.0%}")
    require(abs(vq - vf) <= rel * vf, f"{what} visible joints differ by over {rel:.0%}")


def write_eval_set(root: str, frames, people: dict, labels_name: str = "labels.json",
                   first: int = 0, seg: bool = False, prefix: str = "frame") -> tuple[str, str]:
    """Write (B, H, W) depth frames as root/depth_maps/<prefix>_<first + b>.npy
    and their people as root/<labels_name> in the MP-3DHP label format: per
    frame a list of {"2d_joints", "3d_joints" (back-projected with the KDH3D
    camera), "bbox" (the joints' box with a 20 px margin)}, and the camera
    under "intrinsics"; with `seg`, each frame's people mask (depth > 0,
    uint8) as root/seg_maps/<the same name>. Returns (image directory,
    label path)."""
    from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS as cam, back_project_np

    img_dir = os.path.join(root, "depth_maps")
    os.makedirs(img_dir, exist_ok=True)
    if seg:
        os.makedirs(os.path.join(root, "seg_maps"), exist_ok=True)
    labels = {"intrinsics": {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy}}
    host = frames.cpu().numpy()
    for b in range(host.shape[0]):
        name = f"{prefix}_{first + b:04d}.npy"
        np.save(os.path.join(img_dir, name), host[b])
        if seg:
            np.save(os.path.join(root, "seg_maps", name), (host[b] > 0).astype(np.uint8))
        anns = []
        for p in np.flatnonzero(people["present"][b]):
            j2, z = people["joints2d"][b, p], people["z"][b, p]
            anns.append({"2d_joints": j2.tolist(),
                         "3d_joints": back_project_np(j2[:, 0], j2[:, 1], z, cam).tolist(),
                         "bbox": [float(j2[:, 0].min() - 20), float(j2[:, 1].min() - 20),
                                  float(j2[:, 0].max() + 20), float(j2[:, 1].max() + 20)]})
        labels[name] = anns
    path = os.path.join(root, labels_name)
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


def eval_family(tag: str, model: str, opts: dict, paths, dev, batch: int, weights: dict,
                ckpts: dict | None = None, dcfg=None):
    """One family's driver (cli.main.run_evaluation) on the card with the
    committed weights (A2J from its seeded init) or the port's checkpoint
    directories `ckpts` ({model: dir, "yolo_for_a2j": dir}), then on the host with the
    same CNN outputs, through the plain versions of the kernels; the frames
    at `dcfg`'s geometry (KDH3D's by default). Returns
    (card JSON, host JSON, timing {seconds: the card run, cnn_seconds,
    data_seconds: get_batch, load_seconds: the .npy loads of get_batch and
    of A2J's frames, host_seconds: the host run}, the host's A2J vote inputs
    or None)."""
    import torch

    from popnet_tpu_torch.cli.main import make_infers, run_evaluation
    from popnet_tpu_torch.data.datasets import MPRealDataset

    ckpts = ckpts or {}
    infer, infer_yolo = make_infers(model, weights.get(model), weights.get("yolo_for_a2j"),
                                    seed=A2J_SEED, device=dev, ckpt=ckpts.get(model),
                                    yolo_ckpt=ckpts.get("yolo_for_a2j"))
    rec = Recorder(infer, f"{tag} {'crops' if model == 'a2j' else 'images'}")
    rec_yolo = Recorder(infer_yolo, f"{tag} detector images") if infer_yolo else None
    from popnet_tpu_torch.core.config import KDH3D_DATASET

    dcfg = dcfg or KDH3D_DATASET
    ds = MPRealDataset(*paths, dcfg=dcfg, device=dev)
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
    host_ds = MPRealDataset(*paths, dcfg=dcfg, device="cpu")
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


def painted_oracle(paths, dev, batch: int, device_decode: bool,
                   fast: bool = True) -> tuple[dict, dict]:
    """The painted Open-Pose+ oracle (openpose_painted_maps from the set's
    labels) fed to run_openpose_eval on `dev` (with `fast=False`, the exact
    host decode): (metrics, ablation channels)."""
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

    data = ev.run_openpose_eval(infer, ds, batch, device_decode=device_decode, fast=fast)
    return ev.evaluate_eval_data(data, verbose=False), ev.evaluate_ablation_channels(data)


def phase_eval(rng, dev, n: int = 256, batch: int = 64, keep: str | None = None) -> dict:
    """The MP-3DHP evaluation drivers on the card (the port's eval path):
    two labelled sets of n frames, each family's driver with the committed
    weights (A2J seeded) at `batch`, float32 CNNs; the same CNN outputs
    through the drivers on the host (plain versions), JSON equal (A2J within
    the vote's bar) and metrics equal; the batched metrics on the card
    against NumPy's; the painted Open-Pose+ oracle over its bars; the
    `evaluate` and `benchmark` subcommands once. Returns the eval path's
    launch counts; with `keep`, the "bg" and "zero" sets are copied to
    keep/eval_bg (phase 9 evaluates A2J on it) and keep/eval_zero (phase
    15's evaluate --spatial, phase 16's visualizers), and the Open-Pose+
    evaluate JSON of the latter to keep/openpose_results.json (phase 16's
    visualize-pred)."""
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
        if keep is not None:
            shutil.copytree(os.path.dirname(sets["bg"][0]), os.path.join(keep, "eval_bg"))
            shutil.copytree(os.path.dirname(sets["zero"][0]), os.path.join(keep, "eval_zero"))
            shutil.copy(os.path.join(out, "openpose_results.json"), keep)
    return launches


# -- phase 7: training ----------------------------------------------------------------------

TRAIN_FRAMES = 256          # frames of the training set (512x480, 2-3 people each)
VAL_FRAMES = 64             # frames of the validation set
TRAIN_BATCH = 32            # the command line's batch
TRAIN_INPUT = 224           # the network input, the command line's
STEP_BATCH = 8              # the card-against-CPU step check's batch
TRAIN_LR = 0.05             # the JAX step test's rate (the command line's 1.0 is the CPM recipe's)
N_BACKGROUNDS = 8
TRAIN_FAMILIES = ("openpose", "popnet", "yolo")
TRAIN_TARGETS = {"openpose": (False, False), "popnet": (True, True), "yolo": (False, True)}
TRAIN_WEIGHTS = {"openpose": WEIGHTS, "popnet": WEIGHTS_POPNET, "yolo": WEIGHTS_YOLO}
TARGETS_EXACT = ("image", "zmaps", "fg_masks_z", "fg_masks_align", "prior_mask_conf",
                 "prior_mask_coord", "prior_weight_map")
TARGETS_BAR = 2e-6          # heat, PAF, align and prior maps (torch.exp differs by device)
STEP_BARS = {"loss": 1e-5, "update": 1e-3, "stats": 1e-5}
ZERO_UPDATE = 1e-6          # float64: a zero gradient's update, over the largest update
UPDATE_FLOOR = 1e-6         # the least scale a tensor's update error is measured against
F32_GAP_FACTOR = 4.0        # card's float32-vs-float64 update gap over the CPU's, at most
                            # (read 1.0-1.14 on 8 frames, 2.45 on 4; a channels-last pool 658)
LOOP_EPOCHS = 3             # epochs of the timed Trainer loop and input pipeline
CKPT_EVAL = (("openpose", []), ("openpose", ["--device-decode"]), ("popnet", []),
             ("yolo", []))


def write_train_set(rng, dev, root: str, n_train: int, n_val: int) -> None:
    """A KDH3D-format training set under root (the layout of
    tests/synthetic_data.build): person_frames' people on a zero background
    as depth_maps/*.npy, their masks as seg_maps/*.npy, N_BACKGROUNDS smooth
    2.5-5.5 m backgrounds as bg_maps/*.npy with labels_bg.json, the first
    n_train frames' people in labels.json and the next n_val's in
    labels_val.json."""
    frames, people = person_frames(rng, n_train + n_val, dev, people=True)
    for name, lo, hi in (("labels.json", 0, n_train), ("labels_val.json", n_train,
                                                      n_train + n_val)):
        write_eval_set(root, frames[lo:hi], {k: v[lo:hi] for k, v in people.items()},
                       labels_name=name, first=lo, seg=True)
    os.makedirs(os.path.join(root, "bg_maps"), exist_ok=True)
    ys, xs = np.mgrid[0:frames.shape[1], 0:frames.shape[2]]
    index = {}
    for i in range(N_BACKGROUNDS):
        name = f"bg_{i:03d}.npy"
        bg = (4.0 + 1.5 * np.sin(xs / 60.0 + rng.uniform(0, 2 * np.pi)) * np.cos(ys / 80.0))
        np.save(os.path.join(root, "bg_maps", name), bg.astype(np.float32))
        index[str(i)] = {"file_name": name}
    with open(os.path.join(root, "labels_bg.json"), "w") as f:
        json.dump(index, f)


def train_dataset(root: str, family: str, dev, labels: str = "labels.json",
                  transfer: str = "f32", augment: bool = True):
    from popnet_tpu_torch.core.config import EncoderConfig
    from popnet_tpu_torch.data.datasets import KDH3DDataset

    align, prior = TRAIN_TARGETS[family]
    return KDH3DDataset(os.path.join(root, "depth_maps"), os.path.join(root, labels),
                        ecfg=EncoderConfig(input_x=TRAIN_INPUT, input_y=TRAIN_INPUT),
                        bg_aug=True, bg_file=os.path.join(root, "labels_bg.json"),
                        bg_dir=os.path.join(root, "bg_maps"),
                        seg_dir=os.path.join(root, "seg_maps"), pose_align=align,
                        with_prior=prior, augment=augment, seed=0, transfer=transfer,
                        device=dev)


def compare_batches(tag: str, card: dict, host: dict) -> float:
    """A training batch made on the card against the CPU's from the same
    seed: the image and the masks and z-maps equal, the other maps within
    TARGETS_BAR. Returns the largest error of those."""
    import torch

    require(set(card) == set(host), f"{tag}: the batches' keys differ")
    worst = 0.0
    for k, h in host.items():
        c = card[k].cpu()
        require(c.shape == h.shape and c.dtype == h.dtype, f"{tag} {k}: shape or type differs")
        if k in TARGETS_EXACT:
            require(bool(torch.equal(c, h)), f"{tag} {k}: card and CPU differ")
        else:
            err = _maxerr(c, h)
            require(err <= TARGETS_BAR, f"{tag} {k}: card and CPU {err:.3g} apart (bar "
                    f"{TARGETS_BAR})")
            worst = max(worst, err)
    return worst


def one_step(family: str, batch: dict, dev, dtype, pred_vis: bool = False):
    """One SGD-Nesterov step (TRAIN_LR) of the family from the committed
    weights on `batch`, on `dev` in `dtype` with TF32 off and cuDNN
    deterministic: (loss, state dict before, state dict after, the names of
    the conv biases that feed a BatchNorm, whose gradient is zero in exact
    arithmetic), the tensors on the CPU. With `pred_vis` (PoP-Net), the
    130-channel prior head, which no committed weights fit, starts from
    normal(0, 0.01) drawn from a generator seeded with 0."""
    import torch

    from popnet_tpu_torch.interop.from_jax import load_npz, state_dict_from_jax
    from popnet_tpu_torch.models import PopNet, RTPoseLight3D, YoloPoseNet
    from popnet_tpu_torch.models.layers import ConvBN
    from popnet_tpu_torch.train import steps
    from popnet_tpu_torch.train.state import TrainState, make_optimizer

    if family == "a2j":
        return a2j_one_step(batch, dev, dtype)
    if family in ("rtpose_vgg", "popnet_rgb"):
        return rgb_one_step(family, batch, dev, dtype)
    if pred_vis:
        model = PopNet(pred_vis=True)
        step = steps.make_popnet_train_step(pred_vis=True)
    else:
        model = {"openpose": RTPoseLight3D, "popnet": PopNet, "yolo": YoloPoseNet}[family]()
        step = {"openpose": steps.make_rtpose_train_step, "popnet": steps.make_popnet_train_step,
                "yolo": steps.make_yolo_train_step}[family]()
    sd = state_dict_from_jax(load_npz(TRAIN_WEIGHTS[family]))
    if pred_vis:
        w = model.prior_out.weight
        sd["prior_out.weight"] = torch.empty_like(w).normal_(
            0.0, 0.01, generator=torch.Generator().manual_seed(0))
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    require(want == set(sd), f"{family}: the committed weights do not fit the model")
    model.load_state_dict(sd, strict=False)
    model = model.to(dev, dtype)
    zero = {f"{n}.Conv_0.bias" for n, m in model.named_modules()
            if isinstance(m, ConvBN) and m.norm and m.Conv_0.bias is not None}
    state = TrainState(model, make_optimizer(model, "sgd", TRAIN_LR))
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    b = {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev)) for k, v in batch.items()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False, deterministic=True):
        state, logs = step(state, b)
    after = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return float(logs["loss"]), before, after, zero


def step_errors(a, b) -> dict:
    """Card step `a` against CPU step `b` (`one_step`'s tuples): the loss's
    relative error; the largest per-tensor update error over the CPU's
    largest update of that tensor, floored at UPDATE_FLOOR of the largest
    update of any tensor (a tensor whose gradient nearly vanishes carries
    the float64 rounding of the others at its own scale), with the tensor
    it falls on; the whole update's relative norm error; the running
    statistics' relative error; and how far the tensors with zero
    gradients moved, over the CPU's largest update of any tensor."""
    out = {"loss": abs(a[0] - b[0]) / abs(b[0]), "update": 0.0, "stats": 0.0, "zero": 0.0,
           "worst": ""}
    deltas = {}
    for name, after in b[2].items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = a[2][name].double(), after.double()
        if name.endswith(("running_mean", "running_var")):
            rel = ((got - ref).abs() / (ref.abs() + 1e-12)).max()
            out["stats"] = max(out["stats"], float(rel))
            continue
        start = b[1][name].double()
        deltas[name] = (got - start, ref - start)
    top = max(float(dj.abs().max()) for n, (_, dj) in deltas.items() if n not in b[3])
    num = den = 0.0
    for name, (dp, dj) in deltas.items():
        if name in b[3]:
            out["zero"] = max(out["zero"], float(dp.abs().max()) / top,
                              float(dj.abs().max()) / top)
            continue
        num += float(((dp - dj) ** 2).sum())
        den += float((dj ** 2).sum())
        scale = max(float(dj.abs().max()), UPDATE_FLOOR * top)
        err = float((dp - dj).abs().max()) / scale
        if err >= out["update"]:
            out["update"], out["worst"] = err, f"{name} (its update {scale / top:.3g} of the top)"
    out["norm"] = (num / den) ** 0.5
    return out


def train_step_checks(tag: str, family: str, batch_card: dict, batch_host: dict, dev,
                      pred_vis: bool = False) -> None:
    """(b): one step from the committed weights (A2J: its seeded init and
    the recipe's Adam-L2, `a2j_one_step`) on STEP_BATCH frames, card
    against CPU. float64 on both: the step bars (loss 1e-5, each tensor's
    update within 1e-3 of the CPU's largest, floored at 1e-6 of the largest
    of any tensor, `step_errors`; BatchNorm statistics 1e-5; the conv
    biases ahead of a BatchNorm, whose gradient is zero in exact
    arithmetic, move by under ZERO_UPDATE of the largest update). float32
    with TF32 off: the loss within the bar, and each device's float32 step
    set against its own float64 step: the card's whole-update norm gap at
    most F32_GAP_FACTOR times the CPU's, so that a fault of the card's
    float32 backward (TF32, a less exact convolution algorithm) cannot
    hide behind the float32 step's own sensitivity to rounding."""
    import torch

    t0 = time.perf_counter()
    steps = {}
    for dtype in (torch.float64, torch.float32):
        card = steps["card", dtype] = one_step(family, batch_card, dev, dtype, pred_vis)
        host = steps["cpu", dtype] = one_step(family, batch_host, "cpu", dtype, pred_vis)
        e = step_errors(card, host)
        name = str(dtype).split(".")[1]
        n = len(next(iter(batch_host.values())))
        init = {"a2j": "seeded init, Adam-L2", "rtpose_vgg": "seeded init",
                "popnet_rgb": "seeded init"}.get(family, "committed weights")
        say("train", f"{tag} step check, {name}, card vs CPU ({n} frames, "
            f"{init}, TF32 off, cuDNN deterministic): loss {card[0]:.6f} vs {host[0]:.6f} "
            f"(rel {e['loss']:.3g}), max per-tensor update error {e['update']:.3g} of the "
            f"tensor's largest update ({e['worst']}), whole-update norm {e['norm']:.3g}, "
            f"BatchNorm statistics rel {e['stats']:.3g}; the {len(host[3])} conv biases ahead of a "
            f"BatchNorm moved up to {e['zero']:.3g} of the largest update")
        require(e["loss"] <= STEP_BARS["loss"], f"{tag} {name}: the loss misses its bar")
        if dtype == torch.float64:
            require(e["update"] <= STEP_BARS["update"] and e["stats"] <= STEP_BARS["stats"]
                    and e["zero"] < ZERO_UPDATE, f"{tag} float64: the step misses its bars")
    gap = {where: step_errors(steps[where, torch.float32], steps[where, torch.float64])
           for where in ("card", "cpu")}
    say("train", f"{tag} float32 step against the same device's float64 step: " + "; ".join(
        f"{where} loss rel {g['loss']:.3g}, whole-update norm {g['norm']:.3g}, max per-tensor "
        f"update error {g['update']:.3g} ({g['worst']}), BatchNorm statistics rel "
        f"{g['stats']:.3g}" for where, g in gap.items())
        + f"; card's norm gap over the CPU's {gap['card']['norm'] / gap['cpu']['norm']:.3g} "
        f"(bar {F32_GAP_FACTOR})")
    require(gap["card"]["norm"] <= F32_GAP_FACTOR * gap["cpu"]["norm"],
            f"{tag} float32: the card's step is further from float64 than the CPU's allows")
    say("train", f"{tag} step checks in {time.perf_counter() - t0:.1f} s")


def time_input(ds, batch: int) -> tuple[float, float]:
    """(input pipeline alone, host stage alone) in frames/s: a warm pass of
    iter_batches, then LOOP_EPOCHS timed ones that wait for each batch on
    the card (as bench_train.py measures it), then get_batch_host alone
    over as many passes."""
    import torch

    for _ in ds.iter_batches(batch):
        pass
    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 0
    for _ in range(LOOP_EPOCHS):
        for b in ds.iter_batches(batch):
            torch.cuda.synchronize()
            n += b["image"].shape[0]
    pipe = n / (time.perf_counter() - t0)
    order = np.arange(len(ds))
    t0, nh = time.perf_counter(), 0
    for _ in range(LOOP_EPOCHS):
        for s in range(0, len(ds) - batch + 1, batch):
            ds.get_batch_host(order[s:s + batch])
            nh += batch
    return pipe, nh / (time.perf_counter() - t0)


def time_loop(trainer, ds, batch: int) -> float:
    """e2e train frames/s of LOOP_EPOCHS more epochs of the Trainer's own
    loop (`train_epoch`) on ds, host clock, TF32 off as `train` runs it;
    each epoch's pipeline fill is in the window, as it is in every epoch of
    a run."""
    import torch

    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for _ in range(LOOP_EPOCHS):
            trainer.train_epoch(ds, batch)     # reads its losses at its end
    return LOOP_EPOCHS * (len(ds) // batch) * batch / (time.perf_counter() - t0)


def phase_train(rng, dev, keep: str | None = None) -> dict:
    """Phase 7, the training path of the three depth families (see the
    module docstring). Returns {"train": launches of the training runs,
    "ckpt_eval": launches of evaluate --ckpt}; with `keep`, the Yolo-Pose+
    run's checkpoint is copied to keep/yolo_ckpt (phase 9's detector)."""
    import tempfile

    import torch

    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.models import PopNet, RTPoseLight3D, YoloPoseNet
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.train import checkpoint
    from popnet_tpu_torch.train.state import TrainState, make_optimizer
    from popnet_tpu_torch.train.steps import (make_popnet_train_step, make_rtpose_train_step,
                                              make_yolo_train_step)

    cls = {"openpose": RTPoseLight3D, "popnet": PopNet, "yolo": YoloPoseNet}
    mk_step = {"openpose": make_rtpose_train_step, "popnet": make_popnet_train_step,
               "yolo": make_yolo_train_step}
    launches = {"train": {k.__name__: 0 for k in kernels.KERNELS}}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_train_set(rng, dev, root, TRAIN_FRAMES, VAL_FRAMES)
        say("train", f"wrote a KDH3D-format set of {TRAIN_FRAMES} training and {VAL_FRAMES} "
            f"validation frames (depth, masks, {N_BACKGROUNDS} backgrounds) in "
            f"{time.perf_counter() - t0:.1f} s")
        shared_prior_check(dev)
        cli = ["--data-root", root, "--device", str(dev), "--input-size", str(TRAIN_INPUT),
               "--bg-aug",
               "--batch-size", str(TRAIN_BATCH),
               "--val-labels", "labels_val.json", "--lr", str(TRAIN_LR)]
        for family in TRAIN_FAMILIES:
            tag = f"{family}:"
            # (a) the batch on the card against the CPU's
            t0 = time.perf_counter()
            idx = np.arange(TRAIN_BATCH)
            for transfer in ("f32", "u16mm"):
                card = train_dataset(root, family, dev, transfer=transfer).get_batch(idx)
                host = train_dataset(root, family, "cpu", transfer=transfer).get_batch(idx)
                err = compare_batches(f"{tag} {transfer} batch", card, host)
            say("train", f"{tag} (a) a batch of {TRAIN_BATCH} made on the card equals the CPU's "
                f"(f32 and u16mm transfer, bg_aug, augmented): image, z-maps and masks bit for "
                f"bit, other maps within {err:.3g} (bar {TARGETS_BAR}); "
                f"{time.perf_counter() - t0:.1f} s")
            # (b) one step, card against CPU
            sub = lambda b: {k: v[:STEP_BATCH] for k, v in b.items()}
            train_step_checks(tag, family, sub(card), sub(host), dev)

            # (c) the command line, 2 epochs
            out = os.path.join(root, f"run_{family}")
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = cli_main(["train", "--model", family, "--out-dir", out, "--epochs", "2",
                                *cli])
            wall = time.perf_counter() - t0
            mem = torch.cuda.max_memory_allocated() / 2**20
            hist = trainer.history
            require(len(hist) == 2 and all(np.isfinite([h["train_loss"], h["val_loss"]]).all()
                                           for h in hist), f"{tag} non-finite losses")
            for d in ("ckpt", "ckpt_best"):
                require(bool(checkpoint.checkpoint_steps(os.path.join(out, d))),
                        f"{tag} no {d}/")
            require(os.path.exists(os.path.join(out, "history.jsonl")), f"{tag} no history")
            ds = train_dataset(root, family, dev)
            loop_fps = time_loop(trainer, ds, TRAIN_BATCH)
            for k, v in kernels.launch_counts().items():
                launches["train"][k] += v
            pipe_fps, host_fps = time_input(ds, TRAIN_BATCH)
            batch = ds.get_batch(idx)
            state, step = trainer.state, mk_step[family]()
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                step_ms = time_ms(lambda: step(state, batch), reps=10, warm=2)
            e2e = TRAIN_FRAMES // TRAIN_BATCH * TRAIN_BATCH / hist[1]["train_seconds"]
            say("train", f"{tag} (c) train --bg-aug --batch-size {TRAIN_BATCH} --epochs 2 "
                f"(float32, TF32 off): losses " + ", ".join(
                    f"epoch {h['epoch']} train {h['train_loss']:.5f} val {h['val_loss']:.5f}"
                    for h in hist)
                + f"; e2e train {e2e:.1f} frames/s over epoch 1 (host clock, the whole loop, "
                f"{TRAIN_FRAMES // TRAIN_BATCH} steps with the pipeline's fill; "
                f"{hist[1]['train_seconds']:.3f} s), {loop_fps:.1f} frames/s over "
                f"{LOOP_EPOCHS} further epochs of the Trainer's loop; input pipeline alone "
                f"{pipe_fps:.1f} frames/s, host stage alone {host_fps:.1f} frames/s (over "
                f"{LOOP_EPOCHS} epochs); step {step_ms:.3f} ms at "
                f"batch {TRAIN_BATCH} (CUDA events, TF32 off) = "
                f"{TRAIN_BATCH / step_ms * 1e3:.1f} frames/s; max_memory_allocated "
                f"{mem:.1f} MiB; the command {wall:.1f} s; kernels launched: "
                f"{sum(kernels.launch_counts().values())}")
            # (d) the loss falls over 5 steps on a fixed batch
            model = cls[family]().init_seeded(1).to(dev)
            st = TrainState(model, make_optimizer(model, "sgd", TRAIN_LR))
            losses = []
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                for _ in range(5):
                    st, logs = step(st, batch)
                    losses.append(float(logs["loss"]))
            require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
                    f"{tag} the loss does not fall over 5 steps: {losses}")
            say("train", f"{tag} (d) 5 steps on one batch from a seeded init: loss "
                + " -> ".join(f"{x:.5f}" for x in losses))
            # (e) 1 epoch + --resume 1 epoch against 2 epochs in one call
            t0 = time.perf_counter()
            runs = {}
            with torch.backends.cudnn.flags(enabled=True, deterministic=True):
                for name, calls in (("whole", [["--epochs", "2"]]),
                                    ("resumed", [["--epochs", "1"], ["--epochs", "1",
                                                                     "--resume"]])):
                    d = os.path.join(root, f"det_{family}_{name}")
                    for extra in calls:
                        kernels.reset_launches()
                        cli_main(["train", "--model", family, "--out-dir", d, *extra, *cli])
                        for k, v in kernels.launch_counts().items():
                            launches["train"][k] += v
                    runs[name] = d
            a, _, sa = checkpoint.restore_checkpoint(os.path.join(runs["whole"], "ckpt"))
            b, _, sb = checkpoint.restore_checkpoint(os.path.join(runs["resumed"], "ckpt"))
            same = sa == sb == 1 and all(torch.equal(v, b["model"][k])
                                         for k, v in a["model"].items())
            same = same and all(torch.equal(s["momentum_buffer"],
                                            b["optimizer"]["state"][i]["momentum_buffer"])
                                for i, s in a["optimizer"]["state"].items())
            hists = [[{k: v for k, v in json.loads(x).items() if k != "train_seconds"}
                      for x in open(os.path.join(runs[n], "history.jsonl"))]
                     for n in ("whole", "resumed")]
            require(same and hists[0] == hists[1],
                    f"{tag} 1 epoch + --resume 1 epoch differs from 2 epochs in one call")
            say("train", f"{tag} (e) 1 epoch + --resume 1 epoch equals 2 epochs in one call "
                f"bit for bit (parameters, BatchNorm statistics, momentum buffers, history; "
                f"cuDNN deterministic, TF32 off) in {time.perf_counter() - t0:.1f} s")

        # (f) evaluate --ckpt on the checkpoints of (c)
        t0 = time.perf_counter()
        kernels.reset_launches()
        for family, extra in CKPT_EVAL:
            ev_out = os.path.join(root, f"eval_{family}{'_dd' if extra else ''}")
            m = cli_main(["evaluate", "--model", family, "--data-root", root, "--labels",
                          "labels_val.json", "--ckpt", os.path.join(root, f"run_{family}", "ckpt"),
                          "--out-dir", ev_out, "--batch-size", str(VAL_FRAMES),
                          "--input-size", str(TRAIN_INPUT), "--device", str(dev), *extra])
            require(os.path.exists(os.path.join(ev_out, f"{family}_results.json")),
                    f"evaluate --ckpt {family}: no JSON")
            say("train", f"(f) evaluate --model {' '.join([family, *extra])} --ckpt "
                f"run_{family}/ckpt on the {VAL_FRAMES} validation frames: "
                + json.dumps({k: m[k] for k in ("pck2d", "pck3d", "map2d", "map3d")}))
        torch.cuda.synchronize()
        launches["ckpt_eval"] = kernels.launch_counts()
        fused = kernels.readouts.launches
        say("train", f"(f) evaluate --ckpt launches per kernel: {launches['ckpt_eval']}; of "
            f"them, readouts (K4 and K5 together): {fused}; {time.perf_counter() - t0:.1f} s")
        for name in EVAL_PATH:
            require(launches["ckpt_eval"][name] >= 1, f"evaluate --ckpt did not launch {name}")
        require(fused >= 1, "evaluate --ckpt did not launch the fused readouts")
        if keep is not None:
            shutil.copytree(os.path.join(root, "run_yolo", "ckpt"), os.path.join(keep, "yolo_ckpt"))
    say("train", f"training path launches per kernel: {launches['train']} (none expected)")
    require(not any(launches["train"].values()), "the training path launched a kernel")
    return launches


def shared_prior_check(dev) -> None:
    """The prior encoder's "last person wins" on the card: TRAIN_BATCH frames
    of 8 people at 224², where in every frame people 2 and 6 fall in one
    (cell, anchor) of the 14x14 grid, with an invalid person (4) between
    them and random people around (some of whom may land in the cell too,
    earlier). Encoded on the card and on the CPU: the targets agree
    (compare_batches' bars), and at the shared cell person 6's target and
    pose weight stand."""
    import torch

    from popnet_tpu_torch.core.config import KDH3D_DEPTH, EncoderConfig
    from popnet_tpu_torch.ops.encoders import encode_targets

    B, P = TRAIN_BATCH, 8
    r = np.random.default_rng(11)
    j2 = r.uniform(-10, 234, (B, P, 15, 2)).astype(np.float32)
    z = r.uniform(1, 6, (B, P, 15)).astype(np.float32)
    j3 = np.stack([j2[..., 0] / 500 * z, j2[..., 1] / 500 * z, z], -1).astype(np.float32)
    bb = np.concatenate([j2.min(2), j2.max(2)], -1).astype(np.float32)
    bb[:, 2] = [80.0, 44.0, 120.0, 124.0]        # centre (100, 84): cell (5, 6), first anchor
    bb[:, 6] = [80.0, 48.0, 116.0, 124.0]        # centre (98, 86): the same (cell, anchor)
    pw = r.uniform(0.5, 2.0, (B, P)).astype(np.float32)
    valid = np.ones((B, P), bool)
    valid[:, 4] = valid[:, 7] = False
    dr = r.uniform(0, 6, (B, 28, 28)).astype(np.float32)
    ecfg = EncoderConfig()
    out = {}
    for where in (dev, "cpu"):
        t = [torch.as_tensor(a, device=where) for a in (j2, j3, bb, pw, valid, dr)]
        out[where] = encode_targets(*t, ecfg, KDH3D_DEPTH)
    err = compare_batches("shared prior cell", out[dev], out["cpu"])
    card = {k: v.cpu() for k, v in out[dev].items()}
    prior = card["prior_map"].reshape(B, 14, 14, 2, -1)
    require(bool((card["prior_weight_map"][:, 5, 6] == torch.from_numpy(pw[:, 6])[:, None]).all())
            and bool((prior[:, 5, 6, 0, 0] == 0.125).all())
            and bool((card["prior_mask_coord"][:, 5, 6, 0] == 1.0).all()),
            "the later person does not win the shared prior cell")
    say("train", f"prior encoder, {B} frames with two valid people in one (cell, anchor): the "
        f"later one's target and pose weight stand on the card, and card and CPU agree "
        f"(maps within {err:.3g})")


# -- phase 8: mp-aug training -------------------------------------------------------------

MPAUG_CENTRES = ((140.0, 256.0), (340.0, 256.0), (140.0, 380.0), (340.0, 380.0),
                 (240.0, 300.0))   # tests/synthetic_data.py's five person locations
MPAUG_PER_LOCATION = 96     # single-person recordings a location file
STREAM_SHARD = 64           # --stream-bank: sample indices a shard
STREAM_REPEATS = 2          # --stream-repeats
REAL_SPLIT_FRAMES = 176828  # the MP-3DHP training split, for the streaming reckoning
REAL_STREAM_SHARD = 2048    # the JAX command line's suggested --stream-bank for it
MPAUG_ROUTES = (("host", []), ("device bank", ["--device-bank"]),
                ("stream", ["--stream-bank", str(STREAM_SHARD), "--stream-repeats",
                            str(STREAM_REPEATS)]))
MPAUG_RUNS = tuple((f, r, x) for f in TRAIN_FAMILIES for r, x in MPAUG_ROUTES) + (
    ("popnet", "device bank, pred-vis", ["--device-bank", "--pred-vis"]),)
MPAUG_CKPT_EVAL = (("openpose", []), ("openpose", ["--device-decode"]), ("popnet", []))


def write_mpaug_bank(rng, dev, root: str, n: int) -> None:
    """The per-location recordings of mp-aug under root: for each of the
    five MPAUG_CENTRES, n single-person frames (a person of person_frames'
    template there, 2.0-4.5 m away, on a zero background) as
    depth_maps/loc<l>_*.npy, their masks as seg_maps/, and their people as
    labels_loc<l>.json (write_eval_set)."""
    for loc, (cx, cy) in enumerate(MPAUG_CENTRES):
        pts = np.stack([_skeleton(rng, cx, cy - 30, cy + 30)[None] for _ in range(n)])
        pts = np.clip(pts + rng.normal(0, 2.0, size=pts.shape), 10, [470, 502])
        z = rng.uniform(2.0, 4.5, size=(n, 1, 1)) + rng.normal(0, 0.05, size=(n, 1, 15))
        present = np.ones((n, 1), bool)
        frames = _draw_people(pts, z, present, dev, 512, 480)
        write_eval_set(root, frames, {"joints2d": pts, "z": z, "present": present},
                       labels_name=f"labels_loc{loc}.json", seg=True, prefix=f"loc{loc}")


def mpaug_dataset(cls, root: str, dev, family: str = "popnet", **kw):
    """A dataset of popnet_tpu_torch's mp-aug classes over root's location
    files at TRAIN_INPUT, the family's targets, seed 0."""
    from popnet_tpu_torch.core.config import EncoderConfig

    align, prior = TRAIN_TARGETS[family]
    files = sorted(os.path.join(root, f) for f in os.listdir(root)
                   if f.startswith("labels_loc") and f.endswith(".json"))
    return cls(os.path.join(root, "depth_maps"), files,
               bg_file=os.path.join(root, "labels_bg.json"), bg_dir=os.path.join(root, "bg_maps"),
               seg_dir=os.path.join(root, "seg_maps"),
               ecfg=EncoderConfig(input_x=TRAIN_INPUT, input_y=TRAIN_INPUT), pose_align=align,
               with_prior=prior, seed=0, device=dev, **kw)


def compare_vis(tag: str, card: dict, host: dict) -> float:
    """compare_batches, and the prior's visibility channels (the last K of
    each anchor's 5 + 4K) equal; returns the share of visible joints over
    the anchors a person is assigned to."""
    import torch

    compare_batches(tag, card, host)
    vis = lambda b: b["prior_map"].cpu().reshape(*b["prior_map"].shape[:3], 2, 65)[..., 50:]
    require(bool(torch.equal(vis(card), vis(host))), f"{tag}: visibility channels differ")
    return float(vis(card)[card["prior_mask_coord"].cpu() > 0].mean())


def shard_batch(ds, shard, idx) -> dict:
    ds._use(shard)
    return ds._bank_batch(idx, shard.row_of, shard.bank_depth, shard.bank_seg)


def set_family(ds, family: str, pred_vis: bool = False):
    """ds with the family's targets and a fresh generator (seed 0)."""
    ds.pose_align, ds.with_prior = TRAIN_TARGETS[family]
    ds.pred_vis = pred_vis
    ds.rng = np.random.default_rng(0)
    return ds


def time_mpaug_input(ds, batch: int, full_rows: dict) -> tuple[float, float]:
    """(input pipeline alone over one epoch, each batch waited for on the
    card; its host stage alone over as many frames: the loads, composite and
    label algebra of get_batch_host, or a bank's draws, draw_batch) in
    frames/s."""
    import torch

    t0, n = time.perf_counter(), 0
    for b in ds.iter_batches(batch):
        torch.cuda.synchronize()
        n += b["image"].shape[0]
    pipe = n / (time.perf_counter() - t0)
    order = np.arange(len(ds))
    host = ds.draw_batch if hasattr(ds, "draw_batch") else None
    t0, nh = time.perf_counter(), 0
    for s in range(0, len(ds) - batch + 1, batch):
        if host is None:
            ds.get_batch_host(order[s:s + batch])
        else:
            host(order[s:s + batch], full_rows)
        nh += batch
    return pipe, nh / (time.perf_counter() - t0)


def phase_mpaug(rng, dev) -> dict:
    """Phase 8, mp-aug training (see the module docstring). Returns
    {"train": launches of the training runs, "ckpt_eval": launches of
    evaluate --ckpt on their checkpoints}."""
    import tempfile

    import torch

    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.data import datasets as pds
    from popnet_tpu_torch.data.streaming import StreamingDeviceMPAugDataset
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.train.steps import (make_popnet_train_step, make_rtpose_train_step,
                                              make_yolo_train_step)

    t_phase = time.perf_counter()
    launches = {"train": {k.__name__: 0 for k in kernels.KERNELS}}
    idx = np.arange(TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_train_set(rng, dev, root, TRAIN_BATCH, VAL_FRAMES)
        write_mpaug_bank(rng, dev, root, MPAUG_PER_LOCATION)
        n_layers = len(MPAUG_CENTRES) * MPAUG_PER_LOCATION
        say("mpaug", f"wrote {len(MPAUG_CENTRES)} location files of {MPAUG_PER_LOCATION} "
            f"single-person recordings (512x480 depth and masks, {n_layers} layers), "
            f"{N_BACKGROUNDS} backgrounds and {VAL_FRAMES} validation frames in "
            f"{time.perf_counter() - t0:.1f} s")

        # (b) a batch on the card against the CPU's, PoP-Net targets with pred_vis
        t0 = time.perf_counter()
        card_bank = None
        for name, cls, kw in (("host", pds.KDH3DMPAugDataset, {}),
                              ("host u16mm", pds.KDH3DMPAugDataset, {"transfer": "u16mm"}),
                              ("device bank", pds.DeviceMPAugDataset, {}),
                              ("adv", pds.KDH3DMPAugAdvDataset, {})):
            cds = mpaug_dataset(cls, root, dev, pred_vis=True, **kw)
            hds = mpaug_dataset(cls, root, "cpu", pred_vis=True, **kw)
            card, host = cds.get_batch(idx), hds.get_batch(idx)
            vis = compare_vis(f"mp-aug {name}", card, host)
            require(cds.rng.bit_generator.state == hds.rng.bit_generator.state,
                    f"mp-aug {name}: the generators differ")
            say("mpaug", f"(b) {name}: a batch of {TRAIN_BATCH} on the card equals the CPU's "
                f"(image, z-maps, masks and the prior's visibility channels bit for bit, "
                f"{vis:.3f} of the assigned joints visible; other maps within {TARGETS_BAR}); "
                f"generators in lockstep")
            if name == "device bank":
                card_bank, host_bank, step_pair = cds, hds, (card, host)
        streams = {}
        for where in (dev, "cpu"):
            streams[where] = mpaug_dataset(StreamingDeviceMPAugDataset, root, where,
                                           pred_vis=True, shard_indices=STREAM_SHARD)
            shard = streams[where]._stage(0)
            streams[where, "batch"] = shard_batch(streams[where], shard, idx)
            streams[where]._release(shard)
        compare_vis("stream shard", streams[dev, "batch"], streams["cpu", "batch"])
        say("mpaug", f"(b) a staged stream shard ({STREAM_SHARD} indices): the card's batch "
            f"equals the CPU's likewise; (b) in {time.perf_counter() - t0:.1f} s, the CPU's "
            f"banks and batches included")
        del host_bank, streams
        # (f) the PoP-Net --pred-vis step, card against CPU
        sub = lambda b: {k: v[:STEP_BATCH] for k, v in b.items()}
        train_step_checks("popnet --pred-vis:", "popnet", sub(step_pair[0]), sub(step_pair[1]),
                          dev, pred_vis=True)
        del step_pair

        # (c) the bank against the host path on the card
        bank = set_family(card_bank, "popnet")
        host = set_family(mpaug_dataset(pds.KDH3DMPAugDataset, root, dev, transfer="u16mm"),
                          "popnet")
        hb, db = host.get_batch(idx), bank.get_batch(idx)
        worst = {}
        for k in hb:
            bar = 2e-3 if k in ("image", "zmaps") else 1e-5
            worst[k] = _maxerr(db[k], hb[k])
            require(worst[k] <= bar, f"(c) {k}: bank and host {worst[k]:.3g} apart (bar {bar})")
        require(int(host.rng.integers(0, 1 << 30)) == int(bank.rng.integers(0, 1 << 30)),
                "(c) the generators' next draws differ")
        set_family(bank, "popnet"), set_family(host, "popnet")
        rows_h = host.get_batch_host(idx)[1]
        rows_b = bank.draw_batch(idx, bank._row)[3]
        require(all(np.array_equal(np.asarray(a), np.asarray(b))
                    for ra, rb in zip(rows_h, rows_b) for a, b in zip(ra, rb)),
                "(c) the label rows differ")
        say("mpaug", "(c) DeviceMPAugDataset against KDH3DMPAugDataset(transfer=u16mm) on the "
            f"card: label rows equal; image {worst['image']:.3g}, z-maps {worst['zmaps']:.3g} "
            f"apart (bar 2e-3), other maps within "
            f"{max(v for k, v in worst.items() if k not in ('image', 'zmaps')):.3g} (bar 1e-5); "
            f"the generators' next draws equal")

        # (d) the stream against the full bank; one streamed epoch
        stream = mpaug_dataset(StreamingDeviceMPAugDataset, root, dev, shard_indices=STREAM_SHARD)
        set_family(bank, "popnet", pred_vis=True), set_family(stream, "popnet", pred_vis=True)
        shard = stream._stage(1)
        sidx = np.arange(STREAM_SHARD, STREAM_SHARD + TRAIN_BATCH)
        a, b = bank.get_batch(sidx), shard_batch(stream, shard, sidx)
        stream._release(shard)
        require(all(bool(torch.equal(a[k], b[k])) for k in a),
                "(d) the streamed batch differs from the full bank's")
        seen, staged = [], []
        inner_batch, inner_stage = stream._bank_batch, stream._stage
        stream._bank_batch = lambda i, *r: seen.append([int(x) for x in i]) or inner_batch(i, *r)
        stream._stage = lambda sid: staged.append(inner_stage(sid)) or staged[-1]
        set_family(stream, "popnet")
        stream.max_live_shards = 0
        t0 = time.perf_counter()
        for _ in stream.iter_batches(TRAIN_BATCH):
            torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        covered = sorted(sum(seen, [])) == list(range(len(stream)))
        require(covered and all(len({i // STREAM_SHARD for i in s}) == 1 for s in seen),
                "(d) a streamed epoch does not cover every index once within shards")
        require(stream.max_live_shards <= 2 and stream._live_shards == 0,
                f"(d) {stream.max_live_shards} shards resident at once")
        rate = stream.shard_bytes() / np.mean([s.stage_seconds for s in staged]) / 1e9
        real_bytes = REAL_STREAM_SHARD * len(MPAUG_CENTRES) * 512 * 480 * 3
        real_shards = -(-REAL_SPLIT_FRAMES // REAL_STREAM_SHARD)
        say("mpaug", f"(d) a streamed batch over staged shard 1 equals the full bank's bit for "
            f"bit; one streamed epoch ({stream.n_shards} shards of {STREAM_SHARD} indices, "
            f"{stream.shard_bytes() / 1e6:.1f} MB a shard) covers every index once in "
            f"{epoch_s:.2f} s, at most {stream.max_live_shards} shards resident; staging "
            f"(.npy loads, millimetres, pinned copy to the ready event) "
            f"{rate:.3f} GB/s over {len(staged)} shards. Reckoning, not a measurement: the "
            f"real split's {REAL_SPLIT_FRAMES} indices at --stream-bank {REAL_STREAM_SHARD} "
            f"make {real_shards} shards of at most {real_bytes / 1e9:.2f} GB, "
            f"{real_shards * real_bytes / 1e9 / rate:.0f} s of staging an epoch at this rate")

        # (e) train through the command line
        cli = ["--data-root", root, "--device", str(dev), "--input-size", str(TRAIN_INPUT),
               "--mp-aug", "--bg-aug", "--batch-size", str(TRAIN_BATCH), "--val-labels",
               "labels_val.json", "--lr", str(TRAIN_LR), "--epochs", "2"]
        mk_step = {"openpose": make_rtpose_train_step, "popnet": make_popnet_train_step,
                   "yolo": make_yolo_train_step}
        stream.shard_repeats = STREAM_REPEATS
        timing_ds = {"host": mpaug_dataset(pds.KDH3DMPAugDataset, root, dev),
                     "device bank": bank, "stream": stream}
        stream._bank_batch, stream._stage = inner_batch, inner_stage
        step_ms, rows = {}, []
        for family, route, extra in MPAUG_RUNS:
            pred_vis = "--pred-vis" in extra
            tag = f"{family} {route}:"
            out = os.path.join(root, f"mp_{family}_{route.replace(' ', '_').replace(',', '')}")
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = cli_main(["train", "--model", family, "--out-dir", out, *extra, *cli])
            wall = time.perf_counter() - t0
            mem = torch.cuda.max_memory_allocated() / 2**20
            for k, v in kernels.launch_counts().items():
                launches["train"][k] += v
            hist = trainer.history
            losses = [h["train_loss"] for h in hist]
            require(len(hist) == 2 and bool(np.isfinite(losses + [h["val_loss"] for h in hist])
                                             .all()) and losses[1] < losses[0],
                    f"{tag} the loss is not finite and falling: {hist}")
            repeats = STREAM_REPEATS if route == "stream" else 1
            frames = MPAUG_PER_LOCATION // TRAIN_BATCH * TRAIN_BATCH * repeats
            e2e = frames / hist[1]["train_seconds"]
            ds = set_family(timing_ds[route.split(",")[0]], family, pred_vis)
            pipe_fps, host_fps = time_mpaug_input(ds, TRAIN_BATCH, bank._row)
            key = (family, pred_vis)
            if key not in step_ms:
                batch = set_family(bank, family, pred_vis).get_batch(idx)
                state = trainer.state
                step = (make_popnet_train_step(pred_vis=True) if pred_vis
                        else mk_step[family]())
                with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                    step_ms[key] = time_ms(lambda: step(state, batch), reps=10, warm=2)
            say("mpaug", f"{tag} (e) train --mp-aug {' '.join(extra)} --batch-size {TRAIN_BATCH} "
                f"--epochs 2 (float32, TF32 off): train loss {losses[0]:.5f} -> "
                f"{losses[1]:.5f}, val {hist[0]['val_loss']:.5f} -> {hist[1]['val_loss']:.5f}; "
                f"e2e train {e2e:.1f} frames/s over epoch 2 ({frames} frames, "
                f"{hist[1]['train_seconds']:.3f} s, host clock); input pipeline alone "
                f"{pipe_fps:.1f} frames/s, host stage alone {host_fps:.1f} frames/s (1 epoch); "
                f"step {step_ms[key]:.3f} ms at batch {TRAIN_BATCH} (CUDA events) = "
                f"{TRAIN_BATCH / step_ms[key] * 1e3:.1f} frames/s; max_memory_allocated "
                f"{mem:.1f} MiB; the command {wall:.1f} s; kernels launched: "
                f"{sum(kernels.launch_counts().values())}")
            rows.append((tag, e2e, pipe_fps, host_fps, step_ms[key], mem))
        say("mpaug", "(e) summary, train / pipeline / host stage frames/s, step ms, MiB: "
            + "; ".join(f"{t} {a:.1f} / {b:.1f} / {c:.1f}, {d:.3f}, {m:.0f}"
                        for t, a, b, c, d, m in rows))
        del timing_ds, bank, stream

        # (g) evaluate --ckpt of the device-bank checkpoints
        t0 = time.perf_counter()
        kernels.reset_launches()
        for family, extra in MPAUG_CKPT_EVAL:
            ev_out = os.path.join(root, f"mp_eval_{family}{'_dd' if extra else ''}")
            m = cli_main(["evaluate", "--model", family, "--data-root", root, "--labels",
                          "labels_val.json", "--ckpt",
                          os.path.join(root, f"mp_{family}_device_bank", "ckpt"),
                          "--out-dir", ev_out, "--batch-size", str(VAL_FRAMES),
                          "--input-size", str(TRAIN_INPUT), "--device", str(dev), *extra])
            require(os.path.exists(os.path.join(ev_out, f"{family}_results.json")),
                    f"evaluate --ckpt {family}: no JSON")
            say("mpaug", f"(g) evaluate --model {' '.join([family, *extra])} --ckpt of the "
                f"--mp-aug --device-bank run on the {VAL_FRAMES} validation frames: "
                + json.dumps({k: m[k] for k in ("pck2d", "pck3d", "map2d", "map3d")}))
        torch.cuda.synchronize()
        launches["ckpt_eval"] = kernels.launch_counts()
        say("mpaug", f"(g) evaluate --ckpt launches per kernel: {launches['ckpt_eval']}; of "
            f"them, readouts (K4 and K5 together): {kernels.readouts.launches}; "
            f"{time.perf_counter() - t0:.1f} s")
        for name in EVAL_PATH:
            require(launches["ckpt_eval"][name] >= 1, f"evaluate --ckpt did not launch {name}")
    say("mpaug", f"mp-aug training launches per kernel: {launches['train']} (none expected)")
    require(not any(launches["train"].values()), "the mp-aug training path launched a kernel")
    say("mpaug", f"phase 8 passed in {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 9: A2J training --------------------------------------------------------------------

A2J_LR, A2J_WD = 3.5e-4, 1e-4   # the recipe's Adam with L2 (the command line's A2J defaults)
A2J_EPOCHS = 2              # the command line's run; --resume adds one, against 3 in one call
# the head convs ahead of a BatchNorm, whose bias's gradient is zero in exact arithmetic
A2J_ZERO_GRAD = {f"{h}.Conv_{n}.bias" for h in ("classification", "regression", "depth")
                 for n in range(4)}
A2J_BN_BAR = 1e-8           # float64: running statistics against 0.99 old + 0.01 batch, relative


def a2j_one_step(batch: dict, dev, dtype):
    """`one_step` for A2J: one Adam-L2 step (A2J_LR, A2J_WD) of
    A2J(depth_prior=3.0) from its seeded init (A2J_SEED) on {"crops",
    "labels"}, on `dev` in `dtype`, TF32 off and cuDNN deterministic."""
    import torch

    from popnet_tpu_torch.data.a2j_crops import CROP
    from popnet_tpu_torch.models import A2J
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors
    from popnet_tpu_torch.train.state import TrainState, make_optimizer
    from popnet_tpu_torch.train.steps import make_a2j_train_step

    model = A2J(depth_prior=3.0).init_seeded(A2J_SEED).to(dev, dtype)
    state = TrainState(model, make_optimizer(model, "adam", A2J_LR, weight_decay=A2J_WD))
    step = make_a2j_train_step(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()))
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    b = {k: v.to(dev, dtype) for k, v in batch.items()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False, deterministic=True):
        state, logs = step(state, b)
    after = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return float(logs["loss"]), before, after, set(A2J_ZERO_GRAD)


def a2j_dataset(root: str, dev, **kw):
    """A2JCropDataset (seed 0) over KDH3DMPAugDataset of root's location
    files, the inner built as `train --model a2j --mp-aug` builds it."""
    from popnet_tpu_torch.data import datasets as pds
    from popnet_tpu_torch.data.a2j_crops import A2JCropDataset

    return A2JCropDataset(mpaug_dataset(pds.KDH3DMPAugDataset, root, dev, "openpose"), seed=0,
                          **kw)


def a2j_batchnorm_check(crops, dev) -> tuple[float, int]:
    """One train-mode forward of the seeded A2J in float64 on the card:
    each BatchNorm's running mean and variance become 0.99 x their start +
    0.01 x the batch's mean and biased variance (Flax's momentum), within
    A2J_BN_BAR relative. Returns (the largest error, the BatchNorms)."""
    import torch

    from popnet_tpu_torch.models import A2J
    from popnet_tpu_torch.models.layers import BatchNorm
    from popnet_tpu_torch.train.steps import _nchw

    model = A2J(depth_prior=3.0).init_seeded(A2J_SEED).to(dev, torch.float64).train()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    seen = {}

    def record(name):
        def hook(_, args):
            x = args[0]
            seen[name] = (x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False))
        return hook

    hooks = [m.register_forward_pre_hook(record(n)) for n, m in model.named_modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(_nchw(crops.to(dev, torch.float64)))
    finally:
        for h in hooks:
            h.remove()
    got, worst = model.state_dict(), 0.0
    for name, stats in seen.items():
        for key, batch in zip(("running_mean", "running_var"), stats):
            want = 0.99 * start[f"{name}.{key}"] + 0.01 * batch
            err = (got[f"{name}.{key}"] - want).abs() / (want.abs() + 1e-12)
            worst = max(worst, float(err.max()))
    require(len(seen) == 65 and worst <= A2J_BN_BAR,
            f"A2J BatchNorm statistics off Flax's momentum: {worst:.3g} (bar {A2J_BN_BAR})")
    return worst, len(seen)


def a2j_warp_checks(frames: list, rng, dev) -> dict:
    """Rotate by uniform(+-10) degrees, and RenderDepth by uniform(0.7, 1.7)
    then Resize back to 512x480, both about the KDH3D principal point, on
    each of `frames` ((H, W) float32 CPU tensors): card against CPU bit for
    bit. Returns each warp's card ms for the whole list (CUDA events)."""
    from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS as cam
    from popnet_tpu_torch.data import augment_host as ah

    rots = rng.uniform(-10, 10, len(frames))
    ratios = rng.uniform(0.7, 1.7, len(frames))
    resize = ah.Resize(frames[0].shape[1], frames[0].shape[0])

    def rotate(fs):
        return [ah.Rotate.apply(f, [], r, cam.cx, cam.cy)[0] for f, r in zip(fs, rots)]

    def render(fs):
        return [resize(ah.RenderDepth.apply(f, [], a, cam.cx, cam.cy))[0]
                for f, a in zip(fs, ratios)]

    card = [f.to(dev) for f in frames]
    ms = {}
    for name, fn in (("Rotate", rotate), ("RenderDepth + Resize", render)):
        got, ref = fn(card), fn(frames)
        require(all(bool((g.cpu() == r).all()) and g.shape == r.shape for g, r in zip(got, ref)),
                f"{name}: the card's warp differs from the CPU's")
        ms[name] = time_ms(lambda: fn(card), reps=3, warm=1)
    return ms


def phase_a2j_train(rng, dev, keep: str) -> dict:
    """Phase 9, A2J training (see the module docstring); `keep` holds phase
    6's labelled "bg" set and phase 7's Yolo-Pose+ checkpoint. Returns
    {"train": launches of the training runs, "ckpt_eval": launches of
    evaluate --model a2j --ckpt}."""
    import tempfile

    import torch

    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.data.a2j_crops import (CROP, apply_erasing, erasing_draws,
                                                 erasing_rectangles)
    from popnet_tpu_torch.models import A2J
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.train import checkpoint
    from popnet_tpu_torch.train.steps import _nchw, make_a2j_train_step
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors

    t_phase = time.perf_counter()
    idx = np.arange(TRAIN_BATCH)
    launches = {"train": {k.__name__: 0 for k in kernels.KERNELS}}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_train_set(rng, dev, root, TRAIN_BATCH, VAL_FRAMES)
        write_mpaug_bank(rng, dev, root, MPAUG_PER_LOCATION)
        say("a2j", f"wrote {len(MPAUG_CENTRES)} location files of {MPAUG_PER_LOCATION} "
            f"single-person recordings, {N_BACKGROUNDS} backgrounds and {VAL_FRAMES} validation "
            f"frames (phase 8's writers) in {time.perf_counter() - t0:.1f} s")

        # (a) an A2JCropDataset batch on the card against the CPU's
        t0 = time.perf_counter()
        cds, hds = a2j_dataset(root, dev, erase=False), a2j_dataset(root, "cpu", erase=False)
        fc, fh = cds.frames(idx), hds.frames(idx)
        require(bool(torch.equal(fc[0].cpu(), fh[0])), "(a) the augmented frames differ")
        require(all(np.array_equal(a, b) for a, b in zip(fc[1:], fh[1:])),
                "(a) the boxes, joints or depths differ")
        card, host = cds.crop_frames(*fc), hds.crop_frames(*fh)
        require(all(bool(torch.equal(card[k].cpu(), host[k])) for k in host),
                "(a) the crops or labels differ")
        u, noise = erasing_draws(TRAIN_BATCH, CROP, cds.erase_generator)
        rc, rh = erasing_rectangles(u, CROP), erasing_rectangles(u.cpu(), CROP)
        require(all(bool(torch.equal(a.cpu(), b)) for a, b in zip(rc, rh)),
                "(a) the erased rectangles differ")
        ec = apply_erasing(card["crops"], rc, noise)
        eh = apply_erasing(host["crops"], rh, noise.cpu())
        require(bool(torch.equal(ec.cpu(), eh)), "(a) the erased crops differ")
        require(int(cds.rng.integers(0, 1 << 30)) == int(hds.rng.integers(0, 1 << 30))
                and int(cds.inner.rng.integers(0, 1 << 30))
                == int(hds.inner.rng.integers(0, 1 << 30)), "(a) the generators' next draws differ")
        say("a2j", f"(a) A2JCropDataset over KDH3DMPAugDataset, a batch of {TRAIN_BATCH} at "
            f"{CROP}² made on the card equals the CPU's: augmented frames, boxes, joints, "
            f"crops and labels bit for bit; erasing on the card's draws ({int(rc[0].sum())} of "
            f"{TRAIN_BATCH} crops erased) bit for bit; both generators' next draws equal; "
            f"{time.perf_counter() - t0:.1f} s")

        # (b) the warps alone
        frames = [torch.from_numpy(hds.inner.load_composited(int(i))[0]) for i in idx]
        warp_ms = a2j_warp_checks(frames, rng, dev)
        say("a2j", f"(b) the warps on {len(frames)} frames of 512x480, card against CPU bit for "
            "bit; card ms for the batch (CUDA events, eager): "
            + ", ".join(f"{k} {v:.3f}" for k, v in warp_ms.items()))

        # (c) the step, card against CPU, and BatchNorm's momentum
        sub = lambda b: {k: v[:STEP_BATCH] for k, v in b.items()}
        train_step_checks("a2j:", "a2j", sub(card), sub(host), dev)
        bn_err, n_bn = a2j_batchnorm_check(card["crops"][:STEP_BATCH], dev)
        say("a2j", f"(c) one train-mode forward of the seeded A2J (float64, card): the running "
            f"statistics of its {n_bn} BatchNorms are 0.99 x their start + 0.01 x the batch's "
            f"mean and biased variance within {bn_err:.3g} relative (bar {A2J_BN_BAR})")

        # (d) the command line: 2 epochs, --resume 1, against 3 in one call
        cli = ["train", "--model", "a2j", "--data-root", root, "--device", str(dev), "--mp-aug",
               "--bg-aug", "--batch-size", str(TRAIN_BATCH), "--val-labels", "labels_val.json"]
        out, whole = os.path.join(root, "a2j_run"), os.path.join(root, "a2j_whole")
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.backends.cudnn.flags(enabled=True, deterministic=True):
            trainer = cli_main([*cli, "--out-dir", out, "--epochs", str(A2J_EPOCHS)])
            wall = time.perf_counter() - t0
            mem = torch.cuda.max_memory_allocated() / 2**20
            cli_main([*cli, "--out-dir", out, "--epochs", "1", "--resume"])
            cli_main([*cli, "--out-dir", whole, "--epochs", str(A2J_EPOCHS + 1)])
        for k, v in kernels.launch_counts().items():
            launches["train"][k] += v
        hist = trainer.history
        losses = [h["train_loss"] for h in hist]
        require(len(hist) == A2J_EPOCHS and bool(np.isfinite(losses + [h["val_loss"] for h in hist])
                                                  .all()) and losses[-1] < losses[0],
                f"train --model a2j: the loss is not finite and falling: {hist}")
        a, _, sa = checkpoint.restore_checkpoint(os.path.join(out, "ckpt"))
        b, _, sb = checkpoint.restore_checkpoint(os.path.join(whole, "ckpt"))
        same = sa == sb == A2J_EPOCHS and all(torch.equal(v, b["model"][k])
                                              for k, v in a["model"].items())
        same = same and all(torch.equal(v, b["optimizer"]["state"][i][k])
                            for i, st in a["optimizer"]["state"].items() for k, v in st.items())
        hists = [[{k: v for k, v in json.loads(x).items() if k != "train_seconds"}
                  for x in open(os.path.join(d, "history.jsonl"))] for d in (out, whole)]
        require(same and hists[0] == hists[1],
                f"train --model a2j: {A2J_EPOCHS} epochs + --resume 1 differ from "
                f"{A2J_EPOCHS + 1} in one call")
        n_train = MPAUG_PER_LOCATION // TRAIN_BATCH * TRAIN_BATCH
        e2e = n_train / hist[1]["train_seconds"]
        ds = a2j_dataset(root, dev)
        t0, n = time.perf_counter(), 0
        for bt in ds.iter_batches(TRAIN_BATCH):
            torch.cuda.synchronize()
            n += bt["crops"].shape[0]
        pipe = n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for s0 in range(0, n_train, TRAIN_BATCH):
            ds.frames(np.arange(s0, s0 + TRAIN_BATCH))
        torch.cuda.synchronize()
        frames_rate = n_train / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for i in range(n_train):
            ds.inner.load_composited(i)
        composite_rate = n_train / (time.perf_counter() - t0)
        batch = ds.get_batch(idx)
        state = trainer.state
        step = make_a2j_train_step(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            step_ms = time_ms(lambda: step(state, batch), reps=10, warm=2)
        with torch.no_grad():
            flops = 3.0 * conv_flops(A2J().to(dev).eval(), _nchw(batch["crops"]))
        say("a2j", f"(d) train --model a2j --mp-aug --bg-aug --batch-size {TRAIN_BATCH} --epochs "
            f"{A2J_EPOCHS} (288² crops, float32, TF32 off, cuDNN deterministic; Adam-L2 "
            f"{A2J_LR}, StepLR): losses " + ", ".join(
                f"epoch {h['epoch']} train {h['train_loss']:.5f} val {h['val_loss']:.5f}"
                for h in hist)
            + f"; e2e train {e2e:.1f} crops/s over epoch 2 ({n_train} crops, "
            f"{hist[1]['train_seconds']:.3f} s, host clock); input pipeline alone {pipe:.1f} "
            f"crops/s, its frames stage alone (composite, augmentation on the card, person "
            f"draws) {frames_rate:.1f} frames/s, the host composite alone {composite_rate:.1f} "
            f"frames/s (1 epoch each); step {step_ms:.3f} ms at batch {TRAIN_BATCH} (CUDA events) "
            f"= {TRAIN_BATCH / step_ms * 1e3:.1f} crops/s, {flops / 1e12:.3f} TFLOP "
            f"(3 x the convolutions' forward) = {flops / step_ms / 1e9:.1f} TFLOP/s; "
            f"max_memory_allocated {mem:.1f} MiB; the command {wall:.1f} s; --resume for 1 "
            f"epoch equals {A2J_EPOCHS + 1} epochs in one call bit for bit (parameters, "
            f"BatchNorm statistics, Adam's moments and step, history); kernels launched: "
            f"{sum(launches['train'].values())}")

        # (e) evaluate --model a2j --ckpt on phase 6's labelled set
        t0 = time.perf_counter()
        eval_root = os.path.join(keep, "eval_bg")
        ckpts = {"a2j": os.path.join(out, "ckpt"), "yolo_for_a2j": os.path.join(keep, "yolo_ckpt")}
        kernels.reset_launches()
        m = cli_main(["evaluate", "--model", "a2j", "--data-root", eval_root, "--ckpt",
                      ckpts["a2j"], "--yolo-ckpt", ckpts["yolo_for_a2j"], "--device", str(dev),
                      "--batch-size", str(EVAL_BATCH), "--out-dir", os.path.join(root, "a2j_eval")])
        require(os.path.exists(os.path.join(root, "a2j_eval", "a2j_results.json")),
                "evaluate --model a2j --ckpt: no JSON")
        paths = (os.path.join(eval_root, "depth_maps"), os.path.join(eval_root, "labels.json"))
        card_json, host_json, timing, a2j = eval_family("a2j --ckpt", "a2j", {}, paths, dev,
                                                        EVAL_BATCH, {}, ckpts)
        torch.cuda.synchronize()
        launches["ckpt_eval"] = kernels.launch_counts()
        bars = a2j_bars(a2j)
        compare_eval_json("a2j --ckpt", card_json, host_json, bars)
        people = sum(len(h) for h in card_json["human_pred_set_2d"])
        say("a2j", f"(e) evaluate --model a2j --ckpt a2j_run/ckpt --yolo-ckpt (phase 7's "
            f"Yolo-Pose+) on phase 6's {EVAL_FRAMES} labelled frames, on the card: "
            + json.dumps({k: m[k] for k in ("pck2d", "pck3d", "map2d", "map3d")})
            + f"; the driver with those checkpoints on the card and on the host with the same "
            f"CNN outputs: JSON equal (A2J joints within the vote's bar: (y, x) {bars[3]:.4g} of "
            f"{bars[1]:.4g}, z {bars[4]:.4g} of {bars[2]:.4g}), {people} people; launches "
            f"{launches['ckpt_eval']}; {time.perf_counter() - t0:.1f} s")
    say("a2j", f"A2J training launches per kernel: {launches['train']}, evaluate --ckpt's "
        f"{launches['ckpt_eval']} (none expected)")
    require(not any(launches["train"].values()) and not any(launches["ckpt_eval"].values()),
            "the A2J training or evaluation path launched a kernel")
    say("a2j", f"phase 9 passed in {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 10: the deployment transforms ----------------------------------------------------

DEPLOY = (("exact", {}), ("fold", {"fold_bn": True}), ("int8", {"quant": "int8"}),
          ("fold+int8", {"fold_bn": True, "quant": "int8"}))
DEPLOY_BATCHES = 3          # timed batches of each phase-10 stream, after DEPLOY_WARM
DEPLOY_WARM = 1             # warm batches of each phase-10 stream
DEPLOY_CHECK = 8            # frames (A2J: crops; COCO: 2 frames) of the int8 and fold checks
INT8_PEAK_OPS = 1979e12     # H100 SXM dense int8 tensor-core peak (data sheet)
# the int8 paths (bf16 CNN but the int8 convs, q16 wire) against the float32 slice:
# (people per frame equal on at least this share of frames, people and visible joints
# within this fraction); COCO holds people and visible joints within its fraction
# (the worst of two H100 runs, PR 12: Open-Pose+ 73.4%, 7.2%; PoP-Net 93.4%, 2.4%;
# Yolo-Pose+ 93.4%, 0.9%; Yolo->A2J 94.1%, 0.8%; COCO's seeded noise maps 11.6%, int8
# finding more people than float32 in both runs)
INT8_BARS = {"Open-Pose+": (0.60, 0.12), "PoP-Net": (0.85, 0.05), "Yolo-Pose+": (0.85, 0.03),
             "Yolo->A2J": (0.85, 0.03), "COCO RGB": 0.20}
# evaluate's metrics against the float32 run: folded within 0.005, int8 within 0.02
# (tests/test_quant_int8.py's bar), but for Yolo-Pose+'s pck3d and map3d under int8,
# which the JAX package's own int8 moves by 0.028-0.055 on such frames
# (tests/test_torch_quant.py::test_int8_moves_yolo_3d_metrics_in_both_packages): 0.06
EVAL_DEPLOY_BARS = {"--fold-bn": 0.005, "--quant int8": 0.02}
YOLO_INT8_3D_BAR = 0.06
DEPLOY_PATH = ("find_peaks", "paf_score", "assemble_ids", "window_readout", "point_readout",
               "peak_local_max")


def deploy_families(dev, frames, weights, frames_pn, weights_pn, frames_y, weights_yolo,
                    weights_a2j, frames_c, weights_c) -> dict:
    """{family: (a fresh float32 model on the host, the CNN's float32 input
    on the card for the full batch of the path)}: Open-Pose+, PoP-Net,
    Yolo-Pose+ on their 256 frames, A2J (`weights_a2j`, its seeded init as
    Flax-named variables) on the 1024 crops the float32 detector gives
    those Yolo frames, COCO (VGG19) on its 64 frames, and
    COCO's MobileNet trunk (seeded), whose BatchNorms the fold exercises, on
    the same frames."""
    import torch

    from popnet_tpu_torch.core.config import KDH3D_DEPTH
    from popnet_tpu_torch.data.a2j_crops import crop_resize_batch
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import A2J, PopNet, RTPoseLight3D, RTPoseVGG, YoloPoseNet
    from popnet_tpu_torch.serving import a2j_boxes, preproc_depth, preproc_rgb, yolo_decode

    def depth_in(f):
        return preproc_depth(f).permute(0, 3, 1, 2).contiguous()

    (B, H, W), C = frames_y.shape, MAX_CROPS
    yolo = load_into(YoloPoseNet(), weights_yolo).eval().to(dev)
    with torch.inference_mode():
        det = yolo_decode(yolo(depth_in(frames_y)).permute(0, 2, 3, 1), W, H)
        idx = torch.arange(B, device=dev).repeat_interleave(C)
        crops = crop_resize_batch(frames_y, idx, a2j_boxes(det["dets"], C, W, H),
                                  KDH3D_DEPTH.mean, KDH3D_DEPTH.std)[:, None]
        coco_in = preproc_rgb(frames_c)
        inputs = {"Open-Pose+": depth_in(frames), "PoP-Net": depth_in(frames_pn),
                  "Yolo-Pose+": depth_in(frames_y), "A2J": crops}
    del yolo
    return {
        "Open-Pose+": (lambda: load_into(RTPoseLight3D(), weights), inputs["Open-Pose+"]),
        "PoP-Net": (lambda: load_into(PopNet(), weights_pn), inputs["PoP-Net"]),
        "Yolo-Pose+": (lambda: load_into(YoloPoseNet(), weights_yolo), inputs["Yolo-Pose+"]),
        "A2J": (lambda: load_into(A2J(), weights_a2j), inputs["A2J"]),
        "COCO": (lambda: load_into(RTPoseVGG(), weights_c), coco_in),
        "COCO MobileNet": (lambda: RTPoseVGG(trunk="mobilenet").init_seeded(0), coco_in),
    }


def int8_exact(tag: str, model, x) -> tuple[int, int]:
    """Each int8 conv of `model` (bf16, as served) on the path's real
    activations `x`: for every conv shape (geometry and input size), once,
    the int32 product on the card (`quant.int8_conv`: im2col and
    `torch._int_mm`) against its plain version (F.conv2d in float64 on the
    card, exact) bit for bit; on the first conv with a bias, the whole
    conv's float32 epilogue (`quant.epilogue`, `torch.addcmul` on the card)
    against the epilogue rounded once (`fma_f32`, as XLA contracts it), bit
    for bit. Returns (shapes, int8 convs called)."""
    import torch

    from popnet_tpu_torch.core.numerics import fma_f32
    from popnet_tpu_torch.ops.quant import Int8Conv2d, int8_conv, int8_conv_plain
    from popnet_tpu_torch.ops.quant import epilogue as epilogue_f32
    from popnet_tpu_torch.ops.quant import quantize_activation

    seen, calls, epilogue = set(), [0], []

    def check(m, args):
        inp = args[0]
        key = (tuple(m.weight.shape), m.stride, m.padding, m.dilation, tuple(inp.shape[2:]))
        if key in seen:
            calls[0] += 1
            return None
        seen.add(key)
        calls[0] += 1
        x_q, s_x = quantize_activation(inp, m.rounding)
        card = int8_conv(x_q, m.weight_mat, m.weight_q, m.stride, m.padding, m.dilation)
        plain = int8_conv_plain(x_q, m.weight_q, m.stride, m.padding, m.dilation)
        require(torch.equal(card, plain.permute(0, 2, 3, 1)),
                f"{tag}: the int8 conv {key} differs from its plain version")
        if m.bias is not None and not epilogue:
            scale = s_x * m.weight_scale
            got = epilogue_f32(card, scale, m.bias, m.rounding)
            epilogue.append(int((got != fma_f32(card.float(), scale, m.bias)).sum()))
        return None

    mods = [m for m in model.modules() if isinstance(m, Int8Conv2d)]
    hooks = [m.register_forward_pre_hook(check) for m in mods]
    try:
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    require(calls[0] == len(mods), f"{tag}: {calls[0]} int8 conv calls for {len(mods)} convs")
    require(epilogue == [0] or not epilogue, f"{tag}: the epilogue on the card rounds apart "
            f"from one fused multiply-add on {epilogue} values")
    return len(seen), calls[0]


def fold_check(tag: str, make, x) -> tuple[int, float]:
    """The fused fold against the unfused one (its folded BatchNorms kept as
    x + bias) in float32 on the card, TF32 off, on `x`: every output within
    tests/test_fold_bn.py's bars (rtol 1e-3, atol 1e-4 of max(1, 0.1 x the
    largest magnitude)). Returns (pairs folded, the largest error over its
    atol)."""
    import torch

    from popnet_tpu_torch.interop.from_jax import flat_from_module, load_into
    from popnet_tpu_torch.ops.fold_bn import fold_batchnorm, fuse_folded

    folded, paths = fold_batchnorm(flat_from_module(make()))
    unfused = load_into(make(), folded).eval().to(x.device)
    fused = fuse_folded(load_into(make(), folded).eval(), paths).to(x.device)
    def tensors(out):
        if isinstance(out, (tuple, list)):
            return [t for o in out for t in tensors(o)]
        return [out]

    worst = 0.0
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for ta, tb in zip(tensors(unfused(x)), tensors(fused(x))):
            atol = 1e-4 * max(1.0, float(ta.abs().max()) * 0.1)
            err = float(((tb - ta).abs() - 1e-3 * ta.abs()).max())
            worst = max(worst, err / atol)
    require(worst <= 1.0, f"{tag}: the fused fold is off the unfused one ({worst:.3g} of the bar)")
    return len(paths), worst


def gemm_breakdown(tag: str, model, x) -> dict:
    """One forward of the int8 `model` (bf16) on the full batch `x`, each
    int8 conv timed alone (CUDA events, 2 calls after 1): its GEMM
    (`quant.gemm` on its im2col), the whole int8 conv (quantize, im2col,
    GEMM, epilogue) and the bf16 cuDNN conv it replaces on the same input.
    Returns the sums (ms) and the GEMMs' operations (2 a multiply-add of
    the unpadded K and C_out)."""
    import torch
    import torch.nn.functional as F

    from popnet_tpu_torch.ops.quant import Int8Conv2d, gemm, im2col, quantize_activation

    acc = {"gemm_ms": 0.0, "int8_ms": 0.0, "bf16_ms": 0.0, "ops": 0.0, "convs": 0}

    def timed(m, args):
        inp = args[0]
        O, Cin, kh, kw = m.weight.shape
        x_q, _ = quantize_activation(inp, m.rounding)
        cols, Ho, Wo = im2col(x_q, kh, kw, m.stride, m.padding, m.dilation,
                              m.weight_mat.shape[1])
        acc["gemm_ms"] += time_ms(lambda: gemm(cols, m.weight_mat), reps=2, warm=1)
        del cols, x_q
        acc["int8_ms"] += time_ms(lambda: m.forward(inp), reps=2, warm=1)
        wb = m.weight.to(inp.dtype)
        bb = None if m.bias is None else m.bias.to(inp.dtype)
        acc["bf16_ms"] += time_ms(lambda: F.conv2d(inp, wb, bb, m.stride, m.padding, m.dilation),
                                  reps=2, warm=1)
        acc["ops"] += 2.0 * inp.shape[0] * Ho * Wo * kh * kw * Cin * O
        acc["convs"] += 1
        return None

    hooks = [m.register_forward_pre_hook(timed) for m in model.modules()
             if isinstance(m, Int8Conv2d)]
    try:
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    acc["tops"] = acc["ops"] / acc["gemm_ms"] / 1e9
    say("deploy", f"{tag} int8 convs ({acc['convs']}) one at a time on the full batch: GEMMs "
        f"(_int_mm) {acc['gemm_ms']:.3f} ms, {acc['ops'] / 1e12:.2f} TOP = {acc['tops']:.1f} "
        f"TOPS ({acc['tops'] * 1e12 / INT8_PEAK_OPS:.1%} of the {INT8_PEAK_OPS / 1e12:.0f} TOPS "
        f"int8 peak); the whole int8 convs (quantize, im2col, GEMM, epilogue) "
        f"{acc['int8_ms']:.3f} ms; the bf16 cuDNN convs they replace {acc['bf16_ms']:.3f} ms")
    return acc


def deploy_eval(root: str) -> None:
    """The metric-level gate on phase 6's labelled "bg" set: `evaluate` of
    PoP-Net and Yolo-Pose+ with the committed weights, float32, then with
    --fold-bn and with --quant int8, on the card at batch 64: each of
    pck2d, pck3d, map2d and map3d within EVAL_DEPLOY_BARS of the float32
    run's; the int8 runs through int8 convs."""
    import tempfile

    import torch

    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.ops import quant

    four = ("pck2d", "pck3d", "map2d", "map3d")
    with tempfile.TemporaryDirectory() as tmp:
        for model, w in (("popnet", WEIGHTS_POPNET), ("yolo", WEIGHTS_YOLO)):
            res = {}
            for flags in ((), ("--fold-bn",), ("--quant", "int8")):
                quant.int8_conv.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[flags] = cli_main(["evaluate", "--model", model, "--data-root", root,
                                       "--out-dir", os.path.join(tmp, model), "--batch-size",
                                       str(EVAL_BATCH), "--weights", w, *flags])
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                name = " ".join(flags) or "float32"
                say("deploy", f"evaluate --model {model} {name}: " + json.dumps(
                    {k: res[flags][k] for k in four}) + f" in {sec:.3f} s; int8 convs run "
                    f"{quant.int8_conv.launches}")
                require(("--quant" in flags) == (quant.int8_conv.launches > 0),
                        f"evaluate --model {model} {name}: {quant.int8_conv.launches} int8 convs")
                if flags:
                    for keys in (("pck2d", "map2d"), ("pck3d", "map3d")):
                        bar = EVAL_DEPLOY_BARS[name]
                        if model == "yolo" and "--quant" in flags and keys[0] == "pck3d":
                            bar = YOLO_INT8_3D_BAR
                        gap = max(abs(res[flags][k] - res[()][k]) for k in keys)
                        say("deploy", f"evaluate --model {model} {name} against float32: "
                            f"{' and '.join(keys)} within {gap:.4g} (bar {bar})")
                        require(gap <= bar, f"evaluate --model {model} {name} moves "
                                f"{' or '.join(keys)} by {gap:.4g}")
            require(res[()]["pck2d"] > 0.5, f"evaluate --model {model}: pck2d "
                    f"{res[()]['pck2d']} leaves the gate nothing to hold")


def phase_deploy(dev, paths: dict, keep: str) -> dict:
    """Phase 10: the deployment transforms (ops/fold_bn.py, ops/quant.py).
    `paths`: phase 5's frames, weights and float32 outputs of each path.
    (a) every int8 conv shape of the five families against its plain
    version; (b) the fused fold against the unfused one; (c) each serving
    path exact, folded, int8 and both: frames/s, the CNN's ms, its output
    against the float32 slice, the int8 convs it ran; (d) the int8 GEMMs
    alone beside the bf16 convs they replace; (e) `evaluate --fold-bn` and
    `--quant int8` at the metric level. Returns the kernels' launches over
    (c) and (e)."""
    import torch

    from popnet_tpu_torch import (build_openpose_pipeline, build_popnet_pipeline,
                                  build_rtpose_vgg_pipeline, build_yolo_a2j_pipeline,
                                  build_yolo_pipeline)
    from popnet_tpu_torch.interop.from_jax import flat_from_module
    from popnet_tpu_torch.models import A2J
    from popnet_tpu_torch.ops import kernels, quant
    from popnet_tpu_torch.ops.quant import eligible
    from popnet_tpu_torch.serving import deploy_model, unpack_outputs_2d, unpack_outputs_q16

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    weights_a2j = flat_from_module(A2J().init_seeded(A2J_SEED))    # built once, loaded after
    fam = deploy_families(dev, *(paths[k] for k in ("frames", "weights", "frames_pn",
                                                     "weights_pn", "frames_y", "weights_yolo")),
                          weights_a2j, paths["frames_c"], paths["weights_c"])
    # (a), (b)
    for tag, (make, x) in fam.items():
        small = x[:2] if tag.startswith("COCO") else x[:DEPLOY_CHECK]
        pairs, worst = fold_check(tag, make, small)
        msg = f"{tag}: fused fold vs unfused fold in float32 on {len(small)} inputs: {pairs} " \
              f"Conv->BatchNorm pairs, the largest error {worst:.3g} of the bar"
        if tag != "COCO MobileNet":
            model = deploy_model(make(), dev, bf16, quant="int8")
            shapes, calls = int8_exact(tag, model, small.to(bf16))
            msg += f"; {calls} int8 convs, {shapes} shapes, each int32 product equal to its " \
                   f"plain version bit for bit"
            del model
        say("deploy", msg)
    torch.cuda.empty_cache()

    # (c)
    C = MAX_CROPS
    q16 = lambda n: (lambda buf: unpack_outputs_q16(buf, n, 15))   # noqa: E731
    streams = {
        "Open-Pose+": (lambda **kw: build_openpose_pipeline(paths["weights"], pack="q16", **kw),
                       paths["frames"], lambda out, bars, what: check_bf16(
                           f"Open-Pose+ {what}", q16(16)(out), paths["f32_out"], bars, what)),
        "PoP-Net": (lambda **kw: build_popnet_pipeline(paths["weights_pn"], pack="q16", **kw),
                    paths["frames_pn"], lambda out, bars, what: check_bf16(
                        f"PoP-Net {what}", q16(16)(out), paths["f32_out_pn"], bars, what)),
        "Yolo-Pose+": (lambda **kw: build_yolo_pipeline(paths["weights_yolo"], pack="q16", **kw),
                       paths["frames_y"], lambda out, bars, what: check_bf16(
                           f"Yolo-Pose+ {what}", q16(16)(out), paths["f32_out_y"], bars, what)),
        "Yolo->A2J": (lambda **kw: build_yolo_a2j_pipeline(paths["weights_yolo"], weights_a2j,
                                                           pack="q16", max_crops=C, **kw),
                      paths["frames_y"], lambda out, bars, what: check_a2j_bf16(
                          q16(C)(out), paths["f32_out_a2j"], bars, what)),
        "COCO RGB": (lambda **kw: build_rtpose_vgg_pipeline(paths["weights_c"], **kw),
                     paths["frames_c"], lambda out, rel, what: check_coco_bf16(
                         unpack_outputs_2d(out, 16, 18), paths["f32_out_c"], rel, what)),
    }
    cnn = {"Open-Pose+": ("Open-Pose+",), "PoP-Net": ("PoP-Net",), "Yolo-Pose+": ("Yolo-Pose+",),
           "Yolo->A2J": ("Yolo-Pose+", "A2J"), "COCO RGB": ("COCO",)}
    n_int8 = {f: sum(eligible(m) for m in fam[f][0]().modules()) for f in
              ("Open-Pose+", "PoP-Net", "Yolo-Pose+", "A2J", "COCO")}
    table = {}
    say("deploy", f"checks (a) and (b) in {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.synchronize()
    kernels.reset_launches()
    for path, (build, frames, check) in streams.items():
        for name, kw in DEPLOY:
            int8 = "quant" in kw
            bars = INT8_BARS[path] if int8 else ((0.10 if path == "COCO RGB" else (0.80, 0.10)))
            what = "bf16" if name == "exact" else f"{name} bf16"
            pipe = build(**kw)
            want = sum(n_int8[f] for f in cnn[path]) if int8 else 0
            quant.int8_conv.launches = 0
            fps = time_stream(f"{path} {name}", pipe, frames, DEPLOY_BATCHES,
                              lambda buf: check(buf, bars, what),
                              wire="f32" if path == "COCO RGB" else "q16", warm=DEPLOY_WARM)
            torch.cuda.synchronize()
            require(quant.int8_conv.launches == want * (DEPLOY_WARM + DEPLOY_BATCHES),
                    f"{path} {name}: {quant.int8_conv.launches} int8 convs run, {want} a batch expected")
            del pipe
            ms = []
            for f in cnn[path]:
                model = deploy_model(fam[f][0](), dev, bf16, **kw)
                x = fam[f][1].to(bf16)
                with torch.inference_mode():
                    ms.append(time_ms(lambda: model(x), reps=2, warm=1))
                del model, x
            torch.cuda.empty_cache()
            table[(path, name)] = (fps, ms)
            say("deploy", f"{path} {name}: {fps:.1f} frames/s; CNN ms a batch (CUDA events) "
                + ", ".join(f"{f} {m:.3f}" for f, m in zip(cnn[path], ms))
                + (f"; {want} int8 convs a batch, all run on the card" if int8 else ""))

    # (e), launches counted with (c)
    say("deploy", f"(c) done at {time.perf_counter() - t_phase:.1f} s")
    deploy_eval(os.path.join(keep, "eval_bg"))
    say("deploy", f"(e) done at {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("deploy", f"launches per kernel over the transformed serving paths and evaluate: "
        f"{launches}")
    for name in DEPLOY_PATH:
        require(launches[name] >= 1, f"kernel {name} was not launched in phase 10")

    # (d)
    for tag in ("Open-Pose+", "PoP-Net", "Yolo-Pose+", "A2J", "COCO"):
        make, x = fam[tag]
        gemm_breakdown(tag, deploy_model(make(), dev, bf16, quant="int8"), x.to(bf16))
        torch.cuda.empty_cache()

    for path in streams:
        base = table[(path, "exact")]
        say("deploy", f"{path} frames/s exact / fold / int8 / fold+int8: "
            + " / ".join(f"{table[(path, n)][0]:.1f}" for n, _ in DEPLOY)
            + "; CNN ms: " + " / ".join("+".join(f"{m:.3f}" for m in table[(path, n)][1])
                                        for n, _ in DEPLOY)
            + f"; against exact: " + " / ".join(f"{table[(path, n)][0] / base[0]:.3f}x"
                                                for n, _ in DEPLOY[1:]))
    say("deploy", f"(d) done; phase 10 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 11: ITOP ---------------------------------------------------------------------------

ITOP_FRAMES = 64            # frames of the synthetic ITOP training set, and of its validation set
ITOP_BATCH = 32             # the ITOP crop dataset's and the command line's batch
ITOP_EVAL_BATCH = 16        # the ITOP drivers' batch, the ITOP table's
ITOP_EPOCHS = 2             # epochs of each `train --dataset itop` run
ITOP_PAINTED_FRAMES = 32    # KDH3D frames of the painted oracle through the exact decode
ITOP_ORACLE_BARS = {"a2j": 0.995, "openpose": 0.9}   # acc@10cm of the oracle drivers
# `evaluate --dataset itop`, card against --device cpu, the largest joint gaps: Open-Pose+
# (the committed weights) in px and m, read as 0 and 5.96e-6; A2J ((d)'s checkpoint) in
# px and as a share of the largest |3D joint| of the CPU's float64 run, read in float32
# as 0.104 px and 2.28e-5 (of 94593 m: the depth head diverges) and in float64 as 2.2e-10
# px and 4.2e-14; and the card's float32 joints' distance from the CPU's float64 ones
# over the CPU's float32 joints' distance, read as 4.01 (cuDNN's float32 convolutions
# round further than the CPU's)
ITOP_OP_CLI_BARS = (1e-3, 1e-4)
ITOP_A2J_F32_BARS = (0.5, 2e-4)
ITOP_A2J_F64_BARS = (1e-6, 1e-9)
ITOP_A2J_F32_RATIO = 16.0


def itop_a2j_oracle(dataset):
    """infer_a2j for run_itop_a2j_eval over `dataset`, frames in order:
    heads that put the vote's whole weight on anchor 0 (its class logit 60,
    every other 0) and decode to each frame's ground-truth crop labels at
    the driver's crop geometry, returned on the crops' device."""
    import torch

    from popnet_tpu_torch.cli.itop_eval import _gt_uvz
    from popnet_tpu_torch.core.camera import ITOP_INTRINSICS
    from popnet_tpu_torch.data.itop_a2j import CROP, boxes_from_centers, itop_crop_labels
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors

    anchors = shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()).astype(np.float32)
    gt = _gt_uvz(dataset)
    centers = gt[:, 8]
    boxes = boxes_from_centers(centers, dataset.intrinsics or ITOP_INTRINSICS,
                               img_h=dataset.dcfg.height, img_w=dataset.dcfg.width)
    labels = itop_crop_labels(gt, boxes, centers[:, 2].astype(np.float32))
    pos = {"i": 0}

    def infer(crops):
        b = crops.shape[0]
        lab = labels[pos["i"]:pos["i"] + b]
        pos["i"] += b
        cls = np.zeros((b, len(anchors), lab.shape[1]), np.float32)
        cls[:, 0] = 60.0
        reg = np.zeros(cls.shape + (2,), np.float32)
        reg[:, 0] = lab[..., :2] - anchors[0]
        dep = np.zeros_like(cls)
        dep[:, 0] = lab[..., 2]
        return tuple(torch.from_numpy(a).to(crops.device) for a in (cls, reg, dep))

    return infer


def itop_openpose_oracle(dataset, dev):
    """infer for run_itop_openpose_eval over `dataset`, frames in order:
    each frame's ground-truth maps at the network's input geometry, encoded
    on `dev` by the port's encoders (heat, PAF, and z normalized over a 4.5
    m background), returned as (paf, heat, z) NHWC."""
    import torch

    from popnet_tpu_torch.core.config import EncoderConfig
    from popnet_tpu_torch.data.labels import OOB, pack_annotations
    from popnet_tpu_torch.ops.encoders import encode_targets

    ecfg = EncoderConfig()
    sx, sy = ecfg.input_x / dataset.dcfg.width, ecfg.input_y / dataset.dcfg.height
    pos = {"i": 0}

    def infer(images):
        idx = range(pos["i"], pos["i"] + images.shape[0])
        pos["i"] += images.shape[0]
        rows = []
        for i in idx:
            pk = pack_annotations(dataset.anno_dic[dataset.ids[i]], ecfg.max_people,
                                  ecfg.num_joints)
            j2, bb = pk.joints2d.copy(), pk.bboxes.copy()
            j2[pk.valid, :, 0] *= sx
            j2[pk.valid, :, 1] *= sy
            j2[~pk.valid] = OOB
            bb[:, 0::2] *= sx
            bb[:, 1::2] *= sy
            rows.append((j2, pk.joints3d, bb, pk.pose_weights, pk.valid))
        j2, j3, bb, w, v = (torch.from_numpy(np.stack(c)).to(dev) for c in zip(*rows))
        far = torch.full((len(rows), ecfg.zgrid_h, ecfg.zgrid_w), 4.5, device=dev)
        t = encode_targets(j2, j3, bb, w, v, far, ecfg, dataset.dcfg.depth, pose_align=False,
                           with_prior=False)
        return t["pafs"], t["heatmaps"], t["zmaps"]

    return infer


def write_itop_sets(root: str) -> tuple[float, int]:
    """The synthetic ITOP sets under root (cli.itop_table.build_itop, 320x240
    at the ITOP camera): ITOP_FRAMES training frames of seed 0 with
    labels.json, and ITOP_FRAMES validation frames of seed 777, the ITOP
    table's, beside them as val_*.npy with labels_val.json. Returns
    (seconds, frames)."""
    from popnet_tpu_torch.cli.itop_table import build_itop

    t0 = time.perf_counter()
    build_itop(root, ITOP_FRAMES, seed=0)
    val = build_itop(os.path.join(root, "val_set"), ITOP_FRAMES, seed=777)
    with open(val["labels"]) as f:
        labels = json.load(f)
    renamed = {"intrinsics": labels.pop("intrinsics")}
    for name, anns in labels.items():
        shutil.move(os.path.join(val["img_dir"], name), os.path.join(root, "depth_maps",
                                                                      "val_" + name))
        renamed["val_" + name] = anns
    with open(os.path.join(root, "labels_val.json"), "w") as f:
        json.dump(renamed, f)
    shutil.rmtree(os.path.join(root, "val_set"))
    return time.perf_counter() - t0, 2 * ITOP_FRAMES


def itop_datasets(root: str, dev, labels: str = "labels.json"):
    """(KDH3DDataset, MPRealDataset) of a set of write_itop_sets at ITOP
    geometry on `dev`, as the ITOP table builds them."""
    from popnet_tpu_torch.core.config import ITOP_DATASET, EncoderConfig
    from popnet_tpu_torch.data.datasets import KDH3DDataset, MPRealDataset

    paths = (os.path.join(root, "depth_maps"), os.path.join(root, labels))
    return (KDH3DDataset(*paths, ecfg=EncoderConfig(max_people=2), dcfg=ITOP_DATASET, seed=1,
                         device=dev),
            MPRealDataset(*paths, dcfg=ITOP_DATASET, device=dev))


def _pred_joints(data: dict) -> tuple:
    """(2D (P, K, 2), 3D (P, K, 3)) float64 of an eval JSON's people, in order."""
    return tuple(np.asarray([p for img in data[k] for p in img], np.float64)
                 for k in ("human_pred_set_2d", "human_pred_set_3d"))


def itop_a2j_gaps(root: str, ckpt: str, dev, card32: dict, cpu32: dict) -> dict:
    """A2J's joints from the checkpoint `ckpt` on the validation frames of
    write_itop_sets: the float32 JSONs of `evaluate --dataset itop
    --gt-boxes` on the card and the CPU (card32, cpu32), and the same
    driver with the same checkpoint in float64 on both (the crops as
    float32 makes them, the CNN and the vote in float64). Returns the
    scale (the largest |3D joint| of the CPU's float64 run), the largest
    2D (px) and 3D (share of the scale) gaps card against CPU in float32
    and in float64, and each device's float32 3D joints' distance (norm)
    from the CPU's float64 ones."""
    import torch

    from popnet_tpu_torch.cli.main import _build_model, _nchw
    from popnet_tpu_torch.cli.yolo_a2j import run_yolo_a2j_eval

    f64 = {}
    for where in (dev, "cpu"):
        _, ds = itop_datasets(root, where, "labels_val.json")
        net = _build_model("a2j", None, 0, torch.device(where), ckpt).double()
        with torch.inference_mode():
            f64[where] = _pred_joints(run_yolo_a2j_eval(
                None, lambda crops: net(_nchw(crops).double()), ds, ITOP_EVAL_BATCH,
                gt_boxes=True))
    c32, h32, c64, h64 = _pred_joints(card32), _pred_joints(cpu32), f64[dev], f64["cpu"]
    scale = float(np.abs(h64[1]).max())

    def gap(a, b):
        return _maxerr_np(a[0], b[0]), _maxerr_np(a[1], b[1]) / scale

    return {"scale": scale, "f32": gap(c32, h32), "f64": gap(c64, h64),
            "card32_to_f64": float(np.linalg.norm(c32[1] - h64[1])),
            "cpu32_to_f64": float(np.linalg.norm(h32[1] - h64[1]))}


def phase_itop(rng, dev) -> dict:
    """Phase 11, ITOP (see the module docstring); `rng` draws the painted
    oracle's frames. Returns the kernels' launches over (c), (e) and (f)."""
    import tempfile

    import torch

    from popnet_tpu_torch.cli import itop_table
    from popnet_tpu_torch.cli.itop_eval import run_itop_a2j_eval, run_itop_openpose_eval
    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.core.config import ITOP_DATASET
    from popnet_tpu_torch.data.a2j_crops import (CROP, ITOPA2JCropDataset, apply_erasing,
                                                 erasing_draws, erasing_rectangles)
    from popnet_tpu_torch.data.itop_a2j import itop_relative_stats
    from popnet_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        # (a) the sets
        secs, n = write_itop_sets(root)
        say("itop", f"(a) wrote {n} synthetic ITOP frames (320x240, the ITOP camera; "
            f"{ITOP_FRAMES} training of seed 0, {ITOP_FRAMES} validation of seed 777) in "
            f"{secs:.1f} s")

        # (b) the crop dataset and the relative statistics, card against CPU
        t0 = time.perf_counter()
        kc, _ = itop_datasets(root, dev)
        kh, _ = itop_datasets(root, "cpu")
        mean_c, std_c = itop_relative_stats(kc)
        mean_h, std_h = itop_relative_stats(kh)
        rel = max(abs(mean_c - mean_h) / abs(mean_h), abs(std_c - std_h) / std_h)
        require(rel <= 1e-12, f"(b) itop_relative_stats card {mean_c!r}, {std_c!r} against "
                f"CPU {mean_h!r}, {std_h!r}: {rel:.3g} relative")
        idx = np.arange(ITOP_BATCH)
        cds = ITOPA2JCropDataset(kc, seed=0, erase=False, mean=mean_c, std=std_c)
        hds = ITOPA2JCropDataset(kh, seed=0, erase=False, mean=mean_c, std=std_c)
        card, host = cds.get_batch(idx), hds.get_batch(idx)
        require(all(bool(torch.equal(card[k].cpu(), host[k])) for k in host),
                "(b) the ITOP crops or labels differ")
        u, noise = erasing_draws(ITOP_BATCH, CROP, cds.erase_generator)
        rc, rh = erasing_rectangles(u, CROP), erasing_rectangles(u.cpu(), CROP)
        ec = apply_erasing(card["crops"], rc, noise)
        eh = apply_erasing(host["crops"], rh, noise.cpu())
        require(bool(torch.equal(ec.cpu(), eh)), "(b) the erased ITOP crops differ")
        require(int(cds.rng.integers(0, 1 << 30)) == int(hds.rng.integers(0, 1 << 30)),
                "(b) the generators' next draws differ")
        crops = card["crops"]
        say("itop", f"(b) ITOPA2JCropDataset, a batch of {ITOP_BATCH} at {CROP}² with the box "
            f"shifts, made on the card equals the CPU's bit for bit (crops and labels; erasing "
            f"on the card's draws, {int(rc[0].sum())} crops erased); the generators' next "
            f"draws equal; itop_relative_stats card = CPU within {rel:.3g} relative (mean "
            f"{mean_c:.6f}, std {std_c:.6f}); the crops' mean {float(crops.mean()):.4f}, std "
            f"{float(crops.std()):.4f}; {time.perf_counter() - t0:.1f} s")

        # (c) the oracle drivers, card against host, and the exact decode
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        kernels.reset_launches()
        kv, mv = itop_datasets(root, dev, "labels_val.json")
        kvh, mvh = itop_datasets(root, "cpu", "labels_val.json")
        a2j_card = run_itop_a2j_eval(itop_a2j_oracle(kv), kv, ITOP_EVAL_BATCH)
        a2j_host = run_itop_a2j_eval(itop_a2j_oracle(kvh), kvh, ITOP_EVAL_BATCH)
        pc, ph = np.asarray(a2j_card["pred_uvz"]), np.asarray(a2j_host["pred_uvz"])
        err_a2j = _maxerr_np(pc, ph)
        require(err_a2j <= 2.0 ** -18 * float(np.abs(ph).max()),
                f"(c) the A2J oracle's predictions, card against host: {err_a2j:.3g}")
        rec = Recorder(itop_openpose_oracle(mv, dev), "ITOP Open-Pose+ oracle images")
        op_card = run_itop_openpose_eval(rec, mv, ITOP_EVAL_BATCH)
        op_host = run_itop_openpose_eval(rec.replay(), mvh, ITOP_EVAL_BATCH)
        require(op_card == op_host, "(c) the Open-Pose+ oracle's JSON, card against host")
        for name, out in (("a2j", a2j_card), ("openpose", op_card)):
            require(out["acc_10cm"] > ITOP_ORACLE_BARS[name],
                    f"(c) the {name} oracle driver: acc@10cm {out['acc_10cm']}")
        frames, people = person_frames(rng, ITOP_PAINTED_FRAMES, dev, people=True)
        painted = write_eval_set(os.path.join(root, "painted"), frames, people)
        m, abl = painted_oracle(painted, dev, ITOP_EVAL_BATCH, False, fast=False)
        require(all(m[k] > bar for k, bar in ORACLE_BARS.items()) and abl["perfect_2d"] > 0.95,
                f"(c) the painted oracle through the exact decode falls short: {m}, {abl}")
        say("itop", f"(c) oracle drivers on {ITOP_FRAMES} validation frames: A2J acc@10cm "
            f"{a2j_card['acc_10cm']:.4f} (bar {ITOP_ORACLE_BARS['a2j']}), predictions card vs "
            f"host max|err| {err_a2j:.3g}; Open-Pose+ acc@10cm {op_card['acc_10cm']:.4f} (bar "
            f"{ITOP_ORACLE_BARS['openpose']}), JSON card = host bit for bit; the painted "
            f"Open-Pose+ oracle through the exact host decode (fast=False) on "
            f"{ITOP_PAINTED_FRAMES} KDH3D frames: " + json.dumps({k: m[k] for k in ORACLE_BARS})
            + f", perfect_2d {abl['perfect_2d']:.4f}; {time.perf_counter() - t0:.1f} s")
        launches = kernels.launch_counts()

        # (d) train --dataset itop
        train_launches = {}
        for model, extra in (("a2j", []), ("openpose", ["--lr", str(TRAIN_LR)])):
            out = os.path.join(root, f"run_{model}")
            cli = ["train", "--model", model, "--dataset", "itop", "--data-root", root,
                   "--device", str(dev), "--batch-size", str(ITOP_BATCH), "--epochs",
                   str(ITOP_EPOCHS), "--val-labels", "labels_val.json", "--out-dir", out, *extra]
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            trainer = cli_main(cli)
            wall = time.perf_counter() - t0
            train_launches[model] = sum(kernels.launch_counts().values())
            hist = trainer.history
            losses = [h["train_loss"] for h in hist]
            require(train_launches[model] == 0, f"(d) train {model} --dataset itop launched "
                    f"kernels: {kernels.launch_counts()}")
            require(bool(np.isfinite(losses + [h["val_loss"] for h in hist]).all())
                    and losses[-1] < losses[0],
                    f"(d) train --model {model} --dataset itop: the loss is not finite and "
                    f"falling: {hist}")
            what = "crops" if model == "a2j" else "frames"
            say("itop", f"(d) train --model {model} --dataset itop, {ITOP_EPOCHS} epochs of "
                f"{ITOP_FRAMES} frames at batch {ITOP_BATCH}: train losses "
                + ", ".join(f"{x:.4f}" for x in losses) + ", val losses "
                + ", ".join(f"{h['val_loss']:.4f}" for h in hist)
                + f"; e2e train {what}/s over epoch 2 "
                f"{ITOP_FRAMES // ITOP_BATCH * ITOP_BATCH / hist[-1]['train_seconds']:.1f}, "
                f"the call {wall:.1f} s; no kernel launched")
        torch.cuda.synchronize()
        kernels.reset_launches()

        # (e) evaluate --dataset itop: the drivers card against host, the command line
        # card against the CPU
        t0 = time.perf_counter()
        weights = {"openpose": WEIGHTS, "popnet": WEIGHTS_POPNET}
        vpaths = (os.path.join(root, "depth_maps"), os.path.join(root, "labels_val.json"))
        for tag, model, opts in (("openpose", "openpose", {"device_decode": False}),
                                 ("openpose_device_decode", "openpose", {"device_decode": True}),
                                 ("popnet", "popnet", {"readout": "universe"})):
            card, host, timing, _ = eval_family(f"itop {tag}", model, opts, vpaths, dev,
                                                ITOP_EVAL_BATCH, weights, dcfg=ITOP_DATASET)
            compare_eval_json(f"itop {tag}", card, host)
            say("itop", f"(e) the {tag} driver at ITOP geometry (committed weights): "
                f"{ITOP_FRAMES} frames = {ITOP_FRAMES / timing['seconds']:.1f} eval frames/s "
                f"(batch {ITOP_EVAL_BATCH}); "
                f"{sum(len(h) for h in card['human_pred_set_2d'])} people; JSON card = host "
                "bit for bit")
        ev = ["evaluate", "--dataset", "itop", "--data-root", root, "--batch-size",
              str(ITOP_EVAL_BATCH)]

        def evaluate(model, flags, labels, device, out):
            m = cli_main([*ev, "--model", model, *flags, "--labels", labels, "--device", device,
                          "--out-dir", os.path.join(root, out)])
            with open(os.path.join(root, out, f"{model}_results.json")) as f:
                return m, json.load(f)

        def json_gap(card, cpu):
            """(the same people in each of the CPU's frames, the largest 2D and
            3D gaps over the people of both)."""
            n = len(cpu["human_gt_set_2d"])
            require(card["human_gt_set_2d"][:n] == cpu["human_gt_set_2d"],
                    "(e) evaluate --dataset itop: the GT lists differ")
            same = [len(h) for h in card["human_pred_set_2d"][:n]] == [
                len(h) for h in cpu["human_pred_set_2d"]]
            return (same, *(max((_maxerr_np(a, b) for ia, ib in zip(card[k], cpu[k])
                                 for a, b in zip(ia, ib)), default=0.0)
                            for k in ("human_pred_set_2d", "human_pred_set_3d")))

        four = tuple(ORACLE_BARS)
        t1 = time.perf_counter()
        m_card, j_card = evaluate("openpose", ["--weights", WEIGHTS], "labels_val.json", str(dev),
                                  "ev_op")
        secs = time.perf_counter() - t1
        m_cpu, j_cpu = evaluate("openpose", ["--weights", WEIGHTS], "labels_val.json", "cpu",
                                "evc_op")
        same, e2, e3 = json_gap(j_card, j_cpu)
        say("itop", f"(e) python -m popnet_tpu_torch.cli.main evaluate --dataset itop --model "
            f"openpose --weights: {ITOP_FRAMES} frames on the card in {secs:.2f} s = "
            f"{ITOP_FRAMES / secs:.1f} eval frames/s (the call), metrics "
            + json.dumps({k: m_card[k] for k in four}) + f"; with --device cpu: "
            f"{'the same' if same else 'other'} people, the people in common within {e2:.3g} "
            f"px and {e3:.3g} m (bars {ITOP_OP_CLI_BARS}), metrics "
            + json.dumps({k: m_cpu[k] for k in four}))
        require(same and e2 <= ITOP_OP_CLI_BARS[0] and e3 <= ITOP_OP_CLI_BARS[1],
                "(e) evaluate --model openpose --dataset itop, card against CPU")
        ckpt = os.path.join(root, "run_a2j", "ckpt")
        t1 = time.perf_counter()
        m_card, j_card = evaluate("a2j", ["--gt-boxes", "--ckpt", ckpt], "labels_val.json",
                                  str(dev), "ev_a2j")
        secs = time.perf_counter() - t1
        m_cpu, j_cpu = evaluate("a2j", ["--gt-boxes", "--ckpt", ckpt], "labels_val.json", "cpu",
                                "evc_a2j")
        same = json_gap(j_card, j_cpu)[0]
        g = itop_a2j_gaps(root, ckpt, dev, j_card, j_cpu)
        ratio = g["card32_to_f64"] / max(g["cpu32_to_f64"], 1e-300)
        say("itop", f"(e) python -m popnet_tpu_torch.cli.main evaluate --dataset itop --model a2j "
            f"--gt-boxes --ckpt (d)'s run: {ITOP_FRAMES} frames on the card in {secs:.2f} s = "
            f"{ITOP_FRAMES / secs:.1f} eval frames/s (the call), metrics "
            + json.dumps({k: m_card[k] for k in four}) + "; with --device cpu: "
            f"{'the same' if same else 'other'} people, metrics "
            + json.dumps({k: m_cpu[k] for k in four}) + f"; largest |3D joint| {g['scale']:.6g} "
            f"m (CPU, float64); card against CPU, float32 {g['f32'][0]:.6g} px and "
            f"{g['f32'][1]:.6g} of it (bars {ITOP_A2J_F32_BARS}), float64 {g['f64'][0]:.6g} px "
            f"and {g['f64'][1]:.6g} of it (bars {ITOP_A2J_F64_BARS}); the float32 3D joints' "
            f"distance from the CPU's float64 ones, card {g['card32_to_f64']:.6g}, CPU "
            f"{g['cpu32_to_f64']:.6g} m (ratio {ratio:.3g}, bar {ITOP_A2J_F32_RATIO})")
        require(same and all(g[k][i] <= bars[i] for k, bars in
                             (("f32", ITOP_A2J_F32_BARS), ("f64", ITOP_A2J_F64_BARS))
                             for i in (0, 1)) and ratio <= ITOP_A2J_F32_RATIO,
                "(e) evaluate --model a2j --dataset itop --ckpt, card against CPU")
        say("itop", f"(e) in {time.perf_counter() - t0:.1f} s")

        # (f) the ITOP table at a tiny budget
        t0 = time.perf_counter()
        env = {"ITOP_TRAIN": "32", "ITOP_VAL": "16", "ITOP_EPOCHS": "2", "ITOP_A2J_EPOCHS": "2",
               "ITOP_CHUNK": "1", "ITOP_BATCH": "16", "ITOP_WARMUP": "1",
               "ITOP_DIR": os.path.join(root, "table"),
               "ITOP_OUT": os.path.join(root, "table.json")}
        saved = {k: os.environ.get(k) for k in [*env, "ITOP_CPU", "ITOP_METHODS"]}
        os.environ.update(env)
        os.environ.pop("ITOP_CPU", None)
        os.environ.pop("ITOP_METHODS", None)
        try:
            table = itop_table.main()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        require(all(table["methods"][m].get("done") for m in ("a2j", "openpose"))
                and table["device"]["platform"] == "gpu",
                f"(f) the ITOP table did not finish: {table}")
        say("itop", "(f) python -m popnet_tpu_torch.cli.itop_table at a tiny budget (32 training "
            "and 16 validation frames, 2 epochs a row, batch 16): acc@10cm "
            + json.dumps({m: table["methods"][m]["final"]["acc_10cm"] for m in table["methods"]})
            + f", device {table['device']}; {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = {k: v + launches[k] for k, v in kernels.launch_counts().items()}
    say("itop", f"launches per kernel over (c), (e) and (f): {launches}")
    for name in EVAL_PATH:          # the eval path's kernels, at ITOP geometry
        require(launches[name] >= 1, f"kernel {name} was not launched in phase 11")
    say("itop", f"phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 12: COCO and MPII RGB training ---------------------------------------------------------

RGB_FRAME = (480, 640)      # the RGB sets' BGR frames, (H, W)
RGB_TRAIN_FRAMES = 64       # frames of each training set, and of each validation set:
RGB_VAL_FRAMES = 16
RGB_INPUT = 368             # the command lines' --input-size, the models' full width
RGB_BATCH = 32              # the command lines' batch
RGB_EPOCHS = 2
RGB_STEP_INPUT = 64         # the card-against-CPU step check's input and frames
RGB_STEP_BATCH = 4
RGB_SEED = 0                # the seeded RTPoseVGG and PopNetRGB of the step check
RGB_QUALITY = 90            # the RGB sets' IJG JPEG quality (encode_jpeg)
RGB_TIMED = 16              # frames of each host-stage timing
COCO_AUG_FLAGS = ["--rotate-aug", "30", "--scale-jitter", "0.6,1.0", "--blur-aug", "1.5"]
COCO_AUG = {"rotate_max_deg": 30.0, "scale_jitter": (0.6, 1.0), "blur_max_sigma": 1.5}
RGB_FAMILIES = {"coco": "rtpose_vgg", "mpii": "popnet_rgb"}
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
RGB_MAPS_EXACT = ("image", "scale", "valid", "prior_mask_conf", "prior_mask_coord",
                  "prior_weight_map", "fg_masks_align")

# a person's 17 COCO keypoints in units of its height, feet at (0, 0), facing the camera
RGB_PERSON = np.array([[0.0, -0.92], [0.03, -0.95], [-0.03, -0.95], [0.06, -0.93], [-0.06, -0.93],
                       [0.12, -0.80], [-0.12, -0.80], [0.18, -0.62], [-0.18, -0.62],
                       [0.20, -0.45], [-0.20, -0.45], [0.08, -0.48], [-0.08, -0.48],
                       [0.09, -0.25], [-0.09, -0.25], [0.09, -0.02], [-0.09, -0.02]])
RGB_BONES = ((5, 7), (7, 9), (6, 8), (8, 10), (5, 6), (11, 12), (5, 11), (6, 12), (11, 13),
             (13, 15), (12, 14), (14, 16), (0, 5), (0, 6), (1, 3), (2, 4))


def draw_person(img, xs, ys, pts, colour, height: float) -> None:
    """Paint a person's bones (RGB_BONES between its 17 points `pts`) into
    the float (H, W, 3) image in `colour`, each a capsule of radius 0.03 x
    height; xs, ys the image's pixel coordinates."""
    H, W = img.shape[:2]
    for a, b in RGB_BONES:
        (x0, y0), (x1, y1) = pts[a], pts[b]
        r = 0.03 * height
        lo_x, hi_x = int(max(min(x0, x1) - r, 0)), int(min(max(x0, x1) + r + 1, W))
        lo_y, hi_y = int(max(min(y0, y1) - r, 0)), int(min(max(y0, y1) + r + 1, H))
        if lo_x >= hi_x or lo_y >= hi_y:
            continue
        px, py = xs[lo_y:hi_y, lo_x:hi_x], ys[lo_y:hi_y, lo_x:hi_x]
        dx, dy = x1 - x0, y1 - y0
        t = np.clip(((px - x0) * dx + (py - y0) * dy) / max(dx * dx + dy * dy, 1e-6), 0, 1)
        near = (px - x0 - t * dx) ** 2 + (py - y0 - t * dy) ** 2 <= r * r
        img[lo_y:hi_y, lo_x:hi_x][near] = colour


def rgb_frames(rng, n: int, H: int = RGB_FRAME[0], W: int = RGB_FRAME[1]):
    """n BGR frames of 1-3 painted people over smooth colour, with the
    people's COCO-17 keypoints (x, y, v): per frame an (P, 17, 3) array,
    v = 2 inside the frame (a few 1 or 0 at random), 0 outside."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    frames, people = [], []
    for _ in range(n):
        ph = rng.uniform(0, 2 * np.pi, 3)
        bg = np.stack([96 + 60 * np.sin(xs / rng.uniform(40, 120) + ph[c])
                       * np.cos(ys / rng.uniform(50, 150) + ph[c] / 2) for c in range(3)], -1)
        img = bg + rng.normal(0, 6, (H, W, 3))
        kps = []
        for _ in range(rng.integers(1, 4)):
            height = rng.uniform(150, 380)
            foot = np.array([rng.uniform(40, W - 40), rng.uniform(0.45 * H, H + 20)])
            pts = foot + height * (RGB_PERSON + rng.normal(0, 0.015, RGB_PERSON.shape))
            draw_person(img, xs, ys, pts, rng.uniform(20, 235, 3), height)
            inside = (pts[:, 0] >= 0) & (pts[:, 0] < W) & (pts[:, 1] >= 0) & (pts[:, 1] < H)
            v = np.where(inside, rng.choice([2, 2, 2, 2, 1, 0], 17), 0)
            kps.append(np.concatenate([pts, v[:, None]], 1))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        people.append(np.stack(kps))
    return frames, people


def _mpii_joints(kp17: np.ndarray) -> tuple[list, list]:
    """COCO-17 keypoints -> the 16 MPII joints (pelvis, thorax, neck and head
    top from their neighbours) and their visibility flags."""
    p, v = kp17[:, :2], kp17[:, 2] > 0
    pelvis, thorax = (p[11] + p[12]) / 2, (p[5] + p[6]) / 2
    rows = [(p[16], v[16]), (p[14], v[14]), (p[12], v[12]), (p[11], v[11]), (p[13], v[13]),
            (p[15], v[15]), (pelvis, v[11] & v[12]), (thorax, v[5] & v[6]),
            (thorax + 0.35 * (p[0] - thorax), v[0]), (p[0] + 1.2 * (p[0] - thorax) * 0.3, v[0]),
            (p[10], v[10]), (p[8], v[8]), (p[6], v[6]), (p[5], v[5]), (p[7], v[7]), (p[9], v[9])]
    return [list(map(float, j)) for j, _ in rows], [int(f) for _, f in rows]


def write_rgb_sets(rng, root: str, n_train: int = RGB_TRAIN_FRAMES,
                   n_val: int = RGB_VAL_FRAMES) -> float:
    """n_train + n_val painted frames as JPEG (encode_jpeg) under
    root/images, their people as COCO person_keypoints JSONs (coco_train.json,
    coco_val.json) and MPII JSON releases (mpii_train.json, mpii_val.json).
    Returns the writer's ms a frame."""
    from popnet_tpu_torch.data.image_io import encode_jpeg

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    frames, people = rgb_frames(rng, n_train + n_val)
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        with open(os.path.join(root, "images", f"{i:06d}.jpg"), "wb") as fh:
            fh.write(encode_jpeg(f, RGB_QUALITY))
    write_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    H, W = RGB_FRAME
    for split, lo, hi in (("train", 0, n_train), ("val", n_train, n_train + n_val)):
        images, anns, mpii = [], [], []
        for i in range(lo, hi):
            name = f"{i:06d}.jpg"
            images.append({"id": i, "file_name": name, "height": H, "width": W})
            for kp in people[i]:
                x0, y0 = kp[:, :2].min(0)
                x1, y1 = kp[:, :2].max(0)
                anns.append({"id": len(anns), "image_id": i, "iscrowd": 0,
                             "keypoints": [float(x) for x in kp.ravel()],
                             "num_keypoints": int((kp[:, 2] > 0).sum()),
                             "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]})
                joints, vis = _mpii_joints(kp)
                mpii.append({"image": name, "joints": joints, "joints_vis": vis})
        with open(os.path.join(root, f"coco_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
        with open(os.path.join(root, f"mpii_{split}.json"), "w") as f:
            json.dump(mpii, f)
    return write_ms


def rgb_dataset(root: str, dataset: str, dev, size: int = RGB_INPUT,
                labels: str | None = None, is_train: bool = True):
    """The command line's training dataset of `dataset` ("coco" with
    COCO_AUG and flips, "mpii" with flips) on `dev`, seed 0."""
    labels = labels or f"{dataset}_train.json"
    images, ann = os.path.join(root, "images"), os.path.join(root, labels)
    if dataset == "coco":
        from popnet_tpu_torch.data.coco_dataset import CocoKeypointsDataset

        return CocoKeypointsDataset(images, ann, input_y=size, input_x=size, is_train=is_train,
                                    seed=0, device=dev, **COCO_AUG)
    from popnet_tpu_torch.data.mpii import MPIIKeypointsDataset

    return MPIIKeypointsDataset(images, ann, input_y=size, input_x=size, is_train=is_train,
                                seed=0, device=dev)


def compare_rgb_batches(tag: str, card: dict, host: dict) -> float:
    """An RGB batch made on the card against the CPU's: the image, scales,
    valid flags, masks and prior targets bit for bit, the heat, PAF and
    align maps within TARGETS_BAR (torch.exp rounds apart by device).
    Returns the largest error of those."""
    import torch

    require(set(card) == set(host), f"{tag}: the batches' keys differ")
    worst = 0.0
    for k, h in host.items():
        c = card[k].cpu()
        require(c.shape == h.shape and c.dtype == h.dtype, f"{tag} {k}: shape or type differs")
        if k in RGB_MAPS_EXACT or k == "prior_map":
            require(bool(torch.equal(c, h)), f"{tag} {k}: card and CPU differ")
        else:
            err = _maxerr(c, h)
            require(err <= TARGETS_BAR, f"{tag} {k}: card and CPU {err:.3g} apart")
            worst = max(worst, err)
    return worst


def rgb_one_step(family: str, batch: dict, dev, dtype):
    """`one_step` for the RGB families: one SGD-Nesterov step (TRAIN_LR) of
    RTPoseVGG (VGG19 trunk) or PopNetRGB from its seeded init (RGB_SEED),
    on `dev` in `dtype`, TF32 off and cuDNN deterministic."""
    import torch

    from popnet_tpu_torch.models import PopNetRGB, RTPoseVGG
    from popnet_tpu_torch.models.layers import ConvBN
    from popnet_tpu_torch.train import steps
    from popnet_tpu_torch.train.state import TrainState, make_optimizer

    model = (RTPoseVGG() if family == "rtpose_vgg" else PopNetRGB()).init_seeded(RGB_SEED)
    model = model.to(dev, dtype)
    step = (steps.make_rtpose_vgg_train_step() if family == "rtpose_vgg"
            else steps.make_popnet_rgb_train_step())
    zero = {f"{n}.Conv_0.bias" for n, m in model.named_modules()
            if isinstance(m, ConvBN) and m.norm and m.Conv_0.bias is not None}
    state = TrainState(model, make_optimizer(model, "sgd", TRAIN_LR))
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    b = {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev)) for k, v in batch.items()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False, deterministic=True):
        state, logs = step(state, b)
    after = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return float(logs["loss"]), before, after, zero


def check_jpeg_fixtures() -> tuple[int, int]:
    """(a): each committed fixture decoded by the port's reader to the sha256
    cv2.imread's output had (tests/fixtures/jpeg/hashes.json), the
    progressive ones refused. Returns (decoded, refused)."""
    import hashlib

    from popnet_tpu_torch.data.image_io import imread_bgr

    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        recorded = json.load(f)
    for name, digest in recorded["decoded"].items():
        got = hashlib.sha256(imread_bgr(os.path.join(FIXTURES, name)).tobytes()).hexdigest()
        require(got == digest, f"(a) the reader's {name} differs from cv2.imread's")
    for name in recorded["refused"]:
        try:
            imread_bgr(os.path.join(FIXTURES, name))
        except ValueError as e:
            require("progressive" in str(e) and name in str(e), f"(a) {name}: {e}")
        else:
            raise AssertionError(f"(a) the reader decoded {name}")
    return len(recorded["decoded"]), len(recorded["refused"])


def host_stage_ms(root: str, n: int = RGB_TIMED) -> dict:
    """ms an image of each host transform on the set's first n frames, one
    thread, after a warm call of each: the JPEG read, the rotation (30
    degrees, cubic), the blur (sigma 1.5) and the letterbox resize to
    RGB_INPUT."""
    from popnet_tpu_torch.data.augment_host import resize_linear_u8
    from popnet_tpu_torch.data.coco_dataset import blur_image, rotate_bound
    from popnet_tpu_torch.data.image_io import imread_bgr

    paths = [os.path.join(root, "images", f"{i:06d}.jpg") for i in range(n)]
    warm = imread_bgr(paths[0])             # the first calls build, load and import
    blur_image(rotate_bound(warm, 30.0)[0], 1.5)
    resize_linear_u8(warm, 64, 48)
    t0 = time.perf_counter()
    imgs = [imread_bgr(p) for p in paths]
    out = {"decode": time.perf_counter() - t0}
    t0 = time.perf_counter()
    rot = [rotate_bound(im, 30.0)[0] for im in imgs]
    out["rotate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for im in rot:
        blur_image(im, 1.5)
    out["blur"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for im in imgs:
        h, w = im.shape[:2]
        s = min(RGB_INPUT / h, RGB_INPUT / w)
        resize_linear_u8(im, int(round(w * s)), int(round(h * s)))
    out["resize"] = time.perf_counter() - t0
    return {k: v * 1e3 / n for k, v in out.items()}


def phase_rgb(rng, dev) -> dict:
    """Phase 12, COCO and MPII RGB training (see the module docstring).
    Returns the kernels' launches over the training runs (none expected)."""
    import tempfile

    import torch

    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.data.coco_dataset import HOST_WORKERS
    from popnet_tpu_torch.models import PopNetRGB, RTPoseVGG
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.train import checkpoint, steps
    from popnet_tpu_torch.train.steps import _nchw

    t_phase = time.perf_counter()
    host_threads = min(HOST_WORKERS, os.cpu_count() or 1)
    torch.cuda.empty_cache()                 # the earlier phases' cached blocks
    n_ok, n_refused = check_jpeg_fixtures()
    say("rgb", f"(a) the JPEG reader (csrc/jpeg_decode.cpp, built with the host C++ compiler) on "
        f"the {n_ok + n_refused} committed fixtures: {n_ok} decode to cv2.imread's recorded "
        f"sha256 (4:4:4, 4:2:2, 4:2:0 with restart markers, 4:4:0, 4:1:1 with optimized tables, "
        f"grey, 1x1, an EXIF orientation 6), {n_refused} progressive refused by name")
    launches = {k.__name__: 0 for k in kernels.KERNELS}
    with tempfile.TemporaryDirectory() as root:
        write_ms = write_rgb_sets(rng, root)
        ms = host_stage_ms(root)
        say("rgb", f"(b) wrote {RGB_TRAIN_FRAMES} + {RGB_VAL_FRAMES} frames of "
            f"{RGB_FRAME[1]}x{RGB_FRAME[0]} BGR with painted people as baseline JPEG (encode_jpeg, "
            f"cv2.imencode's 4:2:0 bytes, quality {RGB_QUALITY}, {write_ms:.1f} ms a frame) and their "
            f"COCO and MPII labels; host transforms, ms an image over {RGB_TIMED} frames, one "
            "thread: " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
        idx = np.arange(RGB_BATCH)
        for dataset, family in RGB_FAMILIES.items():
            t0 = time.perf_counter()
            cds, hds = rgb_dataset(root, dataset, dev), rgb_dataset(root, dataset, "cpu")
            card, host = cds.get_batch(idx), hds.get_batch(idx)
            err = compare_rgb_batches(dataset, card, host)
            require(cds.rng.bit_generator.state == hds.rng.bit_generator.state,
                    f"{dataset}: the generators differ after a batch")
            people = int(host["valid"].sum()) if "valid" in host else int(
                host["prior_mask_coord"].sum())
            say("rgb", f"({'b' if dataset == 'coco' else 'c'}) {type(cds).__name__}, a batch of "
                f"{RGB_BATCH} at {RGB_INPUT}² "
                + ("(rotation, scale jitter, blur and flips) " if dataset == "coco" else
                   "(flips) ")
                + f"made on the card equals the CPU's: image, scales, masks and prior targets "
                f"bit for bit, maps within {err:.3g} (bar {TARGETS_BAR}); the generators equal; "
                f"{people} people; {time.perf_counter() - t0:.1f} s")
            del card, host

            # the step, card against CPU, on a small input
            sc, sh = (rgb_dataset(root, dataset, d, RGB_STEP_INPUT) for d in (dev, "cpu"))
            sidx = np.arange(RGB_STEP_BATCH)
            train_step_checks(f"{dataset} {family}", family, sc.get_batch(sidx),
                              sh.get_batch(sidx), dev)

            # the command line: 2 epochs, and 1 epoch + --resume 1 against it
            cli = ["train", "--dataset", dataset, "--model", family, "--data-root", root,
                   "--labels", f"{dataset}_train.json", "--val-labels", f"{dataset}_val.json",
                   "--device", str(dev), "--input-size", str(RGB_INPUT), "--batch-size",
                   str(RGB_BATCH), "--lr", str(TRAIN_LR)]
            if dataset == "coco":
                cli += ["--trunk", "vgg19", *COCO_AUG_FLAGS]
            whole, split = os.path.join(root, f"{dataset}_whole"), os.path.join(root, f"{dataset}_split")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with torch.backends.cudnn.flags(enabled=True, deterministic=True):
                trainer = cli_main([*cli, "--epochs", str(RGB_EPOCHS), "--out-dir", whole])
                wall = time.perf_counter() - t0
                mem = torch.cuda.max_memory_allocated() / 2**20
                cli_main([*cli, "--epochs", "1", "--out-dir", split])
                cli_main([*cli, "--epochs", "1", "--out-dir", split, "--resume"])
            torch.cuda.synchronize()
            for k, v in kernels.launch_counts().items():
                launches[k] += v
            hist = trainer.history
            losses = [h["train_loss"] for h in hist]
            require(len(hist) == RGB_EPOCHS
                    and bool(np.isfinite(losses + [h["val_loss"] for h in hist]).all())
                    and losses[-1] < losses[0],
                    f"train --dataset {dataset}: the loss is not finite and falling: {hist}")
            a, _, sa = checkpoint.restore_checkpoint(os.path.join(whole, "ckpt"))
            b, _, sb = checkpoint.restore_checkpoint(os.path.join(split, "ckpt"))
            same = sa == sb == RGB_EPOCHS - 1 and all(torch.equal(v, b["model"][k])
                                                      for k, v in a["model"].items())
            same = same and all(torch.equal(v, b["optimizer"]["state"][i][k])
                                for i, st in a["optimizer"]["state"].items()
                                for k, v in st.items())
            hists = [[{k: v for k, v in json.loads(x).items() if k != "train_seconds"}
                      for x in open(os.path.join(d, "history.jsonl"))] for d in (whole, split)]
            require(same and hists[0] == hists[1], f"train --dataset {dataset}: 1 epoch + "
                    f"--resume 1 differs from {RGB_EPOCHS} epochs in one call")
            shutil.rmtree(whole)
            shutil.rmtree(split)
            n_train = RGB_TRAIN_FRAMES // RGB_BATCH * RGB_BATCH
            e2e = n_train / hist[-1]["train_seconds"]

            # the input pipeline and its host stage alone, the step alone
            ds = rgb_dataset(root, dataset, dev)
            t0, n = time.perf_counter(), 0
            for bt in ds.iter_batches(RGB_BATCH):
                torch.cuda.synchronize()
                n += bt["image"].shape[0]
            pipe = n / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for s0 in range(0, n_train, RGB_BATCH):
                ds.get_batch_host(np.arange(s0, s0 + RGB_BATCH))
            host_rate = n_train / (time.perf_counter() - t0)
            batch = ds.get_batch(idx)
            state = trainer.state
            step = (steps.make_rtpose_vgg_train_step() if family == "rtpose_vgg"
                    else steps.make_popnet_rgb_train_step())
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                step_ms = time_ms(lambda: step(state, batch), reps=5, warm=2)
            net = (RTPoseVGG() if family == "rtpose_vgg" else PopNetRGB()).to(dev).eval()
            with torch.no_grad():
                flops = 3.0 * conv_flops(net, _nchw(batch["image"]))
            del batch, state, trainer, net
            torch.cuda.empty_cache()
            say("rgb", f"({'b' if dataset == 'coco' else 'c'}) python -m popnet_tpu_torch.cli.main "
                f"train --dataset {dataset} --model {family}"
                + (" --trunk vgg19 " + " ".join(COCO_AUG_FLAGS) if dataset == "coco" else "")
                + f" --input-size {RGB_INPUT} --batch-size {RGB_BATCH} --epochs {RGB_EPOCHS} "
                f"--lr {TRAIN_LR} (float32, TF32 off, cuDNN deterministic): losses " + ", ".join(
                    f"epoch {h['epoch']} train {h['train_loss']:.5f} val {h['val_loss']:.5f}"
                    for h in hist)
                + f"; (d) e2e train {e2e:.1f} frames/s over epoch {RGB_EPOCHS} ({n_train} frames, "
                f"{hist[-1]['train_seconds']:.3f} s, host clock); input pipeline alone {pipe:.1f} "
                f"frames/s, its host stage alone {host_rate:.1f} frames/s (1 epoch each, "
                f"{host_threads} host threads); step {step_ms:.3f} ms at batch {RGB_BATCH} (CUDA "
                f"events) = {RGB_BATCH / step_ms * 1e3:.1f} frames/s, {flops / 1e12:.3f} TFLOP (3 x "
                f"the convolutions' forward) = {flops / step_ms / 1e9:.1f} TFLOP/s; "
                f"max_memory_allocated {mem:.1f} MiB; the command {wall:.1f} s; 1 epoch + "
                f"--resume 1 equals {RGB_EPOCHS} in one call bit for bit (parameters, momentum, "
                f"history)")
    say("rgb", f"launches per kernel over the RGB training runs: {launches} (none expected)")
    require(not any(launches.values()), "the RGB training path launched a kernel")
    say("rgb", f"phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return launches


EVAL_IMAGES = ((480, 640), (640, 480), (427, 640), (640, 427))  # (H, W) of phase 13's images
EVAL_DEST = 368             # the evaluation canvas's short side (crop_with_factor)
EVAL_TIMED = 5              # timed rgb_infer + decode calls an image and setting
EVAL_CROP_ROWS = (426, 360)  # 640x426 and 640x360 images cut from the third: maps 46x70, 46x82
ROUTE_BATCH = 64            # the batch at which phase 13 (b) also times find_peaks_plane and K2
EVAL_MAP_BAR = 1e-4         # card against CPU maps, float32, over the maps' largest magnitude
ORACLE_AP_BAR = 0.9         # the GT-map oracle's COCO AP through the vendored scorer
GENAUG_FRAMES = 48          # frames of each generate-augset set (and recordings a location)


def eval_people(rng, H: int, W: int) -> np.ndarray:
    """2 or 3 standing people of RGB_PERSON's template side by side inside an
    H x W frame, 150 px tall at least: (P, 17, 3) COCO keypoints, v = 2."""
    n = int(rng.integers(2, 4))
    people = []
    for p in range(n):
        height = rng.uniform(150, min(0.85 * H, 1.8 * W / n))
        foot = np.array([(p + 0.5) * W / n + rng.uniform(-8, 8),
                         rng.uniform(0.96 * height + 4, H - 4)])
        pts = foot + height * (RGB_PERSON + rng.normal(0, 0.01, RGB_PERSON.shape))
        people.append(np.concatenate([pts, np.full((17, 1), 2.0)], 1))
    return np.stack(people)


def eval_images(rng, root: str, sizes=EVAL_IMAGES):
    """Phase 13's images, one at each (H, W) of `sizes`: painted people
    (eval_people) over smooth colour, written as baseline JPEG under root
    and read back by the port's reader; and their person_keypoints JSON.
    Returns (BGR uint8 images, people, the JSON's path)."""
    from popnet_tpu_torch.data.image_io import encode_jpeg, imread_bgr

    images, people, anns, infos = [], [], [], []
    for i, (H, W) in enumerate(sizes):
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        ph = rng.uniform(0, 2 * np.pi, 3)
        img = np.stack([96 + 60 * np.sin(xs / 90 + ph[c]) * np.cos(ys / 110 + ph[c] / 2)
                        for c in range(3)], -1) + rng.normal(0, 6, (H, W, 3))
        kps = eval_people(rng, H, W)
        for kp in kps:
            draw_person(img, xs, ys, kp[:, :2], rng.uniform(20, 235, 3), np.ptp(kp[:, 1]) / 0.9)
            x0, y0 = kp[:, :2].min(0) - 6
            x1, y1 = kp[:, :2].max(0) + 6
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
                         "keypoints": [float(v) for v in kp.ravel()], "num_keypoints": 17,
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "area": float((x1 - x0) * (y1 - y0))})
        path = os.path.join(root, f"{i:06d}.jpg")
        with open(path, "wb") as f:
            f.write(encode_jpeg(np.clip(img, 0, 255).astype(np.uint8), RGB_QUALITY))
        images.append(imread_bgr(path))
        people.append(kps)
        infos.append({"id": i, "file_name": os.path.basename(path), "height": H, "width": W})
    gt = os.path.join(root, "person_keypoints_eval.json")
    with open(gt, "w") as f:
        json.dump({"images": infos, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return images, people, gt


def oracle_maps(kps: np.ndarray, canvas_hw, scale: float, dev):
    """GT-encoded COCO maps of the people (P, 17, 3) on an evaluation canvas
    (H', W') at `scale`, by the port's encoders on `dev`: heat (1, H'/8,
    W'/8, 19) and paf (1, H'/8, W'/8, 38)."""
    import torch

    from popnet_tpu_torch.core.config import EncoderConfig
    from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS
    from popnet_tpu_torch.data.coco import coco17_to_rtpose18
    from popnet_tpu_torch.ops.encoders import encode_heatmaps, encode_pafs

    cfg = EncoderConfig(input_x=canvas_hw[1], input_y=canvas_hw[0], num_joints=COCO_NUM_JOINTS,
                        num_limbs=len(COCO_LIMBS))
    j2 = np.full((1, cfg.max_people, COCO_NUM_JOINTS, 2), -1e6, np.float32)
    valid = np.zeros((1, cfg.max_people), bool)
    for p, kp in enumerate(kps):
        joints, vis = coco17_to_rtpose18(kp)
        j2[0, p] = np.where(vis[:, None] > 0, joints * scale, -1e6)
        valid[0, p] = True
    j2_t, v_t = torch.as_tensor(j2, device=dev), torch.as_tensor(valid, device=dev)
    return encode_heatmaps(j2_t, v_t, cfg), encode_pafs(j2_t, v_t, cfg, limbs=COCO_LIMBS)


def decoded_results(out, image_id: int) -> list:
    """A paf_decode_2d output of one image -> its COCO results, each
    person's score the mean confidence of its found joints."""
    from popnet_tpu_torch.data.coco import coco_eval_results

    n = int(out["counts"][0])
    joints, conf = out["joints2d"][0, :n].cpu().numpy(), out["conf"][0, :n].cpu().numpy()
    scores = [float(c[c > 0].mean()) for c in conf]
    return coco_eval_results([joints], [image_id], [scores])


def tree_bytes(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def check_eval_kernels(tag: str, heat, paf) -> int:
    """find_peaks (as it routes one frame of these maps), K3 and K6 on
    (1, H, W, 19) heat and (1, H, W, 38) PAF maps on the card, each exact
    against its plain version; returns the valid peaks."""
    from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS as K
    from popnet_tpu_torch.decode.assemble_device import assemble_inputs
    from popnet_tpu_torch.decode.device import find_peaks_batched, peak_planes
    from popnet_tpu_torch.ops import kernels

    h = peak_planes(heat, K)
    for a, b, n in zip(kernels.find_peaks(h), kernels.find_peaks_plain(h), PEAK_OUTPUTS):
        _exact(f"{tag} find_peaks {n}", a, b)
    peaks, valid = find_peaks_batched(heat, num_joints=K)
    sk, okk = kernels.paf_score(paf, peaks, valid, COCO_LIMBS)
    sp, okp = kernels.paf_score_plain(paf, peaks, valid, COCO_LIMBS)
    _exact(f"{tag} paf_score score", sk, sp)
    _exact(f"{tag} paf_score ok", okk, okp)
    ps, sm = assemble_inputs(peaks, sk, okk)
    for a, b, n in zip(kernels.assemble_ids(ps, sm, COCO_LIMBS),
                       kernels.assemble_ids_plain(ps, sm, COCO_LIMBS), ("ids", "counts")):
        _exact(f"{tag} assemble_ids {n}", a, b)
    return int(valid.sum())


def phase_coco_eval(rng, dev) -> dict:
    """Phase 13, COCO evaluation at the evaluation canvas and MP-3DHP set
    construction (see the module docstring). Returns each kernel's
    launches at each canvas of (a) and (b)'s times of find_peaks_plane
    beside K2's."""
    import torch

    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.core.config import DecodeConfig
    from popnet_tpu_torch.core.skeleton_coco import (COCO_LIMBS, COCO_NUM_JOINTS,
                                                     COCO_SWAP_INDICES)
    from popnet_tpu_torch.data.coco import run_coco_eval
    from popnet_tpu_torch.data.preprocessing import crop_with_factor, rgb_infer
    from popnet_tpu_torch.decode.device import peak_planes
    from popnet_tpu_torch.decode.openpose_infer import paf_decode_2d
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseVGG
    from popnet_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    K, M = COCO_NUM_JOINTS, DecodeConfig().max_peaks
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    weights = coco_weights()
    models = {"float32": load_into(RTPoseVGG(), weights).eval().to(dev),
              "bf16": load_into(RTPoseVGG(), weights).eval().to(dev, torch.bfloat16)}
    host_model = load_into(RTPoseVGG(), weights).eval()

    def infer_of(model, dtype=torch.float32):
        def infer(x):
            with torch.inference_mode():
                (paf, heat), _ = model(x.permute(0, 3, 1, 2).to(dtype))
            return paf.permute(0, 2, 3, 1).float(), heat.permute(0, 2, 3, 1).float()
        return infer

    def decode(paf, heat, s):
        return paf_decode_2d(heat[None], paf[None], K, limbs=COCO_LIMBS, sx=1.0 / s, sy=1.0 / s)

    flip_kw = dict(limbs=COCO_LIMBS, swap_indices=COCO_SWAP_INDICES)
    launches, per_canvas, timings = {k.__name__: 0 for k in kernels.KERNELS}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        images, people, gt = eval_images(rng, root)
        sizes = [f"{w}x{h}" for h, w in EVAL_IMAGES]
        say("coco_eval", f"(a) {len(images)} images of {sizes} (WxH) "
            f"with 2-3 painted people each, written as baseline JPEG and read by the port's "
            f"reader; RTPoseVGG (VGG19, 6 stages) from its seeded init with the scaled heads "
            f"(coco_weights), float32 (TF32 off) and bf16")
        results_card, results_host = [], []
        for i, img in enumerate(images):
            canvas, s, _ = crop_with_factor(img, EVAL_DEST, 8)
            Hm, Wm = canvas.shape[0] // 8, canvas.shape[1] // 8
            tag = (f"{img.shape[1]}x{img.shape[0]} image (canvas {canvas.shape[1]}x"
                   f"{canvas.shape[0]}, maps {Hm}x{Wm} HxW)")
            # the evaluation path on the card: launch counts reset just before, read just after
            torch.cuda.synchronize()
            kernels.reset_launches()
            paf, heat, s_card = rgb_infer(infer_of(models["float32"]), img, mode="rtpose",
                                          dest_size=EVAL_DEST)
            out = decode(paf, heat, s_card)
            torch.cuda.synchronize()
            got = kernels.launch_counts()
            route = kernels.find_peaks_route(K, Hm, Wm, M)
            require(got[route] == 1 and got["paf_score"] == 1 and got["assemble_ids"] == 1
                    and sum(got.values()) == 3, f"{tag}: launches {got} (peaks by {route})")
            groups = kernels.paf_score_groups(K, len(COCO_LIMBS), M, Hm, Wm)[0]
            per_canvas[f"{Hm}x{Wm}"] = {"peaks_by": route, "paf_score_groups": groups}
            for k, v in got.items():
                launches[k] += v
            host = decode(paf.cpu(), heat.cpu(), s_card)
            for k in ("joints2d", "conf", "visibility", "counts"):
                _exact(f"{tag} decode {k}, card against host", out[k], host[k])
            # the card's maps against the CPU's, flip off (and on, for the first image)
            cp, ch, s_cpu = rgb_infer(infer_of(host_model), img, mode="rtpose",
                                      dest_size=EVAL_DEST, device="cpu")
            require(s_cpu == s_card and s_card == EVAL_DEST / min(img.shape[:2]), f"{tag} scale")
            map_err = max(_maxerr(paf.cpu(), cp) / float(cp.abs().max()),
                          _maxerr(heat.cpu(), ch) / float(ch.abs().max()))
            fpaf, fheat, _ = rgb_infer(infer_of(models["float32"]), img, mode="rtpose",
                                       dest_size=EVAL_DEST, flip=True, **flip_kw)
            if i == 0:
                fcp, fch, _ = rgb_infer(infer_of(host_model), img, mode="rtpose",
                                        dest_size=EVAL_DEST, flip=True, device="cpu", **flip_kw)
                map_err = max(map_err, _maxerr(fpaf.cpu(), fcp) / float(fcp.abs().max()),
                              _maxerr(fheat.cpu(), fch) / float(fch.abs().max()))
            require(map_err <= EVAL_MAP_BAR, f"{tag}: card maps {map_err:.3g} off the CPU's")
            # the routed find_peaks kernel, K3 and K6 against their plain versions on these maps
            check_eval_kernels(f"{tag} CNN maps", heat[None], paf[None])
            # (b) the GT-map oracle at this canvas, card and CPU
            oh, op = oracle_maps(people[i], canvas.shape[:2], s_card, dev)
            n_peaks = check_eval_kernels(f"{tag} oracle maps", oh, op)
            ocard = paf_decode_2d(oh, op, K, limbs=COCO_LIMBS, sx=1.0 / s_card, sy=1.0 / s_card)
            ohost = paf_decode_2d(oh.cpu(), op.cpu(), K, limbs=COCO_LIMBS, sx=1.0 / s_card,
                                  sy=1.0 / s_card)
            results_card += decoded_results(ocard, i)
            results_host += decoded_results(ohost, i)
            for k in ("joints2d", "conf", "visibility", "counts"):
                _exact(f"{tag} oracle decode {k}, card against host", ocard[k], ohost[k])
            # (d) the rates at this canvas: rgb_infer + decode, one image a call, host clock
            rates = {}
            for dtype, model in models.items():
                for flip in (False, True):
                    infer = infer_of(model, torch.bfloat16 if dtype == "bf16" else torch.float32)
                    kw = flip_kw if flip else {}
                    decode(*rgb_infer(infer, img, mode="rtpose", dest_size=EVAL_DEST, flip=flip,
                                      **kw))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(EVAL_TIMED):
                        o = decode(*rgb_infer(infer, img, mode="rtpose", dest_size=EVAL_DEST,
                                              flip=flip, **kw))
                        int(o["counts"][0])
                    rates[f"{dtype} flip {'on' if flip else 'off'}"] = \
                        EVAL_TIMED / (time.perf_counter() - t0)
            dec_ms = time_ms(lambda: decode(paf, heat, s_card), reps=10)
            timings[f"{Hm}x{Wm}"] = {"images_per_s": rates, "decode_ms": dec_ms}
            say("coco_eval", f"(a) {tag}: peaks by {route} at batch 1 (K1 would take "
                f"{kernels.find_peaks_smem(K, Hm, Wm, M)} bytes of shared memory, "
                f"{kernels.SMEM_PER_BLOCK} allowed), paf_score in {groups} groups of limbs, "
                f"assemble_ids: each launched once on the path and exact against its plain "
                f"version on the CNN's maps and on the oracle's ({n_peaks} valid peaks); the "
                f"decode on the card equals the host's bit for bit "
                f"({int(out['counts'][0])} people on the seeded CNN's maps); card maps within "
                f"{map_err:.3g} of the CPU's (flip off{', and on' if i == 0 else ''}; bar "
                f"{EVAL_MAP_BAR}); (d) images/s (rgb_infer + decode, host clock) "
                + ", ".join(f"{k} {v:.2f}" for k, v in rates.items())
                + f"; decode {dec_ms:.3f} ms (CUDA events)")
        # (b) the oracle's results through the vendored scorer
        require(results_card == results_host, "the oracle's results JSON differs card vs CPU")
        stats = run_coco_eval(gt, results_card)
        n_gt = sum(len(p) for p in people)
        say("coco_eval", f"(b) the GT-map oracle (port encoders at each canvas, {n_gt} people) "
            f"-> paf_decode_2d -> coco_eval_results -> run_coco_eval: results JSON on the card "
            f"equals the CPU's ({len(results_card)} people); AP {stats[0]:.4f} AP50 "
            f"{stats[1]:.4f} AP75 {stats[2]:.4f} AR {stats[3]:.4f} (bar AP {ORACLE_AP_BAR})")
        require(stats[0] >= ORACLE_AP_BAR, f"the oracle's AP {stats[0]:.4f} < {ORACLE_AP_BAR}")

        # find_peaks_plane and K2 at the four canvases and at two common COCO ones (rows cut
        # from the 640x427 image), batch 1, and at the first canvas at ROUTE_BATCH frames:
        # CUDA-graph replays beside their bound and the launch floor. find_peaks_route takes
        # find_peaks_plane wherever K1 cannot hold the maps, so it must be the faster at each.
        # Both kernels and find_peaks exact against the plain version there, at batch 1 and
        # 2 (K2 takes the 18 planes in rounds)
        one = torch.zeros(1, device=dev)
        floor_ms = graph_ms(lambda: one.fill_(0.0))
        k12 = {}
        canvases = [*images, *(images[2][:rows] for rows in EVAL_CROP_ROWS)]
        for i, img in enumerate(canvases):
            _, heat, _ = rgb_infer(infer_of(models["float32"]), img, mode="rtpose",
                                   dest_size=EVAL_DEST)
            frames = torch.stack([heat, heat.flip(1)])
            grid = f"{heat.shape[0]}x{heat.shape[1]}"
            for h in (peak_planes(heat[None], K), peak_planes(frames, K)):
                ref = kernels.find_peaks_plain(h)
                for fn in (kernels.find_peaks, kernels.find_peaks_plane, kernels.find_peaks_row):
                    for a, b, n in zip(fn(h), ref, PEAK_OUTPUTS):
                        _exact(f"{fn.__name__} at maps {grid}, batch {h.shape[0]}, {n}", a, b)
            batches = (ROUTE_BATCH, 1) if i == 0 else (1,)   # batch 1 last: its stages
            for B in batches:
                h = peak_planes(heat[None].repeat(B, 1, 1, 1), K)
                px, py, _, _, v = kernels.find_peaks_plane(h)
                times = {"find_peaks_plane": graph_ms(lambda: kernels.find_peaks_plane(h)),
                         "find_peaks_row": graph_ms(lambda: kernels.find_peaks_row(h))}
                plain_ms = graph_ms(lambda: kernels.find_peaks_plain(h), reps=5)
                nbytes, ops, bound_ms, _ = _bounds("find_peaks_plane", {
                    "heat": h, "px": px, "py": py, "valid": v,
                    "thresh": DecodeConfig().thresh_heatmap})
                by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
                key = grid if B == 1 else f"{grid} batch {B}"
                k12[key] = {"ms": times["find_peaks_plane"], "k2_ms": times["find_peaks_row"],
                            "plain_ms": plain_ms, "bound_ms": bound_ms, "floor_ms": floor_ms,
                            "find_peaks_smem": kernels.find_peaks_smem(K, *h.shape[2:], M),
                            "config": kernels.find_peaks_plane_config(B, K, *h.shape[2:], M)}
                say("coco_eval", f"find_peaks_plane at maps {grid} (HxW), batch {B}: "
                    f"{times['find_peaks_plane']:.4f} ms (CUDA graph; {k12[key]['config']}), "
                    f"K2 (find_peaks_row) {times['find_peaks_row']:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({nbytes / 1e3:.1f} "
                    f"kB, {ops / 1e6:.3f} MFLOP), the launch floor {floor_ms:.4f} ms ({times['find_peaks_plane'] / floor_ms:.2f}x it); K1 "
                    f"cannot launch there ({k12[key]['find_peaks_smem']} bytes of shared "
                    f"memory a block); find_peaks, find_peaks_plane and K2 exact against the "
                    f"plain version at batch 1 and 2")
                require(times["find_peaks_plane"] < times["find_peaks_row"],
                        f"find_peaks_route takes find_peaks_plane at {grid}, batch {B}, as the "
                        f"faster, but K2 took {times['find_peaks_row']:.4f} ms against "
                        f"{times['find_peaks_plane']:.4f}")
            if i == 0:
                stage_breakdown("find_peaks_plane", lambda: kernels.find_peaks_plane(h),
                                times["find_peaks_plane"], tag=f"coco_eval {key}: ")

        # (c) generate-augset on the card and on the CPU
        data = os.path.join(root, "kdh3d")
        write_train_set(rng, dev, data, GENAUG_FRAMES, 0)
        write_mpaug_bank(rng, dev, data, GENAUG_FRAMES)
        gen_rates = {}
        for kind in ("bgaug", "mpaug"):
            outs = {}
            for route, extra in (("card", []), ("cpu", ["--device", "cpu"])):
                out = os.path.join(root, f"{kind}_{route}")
                t0 = time.perf_counter()
                cli_main(["generate-augset", "--kind", kind, "--data-root", data, "--out-dir",
                          out, "--augment", *extra])
                gen_rates[f"{kind} {route}"] = GENAUG_FRAMES / (time.perf_counter() - t0)
                outs[route] = tree_bytes(out)
            a, b = outs.values()
            require(a == b and len(a) == GENAUG_FRAMES + 1,
                    f"generate-augset --kind {kind}: the card's set differs from the CPU's")
        torch.cuda.synchronize()
        kernels.reset_launches()
        metrics = cli_main(["evaluate", "--model", "openpose", "--data-root",
                            os.path.join(root, "mpaug_card"), "--labels", "labels_test.json",
                            "--weights", WEIGHTS, "--batch-size", "16", "--out-dir",
                            os.path.join(root, "eval_out")])
        torch.cuda.synchronize()
        ev = kernels.launch_counts()
        require(ev["find_peaks"] >= 1 and ev["paf_score"] >= 1,
                f"evaluate on the frozen mp-aug set launched {ev}")
        say("coco_eval", f"(c) generate-augset --augment of {GENAUG_FRAMES} frames, --kind bgaug "
            f"and mpaug, on the card (the default) equals --device cpu byte for byte "
            f"(every .npy and labels_test.json); (d) frames/s "
            + ", ".join(f"{k} {v:.1f}" for k, v in gen_rates.items())
            + f"; evaluate --model openpose on the frozen mp-aug set on the card: "
            + ", ".join(f"{k} {metrics[k]:.4f}" for k in ("pck2d", "pck3d", "map2d", "map3d"))
            + f", launches {ev}")
    torch.backends.cudnn.allow_tf32 = tf32
    say("coco_eval", f"launches over (a) per kernel: {launches}; by canvas: {per_canvas}")
    routes = {c["peaks_by"] for c in per_canvas.values()}
    require(routes == {"find_peaks_plane"} and launches["find_peaks_plane"] == len(images)
            and launches["find_peaks_row"] == 0 and launches["paf_score"] >= 1
            and launches["assemble_ids"] >= 1,
            f"phase 13's path launched {launches} (peaks by {routes})")
    say("coco_eval", f"phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "per_canvas": per_canvas, "k12": k12, "timings": timings,
            "generate_augset_fps": gen_rates, "oracle_stats": stats.tolist()}


WIDE_IMAGE = (384, 2304)    # (H, W) of phase 13 (e)'s panorama: canvas 368x2208, maps 46x276


def phase_wide_canvas(rng, dev) -> dict:
    """Phase 13 (e): COCO evaluation of a panorama whose evaluation canvas
    gives maps over 255 cells wide, which only find_peaks_plane takes: one
    painted WIDE_IMAGE through `rgb_infer` + `paf_decode_2d` on the card
    (float32, TF32 off), the launch counts reset just before and read just
    after; the decode on the card against the host's on the same maps; K3,
    K6 and find_peaks (as it routes) against their plain versions on the
    CNN's maps and on the GT-map oracle's; the oracle's AP; and
    find_peaks_plane at these maps, batch 1, against its bound. Returns
    {"launches", "maps", "ms", "plain_ms", "bound_ms", "bound_by", "ap"}."""
    import torch

    from popnet_tpu_torch.core.config import DecodeConfig
    from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS as K
    from popnet_tpu_torch.data.coco import run_coco_eval
    from popnet_tpu_torch.data.preprocessing import crop_with_factor, rgb_infer
    from popnet_tpu_torch.decode.device import peak_planes
    from popnet_tpu_torch.decode.openpose_infer import paf_decode_2d
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseVGG
    from popnet_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    M = DecodeConfig().max_peaks
    model = load_into(RTPoseVGG(), coco_weights()).eval().to(dev)

    def infer(x):
        with torch.inference_mode():
            (paf, heat), _ = model(x.permute(0, 3, 1, 2))
        return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)

    def decode(paf, heat, s):
        return paf_decode_2d(heat, paf, K, limbs=COCO_LIMBS, sx=1.0 / s, sy=1.0 / s)

    with tempfile.TemporaryDirectory() as root, \
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        (img,), (kps,), gt = eval_images(rng, root, (WIDE_IMAGE,))
        canvas, _, _ = crop_with_factor(img, EVAL_DEST, 8)
        Hm, Wm = canvas.shape[0] // 8, canvas.shape[1] // 8
        maps = f"{Hm}x{Wm}"
        route = kernels.find_peaks_route(K, Hm, Wm, M)
        require(route == "find_peaks_plane" and Wm > 255,
                f"the panorama's maps {maps} go to {route}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        paf, heat, s_card = rgb_infer(infer, img, mode="rtpose", dest_size=EVAL_DEST)
        out = decode(paf[None], heat[None], s_card)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        require(launches["find_peaks_plane"] == 1 and launches["paf_score"] == 1
                and launches["assemble_ids"] == 1 and sum(launches.values()) == 3,
                f"the panorama's evaluation launched {launches}")
        host = decode(paf[None].cpu(), heat[None].cpu(), s_card)
        for k in ("joints2d", "conf", "visibility", "counts"):
            _exact(f"panorama decode {k}, card against host", out[k], host[k])
        check_eval_kernels(f"panorama {maps} CNN maps", heat[None], paf[None])
        oh, op = oracle_maps(kps, canvas.shape[:2], s_card, dev)
        n_peaks = check_eval_kernels(f"panorama {maps} oracle maps", oh, op)
        ocard, ohost = decode(op, oh, s_card), decode(op.cpu(), oh.cpu(), s_card)
        for k in ("joints2d", "conf", "visibility", "counts"):
            _exact(f"panorama oracle decode {k}, card against host", ocard[k], ohost[k])
        ap = float(run_coco_eval(gt, decoded_results(ocard, 0))[0])
    require(ap >= ORACLE_AP_BAR, f"the panorama oracle's AP {ap:.4f} < {ORACLE_AP_BAR}")
    h = peak_planes(heat[None], K)
    px, py, _, _, v = kernels.find_peaks(h)
    ms = graph_ms(lambda: kernels.find_peaks(h))
    plain_ms = graph_ms(lambda: kernels.find_peaks_plain(h), reps=5)
    nbytes, ops, bound_ms, _ = _bounds("find_peaks_plane", {
        "heat": h, "px": px, "py": py, "valid": v, "thresh": DecodeConfig().thresh_heatmap})
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    stage_breakdown("find_peaks_plane", lambda: kernels.find_peaks(h), ms,
                    tag=f"(e) panorama {maps} batch 1: ")
    say("coco_eval", f"(e) a {img.shape[1]}x{img.shape[0]} panorama (canvas {canvas.shape[1]}x"
        f"{canvas.shape[0]}, maps {maps} HxW, {len(kps)} people): rgb_infer + paf_decode_2d on "
        f"the card launched {launches} (peaks by {route}), its decode equals the host's bit for "
        f"bit ({int(out['counts'][0])} people on the seeded CNN's maps); find_peaks, K3 and K6 "
        f"exact against their plain versions on the CNN's and the oracle's maps ({n_peaks} valid "
        f"peaks); the oracle's AP {ap:.4f}; find_peaks_plane at batch 1: {ms:.4f} ms (CUDA "
        f"graph), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e3:.1f} kB, {ops / 1e6:.3f} MFLOP); in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "maps": maps, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ap": ap}


def coco_eval_entry(name: str, res: dict) -> dict:
    """A kernel's "coco_eval" entry of the kernels line: its launches over
    phase 13's evaluation path; the find_peaks kernels the canvases each
    took, find_peaks_plane its times beside K2's (phase 13 (b)), K3
    its groups of limbs at each."""
    entry = {"launches": res["launches"][name]}
    if name in ("find_peaks", "find_peaks_row", "find_peaks_plane"):
        entry["maps"] = [g for g, c in res["per_canvas"].items() if c["peaks_by"] == name]
    if name == "find_peaks_plane":
        entry["against_k2"] = res["k12"]
    if name == "paf_score":
        entry["groups"] = {g: c["paf_score_groups"] for g, c in res["per_canvas"].items()}
    return entry


# -- phase 14: the four-method table and the readout ablation ------------------------------------

# the table at a smoke budget: 32 training scenes, 8 validation scenes frozen, 2 steps a
# row at batch 32 in two chunks, the second after a resume (TABLE_CHUNKS=1 per call)
TABLE_SMOKE = {"TABLE_TRAIN": "32", "TABLE_VAL": "8", "TABLE_EPOCHS": "2",
               "TABLE_A2J_EPOCHS": "2", "TABLE_CHUNK": "1", "TABLE_CHUNKS": "1",
               "TABLE_BATCH": "32", "TABLE_WARMUP": "1"}
# sha256 of the smoke table's validation tree (data.synthetic.build, 8 scenes, 5
# locations, seed 777) and of its frozen set (generate-augset --seed 777), names and
# bytes (tree_sha256); tests/test_torch_method_table.py pins it on the CPU
TABLE_SMOKE_SHA256 = "368ca9e8f7945021465046fd2ca2380850ba47ea552c939505eb471199e039e8"


def tree_sha256(*roots: str) -> str:
    """sha256 over the files under each root, in sorted order: each file's
    path below its root's parent, then its bytes."""
    import hashlib

    h = hashlib.sha256()
    for root in roots:
        base = os.path.dirname(os.path.abspath(root))
        for dirpath, dirs, files in os.walk(root):
            dirs.sort()
            for f in sorted(files):
                path = os.path.join(dirpath, f)
                h.update(os.path.relpath(path, base).encode() + b"\0")
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()


def phase_tables(dev) -> dict:
    """Phase 14, the paper's instruments at a smoke budget (TABLE_SMOKE):
    `python -m popnet_tpu_torch.cli.method_table`'s main twice in this
    process, the second call resuming each row from its checkpoint, all
    four rows trained and scored on the card; the launch counts reset just
    before the first call and read just after the second; then the
    ablation (`cli/ablation_table.py ablation`) of the committed Open-Pose+
    weights on the table's frozen set on the card, counted the same way,
    against the same on the CPU. Checks: the validation and frozen trees'
    sha256 (TABLE_SMOKE_SHA256), every row done at 2 steps with its curve
    and metrics in [0, 1], the device named with its power limit, the
    table's kernels launched, the ablation card = CPU. Returns {"table",
    "ablation"}: each kernel's launches."""
    import torch

    from popnet_tpu_torch.cli import method_table
    from popnet_tpu_torch.cli.ablation_table import ablation
    from popnet_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_table_")
    saved = {k: os.environ.get(k) for k in (*TABLE_SMOKE, "TABLE_DIR", "TABLE_OUT")}
    try:
        os.environ.update(TABLE_SMOKE, TABLE_DIR=work,
                          TABLE_OUT=os.path.join(work, "method_table.json"))
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        first = method_table.main()
        walls = [time.perf_counter() - t0]
        calls = [{k: len(r["curve"]) for k, r in first["methods"].items()}]
        out = method_table.main()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0 - walls[0])
        table_launches = kernels.launch_counts()
        calls.append({k: len(r["curve"]) for k, r in out["methods"].items()})
        digest = tree_sha256(os.path.join(work, "val"), os.path.join(work, "val_frozen"))
        require(digest == TABLE_SMOKE_SHA256,
                f"the smoke table's validation and frozen trees hash to {digest}, not "
                f"{TABLE_SMOKE_SHA256}")
        require(calls[0] == {m: 1 for m in method_table.METHODS}
                and calls[1] == {m: 2 for m in method_table.METHODS},
                f"curve points after each call: {calls}")
        for name, rec in out["methods"].items():
            require(rec.get("done") and rec["steps"] == 2 and "latest" not in rec,
                    f"table row {name}: {rec}")
            require(all(0.0 <= v <= 1.0 for p in rec["curve"] for v in p["metrics"].values()),
                    f"table row {name}: a metric outside [0, 1]")
        dev_desc = out["device"]
        require(dev_desc["platform"] == "gpu" and "W" in dev_desc.get("nvidia_smi", ""),
                f"the table's device {dev_desc}")
        for k in ("find_peaks", "paf_score", "assemble_ids", "window_readout", "point_readout",
                  "peak_local_max"):
            require(table_launches[k] >= 1, f"the table's scoring launched {k} no time")
        frozen = os.path.join(work, "val_frozen")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        card = ablation(WEIGHTS, method_table.frozen_dataset(frozen, dev))
        torch.cuda.synchronize()
        abl_launches = kernels.launch_counts()
        walls.append(time.perf_counter() - t0)
        cpu = ablation(WEIGHTS, method_table.frozen_dataset(frozen, torch.device("cpu")))
        walls.append(time.perf_counter() - t0 - walls[2])
        require(card == cpu, f"the ablation on the card {card} differs from the CPU's {cpu}")
        require(abl_launches["find_peaks"] >= 1 and abl_launches["paf_score"] >= 1,
                f"the ablation launched {abl_launches}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    finals = {k: r["final"] for k, r in out["methods"].items()}
    say("tables", f"wall: the first call {walls[0]:.1f} s (the sets built in it), the resume "
        f"{walls[1]:.1f} s, the ablation on the card {walls[2]:.1f} s and on the CPU "
        f"{walls[3]:.1f} s")
    say("tables", f"method_table at {TABLE_SMOKE} in two calls (a resume): rows done at 2 steps, "
        f"curves {calls}, metrics in [0, 1]: {finals}; the validation and frozen trees' sha256 "
        f"{digest} as pinned; device {dev_desc}; launches over both calls {table_launches}")
    say("tables", f"ablation of {os.path.relpath(WEIGHTS, ROOT)} on the frozen set: card = CPU "
        f"{card}; launches {abl_launches}")
    say("tables", f"phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return {"table": table_launches, "ablation": abl_launches}


# -- phase 15: parallel layouts ------------------------------------------------------------

PAR_FRAMES = 64             # training frames of phase 15's set: 2 batches of TRAIN_BATCH
PAR_STEPS = PAR_FRAMES // TRAIN_BATCH   # (a)'s steps: an epoch
PAR_TIMED = 5               # steps of each timing run of (e), the first a warm-up
PAR_FRAME_BATCH = 4         # (c)'s 512x480 frames
PAR_BARS = {"loss": 1e-5, "params": 1e-5, "pipeline": 1e-5}
PAR_EVAL = (("openpose", "eval_zero", ["--device-decode"]), ("popnet", "eval_bg", []))


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _state_gap(a: dict, b: dict) -> tuple[float, str | None]:
    """max |a - b| over two state dicts' float tensors, and the first tensor that differs."""
    worst, first = 0.0, None
    for k, v in a.items():
        w = np.asarray(b[k])
        if np.asarray(v).dtype.kind != "f":
            continue
        gap = float(np.abs(np.asarray(v, np.float64) - w).max()) if v.size else 0.0
        if gap and first is None:
            first = k
        worst = max(worst, gap)
    return worst, first


def parallel_trainers(root: str, dev, batch: int) -> dict:
    """(a) PoP-Net's Trainer over a mesh of one rank (data=1, the job's
    group) against the plain Trainer: an epoch of the set under `root`
    (PAR_STEPS steps of `batch`) from the same seeded init and the same
    batches, float32, TF32 off, cuDNN deterministic. Returns each one's
    mean loss and the state dicts' gap."""
    import torch

    from popnet_tpu_torch.models import PopNet
    from popnet_tpu_torch.parallel.mesh import Mesh
    from popnet_tpu_torch.train import steps as st
    from popnet_tpu_torch.train.loop import Trainer

    out = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False, deterministic=True):
        for name, mesh in (("plain", None), ("dp", Mesh({"data": 1}))):
            with tempfile.TemporaryDirectory() as tmp:
                trainer = Trainer(PopNet(), st.make_popnet_train_step(),
                                  st.make_popnet_eval_loss(), learning_rate=TRAIN_LR,
                                  out_dir=tmp, device=dev, mesh=mesh, print_freq=10 ** 6)
                loss = trainer.train_epoch(train_dataset(root, "popnet", dev), batch)
                out[name] = (loss, {k: v.detach().cpu().numpy() for k, v in
                                    trainer.state.model.state_dict().items()})
    gap, first = _state_gap(out["dp"][1], out["plain"][1])
    return {"loss": (out["plain"][0], out["dp"][0]), "gap": gap, "first": first}


def start_gloo(batch_np: dict, dev, go: str, steps: int = 3):
    """Start (b): data parallelism at world size 2 over gloo, both ranks on
    card 0 (`checks.train_job` spawned), `steps` steps of PoP-Net, those
    after the first waiting for the file `go` (so that they are timed with
    the card to themselves). Returns the job."""
    from popnet_tpu_torch.parallel import checks, distributed

    args = ("popnet", None, batch_np, {"data": 2}, "dp", steps, TRAIN_LR, "float32", 0,
            dev.type, True, go)
    return distributed.start(checks.train_job, 2, args, device=dev.type, backend="gloo",
                             one_card=True, timeout=300, threads=2)


# what a rank raises where gloo takes no CUDA tensors: the dispatcher finds no gloo backend
# for the device, or ProcessGroupGloo refuses it by name
GLOO_REFUSAL = re.compile(r"No backend type associated with device type cuda"
                          r"|ProcessGroupGloo::\w+: (?:unsupported|invalid) device type")


def gloo_refused(e: BaseException) -> bool:
    """True when `e` is a rank's failure (the launcher's ProcessRaisedException,
    the rank's traceback in its message) on gloo's refusal of CUDA tensors."""
    import torch.multiprocessing as mp

    return isinstance(e, mp.ProcessRaisedException) and GLOO_REFUSAL.search(str(e)) is not None


def parallel_gloo(batch_np: dict, dev, job=None, go: str | None = None) -> dict:
    """(b) against the same step at world size 1 (over the job's group where
    there is one): PoP-Net, the first step's loss and parameters, and the
    later steps' median ms. `job` is `start_gloo`'s (started here when
    None); `go` is created here before its result is awaited. Gloo's
    refusal of CUDA tensors (`gloo_refused`), if it refuses, is returned as
    "error"; any other failure, a timeout included, raises."""
    from popnet_tpu_torch.parallel import checks

    if job is None:
        go = os.path.join(tempfile.mkdtemp(), "go")
        job = start_gloo(batch_np, dev, go)
    open(go, "w").close()
    try:
        two = job.result()
    except Exception as e:
        if not gloo_refused(e):
            raise
        return {"error": f"{type(e).__name__}: {str(e)[-600:]}"}
    one = checks.train_job("popnet", None, batch_np, {"data": 1}, "dp", 1, TRAIN_LR, "float32",
                           0, dev.type, True)
    gap, _ = _state_gap(two["state"], one["state"])
    return {"loss": (float(one["losses"][0]), float(two["losses"][0])), "gap": gap,
            "ms": float(np.median(two["seconds"][1:])) * 1e3}


def parallel_group_of_one(root: str, dev, batch_np: dict, frames: np.ndarray) -> dict:
    """(c) tensor, spatial and pipeline parallelism at group size 1, at
    full width: Open-Pose+'s step under model=1 against the plain step
    (loss and parameters); RTPoseLight3D's forward of 512x480 frames under
    spatial=1 against the plain forward; the pipelined Open-Pose+ at
    pipe=1, n_micro=2 (its uniform stages, 224², `batch_np`): the forward
    against the sequential eval-mode model, and one step's loss and the
    whole state after it against one step of the sequential eval-mode
    model (`checks.sequential_pipeline_step`)."""
    import torch

    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.parallel import checks

    tp = checks.train_job("openpose", None, batch_np, {"data": 1, "model": 1}, "tp", 1, TRAIN_LR,
                          "float32", 0, dev.type, True)
    plain = checks.train_job("openpose", None, batch_np, None, "dp", 1, TRAIN_LR, "float32", 0,
                             dev.type, True)
    tp_gap, tp_first = _state_gap(tp["state"], plain["state"])
    model = RTPoseLight3D().init_seeded(0).to(dev).eval()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = model(torch.as_tensor(frames, device=dev))[0]
    got = checks.spatial_forward_job("openpose", None, frames, {"data": 1, "spatial": 1},
                                     device=dev.type)
    sp_gap = max(float(np.abs(g - w.cpu().numpy()).max()) for g, w in zip(got, want))
    x = np.ascontiguousarray(np.transpose(batch_np["image"], (0, 3, 1, 2)))
    pp_batch = {k: batch_np[k] for k in ("image", "heatmaps", "pafs", "zmaps")}
    pp = checks.pipeline_job(None, x, pp_batch, {"data": 1, "pipe": 1}, n_micro=2, lr=TRAIN_LR,
                             device=dev.type)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _, saved = model(torch.as_tensor(x, device=dev))
    seq = checks.sequential_pipeline_step(None, pp_batch, lr=TRAIN_LR, device=dev.type)
    pp_gap = max(float(np.abs(g - w.cpu().numpy()).max()) for g, w in zip(pp["saved"], saved))
    pp_state_gap, pp_first = _state_gap(pp["state"], seq["state"])
    return {"tp_loss": (float(plain["losses"][0]), float(tp["losses"][0])), "tp_gap": tp_gap,
            "tp_first": tp_first, "sp_gap": sp_gap, "pp_gap": pp_gap,
            "pp_loss": (seq["loss"], pp["loss"]), "pp_state_gap": pp_state_gap,
            "pp_first": pp_first}


def parallel_eval(keep: str, dev, batch: int) -> tuple[dict, dict, float]:
    """(d) `evaluate --spatial 1` of Open-Pose+ (--device-decode) and
    PoP-Net on phase 6's sets against the plain `evaluate`: the JSONs equal,
    the kernels' launches counted over the spatial runs. Returns (launches,
    readouts' launches, the spatial runs' seconds)."""
    import torch

    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.ops import kernels

    weights = {"openpose": WEIGHTS, "popnet": WEIGHTS_POPNET}
    launches = {k.__name__: 0 for k in kernels.KERNELS}
    fused, seconds = 0, 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for model, data, extra in PAR_EVAL:
            jsons = []
            for spatial in ([], ["--spatial", "1"]):
                out = os.path.join(tmp, model + "_".join(spatial))
                _sync(dev)
                kernels.reset_launches()
                t0 = time.perf_counter()
                cli_main(["evaluate", "--model", model, "--data-root", os.path.join(keep, data),
                          "--out-dir", out, "--batch-size", str(batch), "--weights",
                          weights[model], "--device", str(dev), *extra, *spatial])
                _sync(dev)
                if spatial:
                    seconds += time.perf_counter() - t0
                    for k, v in kernels.launch_counts().items():
                        launches[k] += v
                    fused += kernels.readouts.launches
                with open(os.path.join(out, f"{model}_results.json")) as f:
                    jsons.append(json.load(f))
            require(jsons[0] == jsons[1], f"evaluate --spatial 1 --model {model}: the JSON "
                    "differs from the plain evaluate's")
    return launches, {"readouts": fused}, seconds


def phase_parallel(rng, dev, keep: str) -> dict:
    """Phase 15, the parallel layouts (popnet_tpu_torch/parallel): (a)-(d)
    of the module docstring, and (e) the data-parallel step's ms at world
    size 1 beside the plain step's, and (b)'s. Returns the launches of (d)."""
    import torch

    from popnet_tpu_torch.parallel import checks, distributed

    t_phase = time.perf_counter()
    card = phase_device_name()
    with tempfile.TemporaryDirectory() as root:
        write_train_set(rng, dev, root, PAR_FRAMES, 4)
        idx = np.arange(TRAIN_BATCH)
        batch_pn = {k: v.cpu().numpy() for k, v in
                    train_dataset(root, "popnet", dev).get_batch(idx).items()}
        batch_op = {k: v.cpu().numpy() for k, v in
                    train_dataset(root, "openpose", dev).get_batch(idx).items()}
        names = sorted(os.listdir(os.path.join(root, "depth_maps")))[:PAR_FRAME_BATCH]
        frames = np.stack([(np.clip(np.load(os.path.join(root, "depth_maps", n)), 0, 6) - 3) / 2
                           for n in names]).astype(np.float32)[:, None]
        t_set = time.perf_counter() - t_phase
        go = os.path.join(root, "go")
        job = start_gloo(batch_pn, dev, go)     # its start-up overlaps (a), (c) and (d)
        with distributed.single_rank_job(dev):
            t0 = time.perf_counter()
            a = parallel_trainers(root, dev, TRAIN_BATCH)
            t_a = time.perf_counter() - t0
            c = parallel_group_of_one(root, dev, batch_op, frames)
            t_c = time.perf_counter() - t0 - t_a
            launches, fused, eval_s = parallel_eval(keep, dev, EVAL_BATCH)
            t_d = time.perf_counter() - t0 - t_a - t_c
            gloo = parallel_gloo(batch_pn, dev, job, go)
            t_b = time.perf_counter() - t0 - t_a - t_c - t_d
            timed = {}
            for name, shape in (("plain", None), ("dp", {"data": 1}), ("plain_again", None)):
                r = checks.train_job("popnet", None, batch_pn, shape, "dp", PAR_TIMED, TRAIN_LR,
                                     "float32", 0, dev.type)
                timed[name] = float(np.median(r["seconds"][1:])) * 1e3
            t_e = time.perf_counter() - t0 - t_a - t_c - t_d - t_b
    say("parallel", f"wrote a set of {PAR_FRAMES} training frames; {card}; seconds: the set and "
        f"its batches {t_set:.1f}, (a) {t_a:.1f}, (c) {t_c:.1f}, (d) {t_d:.1f}, (b) after them "
        f"{t_b:.1f} (its start-up overlapped them), (e) {t_e:.1f}")
    require(a["loss"][0] == a["loss"][1] and a["gap"] == 0.0,
            f"(a) the data-parallel Trainer at world size 1 differs from the plain one: losses "
            f"{a['loss']}, parameters {a['gap']:.3g} apart (first {a['first']})")
    say("parallel", f"(a) Trainer --mesh data=1 over NCCL against the plain Trainer: PoP-Net at "
        f"{TRAIN_INPUT}², batch {TRAIN_BATCH}, {PAR_STEPS} steps, float32, TF32 off: mean loss "
        f"{a['loss'][1]!r} = {a['loss'][0]!r}, parameters bit for bit")
    if "error" in gloo:
        say("parallel", f"(b) gloo refused the job on CUDA tensors: {gloo['error']}")
    else:
        rel = abs(gloo["loss"][1] - gloo["loss"][0]) / abs(gloo["loss"][0])
        require(rel <= PAR_BARS["loss"] and gloo["gap"] <= PAR_BARS["params"],
                f"(b) world size 2 over gloo against 1: loss {gloo['loss']} (rel {rel:.3g}), "
                f"parameters {gloo['gap']:.3g} apart")
        say("parallel", f"(b) data=2 over gloo, both ranks on cuda:0, {TRAIN_BATCH // 2} "
            f"frames a rank, one step: loss {gloo['loss'][1]!r} against {gloo['loss'][0]!r} at world size 1 (rel "
            f"{rel:.3g}, bar {PAR_BARS['loss']}), parameters {gloo['gap']:.3g} apart (bar "
            f"{PAR_BARS['params']})")
    rel_tp = abs(c["tp_loss"][1] - c["tp_loss"][0]) / abs(c["tp_loss"][0])
    rel_pp = abs(c["pp_loss"][1] - c["pp_loss"][0]) / abs(c["pp_loss"][0])
    require(c["tp_loss"][0] == c["tp_loss"][1] and c["tp_gap"] == 0.0,
            f"(c) model=1 differs from the plain step: losses {c['tp_loss']}, parameters "
            f"{c['tp_gap']:.3g} apart (first {c['tp_first']})")
    require(c["sp_gap"] == 0.0, f"(c) spatial=1's forward is {c['sp_gap']:.3g} off the plain one")
    require(c["pp_gap"] <= PAR_BARS["pipeline"] and rel_pp <= PAR_BARS["loss"]
            and c["pp_state_gap"] <= PAR_BARS["params"],
            f"(c) pipe=1: forward {c['pp_gap']:.3g} off the sequential model, loss "
            f"{c['pp_loss']}, the state after the step {c['pp_state_gap']:.3g} off the "
            f"sequential step's (first {c['pp_first']})")
    say("parallel", f"(c) at group size 1 over NCCL: model=1 Open-Pose+ step = the plain step "
        f"bit for bit (loss {c['tp_loss'][1]!r}); spatial=1 forward of {PAR_FRAME_BATCH} 512x480 "
        f"frames = the plain forward bit for bit; pipe=1, n_micro=2 at {TRAIN_INPUT}², batch "
        f"{TRAIN_BATCH}: forward {c['pp_gap']:.3g} from the sequential eval-mode model (bar "
        f"{PAR_BARS['pipeline']}), loss {c['pp_loss'][1]!r} against {c['pp_loss'][0]!r} (rel "
        f"{rel_pp:.3g}, bar {PAR_BARS['loss']}), the state after the step "
        f"{c['pp_state_gap']:.3g} from the sequential step's (bar {PAR_BARS['params']}); tp rel "
        f"{rel_tp:.3g}")
    for name in EVAL_PATH:
        require(launches[name] >= 1, f"(d) evaluate --spatial 1 launched {name} no time")
    require(fused["readouts"] >= 1, "(d) evaluate --spatial 1 launched the fused readouts no time")
    say("parallel", f"(d) evaluate --spatial 1 (Open-Pose+ --device-decode, PoP-Net) on phase "
        f"6's sets: JSON = the plain evaluate's; launches over the spatial runs {launches}, "
        f"readouts (K4 and K5 together) {fused['readouts']}; {eval_s:.1f} s")
    gloo_ms = (f"{gloo['ms']:.2f} ms a step ({TRAIN_BATCH // 2} frames a rank)" if "ms" in gloo
               else "not run")
    say("parallel", f"(e) PoP-Net step at {TRAIN_INPUT}², batch {TRAIN_BATCH}, float32, CUDA "
        f"synchronized wall, median of {PAR_TIMED - 1} after a warm-up, on {card}: plain "
        f"{timed['plain']:.2f} ms, data=1 over NCCL {timed['dp']:.2f} ms, plain again "
        f"{timed['plain_again']:.2f} ms; data=2 over gloo on one card {gloo_ms}")
    say("parallel", f"phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 16: visualizers and reference checkpoints ----------------------------------------

VIZ_FRAMES = 64             # frames of phase 6's "zero" set the visualize commands draw
VIZ_SERVE_BATCH = 64        # the batch (a) serves through both pipelines
VIZ_ROI_BATCH = 8           # frames of (c)'s ROIDataset batch
VIZ_ROI_SEED = 16
VIZ_PSNR_BAR = 20.0         # dB: a drawn frame's JPEG against the frame (the encoder's loss)


def phase_viz(dev, keep: str, frames) -> dict:
    """Phase 16: (a) the committed Open-Pose+ weights exported as a
    reference state dict (interop.torch_import.export_rtpose_light3d, under
    the 'module.' prefix) and imported into a fresh RTPoseLight3D on the
    card, every tensor unchanged, then one batch served through
    build_openpose_pipeline with cuDNN deterministic: the wire buffer
    equal to the committed weights' bit for bit, K1, K3 and K6 launched;
    (b) `visualize-pred` on phase 6's Open-Pose+ evaluate JSON and
    `visualize-gt` with seg maps, each on the card and with --device cpu,
    over VIZ_FRAMES frames: every file equal byte for byte, its decode
    equal to the decode of encode_jpeg of the frame drawn here, within
    VIZ_PSNR_BAR of the drawn frame, no kernel launched; (c) a
    ROIDataset batch made on the card against the CPU's; (d) images/s of
    visualize-pred on the card, with the card's name and power limit.
    Returns (a)'s launches."""
    import torch

    from popnet_tpu_torch import build_openpose_pipeline, load_npz
    from popnet_tpu_torch.cli.main import main as cli_main
    from popnet_tpu_torch.data.datasets import ROIDataset
    from popnet_tpu_torch.data.image_io import decode_jpeg, encode_jpeg
    from popnet_tpu_torch.data.labels import load_label_file
    from popnet_tpu_torch.interop import torch_import as ti
    from popnet_tpu_torch.interop.from_jax import flat_from_module, load_into
    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.ops import kernels
    from popnet_tpu_torch.viz import visualize_gt, visualize_pred

    t_phase = time.perf_counter()
    committed = load_into(RTPoseLight3D(), load_npz(WEIGHTS))
    template = {f"module.{k}": v for k, v in RTPoseLight3D().state_dict().items()}
    exported = {f"module.{k}": torch.from_numpy(v)
                for k, v in ti.export_rtpose_light3d(committed, template).items()}
    imported = ti.import_rtpose_light3d(RTPoseLight3D().to(dev), exported)
    for k, v in committed.state_dict().items():
        require(torch.equal(imported.state_dict()[k].cpu(), v),
                f"viz (a): {k} changed through export and import")
    batch = frames[:VIZ_SERVE_BATCH]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = build_openpose_pipeline(load_npz(WEIGHTS), device=dev)(batch)
        pipe = build_openpose_pipeline(flat_from_module(imported), device=dev)
        _sync(dev)
        kernels.reset_launches()
        got = pipe(batch)
        _sync(dev)
        launches = kernels.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    require(bool(torch.equal(got, ref)), "viz (a): the imported weights' wire buffer differs")
    require(all(launches[k] >= 1 for k in ("find_peaks", "paf_score", "assemble_ids")),
            f"viz (a): the Open-Pose+ path missed a kernel: {launches}")
    say("viz", f"(a) the committed Open-Pose+ weights exported as a reference state dict "
        f"({len(exported)} keys under 'module.') and imported into a fresh RTPoseLight3D on the "
        f"card, every tensor unchanged; {len(batch)} frames served through "
        f"build_openpose_pipeline: wire buffer {tuple(got.shape)} = the committed weights' bit "
        f"for bit; launches {json.dumps({k: v for k, v in launches.items() if v})}")

    data = os.path.join(keep, "eval_zero")
    pred = os.path.join(keep, "openpose_results.json")
    anno, _ = load_label_file(os.path.join(data, "labels.json"))
    ids = list(anno)[:VIZ_FRAMES]
    os.makedirs(os.path.join(data, "seg_maps"), exist_ok=True)
    for image_id in ids:
        depth = np.load(os.path.join(data, "depth_maps", image_id))
        np.save(os.path.join(data, "seg_maps", image_id), (depth > 0).astype(np.uint8))
    with open(pred) as f:
        res = json.load(f)
    key = "human_pred_set_2d_aligned" if "human_pred_set_2d_aligned" in res else "human_pred_set_2d"
    humans = res[key][:VIZ_FRAMES]
    n_people = sum(len(h) for h in humans)
    with tempfile.TemporaryDirectory() as tmp:
        seconds = {}
        for cmd in ("visualize-pred", "visualize-gt"):
            extra = ["--pred", pred] if cmd == "visualize-pred" else []
            files = {}
            for device in (str(dev), "cpu"):
                out = os.path.join(tmp, f"{cmd}-{device}")
                _sync(dev)
                kernels.reset_launches()
                t0 = time.perf_counter()
                files[device] = cli_main([cmd, "--data-root", data, "--out-dir", out, "--limit",
                                          str(VIZ_FRAMES), "--device", device, *extra])
                _sync(dev)
                seconds[cmd, device] = time.perf_counter() - t0
                require(not any(kernels.launch_counts().values()),
                        f"viz (b): {cmd} launched a kernel")
            require(len(files[str(dev)]) == len(files["cpu"]) == VIZ_FRAMES,
                    f"viz (b): {cmd} wrote {len(files[str(dev)])} files, not {VIZ_FRAMES}")
            psnr = []
            for i, (pc, ph) in enumerate(zip(files[str(dev)], files["cpu"])):
                with open(pc, "rb") as fc, open(ph, "rb") as fh:
                    data_c, data_h = fc.read(), fh.read()
                require(data_c == data_h, f"viz (b): {cmd} {os.path.basename(pc)}: the card's "
                        "file differs from the CPU's")
                depth = torch.from_numpy(np.load(os.path.join(data, "depth_maps", ids[i]))).to(dev)
                if cmd == "visualize-pred":
                    drawn = visualize_pred(depth, [np.asarray(h) for h in humans[i]])
                else:
                    seg = torch.from_numpy(np.load(os.path.join(data, "seg_maps", ids[i])))
                    drawn = visualize_gt(depth, anno[ids[i]], seg=seg)
                decoded = decode_jpeg(data_c, pc)
                require(np.array_equal(decoded, decode_jpeg(encode_jpeg(drawn))),
                        f"viz (b): {cmd} {os.path.basename(pc)} is not the drawn frame's JPEG")
                mse = float(np.mean((decoded.astype(np.float64) - drawn) ** 2))
                psnr.append(float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
            require(min(psnr) > VIZ_PSNR_BAR, f"viz (b): {cmd}: a frame's JPEG is "
                    f"{min(psnr):.2f} dB from the drawn frame (bar {VIZ_PSNR_BAR})")
            say("viz", f"(b) {cmd} over {VIZ_FRAMES} frames of phase 6's zero set"
                + (f" ({n_people} predicted people of its Open-Pose+ evaluate JSON)"
                   if cmd == "visualize-pred" else " (seg maps of their people)")
                + f": --device {dev} and --device cpu wrote the same {VIZ_FRAMES} files byte for "
                f"byte, each the JPEG of the frame drawn here, PSNR {min(psnr):.2f}-"
                f"{max(psnr):.2f} dB against it; no kernel launched; "
                f"{seconds[cmd, str(dev)]:.2f} s on the card, {seconds[cmd, 'cpu']:.2f} s on the "
                "CPU")

    frames_with_people = [i for i, image_id in enumerate(anno) if anno[image_id]]
    idx = np.asarray(frames_with_people[:VIZ_ROI_BATCH])
    dss = {d: ROIDataset(os.path.join(data, "depth_maps"), os.path.join(data, "labels.json"),
                         seed=VIZ_ROI_SEED, device=d) for d in (dev, "cpu")}
    worst = compare_batches("viz (c)", dss[dev].get_batch(idx), dss["cpu"].get_batch(idx))
    require(dss[dev].rng.bit_generator.state == dss["cpu"].rng.bit_generator.state,
            "viz (c): the generators part")
    say("viz", f"(c) a ROIDataset batch of {len(idx)} frames (one drawn person each, cropped and "
        f"resized to 224²) made on the card = the CPU's: image, masks and z-maps bit for bit, "
        f"other maps within {worst:.3g} (bar {TARGETS_BAR}); generators equal")
    rate = VIZ_FRAMES / seconds["visualize-pred", str(dev)]
    say("viz", f"(d) visualize-pred: {rate:.1f} images/s with the grey map on the card "
        f"({VIZ_FRAMES / seconds['visualize-pred', 'cpu']:.1f} on the CPU), 512x480 frames, "
        f"{phase_device_name()}")
    say("viz", f"phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_device_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


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
    from popnet_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)           # the first slice's inputs, as ever
    rng_new = np.random.default_rng([args.seed, 2])  # the later kernels' and PoP-Net's
    sm_clock_mhz = phase_device()
    phase_build()
    rng3 = np.random.default_rng([args.seed, 3])    # the sparse and shared-coordinate cases
    rng4 = np.random.default_rng([args.seed, 4])    # the readout's and the assembly's new cases
    errs = phase_kernels(rng, rng_new, rng3, rng4, dev, BATCH)
    n_plane, errs["find_peaks_plane"] = plane_cases(np.random.default_rng([args.seed, 16]), dev)
    say("kernels", f"find_peaks_plane: px/py/loc/score/valid exact against the plain version in "
        f"{n_plane} cases at {PLANE_SHAPES + PLANE_EDGE_SHAPES} (B, K, H, W), where find_peaks "
        f"routes to it (one launch, none on K1 or K2): NCHW, NHWC and sliced planes, dense heat "
        f"(a lattice of peaks, an exact tie, 32 kept), sparse heat, and at the last "
        f"{len(PLANE_EDGE_SHAPES)} shapes peaks, plateaus and ties on the rows where bands meet "
        f"(the 2048x2048 plane in bands taken in turn, "
        f"{kernels.find_peaks_plane_config(1, 1, 2048, 2048, 32)})")
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
    # phase 6's labelled set and phase 7's Yolo-Pose+ checkpoint, kept for phase 9
    keep = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        rng_eval = np.random.default_rng([args.seed, 7])  # the eval phase's labelled frames
        eval_launches = phase_eval(rng_eval, dev, EVAL_FRAMES, EVAL_BATCH, keep)
        for r in rows:                  # launches on the eval path, beside the serving path's
            r["eval_launches"] = eval_launches[r["name"]]
        rng_train = np.random.default_rng([args.seed, 8])  # the training phase's frames
        train_launches = phase_train(rng_train, dev, keep)
        for r in rows:                  # none on the training path; evaluate --ckpt's
            r["train_launches"] = train_launches["train"][r["name"]]
            r["ckpt_eval_launches"] = train_launches["ckpt_eval"][r["name"]]
        rng_mpaug = np.random.default_rng([args.seed, 9])  # the mp-aug phase's recordings
        mpaug_launches = phase_mpaug(rng_mpaug, dev)
        for r in rows:                  # none on the mp-aug training path; evaluate --ckpt's
            r["mpaug_train_launches"] = mpaug_launches["train"][r["name"]]
            r["mpaug_ckpt_eval_launches"] = mpaug_launches["ckpt_eval"][r["name"]]
        rng_a2j = np.random.default_rng([args.seed, 10])  # the A2J training phase's recordings
        a2j_launches = phase_a2j_train(rng_a2j, dev, keep)
        for r in rows:                  # none on the A2J training or evaluate --ckpt paths
            r["a2j_train_launches"] = a2j_launches["train"][r["name"]]
            r["a2j_ckpt_eval_launches"] = a2j_launches["ckpt_eval"][r["name"]]
        deploy_launches = phase_deploy(dev, {
            "frames": frames, "weights": weights, "f32_out": f32_out, "frames_pn": frames_pn,
            "weights_pn": weights_pn, "f32_out_pn": f32_out_pn, "frames_y": frames_y,
            "weights_yolo": weights_yolo, "f32_out_y": f32_out_y, "f32_out_a2j": f32_out_a2j,
            "frames_c": frames_c, "weights_c": weights_c, "f32_out_c": f32_out_c}, keep)
        for r in rows:                  # the folded and int8 serving paths, evaluate's flags
            r["deploy_launches"] = deploy_launches[r["name"]]
        rng_itop = np.random.default_rng([args.seed, 11])  # phase 11's painted frames
        itop_launches = phase_itop(rng_itop, dev)
        for r in rows:                  # the ITOP drivers, evaluate --dataset itop, the table
            r["itop_launches"] = itop_launches[r["name"]]
        rng_rgb = np.random.default_rng([args.seed, 12])  # phase 12's painted RGB frames
        rgb_launches = phase_rgb(rng_rgb, dev)
        for r in rows:                  # none on the COCO and MPII training paths
            r["rgb_train_launches"] = rgb_launches[r["name"]]
        rng_eval13 = np.random.default_rng([args.seed, 13])  # phase 13's images and sets
        coco_eval = phase_coco_eval(rng_eval13, dev)
        for r in rows:                  # the COCO evaluation canvases of phase 13 (a)
            r["coco_eval"] = coco_eval_entry(r["name"], coco_eval)
        wide = phase_wide_canvas(np.random.default_rng([args.seed, 13, 5]), dev)
        for r in rows:                  # the panorama of phase 13 (e): find_peaks_plane's path
            r["wide_canvas_launches"] = wide["launches"][r["name"]]
            if r["name"] == "find_peaks_plane":    # (e)'s launches and times; (a)'s: coco_eval
                r["depth_planes"] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                r.update({k: wide[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                         launches=wide["launches"]["find_peaks_plane"], maps=wide["maps"])
        tables = phase_tables(dev)
        for r in rows:                  # the four-method table and the ablation of phase 14
            r["table_launches"] = {k: v[r["name"]] for k, v in tables.items()}
        par = phase_parallel(np.random.default_rng([args.seed, 15]), dev, keep)
        for r in rows:                  # evaluate --spatial 1 of phase 15 (d)
            r["parallel_launches"] = par[r["name"]]
        phase_viz(dev, keep, frames)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
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
