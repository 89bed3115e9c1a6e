"""The port's command line: the `train`, `evaluate`, `benchmark`,
`visualize-gt`, `visualize-pred` and `generate-augset` subcommands.

    python -m popnet_tpu_torch.cli.main train --model openpose --data-root DATA \\
        --bg-aug --val-labels labels_val.json --out-dir runs/op
    python -m popnet_tpu_torch.cli.main evaluate --model openpose \\
        --data-root DATA --ckpt runs/op/ckpt
    python -m popnet_tpu_torch.cli.main benchmark --gt DATA/labels.json \\
        --pred runs/out/openpose_results.json
    python -m popnet_tpu_torch.cli.main generate-augset --kind mpaug \\
        --data-root DATA --out-dir frozen/mpaug --augment
    python -m popnet_tpu_torch.cli.main visualize-pred --data-root DATA \\
        --pred runs/out/openpose_results.json --out-dir runs/vis --limit 16

`train` trains Open-Pose+, PoP-Net, Yolo-Pose+ or A2J (`--model openpose|
popnet|yolo|a2j`) on a KDH3D-format dataset (DATA/depth_maps/*.npy and the
label JSON `--labels`, 480x512 frames, or ITOP's 320x240 frames, camera and
5 m clip with `--dataset itop`; with `--bg-aug`, composited over DATA/bg_maps by DATA/seg_maps
and DATA/labels_bg.json; with `--mp-aug`, multi-person frames z-buffered
from the per-location recordings of DATA/<--mp-label-prefix>*.json, on the
host, or over a scene bank resident on the device with `--device-bank`, or
streamed through it in shards of N indices with `--stream-bank N`),
validating on `--val-labels` without augmentation (and without mp-aug),
with the JAX command line's flags and defaults (SGD-Nesterov
at lr 1.0 and a plateau controller, batch 32, 224² input; A2J with the
JAX command line's A2J recipe: 288² person crops of those frames, or at
ITOP the torso-centred crops of torso-relative depth (`ITOPA2JCropDataset`,
normalized by the absolute depth statistics, as the JAX command line
leaves them), Adam with L2 at 3.5e-4 and StepLR, `_a2j_trainer`): it writes
`history.jsonl`, the periodic checkpoints `ckpt/` and the best-validation
`ckpt_best/` to `--out-dir`, and `--resume` continues from `ckpt/`. The
model starts from its seeded init (`init_seeded(--seed)`); convolutions run
in float32 with TF32 off.

`evaluate` runs a model over an MP-3DHP-format dataset (DATA/depth_maps/*.npy
and the label JSON `--labels`; at ITOP geometry with `--dataset itop`, the
same MP-3DHP drivers, as the JAX command line runs them) on the card, or on the CPU with
`--device cpu`, writes `<model>_results.json` (the benchmark's prediction
JSON) to `--out-dir` and prints the four metrics. `benchmark` scores a
prediction JSON against a label file. The CNNs run in float32 (no TF32).
Weights are the port's checkpoints (`--ckpt`, `--yolo-ckpt`: a `ckpt/`
directory that `train` wrote) or npz files of Flax variables (`--weights`,
`--yolo-weights`, `interop.load_npz`); without either a model starts from
its seeded init (`torch.manual_seed(--seed)`; A2J's `init_seeded`), which
predicts nothing but drives every stage.

`train --dataset coco --model rtpose_vgg` trains RTPoseVGG (`--trunk
vgg19|mobilenet`) on COCO keypoints: DATA/images/*.jpg and the
person_keypoints JSON `--labels` (and `--val-labels`), letterboxed to
`--input-size`, with `--rotate-aug DEG`, `--scale-jitter LO,HI` and
`--blur-aug SIGMA` (`data.coco_dataset`); `train --dataset mpii --model
popnet_rgb` trains PopNetRGB on MPII: DATA/images/*.jpg and an MPII JSON
release `--labels` (`data.mpii`). As in the JAX command line, these two run
SGD-Nesterov at --lr with the plateau controller, validate and checkpoint
every epoch, and leave --optimizer, --schedule and the other depth-only
options aside; each dataset trains its one model and refuses the others.

`--pred-vis` trains PoP-Net with the visibility-inferring prior targets
(`PopNet(pred_vis=True)` and its step, as the JAX library composes them);
Open-Pose+ encodes no prior, so the flag changes nothing there; Yolo-Pose+
refuses it, as the JAX package has no visibility-aware Yolo loss.

`evaluate --fold-bn` folds each Conv -> BatchNorm pair of the CNN into
the conv (`ops/fold_bn.py`; with `--model a2j`, of both stages), and
`--quant int8` runs the CNN's eligible convs in dynamic int8 (`ops/quant.py`),
rounded as the JAX command line's op-by-op call of the model rounds them
(`rounding="eager"`). As in the JAX command line, `--model a2j` ignores
`--quant`, and says so.

`generate-augset --kind bgaug|mpaug` freezes the bg-aug or mp-aug
composite of DATA (the layout `train --bg-aug` / `--mp-aug` reads) into a
static test set in `--out-dir` (`depth_maps/%08d.npy`, `labels_test.json`;
`data.construction`): `--n-images` frames (all by default), `--augment`
adds the freeze-time rotation, dolly and resize. The composite and the
transforms run on `--device`, the card unless `--device cpu` is passed
(the JAX command line composites on its host unless given its boolean
`--device`); the card's sets equal the CPU's byte for byte.

`visualize-gt` draws each frame of DATA's label file `--labels` (its
depth map in grey, DATA/seg_maps/<id> in red where it exists, the GT
skeletons) and `visualize-pred` the skeletons of a prediction JSON
`--pred` (`human_pred_set_2d_aligned` where the JSON holds it, else
`human_pred_set_2d`) over the depth, into `--out-dir/{i:06d}.jpg`, the
first `--limit` frames (all with 0): the grey map and the overlay run on
`--device`, the drawing on the host (`viz/`), and the files are the bytes
`cv2.imwrite` writes (`data.image_io.imwrite_jpeg`), as the JAX command
line's are.

`evaluate --dataset coco|mpii` and the RGB models exit, as the JAX command
line's do (its `_build_model` refuses `rtpose_vgg` and `popnet_rgb`):
neither command line evaluates an RGB model. COCO results are scored by
the library chain `data.preprocessing.rgb_infer` ->
`decode.openpose_infer.paf_decode_2d` -> `data.coco.coco_eval_results` ->
`data.coco.run_coco_eval`. ITOP's single-person 10-cm table has its own
entry point, `python -m popnet_tpu_torch.cli.itop_table`.

Parallel layouts (`parallel/`), with the JAX command line's grammar:
`train --mesh data=D[,model=N | ,spatial=N | ,pipe=N]` trains the three
dense depth families over D x N ranks, channel-sharded (`model`), in
height bands (`spatial`) or, for `--model openpose` only, as a GPipe
pipeline of `--n-micro` microbatches (`pipe`; its final checkpoint is in
the sequential layout, with `pipelined` and `n_pipe` in its metadata, so
`evaluate --ckpt` scores it). `data` defaults to the ranks available over
N: torchrun's WORLD_SIZE, the host's cards, or 1 on the CPU. A2J, COCO
and MPII ignore --mesh, as the JAX command line does, and say so.
`evaluate --spatial N` runs the CNN in N height bands (N must divide
--input-size; a ragged tail batch takes the plain path); every rank runs
the driver and the mesh's first rank writes the JSON. Without a torchrun
environment the command starts its ranks itself on this host
(`parallel.distributed.launch`: one a card, or processes over gloo with
`--device cpu`); a mesh of one rank runs in this process.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from popnet_tpu_torch.core.config import (ITOP_DATASET, KDH3D_DATASET, DatasetConfig,
                                          DecodeConfig, EncoderConfig)

# evaluate's RGB datasets and models: neither command line evaluates them
_RGB_SCORING = ("COCO results are scored by data.preprocessing.rgb_infer -> "
                "decode.openpose_infer.paf_decode_2d -> data.coco.coco_eval_results -> "
                "data.coco.run_coco_eval")
_NO_RGB_EVALUATE = {
    "coco": f"--dataset coco: neither command line evaluates an RGB model; {_RGB_SCORING}",
    "mpii": "--dataset mpii: neither command line evaluates an RGB model",
    "rtpose_vgg": f"rtpose_vgg: neither command line evaluates an RGB model (the JAX one's "
                  f"_build_model refuses it); {_RGB_SCORING}",
    "popnet_rgb": "popnet_rgb: neither command line evaluates an RGB model (the JAX one's "
                  "_build_model refuses it)",
}
# the one model each RGB dataset trains, and the refusal of the others (the JAX command line's)
_RGB_MODELS = {"coco": "rtpose_vgg", "mpii": "popnet_rgb"}


def _dataset_cfg(name: str) -> DatasetConfig:
    """The frame geometry, camera and depth statistics of `--dataset`."""
    return ITOP_DATASET if name == "itop" else KDH3D_DATASET


def _build_model(name: str, weights: str | None, seed: int, device: torch.device,
                 ckpt: str | None = None):
    """The float32 model `name` in eval mode on `device`, from the port's
    checkpoint directory `ckpt`, the npz `weights` or its seeded init."""
    from popnet_tpu_torch.interop.from_jax import load_into, load_npz
    from popnet_tpu_torch.models import A2J, PopNet, RTPoseLight3D, YoloPoseNet
    from popnet_tpu_torch.train.checkpoint import restore_params

    torch.manual_seed(seed)
    if name == "a2j":
        # the depth head starts at the dataset's depth prior (3.0 m)
        model = A2J(depth_prior=3.0)
        if weights is None and ckpt is None:
            model = model.init_seeded(seed)
    else:
        model = {"openpose": RTPoseLight3D, "popnet": PopNet, "yolo": YoloPoseNet}[name]()
    if ckpt is not None:
        model.load_state_dict(restore_params(ckpt)[0])
    elif weights is not None:
        load_into(model, load_npz(weights))
    return model.eval().to(device=device, dtype=torch.float32)


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def make_infers(model: str, weights: str | None = None, yolo_weights: str | None = None,
                seed: int = 0, device: str | torch.device = "cuda", ckpt: str | None = None,
                yolo_ckpt: str | None = None, fold_bn: bool = False, quant: str | None = None,
                spatial_mesh=None):
    """(infer, infer_yolo) for `model`'s driver: infer(images NHWC) -> the
    model's NHWC maps as the evaluation driver takes them (for "a2j", its heads from
    crops); infer_yolo is the stage-1 detector of "a2j" where `yolo_weights`
    or `yolo_ckpt` are given, else None. Weights come from the checkpoint
    directories (`ckpt`, `yolo_ckpt`) before the npz files. The CNNs run in
    float32, with their BatchNorms folded (`fold_bn`, both stages of "a2j")
    and their eligible convs in int8 (`quant="int8"`), rounded as the JAX
    command line's op-by-op call (`serving.deploy_model`). With
    `spatial_mesh` the CNN runs in height bands over it
    (`parallel.spatial.SpatialModel`), its outputs whole on every rank."""
    from popnet_tpu_torch.serving import deploy_model

    net = deploy_model(_build_model(model, weights, seed, device, ckpt), device, torch.float32,
                       fold_bn, quant, rounding="eager")
    if spatial_mesh is not None:
        from popnet_tpu_torch.parallel.spatial import SpatialModel

        net = SpatialModel(net, spatial_mesh)
    if model == "openpose":
        def infer(images):
            (paf, heat, z), _ = net(_nchw(images))
            return _nhwc(paf), _nhwc(heat), _nhwc(z)
    elif model == "popnet":
        def infer(images):
            maps, _ = net(_nchw(images))
            return tuple(_nhwc(t) for t in maps)
    elif model == "yolo":
        def infer(images):
            return _nhwc(net(_nchw(images)))
    else:
        def infer(crops):
            return net(_nchw(crops))
    infer_yolo = None
    if model == "a2j" and (yolo_weights or yolo_ckpt):
        infer_yolo = make_infers("yolo", yolo_weights, seed=seed, device=device,
                                 ckpt=yolo_ckpt, fold_bn=fold_bn, quant=quant)[0]
    return infer, infer_yolo


def run_evaluation(model: str, infer, dataset, batch_size: int = 32,
                   ecfg: EncoderConfig = EncoderConfig(), decfg: DecodeConfig = DecodeConfig(),
                   device_decode: bool = False, readout: str = "universe",
                   gt_boxes: bool = False, infer_yolo=None) -> dict:
    """`model`'s driver over `dataset` with `make_infers`'s functions, in
    inference mode with cuDNN's TF32 off -> the prediction JSON dict."""
    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.cli.yolo_a2j import run_yolo_a2j_eval

    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        if model == "openpose":
            return ev.run_openpose_eval(infer, dataset, batch_size, ecfg, decfg,
                                        device_decode=device_decode)
        if model == "popnet":
            return ev.run_popnet_eval(infer, dataset, batch_size, ecfg, decfg, readout=readout)
        if model == "yolo":
            return ev.run_yolo_eval(infer, dataset, batch_size, ecfg, decfg)
        return run_yolo_a2j_eval(infer_yolo, infer, dataset, batch_size, ecfg, decfg,
                                 gt_boxes=gt_boxes)


_YOLO_PRED_VIS = ("train: --pred-vis encodes 2 x (5 + 4 x 15) = 130 prior channels, and "
                  "YoloPoseNet's head has 2 x (5 + 3 x 15) = 100: the JAX package has no "
                  "visibility-aware Yolo loss (yolo_loss takes no pred_vis); train PoP-Net with it")


def _family(model: str, ecfg: EncoderConfig, pred_vis: bool = False):
    """(model, train step, eval loss, pose_align, with_prior) of a family."""
    from popnet_tpu_torch.models import PopNet, RTPoseLight3D, YoloPoseNet
    from popnet_tpu_torch.train import steps

    if model == "popnet":
        return (PopNet(pred_vis=pred_vis),
                steps.make_popnet_train_step(ecfg.num_joints, pred_vis),
                steps.make_popnet_eval_loss(ecfg.num_joints, pred_vis), True, True)
    if model == "openpose":
        return (RTPoseLight3D(), steps.make_rtpose_train_step(), steps.make_rtpose_eval_loss(),
                False, False)
    return (YoloPoseNet(), steps.make_yolo_train_step(ecfg.num_joints),
            steps.make_yolo_eval_loss(ecfg.num_joints), False, True)


def _train_dataset(args, labels: str, ecfg: EncoderConfig, pose_align: bool, with_prior: bool,
                   device, augment: bool = True, mp_aug: bool = False):
    """The training dataset under --data-root: with `mp_aug`, the mp-aug
    dataset of the --mp-label-prefix location files (host, device bank or
    streaming bank), else the KDH3D dataset of `labels`."""
    from popnet_tpu_torch.data import datasets

    root = args.data_root
    common = dict(ecfg=ecfg, dcfg=_dataset_cfg(args.dataset), pose_align=pose_align,
                  with_prior=with_prior, pred_vis=args.pred_vis, augment=augment, seed=args.seed,
                  transfer=args.transfer, cache_images=args.cache_images, device=device)
    if mp_aug:
        ann_files = sorted(os.path.join(root, f) for f in os.listdir(root)
                           if f.startswith(args.mp_label_prefix) and f.endswith(".json"))
        if not ann_files:
            raise SystemExit(f"train --mp-aug: no {args.mp_label_prefix}*.json in {root}")
        if args.stream_bank:
            from popnet_tpu_torch.data.streaming import StreamingDeviceMPAugDataset

            cls = StreamingDeviceMPAugDataset
            common.update(shard_indices=args.stream_bank, shard_repeats=args.stream_repeats)
        else:
            cls = datasets.DeviceMPAugDataset if args.device_bank else datasets.KDH3DMPAugDataset
        return cls(os.path.join(root, "depth_maps"), ann_files,
                   bg_file=os.path.join(root, "labels_bg.json"),
                   bg_dir=os.path.join(root, "bg_maps"), seg_dir=os.path.join(root, "seg_maps"),
                   **common)
    bg = args.bg_aug
    return datasets.KDH3DDataset(
        os.path.join(root, "depth_maps"), os.path.join(root, labels), bg_aug=bg,
        bg_file=os.path.join(root, "labels_bg.json") if bg else None,
        bg_dir=os.path.join(root, "bg_maps") if bg else None,
        seg_dir=os.path.join(root, "seg_maps") if bg else None, **common)


def _a2j_trainer(args, ecfg: EncoderConfig, device):
    """The A2J recipe (the JAX command line's `_train_a2j`): person crops
    of 288² from the training dataset that --mp-aug or --bg-aug pick
    (`A2JCropDataset`, augmented, with random erasing; with --dataset itop,
    `ITOPA2JCropDataset`'s torso crops with their box shifts and erasing,
    normalized by the absolute depth statistics as in the JAX command line),
    validation crops of --val-labels without mp-aug, augmentation or erasing;
    Adam with L2 weight decay, at 3.5e-4 where --lr is left at 1.0 and 1e-4
    where --weight-decay is left at 0; StepLR(10 epochs, 0.2); loss = anchor
    + 3 * regression. Returns (trainer, train set, validation set or None)."""
    from popnet_tpu_torch.data.a2j_crops import CROP, A2JCropDataset, ITOPA2JCropDataset
    from popnet_tpu_torch.models import A2J
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors
    from popnet_tpu_torch.train import steps
    from popnet_tpu_torch.train.loop import Trainer
    from popnet_tpu_torch.train.schedule import StepLR

    anchors = torch.as_tensor(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
                              dtype=torch.float32)
    wrap = ITOPA2JCropDataset if args.dataset == "itop" else A2JCropDataset
    train_ds = wrap(_train_dataset(args, args.labels, ecfg, False, False, device,
                                   mp_aug=args.mp_aug), seed=args.seed)
    val_ds = None
    if args.val_labels:
        inner = _train_dataset(args, args.val_labels, ecfg, False, False, device, augment=False)
        val_ds = wrap(inner, augment=False, seed=args.seed + 1)
    lr = args.lr if args.lr != 1.0 else 3.5e-4
    wd = args.weight_decay if args.weight_decay else 1e-4
    # the depth head starts at the dataset's depth prior (3.0 m), at ITOP too, as in the
    # JAX command line, though ITOP's labels carry torso-relative depths near 0
    trainer = Trainer(A2J(depth_prior=3.0), steps.make_a2j_train_step(anchors),
                      steps.make_a2j_eval_loss(anchors), learning_rate=lr, weight_decay=wd,
                      out_dir=args.out_dir, seed=args.seed, optimizer="adam",
                      scheduler=StepLR(lr, step_size=10, gamma=0.2), device=device)
    return trainer, train_ds, val_ds


def _rgb_trainer(args, device):
    """The RGB recipes (the JAX command line's `_train_coco` and
    `_train_mpii`): RTPoseVGG on COCO or PopNetRGB on MPII under
    --data-root/images, the training set of --labels (augmented) and the
    validation set of --val-labels, SGD-Nesterov at --lr with the plateau
    controller. Returns (trainer, train set, validation set or None)."""
    from popnet_tpu_torch.train import steps
    from popnet_tpu_torch.train.loop import Trainer

    images = os.path.join(args.data_root, "images")
    if args.dataset == "coco":
        from popnet_tpu_torch.data.coco_dataset import CocoKeypointsDataset
        from popnet_tpu_torch.models import RTPoseVGG

        jitter = None
        if args.scale_jitter:
            lo, hi = (float(v) for v in args.scale_jitter.split(","))
            jitter = (lo, hi)

        def make_ds(ann, is_train):
            return CocoKeypointsDataset(images, os.path.join(args.data_root, ann),
                                        input_y=args.input_size, input_x=args.input_size,
                                        is_train=is_train, seed=args.seed,
                                        rotate_max_deg=args.rotate_aug, scale_jitter=jitter,
                                        blur_max_sigma=args.blur_aug, device=device)

        model, step, eval_loss = (RTPoseVGG(trunk=args.trunk), steps.make_rtpose_vgg_train_step(),
                                  steps.make_rtpose_vgg_eval_loss())
    else:
        from popnet_tpu_torch.data.mpii import MPII_NUM_JOINTS, MPIIKeypointsDataset
        from popnet_tpu_torch.models import PopNetRGB

        def make_ds(ann, is_train):
            return MPIIKeypointsDataset(images, os.path.join(args.data_root, ann),
                                        input_y=args.input_size, input_x=args.input_size,
                                        is_train=is_train, seed=args.seed, device=device)

        model = PopNetRGB(num_parts=MPII_NUM_JOINTS)
        step = steps.make_popnet_rgb_train_step(MPII_NUM_JOINTS)
        eval_loss = steps.make_popnet_rgb_eval_loss(MPII_NUM_JOINTS)
    train_ds = make_ds(args.labels, True)
    val_ds = make_ds(args.val_labels, False) if args.val_labels else None
    trainer = Trainer(model, step, eval_loss, learning_rate=args.lr, momentum=args.momentum,
                      weight_decay=args.weight_decay, out_dir=args.out_dir, seed=args.seed,
                      device=device)
    return trainer, train_ds, val_ds


def _parse_mesh(spec: str, available: int | None = None) -> tuple[str, dict]:
    """--mesh "data=4,model=2" -> (layout, {"data": 4, "model": 2}): data
    (optional; `available` ranks over the other axis's size, else 1) plus
    at most one of model (tensor parallel), spatial or pipe (GPipe)."""
    try:
        sizes = {k: int(v) for k, v in (p.split("=") for p in spec.split(","))}
    except ValueError:
        raise SystemExit(f"bad --mesh spec {spec!r} (want e.g. data=4,model=2)") from None
    n_data = sizes.pop("data", None)
    if not sizes:
        return "dp", {"data": n_data or available or 1}
    if len(sizes) > 1:
        raise SystemExit("--mesh supports data plus ONE of model|spatial|pipe")
    (axis, n), = sizes.items()
    layouts = {"model": "tp", "spatial": "sp", "pipe": "pp"}
    if axis not in layouts:
        raise SystemExit(f"unknown mesh axis {axis!r} (model | spatial | pipe)")
    if n < 1 or (n_data is not None and n_data < 1):
        raise SystemExit(f"bad --mesh spec {spec!r}: sizes are at least 1")
    return layouts[axis], {"data": n_data or max(1, (available or n) // n), axis: n}


def _available_ranks(device: str) -> int | None:
    """The ranks a mesh that leaves `data` out fills: a job's, the host's
    cards, or None on the CPU."""
    from popnet_tpu_torch.parallel.distributed import under_launcher

    if under_launcher():
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return None


def _uses_mesh(args) -> bool:
    """train --mesh, but where the JAX command line ignores it (A2J, COCO,
    MPII) unless it pipelines, which it refuses there first."""
    if not args.mesh:
        return False
    layout, _ = _parse_mesh(args.mesh, _available_ranks(args.device))
    return layout == "pp" or not (args.model == "a2j" or args.dataset in _RGB_MODELS)


def _job_ranks(args) -> int | None:
    """The ranks the command runs on (None: one process, no mesh); refuses,
    in the calling process, what the JAX command line refuses."""
    if args.cmd == "train" and args.mesh:
        layout, shape = _parse_mesh(args.mesh, _available_ranks(args.device))
        if layout == "pp":
            if args.model != "openpose":
                raise SystemExit("--mesh ...,pipe=N pipelines the CPM stage family; use "
                                 "--model openpose")
            if args.batch_size % (shape["data"] * args.n_micro):
                raise SystemExit(f"batch {args.batch_size} must divide data axis "
                                 f"({shape['data']}) x n_micro ({args.n_micro})")
        return math.prod(shape.values()) if _uses_mesh(args) else None
    if args.cmd == "evaluate" and args.spatial and args.model != "a2j":
        if args.input_size % args.spatial:
            raise SystemExit(f"--spatial {args.spatial} must divide --input-size "
                             f"{args.input_size}")
        if args.quant:
            raise SystemExit("evaluate --spatial: the int8 convs take one dynamic scale an "
                             "activation, which the height bands do not share; run --spatial "
                             "in float32")
        available = _available_ranks(args.device)
        return max(1, (available or args.spatial) // args.spatial) * args.spatial
    return None


def _mesh_of(args):
    """The command's Mesh over the job (built collectively on every rank)."""
    from popnet_tpu_torch.parallel.distributed import world_size
    from popnet_tpu_torch.parallel.mesh import Mesh

    if args.cmd == "train":
        layout, shape = _parse_mesh(args.mesh, world_size())
    else:
        layout, shape = "sp", {"data": max(1, world_size() // args.spatial),
                               "spatial": args.spatial}
    n = math.prod(shape.values())
    if n != world_size():
        raise SystemExit(f"the mesh {shape} needs {n} ranks and the job has {world_size()}")
    return layout, Mesh(shape)


def _writes() -> bool:
    """This process writes the command's files (the job's first rank)."""
    from popnet_tpu_torch.parallel.distributed import rank

    return rank() == 0


def _train_openpose_pipelined(args, mesh, device):
    """GPipe-pipelined Open-Pose+ training (the JAX command line's
    `_train_openpose_pipelined`): the stem on each data shard's first pipe
    rank, the stages over the pipe, `--n-micro` microbatches; the final
    checkpoint in the sequential layout, so `evaluate --ckpt` scores it.
    Returns the history."""
    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.parallel import pipeline as pp
    from popnet_tpu_torch.train import checkpoint as ckpt
    from popnet_tpu_torch.train.state import make_optimizer

    ecfg = EncoderConfig(input_x=args.input_size, input_y=args.input_size)
    model = RTPoseLight3D().init_seeded(args.seed).to(device)
    state = pp.create_pipeline_train_state(model, mesh, args.lr, args.momentum,
                                           args.weight_decay)
    step = pp.make_pipeline_train_step(args.n_micro)
    train_ds = _train_dataset(args, args.labels, ecfg, False, False, device, mp_aug=args.mp_aug)
    os.makedirs(args.out_dir, exist_ok=True)
    history = []
    for epoch in range(args.epochs):
        losses = [step(state, batch)[1]["loss"] for batch in train_ds.iter_batches(args.batch_size)]
        train_loss = float(torch.stack(losses).double().mean()) if losses else 0.0
        rec = {"epoch": epoch, "train_loss": train_loss}
        history.append(rec)
        if _writes():
            print(f"epoch {epoch} [pipelined x{mesh.shape['pipe']}] loss {train_loss:.4f}",
                  flush=True)
            with open(os.path.join(args.out_dir, "history.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
    sd = pp.sequential_state_dict(state)
    if _writes():
        seq = RTPoseLight3D()
        seq.load_state_dict(sd)
        opt = make_optimizer(seq, "sgd", args.lr, args.momentum, args.weight_decay)
        ckpt.save_checkpoint(os.path.join(args.out_dir, "ckpt"),
                             {"model": seq.state_dict(), "optimizer": opt.state_dict()},
                             step=args.epochs - 1,
                             metadata={"pipelined": True, "n_pipe": int(mesh.shape["pipe"])})
    return history


def cmd_train(args):
    """Train a depth or RGB family (`train --help`); returns the Trainer
    (the pipelined run's history)."""
    from popnet_tpu_torch.core.device import resolve_device
    from popnet_tpu_torch.train.loop import Trainer
    from popnet_tpu_torch.train.schedule import WarmupCosine

    layout, mesh = "dp", None
    if _job_ranks(args) is not None:
        layout, mesh = _mesh_of(args)
    elif args.mesh:
        print(f"train --model {args.model} --dataset {args.dataset}: --mesh is ignored, as the "
              "JAX command line ignores it there (one device)", flush=True)
    rgb = args.dataset in _RGB_MODELS
    if rgb and args.model != _RGB_MODELS[args.dataset]:
        raise SystemExit(f"--dataset {args.dataset} trains --model {_RGB_MODELS[args.dataset]}")
    if not rgb and args.model in _RGB_MODELS.values():
        dataset = next(d for d, m in _RGB_MODELS.items() if m == args.model)
        raise SystemExit(f"train: {args.model} trains with --dataset {dataset}")
    if args.model == "yolo" and args.pred_vis:
        raise SystemExit(_YOLO_PRED_VIS)

    device = resolve_device(args.device)
    ecfg = EncoderConfig(input_x=args.input_size, input_y=args.input_size)
    if layout == "pp":
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return _train_openpose_pipelined(args, mesh, device)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    if rgb:
        trainer, train_ds, val_ds = _rgb_trainer(args, device)
    elif args.model == "a2j":
        trainer, train_ds, val_ds = _a2j_trainer(args, ecfg, device)
    else:
        model, step, eval_loss, pose_align, with_prior = _family(args.model, ecfg,
                                                                  args.pred_vis)
        train_ds = _train_dataset(args, args.labels, ecfg, pose_align, with_prior, device,
                                  mp_aug=args.mp_aug)
        val_ds = None
        if args.val_labels:
            val_ds = _train_dataset(args, args.val_labels, ecfg, pose_align, with_prior, device,
                                    augment=False)
        scheduler = None
        if args.schedule == "cosine":
            scheduler = WarmupCosine(args.lr, total_epochs=args.total_epochs or args.epochs,
                                     warmup_epochs=args.warmup_epochs)
        trainer = Trainer(model, step, eval_loss, learning_rate=args.lr, momentum=args.momentum,
                          weight_decay=args.weight_decay, out_dir=args.out_dir, seed=args.seed,
                          optimizer=args.optimizer, scheduler=scheduler, device=device,
                          mesh=mesh, layout=layout)
        if args.lr_patience is not None and args.schedule == "plateau":
            # patience past the epoch budget holds the rate constant
            trainer.scheduler.patience = args.lr_patience
    if args.resume:
        trainer.resume()
    if _writes():
        where = f"{device}" if mesh is None else f"{mesh.size} ranks {mesh.shape} ({layout})"
        print(f"train {args.model} on {where}: float32 convolutions, TF32 off", flush=True)
    tf32 = torch.backends.cudnn.allow_tf32      # the other cuDNN flags stay as the caller set them
    torch.backends.cudnn.allow_tf32 = False
    # the RGB recipes validate and checkpoint every epoch, as the JAX command line's do
    every = {} if rgb else {"checkpoint_every": args.ckpt_every, "val_every": args.val_every}
    try:
        trainer.fit(train_ds, val_ds, epochs=args.epochs, batch_size=args.batch_size, **every)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return trainer


def cmd_evaluate(args) -> dict:
    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.core.device import resolve_device
    from popnet_tpu_torch.data.datasets import MPRealDataset
    from popnet_tpu_torch.train.checkpoint import checkpoint_steps

    for refused in (args.dataset, args.model):
        if refused in _NO_RGB_EVALUATE:
            raise SystemExit(f"evaluate {_NO_RGB_EVALUATE[refused]}")
    if args.model == "a2j" and not (args.yolo_weights or args.yolo_ckpt or args.gt_boxes):
        raise SystemExit("evaluate --model a2j needs --yolo-ckpt or --yolo-weights (the "
                         "stage-1 detector) or --gt-boxes (the label-box ablation)")

    for opt in ("ckpt", "yolo_ckpt"):
        d = getattr(args, opt)
        if d is not None and not checkpoint_steps(d):
            raise SystemExit(f"evaluate: no checkpoint of the port in {d!r} (train writes "
                             "<out-dir>/ckpt; the JAX package's orbax checkpoints are not read)")

    device = resolve_device(args.device)
    ecfg = EncoderConfig(input_x=args.input_size, input_y=args.input_size)
    decfg = DecodeConfig()
    dataset = MPRealDataset(
        os.path.join(args.data_root, "depth_maps"), os.path.join(args.data_root, args.labels),
        ecfg=ecfg, dcfg=_dataset_cfg(args.dataset), device=device,
    )
    quant = args.quant
    if args.model == "a2j" and quant:
        print("evaluate --model a2j: --quant is ignored, as the JAX command line ignores it "
              "(both stages run float32 convs)")
        quant = None
    if args.model == "a2j" and args.spatial:
        print("evaluate --model a2j: --spatial is ignored, as the JAX command line ignores it")
    mesh = _mesh_of(args)[1] if _job_ranks(args) is not None else None
    infer, infer_yolo = make_infers(args.model, args.weights, args.yolo_weights, args.seed,
                                    device, ckpt=args.ckpt, yolo_ckpt=args.yolo_ckpt,
                                    fold_bn=args.fold_bn, quant=quant, spatial_mesh=mesh)
    data = run_evaluation(args.model, infer, dataset, args.batch_size, ecfg, decfg,
                          device_decode=args.device_decode, readout=args.readout,
                          gt_boxes=args.gt_boxes, infer_yolo=infer_yolo)

    out_json = os.path.join(args.out_dir, f"{args.model}_results.json")
    if _writes():
        os.makedirs(args.out_dir, exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(data, f)
        print(f"wrote {out_json}")
    result = ev.evaluate_eval_data(data, verbose=_writes())
    if "human_pred_set_3d_perfect_2d" in data and _writes():
        print("ablation 3D-PCK channels:",
              json.dumps(ev.evaluate_ablation_channels(data, ecfg.num_joints)))
    return result


def cmd_benchmark(args) -> dict:
    """Score a prediction JSON against a labels JSON; returns the metrics."""
    from popnet_tpu_torch.cli.evaluate import evaluate_predictions
    from popnet_tpu_torch.data.labels import load_label_file

    res = json.load(open(args.pred))
    if args.aligned or ("pop" in os.path.basename(args.pred)
                        and "human_pred_set_2d_aligned" in res):
        p2, p3 = res["human_pred_set_2d_aligned"], res["human_pred_set_3d_aligned"]
    else:
        p2, p3 = res["human_pred_set_2d"], res["human_pred_set_3d"]

    anno_dic, _ = load_label_file(args.gt)
    gt2d = [[a["2d_joints"] for a in anns] for anns in anno_dic.values()]
    gt3d = [[a["3d_joints"] for a in anns] for anns in anno_dic.values()]
    return evaluate_predictions(p2, p3, res.get("human_pred_set_part_conf", []), gt2d, gt3d)


def cmd_visualize(args, gt: bool) -> list[str]:
    """Draw the GT (`gt`) or the predictions of --pred over each frame's
    depth into --out-dir/{i:06d}.jpg; returns the paths written."""
    import numpy as np

    from popnet_tpu_torch.core.device import resolve_device
    from popnet_tpu_torch.data.image_io import imwrite_jpeg
    from popnet_tpu_torch.data.labels import load_label_file
    from popnet_tpu_torch.viz import visualize_gt, visualize_pred

    device = resolve_device(args.device)
    anno_dic, _ = load_label_file(os.path.join(args.data_root, args.labels))
    os.makedirs(args.out_dir, exist_ok=True)
    preds = None
    if not gt:
        with open(args.pred) as f:
            preds = json.load(f)
        key = ("human_pred_set_2d_aligned" if "human_pred_set_2d_aligned" in preds
               else "human_pred_set_2d")
    written = []
    for i, (image_id, anns) in enumerate(anno_dic.items()):
        if args.limit and i >= args.limit:
            break
        depth = torch.from_numpy(np.load(os.path.join(args.data_root, "depth_maps", image_id)))
        depth = depth.to(device)
        if gt:
            seg_path = os.path.join(args.data_root, "seg_maps", image_id)
            seg = torch.from_numpy(np.load(seg_path)) if os.path.exists(seg_path) else None
            img = visualize_gt(depth, anns, seg=seg)
        else:
            img = visualize_pred(depth, [np.asarray(h) for h in preds[key][i]])
        path = os.path.join(args.out_dir, f"{i:06d}.jpg")
        imwrite_jpeg(path, img)
        written.append(path)
    print(f"wrote images to {args.out_dir}")
    return written


def cmd_generate_augset(args) -> dict:
    """Freeze DATA's bg-aug or mp-aug composite into a static test set in
    --out-dir; returns the labels written."""
    from popnet_tpu_torch.core.device import resolve_device
    from popnet_tpu_torch.data import construction
    from popnet_tpu_torch.data.datasets import KDH3DDataset, KDH3DMPAugDataset

    device = resolve_device(args.device)
    root = args.data_root
    scene = dict(bg_file=os.path.join(root, "labels_bg.json"),
                 bg_dir=os.path.join(root, "bg_maps"), seg_dir=os.path.join(root, "seg_maps"),
                 ecfg=EncoderConfig(), augment=False, seed=args.seed, device=device)
    if args.kind == "bgaug":
        ds = KDH3DDataset(os.path.join(root, "depth_maps"), os.path.join(root, args.labels),
                          bg_aug=True, **scene)
        generate = construction.generate_bgaug_set
    else:
        ann_files = sorted(os.path.join(root, f) for f in os.listdir(root)
                           if f.startswith(args.mp_label_prefix) and f.endswith(".json"))
        ds = KDH3DMPAugDataset(os.path.join(root, "depth_maps"), ann_files, **scene)
        generate = construction.generate_mpaug_set
    labels = generate(ds, args.out_dir, args.n_images, augment=args.augment)
    print(f"frozen {args.kind} set written to {args.out_dir}")
    return labels


def build_parser():
    p = argparse.ArgumentParser(prog="popnet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--data-root", required=True)
        sp.add_argument("--labels", default="labels.json")
        sp.add_argument("--dataset", choices=["kdh3d", "itop", "coco", "mpii"],
                        default="kdh3d")
        sp.add_argument("--model", choices=["popnet", "openpose", "yolo", "a2j", "rtpose_vgg",
                                            "popnet_rgb"], default="popnet")
        sp.add_argument("--input-size", type=int, default=224)
        sp.add_argument("--batch-size", type=int, default=32)
        sp.add_argument("--out-dir", default="runs/out")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda",
                        help="torch device everything runs on (cuda or cpu)")

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--lr", type=float, default=1.0)
    t.add_argument("--momentum", type=float, default=0.9)
    t.add_argument("--transfer", choices=["f32", "u16mm"], default="f32",
                   help="host->device image transfer: f32 metres or uint16 millimetres "
                        "(half the bytes; lossless for mm-native recordings)")
    t.add_argument("--weight-decay", type=float, default=0.0)
    t.add_argument("--optimizer", choices=["sgd", "adam"], default="sgd",
                   help="sgd = SGD-Nesterov 0.9 (the CPM recipe); adam = Adam with L2")
    t.add_argument("--schedule", choices=["plateau", "cosine"], default="plateau",
                   help="plateau = ReduceLROnPlateau on the validation loss; cosine = "
                        "warmup + cosine over --total-epochs")
    t.add_argument("--warmup-epochs", type=int, default=0)
    t.add_argument("--total-epochs", type=int, default=None,
                   help="cosine horizon (defaults to --epochs; set it when training in "
                        "resumed chunks)")
    t.add_argument("--val-every", type=int, default=1,
                   help="validate and update the best every N epochs (the last always)")
    t.add_argument("--ckpt-every", type=int, default=None,
                   help="save the periodic checkpoint every N epochs")
    t.add_argument("--cache-images", action="store_true",
                   help="keep decoded .npy frames in host RAM across epochs (~1 MB a frame)")
    t.add_argument("--lr-patience", type=int, default=None,
                   help="ReduceLROnPlateau patience (default 5; >= epochs holds the rate)")
    t.add_argument("--bg-aug", action="store_true",
                   help="composite each frame over a background (seg_maps, bg_maps)")
    t.add_argument("--val-labels", default=None,
                   help="label JSON under --data-root to validate on, without augmentation")
    t.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --out-dir/ckpt")
    t.add_argument("--mp-aug", action="store_true",
                   help="multi-person frames z-buffered from the per-location recordings "
                        "(DATA/<--mp-label-prefix>*.json, seg_maps, bg_maps)")
    t.add_argument("--mp-label-prefix", default="labels_loc",
                   help="--mp-aug: the location label files' prefix")
    t.add_argument("--device-bank", action="store_true",
                   help="--mp-aug: keep the whole scene bank on the device (uint16 mm, "
                        "~0.74 MB a recording) and composite there; per step only ids "
                        "and labels cross to the device")
    t.add_argument("--stream-bank", type=int, default=0, metavar="N",
                   help="--mp-aug: stream the scene bank through the device in shards of N "
                        "sample indices, two at most resident (data/streaming.py)")
    t.add_argument("--stream-repeats", type=int, default=1,
                   help="--stream-bank: passes over each resident shard an epoch")
    t.add_argument("--pred-vis", action="store_true",
                   help="popnet: the prior also predicts each joint's visibility, inferred "
                        "from the z-buffered pose-depth map (PopNet(pred_vis=True))")
    t.add_argument("--trunk", choices=["vgg19", "mobilenet"], default="vgg19",
                   help="rtpose_vgg's trunk (--dataset coco)")
    t.add_argument("--rotate-aug", type=float, default=0.0, metavar="DEG",
                   help="--dataset coco: a random rotation a frame, uniform in +-DEG, the "
                        "canvas expanded")
    t.add_argument("--scale-jitter", default=None, metavar="LO,HI",
                   help="--dataset coco: a uniform scale factor in [LO, HI] folded into the "
                        "letterbox, e.g. 0.5,1.0")
    t.add_argument("--blur-aug", type=float, default=0.0, metavar="SIGMA",
                   help="--dataset coco: a Gaussian blur a frame, sigma uniform in [0, SIGMA]")
    t.add_argument("--mesh", default=None,
                   help="rank mesh layout, e.g. data=4 | data=4,model=2 (tensor parallel) | "
                        "data=2,spatial=4 (height-sharded) | data=1,pipe=2 (GPipe, --model "
                        "openpose); ranks start on this host without torchrun")
    t.add_argument("--n-micro", type=int, default=2,
                   help="GPipe microbatches per data shard's batch (--mesh ...,pipe=N)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate")
    common(e)
    e.add_argument("--ckpt", default=None,
                   help="the model's checkpoint directory, as train writes it (<out>/ckpt)")
    e.add_argument("--yolo-ckpt", default=None,
                   help="the stage-1 detector's checkpoint directory for --model a2j")
    e.add_argument("--weights", default=None,
                   help="the model's Flax variables as an npz (interop.load_npz)")
    e.add_argument("--yolo-weights", default=None,
                   help="the stage-1 detector's npz for --model a2j (two-stage Yolo->A2J)")
    e.add_argument("--gt-boxes", action="store_true",
                   help="--model a2j: crop from the labels' person bboxes instead of "
                        "detector boxes (the A2J-in-isolation ablation)")
    e.add_argument("--readout", choices=["gated", "universe"], default="universe",
                   help="PoP-Net alignment readout")
    e.add_argument("--device-decode", action="store_true",
                   help="run the whole Open-Pose+ decode (assembly, z readouts, "
                        "back-projection) on the device")
    e.add_argument("--fold-bn", action="store_true", dest="fold_bn",
                   help="fold each Conv -> BatchNorm pair into the conv (exact; both stages "
                        "of --model a2j)")
    e.add_argument("--quant", choices=["int8"], default=None,
                   help="int8: dynamic int8 for the CNN's eligible convs (ignored by --model "
                        "a2j, as in the JAX command line)")
    e.add_argument("--spatial", type=int, default=0, metavar="N",
                   help="run the CNN in N height bands over a (data, spatial=N) mesh of ranks "
                        "(parallel/spatial.py halo exchanges); N must divide --input-size")
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("benchmark")
    b.add_argument("--gt", required=True)
    b.add_argument("--pred", required=True)
    b.add_argument("--aligned", action="store_true")
    b.set_defaults(fn=cmd_benchmark)

    vg = sub.add_parser("visualize-gt")
    common(vg)
    vg.add_argument("--limit", type=int, default=0)
    vg.set_defaults(fn=lambda a: cmd_visualize(a, gt=True))

    vp = sub.add_parser("visualize-pred")
    common(vp)
    vp.add_argument("--pred", required=True)
    vp.add_argument("--limit", type=int, default=0)
    vp.set_defaults(fn=lambda a: cmd_visualize(a, gt=False))

    g = sub.add_parser("generate-augset")
    common(g)
    g.add_argument("--kind", choices=["bgaug", "mpaug"], required=True)
    g.add_argument("--n-images", type=int, default=None)
    g.add_argument("--mp-label-prefix", default="labels_loc")
    g.add_argument("--augment", action="store_true",
                   help="freeze-time Rotate/RenderDepth/Resize like the reference generator")
    g.set_defaults(fn=cmd_generate_augset)
    return p


def _cli_rank(argv):
    """One rank of a job that `main` launched: the command, and what rank 0
    hands back (a Trainer's history)."""
    from popnet_tpu_torch.train.loop import Trainer

    out = main(argv)
    return out.history if isinstance(out, Trainer) else out


def main(argv=None):
    """Run a subcommand. A command over a mesh of several ranks outside a
    job starts the job on this host and returns its first rank's result."""
    import torch.distributed as dist

    from popnet_tpu_torch.parallel import distributed

    args = build_parser().parse_args(argv)
    ranks = _job_ranks(args)
    if ranks is None or dist.is_initialized():
        return args.fn(args)
    if distributed.under_launcher():
        distributed.initialize(device=args.device)
        return args.fn(args)
    distributed.check_cards(ranks, args.device)
    if ranks == 1:
        with distributed.single_rank_job(args.device):
            return args.fn(args)
    argv = list(argv) if argv is not None else sys.argv[1:]
    threads = torch.get_num_threads() if torch.device(args.device).type == "cpu" else None
    return distributed.launch(_cli_rank, ranks, (argv,), device=args.device, threads=threads)


if __name__ == "__main__":
    main()
