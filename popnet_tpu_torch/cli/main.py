"""The port's command line: the `evaluate` and `benchmark` subcommands.

    python -m popnet_tpu_torch.cli.main evaluate --model openpose \\
        --data-root DATA --weights examples/results/bench_weights_openpose.npz
    python -m popnet_tpu_torch.cli.main benchmark --gt DATA/labels.json \\
        --pred runs/out/openpose_results.json

`evaluate` runs a model over an MP-3DHP-format dataset (DATA/depth_maps/*.npy
and the label JSON `--labels`) on the card, or on the CPU with
`--device cpu`, writes `<model>_results.json` (the benchmark's prediction
JSON) to `--out-dir` and prints the four metrics. `benchmark` scores a
prediction JSON against a label file. The CNNs run in float32 (no TF32).
Weights are npz files of Flax variables (`interop.load_npz`); without
`--weights` a model starts from its seeded init (`torch.manual_seed(--seed)`;
A2J's `init_seeded`), which predicts nothing but drives every stage.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from popnet_tpu_torch.core.config import KDH3D_DATASET, DecodeConfig, EncoderConfig

# what each option of the JAX command line that the port lacks waits for
_NOT_PORTED = {
    "ckpt": "orbax checkpoints (--ckpt) wait for ROADMAP Queue 1 item 11; pass --weights",
    "yolo_ckpt": "orbax checkpoints (--yolo-ckpt) wait for ROADMAP Queue 1 item 11; "
                 "pass --yolo-weights",
    "fold_bn": "--fold-bn waits for ROADMAP Queue 1 item 12",
    "quant": "--quant waits for ROADMAP Queue 1 item 12",
    "spatial": "--spatial waits for ROADMAP Queue 1 item 13",
}
_NOT_PORTED_DATASETS = {
    "itop": "ITOP evaluation waits for ROADMAP Queue 1 item 9b",
    "coco": "COCO evaluation waits for ROADMAP Queue 1 item 9b",
    "mpii": "MPII evaluation waits for ROADMAP Queue 1 item 9b",
}
_NOT_PORTED_MODELS = {
    "rtpose_vgg": "rtpose_vgg evaluates on COCO, which waits for ROADMAP Queue 1 item 9b",
    "popnet_rgb": "popnet_rgb evaluates on MPII, which waits for ROADMAP Queue 1 item 9b",
}


def _build_model(name: str, weights: str | None, seed: int, device: torch.device):
    """The float32 model `name` in eval mode on `device`, from the npz
    `weights` or from its seeded init."""
    from popnet_tpu_torch.interop.from_jax import load_into, load_npz
    from popnet_tpu_torch.models import A2J, PopNet, RTPoseLight3D, YoloPoseNet

    torch.manual_seed(seed)
    if name == "a2j":
        # the depth head starts at the dataset's depth prior (3.0 m)
        model = A2J(depth_prior=3.0)
        model = model.init_seeded(seed) if weights is None else load_into(model, load_npz(weights))
    else:
        model = {"openpose": RTPoseLight3D, "popnet": PopNet, "yolo": YoloPoseNet}[name]()
        if weights is not None:
            load_into(model, load_npz(weights))
    return model.eval().to(device=device, dtype=torch.float32)


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def make_infers(model: str, weights: str | None = None, yolo_weights: str | None = None,
                seed: int = 0, device: str | torch.device = "cuda"):
    """(infer, infer_yolo) for `model`'s driver: infer(images NHWC) -> the
    model's NHWC maps as the evaluation driver takes them (for "a2j", its heads from
    crops); infer_yolo is the stage-1 detector of "a2j" where `yolo_weights`
    are given, else None. The CNNs run in float32."""
    net = _build_model(model, weights, seed, device)
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
    if model == "a2j" and yolo_weights:
        infer_yolo = make_infers("yolo", yolo_weights, seed=seed, device=device)[0]
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


def cmd_evaluate(args) -> dict:
    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.core.device import resolve_device
    from popnet_tpu_torch.data.datasets import MPRealDataset

    for opt, why in _NOT_PORTED.items():
        if getattr(args, opt):
            raise SystemExit(f"evaluate: {why}")
    if args.dataset in _NOT_PORTED_DATASETS:
        raise SystemExit(f"evaluate: {_NOT_PORTED_DATASETS[args.dataset]}")
    if args.model in _NOT_PORTED_MODELS:
        raise SystemExit(f"evaluate: {_NOT_PORTED_MODELS[args.model]}")
    if args.model == "a2j" and not args.yolo_weights and not args.gt_boxes:
        raise SystemExit("evaluate --model a2j needs --yolo-weights (the stage-1 detector) "
                         "or --gt-boxes (the label-box ablation)")

    device = resolve_device(args.device)
    ecfg = EncoderConfig(input_x=args.input_size, input_y=args.input_size)
    decfg = DecodeConfig()
    dataset = MPRealDataset(
        os.path.join(args.data_root, "depth_maps"), os.path.join(args.data_root, args.labels),
        ecfg=ecfg, dcfg=KDH3D_DATASET, device=device,
    )
    infer, infer_yolo = make_infers(args.model, args.weights, args.yolo_weights, args.seed,
                                    device)
    data = run_evaluation(args.model, infer, dataset, args.batch_size, ecfg, decfg,
                          device_decode=args.device_decode, readout=args.readout,
                          gt_boxes=args.gt_boxes, infer_yolo=infer_yolo)

    os.makedirs(args.out_dir, exist_ok=True)
    out_json = os.path.join(args.out_dir, f"{args.model}_results.json")
    with open(out_json, "w") as f:
        json.dump(data, f)
    print(f"wrote {out_json}")
    result = ev.evaluate_eval_data(data)
    if "human_pred_set_3d_perfect_2d" in data:
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


def build_parser():
    p = argparse.ArgumentParser(prog="popnet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("evaluate")
    e.add_argument("--data-root", required=True)
    e.add_argument("--labels", default="labels.json")
    e.add_argument("--dataset", choices=["kdh3d", "itop", "coco", "mpii"], default="kdh3d")
    e.add_argument("--model", choices=["popnet", "openpose", "yolo", "a2j", "rtpose_vgg",
                                       "popnet_rgb"], default="popnet")
    e.add_argument("--input-size", type=int, default=224)
    e.add_argument("--batch-size", type=int, default=32)
    e.add_argument("--out-dir", default="runs/out")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--device", default="cuda",
                   help="torch device the models, decodes and batches run on (cuda or cpu)")
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
    # options of the JAX command line that the port does not have yet: they raise
    e.add_argument("--ckpt", default=None, help=argparse.SUPPRESS)
    e.add_argument("--yolo-ckpt", default=None, help=argparse.SUPPRESS)
    e.add_argument("--fold-bn", action="store_true", dest="fold_bn", help=argparse.SUPPRESS)
    e.add_argument("--quant", choices=["int8"], default=None, help=argparse.SUPPRESS)
    e.add_argument("--spatial", type=int, default=0, help=argparse.SUPPRESS)
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("benchmark")
    b.add_argument("--gt", required=True)
    b.add_argument("--pred", required=True)
    b.add_argument("--aligned", action="store_true")
    b.set_defaults(fn=cmd_benchmark)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
