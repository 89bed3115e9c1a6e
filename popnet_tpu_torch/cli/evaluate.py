"""MP-3DHP evaluation drivers producing the benchmark's prediction JSON.

The port's counterpart of the JAX package's `popnet_tpu/cli/evaluate.py`:

- run_openpose_eval: dense maps -> peaks (K1) and PAF pair scores (K3) on
  the device, greedy assembly on the host (`decode/assemble.py`), the
  heat-weighted z readout and back-projection on the host; or, with
  `device_decode=True`, the whole decode on the device (`openpose_decode`:
  K1, K3, K6 and the fused readouts). Both emit the raw-depth and
  perfect-2D ablation channels.
- run_yolo_eval: prior decode and NMS -> scale -> back-projection.
- run_popnet_eval: prior decode + alignment and z refinement (K7) ->
  the `*_aligned` keys, beside the plain prior decode's keys.
- evaluate_predictions: the four benchmark metrics from (pred, gt) sets.

Each run_* takes `infer(images) -> model outputs`: `images` is the
dataset's batch as it lies on its device ((B, input_y, input_x, 1),
normalized), and the outputs are torch tensors, NHWC, so the same driver
serves the CNNs and GT-map oracles. The host arithmetic (the z
denormalization, the int() truncations, the visible-joint scaling, the
float64 back-projection) is NumPy, as in the JAX package: given equal maps
the JSON equals the JAX driver's. A batch's maps leave the device in one
copy per tensor.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from popnet_tpu_torch.core.camera import CameraIntrinsics, back_project_np
from popnet_tpu_torch.core.config import DecodeConfig, DepthStats, EncoderConfig
from popnet_tpu_torch.core.skeleton import KEYPOINT_NAMES
from popnet_tpu_torch.decode import prior as prior_decode, readout
from popnet_tpu_torch.decode.assemble import assemble_batch
from popnet_tpu_torch.decode.device import find_peaks_batched, score_limb_pairs_batched
from popnet_tpu_torch.decode.openpose_infer import openpose_decode
from popnet_tpu_torch.decode.popnet_infer import popnet_decode
from popnet_tpu_torch.eval import map as eval_map, pck as eval_pck


def _host(t) -> np.ndarray:
    """One tensor to the host as float32 NumPy (one copy)."""
    return t.detach().float().cpu().numpy()


def _scale_visible(human, vis, sx, sy):
    h = np.asarray(human, dtype=np.float64)
    idx = np.where(np.asarray(vis) > 0.5)[0]
    h[idx, 0] *= sx
    h[idx, 1] *= sy
    return h


def _back_project(h2d, z, cam: CameraIntrinsics):
    return back_project_np(h2d[:, 0], h2d[:, 1], np.asarray(z), cam)


def run_openpose_eval(
    infer,
    dataset,
    batch_size: int = 16,
    ecfg: EncoderConfig = EncoderConfig(),
    dcfg: DecodeConfig = DecodeConfig(),
    fast: bool = True,
    device_decode: bool = False,
):
    """Open-Pose+ inference over an eval dataset -> benchmark eval_data dict.

    `infer(image_batch)` must return (paf, heat, z) NHWC with z in
    NORMALIZED units (the raw model output).

    The default host path finds peaks and scores PAF pairs on the device
    and assembles, reads z and back-projects on the host in float64;
    `device_decode=True` runs the whole decode on the device
    (decode/openpose_infer.py). `fast=False`, the exact host decode of the
    JAX package, is not ported."""
    if not fast:
        raise NotImplementedError(
            "fast=False (the exact host decode) is not ported yet: ROADMAP Queue 1 item 9b")
    cam = dataset.intrinsics or dataset.dcfg.intrinsics
    depth: DepthStats = dataset.dcfg.depth
    w_org, h_org = dataset.dcfg.width, dataset.dcfg.height

    pred2d_set, pred3d_set, pred3d_raw_set = [], [], []
    pred3d_p2d_set, pred3d_p2d_raw_set = [], []
    conf_set, vis_set = [], []
    gt2d_set, gt3d_set = dataset.gt_human_lists()

    n = len(dataset)
    for s in range(0, n, batch_size):
        idx = list(range(s, min(s + batch_size, n)))
        images = dataset.get_batch(idx)["image"]  # (B, H, W, 1) normalized, on the device
        paf, heat, zmap_n = infer(images)
        heat_h = _host(heat)
        zmap = _host(zmap_n) * depth.std + depth.mean
        raw_img = _host(images)[..., 0] * depth.std + depth.mean

        if device_decode:
            std = torch.full((), float(depth.std), device=heat.device)
            out = openpose_decode(
                heat, paf, torch.as_tensor(zmap - depth.mean, device=heat.device) / std,
                images, ecfg, dcfg, depth, cam, w_out=float(w_org), h_out=float(h_org),
            )
            j2, j3, j3r, dconf = (_host(out[k]).astype(np.float64) for k in
                                  ("joints2d", "joints3d", "joints3d_raw", "conf"))
            dvis = out["visibility"].cpu().numpy()
            dcounts = out["counts"].cpu().numpy()
            for b in range(len(idx)):
                nb = int(dcounts[b])
                pred2d_set.append([j2[b, p].tolist() for p in range(nb)])
                pred3d_set.append([j3[b, p].tolist() for p in range(nb)])
                pred3d_raw_set.append([j3r[b, p].tolist() for p in range(nb)])
                conf_set.append([list(map(float, dconf[b, p])) for p in range(nb)])
                vis_set.append([list(map(int, dvis[b, p])) for p in range(nb)])
                p2d, p2dr = _perfect_2d_channels(
                    gt2d_set[s + b], zmap[b], raw_img[b], ecfg, dcfg, w_org, h_org, cam,
                )
                pred3d_p2d_set.append(p2d)
                pred3d_p2d_raw_set.append(p2dr)
            continue

        peaks, valid = find_peaks_batched(
            heat, max_peaks=dcfg.max_peaks, thresh=dcfg.thresh_heatmap,
            factor=dcfg.downsample, num_joints=ecfg.num_joints,
        )
        scores, ok = score_limb_pairs_batched(
            paf, peaks, valid, num_intermed_pts=dcfg.num_intermed_pts,
            thresh_paf=dcfg.thresh_paf, factor=dcfg.downsample,
        )
        assembled = assemble_batch(
            peaks.cpu().numpy(), valid.cpu().numpy(), scores.cpu().numpy(), ok.cpu().numpy(),
            min_parts=dcfg.min_parts, min_score=dcfg.min_score,
        )

        for b in range(len(idx)):
            humans_2d, visibility, conf_vec = assembled[b]
            humans_depth, humans_depth_raw = [], []
            for i, human in enumerate(humans_2d):
                hd = np.full(ecfg.num_joints, -1.0)
                hdr = np.full(ecfg.num_joints, -1.0)
                for j, joint in enumerate(human):
                    if visibility[i][j] > 0.5:
                        hd[j] = readout.retrieve_depth_heat_weighted(
                            [int(joint[0] / dcfg.downsample), int(joint[1] / dcfg.downsample)],
                            zmap[b, :, :, j], heat_h[b, :, :, j].copy(), radius=1,
                        )
                        yy = int(np.clip(joint[1], 0, raw_img.shape[1] - 1))
                        xx = int(np.clip(joint[0], 0, raw_img.shape[2] - 1))
                        hdr[j] = raw_img[b, yy, xx]
                humans_depth.append(hd)
                humans_depth_raw.append(hdr)

            sx = w_org / ecfg.input_x
            sy = h_org / ecfg.input_y
            out2d, out3d, out3d_raw = [], [], []
            for i, human in enumerate(humans_2d):
                h = _scale_visible(human, visibility[i], sx, sy)
                out2d.append(h.tolist())
                out3d.append(_back_project(h, humans_depth[i], cam).tolist())
                out3d_raw.append(_back_project(h, humans_depth_raw[i], cam).tolist())
            pred2d_set.append(out2d)
            pred3d_set.append(out3d)
            pred3d_raw_set.append(out3d_raw)
            conf_set.append([list(map(float, c)) for c in conf_vec])
            vis_set.append([list(map(int, v)) for v in visibility])
            p2d, p2dr = _perfect_2d_channels(
                gt2d_set[s + b], zmap[b], raw_img[b], ecfg, dcfg, w_org, h_org, cam,
            )
            pred3d_p2d_set.append(p2d)
            pred3d_p2d_raw_set.append(p2dr)

    return {
        "human_pred_set_2d": pred2d_set,
        "human_pred_set_3d": pred3d_set,
        "human_pred_set_3d_read_raw_depth": pred3d_raw_set,
        "human_pred_set_3d_perfect_2d": pred3d_p2d_set,
        "human_pred_set_3d_perfect_2d_read_raw_depth": pred3d_p2d_raw_set,
        "human_pred_set_part_conf": conf_set,
        "human_pred_set_visibility": vis_set,
        "human_gt_set_2d": gt2d_set,
        "human_gt_set_2d_visible": [list(g) for g in gt2d_set],
        "human_gt_set_3d": gt3d_set,
    }


def _perfect_2d_channels(gt_humans_2d, zmap_img, raw_img, ecfg, dcfg, w_org, h_org, cam):
    """Perfect-2D ablation channels: read depth at the GT 2D joints and
    back-project the GT 2D, which isolates the z path from 2D localization.
    No visibility gating, int() truncation, window-free reads."""
    gw = ecfg.input_x // dcfg.downsample
    gh = ecfg.input_y // dcfg.downsample
    out3d, out3d_raw = [], []
    for human in gt_humans_2d:
        h = np.asarray(human, dtype=np.float64)
        zp = np.full(ecfg.num_joints, -1.0)
        zr = np.full(ecfg.num_joints, -1.0)
        for j in range(min(len(h), ecfg.num_joints)):
            x2d = int(h[j, 0] / w_org * ecfg.input_x / dcfg.downsample)
            y2d = int(h[j, 1] / h_org * ecfg.input_y / dcfg.downsample)
            x2d = min(max(x2d, 0), gw - 1)
            y2d = min(max(y2d, 0), gh - 1)
            zp[j] = zmap_img[y2d, x2d, j]
            xr = min(max(int(h[j, 0] / w_org * ecfg.input_x), 0), ecfg.input_x - 1)
            yr = min(max(int(h[j, 1] / h_org * ecfg.input_y), 0), ecfg.input_y - 1)
            zr[j] = raw_img[yr, xr]
        out3d.append(_back_project(h, zp, cam).tolist())
        out3d_raw.append(_back_project(h, zr, cam).tolist())
    return out3d, out3d_raw


def run_yolo_eval(
    infer,
    dataset,
    batch_size: int = 16,
    ecfg: EncoderConfig = EncoderConfig(),
    dcfg: DecodeConfig = DecodeConfig(),
):
    """Yolo-Pose+ inference -> benchmark eval_data dict.

    `infer(image_batch)` returns the prior map (B, Hp, Wp, A*(5+3K))."""
    cam = dataset.intrinsics or dataset.dcfg.intrinsics
    depth = dataset.dcfg.depth
    w_org, h_org = dataset.dcfg.width, dataset.dcfg.height

    pred2d_set, pred3d_set, conf_set = [], [], []
    gt2d_set, gt3d_set = dataset.gt_human_lists()

    n = len(dataset)
    for s in range(0, n, batch_size):
        idx = list(range(s, min(s + batch_size, n)))
        prior_map = infer(dataset.get_batch(idx)["image"])
        bboxes, humans_prior, _vis = prior_decode.parse_prior_pose(
            prior_map, np.asarray(ecfg.anchors, np.float32), ecfg.num_joints,
            ecfg.input_x, ecfg.input_y, depth,
            conf_threshold=dcfg.conf_threshold, nms_threshold=dcfg.nms_threshold,
            max_det=dcfg.max_people,
        )
        for b in range(len(idx)):
            humans_2d, humans_z, part_conf = [], [], []
            for i, hp in enumerate(humans_prior[b]):
                h = np.asarray(hp, dtype=np.float64)
                h2 = h[:, :2].copy()
                h2[:, 0] = h2[:, 0] / ecfg.input_x * w_org
                h2[:, 1] = h2[:, 1] / ecfg.input_y * h_org
                humans_2d.append(h2)
                humans_z.append(h[:, 2])
                part_conf.append([float(bboxes[b][i][4])] * ecfg.num_joints)
            pred2d_set.append([h.tolist() for h in humans_2d])
            pred3d_set.append(
                [_back_project(h, z, cam).tolist() for h, z in zip(humans_2d, humans_z)])
            conf_set.append(part_conf)

    return {
        "human_pred_set_2d": pred2d_set,
        "human_pred_set_3d": pred3d_set,
        "human_pred_set_part_conf": conf_set,
        "human_gt_set_2d": gt2d_set,
        "human_gt_set_3d": gt3d_set,
    }


def run_popnet_eval(
    infer,
    dataset,
    batch_size: int = 16,
    ecfg: EncoderConfig = EncoderConfig(),
    dcfg: DecodeConfig = DecodeConfig(),
    readout: str = "universe",
):
    """PoP-Net inference -> benchmark eval_data dict with `*_aligned` keys.

    `infer(image_batch)` returns (heat, z, align, prior) NHWC. `readout`
    selects the alignment mechanism ("gated" or "universe"), see
    decode/popnet_infer.popnet_decode."""
    cam = dataset.intrinsics or dataset.dcfg.intrinsics
    depth = dataset.dcfg.depth
    w_org, h_org = dataset.dcfg.width, dataset.dcfg.height

    pred2d_set, pred3d_set = [], []
    pred2d_al_set, pred3d_al_set, conf_set = [], [], []
    gt2d_set, gt3d_set = dataset.gt_human_lists()

    n = len(dataset)
    for s in range(0, n, batch_size):
        idx = list(range(s, min(s + batch_size, n)))
        heat, zmap, align, prior_map = infer(dataset.get_batch(idx)["image"])

        out = popnet_decode(
            heat, zmap, align, prior_map, ecfg, dcfg, depth, cam,
            w_out=float(w_org), h_out=float(h_org), readout=readout,
        )
        j2, j3, boxes = (_host(out[k]) for k in ("joints2d", "joints3d", "boxes"))
        valid = out["valid"].cpu().numpy()

        # plain (unaligned) prior results, for the non-aligned keys
        _, humans_prior, _ = prior_decode.parse_prior_pose(
            prior_map, np.asarray(ecfg.anchors, np.float32), ecfg.num_joints,
            w_org, h_org, depth, conf_threshold=dcfg.conf_threshold,
            nms_threshold=dcfg.nms_threshold, max_det=dcfg.max_people,
        )

        for b in range(len(idx)):
            al2d, al3d, conf = [], [], []
            for m in range(valid.shape[1]):
                if not valid[b, m]:
                    continue
                al2d.append(j2[b, m].tolist())
                al3d.append(j3[b, m].tolist())
                conf.append([float(boxes[b, m, 4])] * ecfg.num_joints)
            pred2d_al_set.append(al2d)
            pred3d_al_set.append(al3d)
            conf_set.append(conf)

            plain2d, plain3d = [], []
            for hp in humans_prior[b]:
                h = np.asarray(hp, dtype=np.float64)
                plain2d.append(h[:, :2].tolist())
                plain3d.append(_back_project(h[:, :2], h[:, 2], cam).tolist())
            pred2d_set.append(plain2d)
            pred3d_set.append(plain3d)

    return {
        "human_pred_set_2d": pred2d_set,
        "human_pred_set_3d": pred3d_set,
        "human_pred_set_2d_aligned": pred2d_al_set,
        "human_pred_set_3d_aligned": pred3d_al_set,
        "human_pred_set_part_conf": conf_set,
        "human_gt_set_2d": gt2d_set,
        "human_gt_set_3d": gt3d_set,
    }


def evaluate_predictions(pred2d, pred3d, conf, gt2d, gt3d, verbose: bool = True):
    """The benchmark's four headline metrics: 2D PCKh, 3D PCK, 2D mAP and
    3D mAP, with the per-joint PCKs."""
    joint_names = list(KEYPOINT_NAMES)
    _, pck2d = eval_pck.eval_human_dataset_2d_pckh(
        pred2d, gt2d, head_id=0, neck_id=1, num_joints=len(joint_names),
        h_th=0.5, iou_th=0.5,
    )
    _, pck3d = eval_pck.eval_human_dataset_3d(
        pred2d, gt2d, pred3d, gt3d, num_joints=len(joint_names),
        dist_th=0.1, iou_th=0.5,
    )
    ap2d = eval_map.eval_ap_mpii_v2(
        pred2d, conf, gt2d, gt_visibility_set=[], head_id=0, neck_id=1,
        joint_names=joint_names, thresh=0.5, verbose=verbose,
    )
    ap3d = eval_map.eval_ap_3d(
        pred3d, conf, gt3d, gt_visibility_set=[], joint_names=joint_names,
        thresh=0.1, verbose=verbose,
    )
    result = {
        "pck2d": float(np.nanmean(pck2d)),
        "pck3d": float(np.nanmean(pck3d)),
        "map2d": float(ap2d[-1]) / 100.0,
        "map3d": float(ap3d[-1]) / 100.0,
        "per_joint_pck2d": list(map(float, pck2d)),
        "per_joint_pck3d": list(map(float, pck3d)),
    }
    if verbose:
        print(json.dumps({k: v for k, v in result.items() if not k.startswith("per_")}))
    return result


def evaluate_ablation_channels(eval_data: dict, num_joints: int = 15,
                               dist_th: float = 0.1, iou_th: float = 0.5):
    """3D PCK of each ablation channel, each with the pred-2D list that
    drives its matching."""
    gt2d = eval_data["human_gt_set_2d"]
    gt3d = eval_data["human_gt_set_3d"]
    channels = {
        "pose_depth": (eval_data["human_pred_set_2d"], "human_pred_set_3d"),
        "raw_depth": (eval_data["human_pred_set_2d"], "human_pred_set_3d_read_raw_depth"),
        "perfect_2d": (gt2d, "human_pred_set_3d_perfect_2d"),
        "perfect_2d_visible": (eval_data.get("human_gt_set_2d_visible", gt2d),
                               "human_pred_set_3d_perfect_2d"),
        "perfect_2d_raw_depth": (gt2d, "human_pred_set_3d_perfect_2d_read_raw_depth"),
    }
    out = {}
    for name, (p2d, key3d) in channels.items():
        if key3d not in eval_data:
            continue
        _, pck = eval_pck.eval_human_dataset_3d(
            p2d, gt2d, eval_data[key3d], gt3d, num_joints=num_joints,
            dist_th=dist_th, iou_th=iou_th,
        )
        out[name] = float(np.nanmean(pck))
    return out


def evaluate_eval_data(eval_data: dict, use_aligned: bool | None = None, verbose=True):
    """Score a prediction JSON against its embedded GT (the aligned keys
    where the JSON has them)."""
    if use_aligned is None:
        use_aligned = "human_pred_set_2d_aligned" in eval_data
    k2 = "human_pred_set_2d_aligned" if use_aligned else "human_pred_set_2d"
    k3 = "human_pred_set_3d_aligned" if use_aligned else "human_pred_set_3d"
    return evaluate_predictions(
        eval_data[k2], eval_data[k3], eval_data["human_pred_set_part_conf"],
        eval_data["human_gt_set_2d"], eval_data["human_gt_set_3d"], verbose,
    )
