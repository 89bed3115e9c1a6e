"""Open-Pose+ decode: dense maps -> fixed-size 3D human tensors.

    peaks + subpixel refine  (decode/device.find_peaks_batched, kernel K1)
    PAF pair scoring         (decode/device.score_limb_pairs_batched, K3)
    greedy person assembly   (decode/assemble_device.assemble_batched)
    heat-weighted z readout  (depth_readouts: ops/kernels.readouts, K4 and
    raw-depth readout         K5 in one launch from the normalized maps)
    scale to the output resolution + pinhole back-projection

`paf_decode_2d` is the same decode without the depth stages, for any
skeleton (the COCO RGB path runs it with the COCO-18 tables).

Maps are (B, H, W, C) at this interface, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, CameraIntrinsics, back_project
from popnet_tpu_torch.core.config import KDH3D_DEPTH, DecodeConfig, DepthStats, EncoderConfig
from popnet_tpu_torch.core.skeleton import LIMBS
from popnet_tpu_torch.decode.assemble_device import assemble_batched
from popnet_tpu_torch.decode.device import find_peaks_batched, score_limb_pairs_batched
from popnet_tpu_torch.ops import kernels


def readout_inputs(joints: torch.Tensor, heat: torch.Tensor, zmap: torch.Tensor,
                   image: torch.Tensor, downsample: int = 8,
                   depth: DepthStats = KDH3D_DEPTH):
    """The arguments of `kernels.readouts` for decoded joints (B, P, K, 3)
    in input-image coords; maps as in `openpose_decode`: the z map and the
    input image as the CNN and the preproc left them, normalized (no
    denormalized copy of either is made: the readouts denormalize what they
    read), the joints' heat channels, and the depth statistics."""
    K = joints.shape[2]
    return (zmap, heat[..., :K].float(), joints, image[..., 0], depth.std, depth.mean,
            downsample)


def depth_readouts(joints: torch.Tensor, heat: torch.Tensor, zmap: torch.Tensor,
                   image: torch.Tensor, downsample: int = 8,
                   depth: DepthStats = KDH3D_DEPTH):
    """The decode's two depth readouts of joints (B, P, K, 3), in one
    launch: the pose depth over heat-weighted windows (K4) and the raw depth
    at the points (K5), each (B, P, K) in metres."""
    return kernels.readouts(*readout_inputs(joints, heat, zmap, image, downsample, depth))


def openpose_decode(heat: torch.Tensor, paf: torch.Tensor, zmap: torch.Tensor,
                    image: torch.Tensor, ecfg: EncoderConfig = EncoderConfig(),
                    dcfg: DecodeConfig = DecodeConfig(),
                    depth: DepthStats = KDH3D_DEPTH,
                    cam: CameraIntrinsics = KDH3D_INTRINSICS,
                    w_out: float = 480.0, h_out: float = 512.0,
                    limbs: tuple = LIMBS) -> dict[str, torch.Tensor]:
    """heat (B, H, W, >=K), paf (B, H, W, 2L), zmap (B, H, W, K) normalized
    z (float32 or bfloat16), image (B, input_y, input_x, 1) normalized
    input depth.

    Returns joints2d (B, P, K, 2) in (w_out, h_out) coords with (-1, -1)
    holes; joints3d / joints3d_raw (B, P, K, 3) from the pose-z and
    raw-depth readouts (z = -1 at holes); conf (B, P, K); visibility
    (B, P, K) int32; counts (B,). Row p is a person iff p < counts[b]."""
    heat = heat.float()
    K = ecfg.num_joints

    peaks, pvalid = find_peaks_batched(
        heat, max_peaks=dcfg.max_peaks, thresh=dcfg.thresh_heatmap,
        factor=dcfg.downsample, win_size=dcfg.win_size, num_joints=K)
    scores, ok = score_limb_pairs_batched(
        paf, peaks, pvalid, num_intermed_pts=dcfg.num_intermed_pts,
        thresh_paf=dcfg.thresh_paf, factor=dcfg.downsample, limbs=limbs)
    joints, counts = assemble_batched(
        peaks, pvalid, scores, ok, limbs=limbs, max_people=dcfg.max_people,
        min_parts=dcfg.min_parts, min_score=dcfg.min_score)

    x_up, y_up, conf = joints[..., 0], joints[..., 1], joints[..., 2]
    vis = x_up >= 0  # border-clamped refinement keeps real joints at x, y >= 0

    z_pose, z_raw = depth_readouts(joints, heat, zmap, image, dcfg.downsample, depth)

    z_pose = torch.where(vis, z_pose, -1.0)
    z_raw = torch.where(vis, z_raw, -1.0)
    sx = w_out / ecfg.input_x
    sy = h_out / ecfg.input_y
    x2 = torch.where(vis, x_up * sx, x_up)
    y2 = torch.where(vis, y_up * sy, y_up)

    return {
        "joints2d": torch.stack([x2, y2], dim=-1),
        "joints3d": back_project(x2, y2, z_pose, cam),
        "joints3d_raw": back_project(x2, y2, z_raw, cam),
        "conf": conf,
        "visibility": vis.to(torch.int32),
        "counts": counts,
    }


def paf_decode_2d(heat: torch.Tensor, paf: torch.Tensor, num_joints: int,
                  dcfg: DecodeConfig = DecodeConfig(), limbs: tuple = LIMBS,
                  sx: float = 1.0, sy: float = 1.0) -> dict[str, torch.Tensor]:
    """The skeleton-generic 2D PAF decode of the RGB models: peaks and
    subpixel refine (K1), PAF pair scores (K3), greedy assembly (K6), then
    joints scaled from model-input pixels by float32(sx), float32(sy); no
    depth stage. heat (B, H, W, >= num_joints) raw heat maps, paf (B, H, W,
    2L) for L = len(limbs), any float type.

    Returns joints2d (B, P, K, 2) with (-1, -1) holes, conf (B, P, K),
    visibility (B, P, K) int32 and counts (B,) int32."""
    heat, paf = heat.float(), paf.float()
    peaks, pvalid = find_peaks_batched(
        heat, max_peaks=dcfg.max_peaks, thresh=dcfg.thresh_heatmap,
        factor=dcfg.downsample, win_size=dcfg.win_size, num_joints=num_joints)
    scores, ok = score_limb_pairs_batched(
        paf, peaks, pvalid, num_intermed_pts=dcfg.num_intermed_pts,
        thresh_paf=dcfg.thresh_paf, factor=dcfg.downsample, limbs=limbs)
    joints, counts = assemble_batched(
        peaks, pvalid, scores, ok, limbs=limbs, max_people=dcfg.max_people,
        min_parts=dcfg.min_parts, min_score=dcfg.min_score)
    x, y = joints[..., 0], joints[..., 1]
    vis = x >= 0
    x2 = torch.where(vis, x * float(np.float32(sx)), x)
    y2 = torch.where(vis, y * float(np.float32(sy)), y)
    return {
        "joints2d": torch.stack([x2, y2], dim=-1),
        "conf": joints[..., 2],
        "visibility": vis.to(torch.int32),
        "counts": counts,
    }
