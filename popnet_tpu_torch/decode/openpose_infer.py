"""Open-Pose+ decode: dense maps -> fixed-size 3D human tensors.

    peaks + subpixel refine  (decode/device.find_peaks_batched, kernel K1)
    PAF pair scoring         (decode/device.score_limb_pairs_batched, K3)
    greedy person assembly   (decode/assemble_device.assemble_batched)
    heat-weighted z readout  (window_readout_heat_weighted, K4)
    raw-depth readout        (ops/kernels.point_readout, K5)
    scale to the output resolution + pinhole back-projection

Maps are (B, H, W, C) at this interface, as in the JAX package.
"""

from __future__ import annotations

import torch

from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, CameraIntrinsics
from popnet_tpu_torch.core.config import KDH3D_DEPTH, DecodeConfig, DepthStats, EncoderConfig
from popnet_tpu_torch.core.skeleton import LIMBS
from popnet_tpu_torch.decode.assemble_device import assemble_batched
from popnet_tpu_torch.decode.device import find_peaks_batched, score_limb_pairs_batched
from popnet_tpu_torch.ops import kernels


def window_readout_heat_weighted(depthmaps: torch.Tensor, heatmaps: torch.Tensor,
                                 cx: torch.Tensor, cy: torch.Tensor,
                                 radius: int = 1) -> torch.Tensor:
    """Batched heat-weighted depth readout over the inclusive window
    clip(c - r)..clip(c + r), which shrinks at the borders and collapses to
    the edge cell for centres off the map. depthmaps, heatmaps (B, H, W, K);
    cx, cy (B, P, K) int32 -> (B, P, K)."""
    return kernels.window_readout(depthmaps.float(), heatmaps.float(),
                                  cx.to(torch.int32).contiguous(),
                                  cy.to(torch.int32).contiguous(), radius)


def readout_inputs(joints: torch.Tensor, heat: torch.Tensor, zmap: torch.Tensor,
                   image: torch.Tensor, downsample: int = 8,
                   depth: DepthStats = KDH3D_DEPTH):
    """What the two depth readouts receive for decoded joints (B, P, K, 3)
    in input-image coords; maps as in `openpose_decode`.

    Returns ((zmap_m, heat_k, gx, gy), (raw_m, rx, ry)): K4's z map in
    metres (B, H, W, K), the joints' heat channels and the window centres
    (B, P, K) int32 at truncated low-res coords (int() semantics); K5's raw
    depth in metres (B, Hi, Wi) and its points (B, P*K) int32, clamped to
    the image and truncated."""
    x_up, y_up = joints[..., 0], joints[..., 1]
    B, P, K = x_up.shape
    zmap = zmap.float() * depth.std + depth.mean
    raw = image[..., 0].float() * depth.std + depth.mean
    gx = (x_up / downsample).to(torch.int32)
    gy = (y_up / downsample).to(torch.int32)
    Hi, Wi = raw.shape[1], raw.shape[2]
    rx = x_up.clamp(0, Wi - 1).to(torch.int32).reshape(B, P * K)
    ry = y_up.clamp(0, Hi - 1).to(torch.int32).reshape(B, P * K)
    return (zmap, heat[..., :K].float(), gx, gy), (raw, rx, ry)


def openpose_decode(heat: torch.Tensor, paf: torch.Tensor, zmap: torch.Tensor,
                    image: torch.Tensor, ecfg: EncoderConfig = EncoderConfig(),
                    dcfg: DecodeConfig = DecodeConfig(),
                    depth: DepthStats = KDH3D_DEPTH,
                    cam: CameraIntrinsics = KDH3D_INTRINSICS,
                    w_out: float = 480.0, h_out: float = 512.0,
                    limbs: tuple = LIMBS) -> dict[str, torch.Tensor]:
    """heat (B, H, W, >=K), paf (B, H, W, 2L), zmap (B, H, W, K) normalized
    z, image (B, input_y, input_x, 1) normalized input depth.

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

    # pose-depth readout over heat-weighted windows, raw-depth readout at points
    window_in, point_in = readout_inputs(joints, heat, zmap, image, dcfg.downsample, depth)
    z_pose = window_readout_heat_weighted(*window_in)
    z_raw = kernels.point_readout(*point_in).reshape(vis.shape)

    z_pose = torch.where(vis, z_pose, -1.0)
    z_raw = torch.where(vis, z_raw, -1.0)
    sx = w_out / ecfg.input_x
    sy = h_out / ecfg.input_y
    x2 = torch.where(vis, x_up * sx, x_up)
    y2 = torch.where(vis, y_up * sy, y_up)

    def backproj(z):
        return torch.stack([(x2 - cam.cx) / cam.fx * z, (y2 - cam.cy) / cam.fy * z, z], dim=-1)

    return {
        "joints2d": torch.stack([x2, y2], dim=-1),
        "joints3d": backproj(z_pose),
        "joints3d_raw": backproj(z_raw),
        "conf": conf,
        "visibility": vis.to(torch.int32),
        "counts": counts,
    }
