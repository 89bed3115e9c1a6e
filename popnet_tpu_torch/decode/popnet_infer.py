"""PoP-Net decode: dense maps + prior maps -> aligned 3D poses.

1. decode the prior subnet into candidate people (boxes + K x (x, y, z))
   (decode/prior.decode_prior_maps),
2. refine each joint's 2D position with the predicted short-range alignment
   field, weighted by the part heatmap in a 3x3 window,
3. re-read each joint's depth from the z-map with heatmap weighting,
4. back-project to camera-frame 3D.

Everything is batched and fixed-shape: (B, M, K, ...) with validity masks.
Maps are (B, H, W, C) at this interface, as in the JAX package. Window cells
are read by gathers (the JAX package's one-hot products are its way around
slow gathers on its hardware). Sums over a window run in a fixed order, so
the CPU and the card round alike.
"""

from __future__ import annotations

import torch

from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, CameraIntrinsics, back_project
from popnet_tpu_torch.core.config import KDH3D_DEPTH, DecodeConfig, DepthStats, EncoderConfig
from popnet_tpu_torch.core.numerics import div_const
from popnet_tpu_torch.decode.prior import decode_prior_maps, stable_top_k
from popnet_tpu_torch.ops import kernels


def _window_offsets(radius: int, device):
    r = torch.arange(-radius, radius + 1, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (short) last axis, left to right."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _int_peaks_batched(heat: torch.Tensor, thresh: float, max_peaks: int):
    """Integer-coordinate local maxima per joint channel (kernel K7,
    `ops/kernels.peak_mask`), the top `max_peaks` by score with the lower
    flat index first among equals, returned in row-major order so that a
    later nearest-peak argmin breaks ties as a scan of the map would.

    heat (B, H, W, K) -> (px, py, valid), each (B, K, N)."""
    B, H, W, K = heat.shape
    is_peak = kernels.peak_mask(heat, thresh)
    ninf = torch.full((), float("-inf"), device=heat.device)
    s = torch.where(is_peak, heat.float(), ninf).permute(0, 3, 1, 2).reshape(B, K, H * W)
    val, idx = stable_top_k(s, max_peaks)
    idx = torch.sort(torch.where(torch.isfinite(val), idx, H * W), dim=-1).values
    valid = idx < H * W
    idx = torch.where(valid, idx, 0)
    return idx % W, idx // W, valid


def popnet_decode(heat: torch.Tensor, zmap: torch.Tensor, align: torch.Tensor,
                  prior: torch.Tensor, ecfg: EncoderConfig = EncoderConfig(),
                  dcfg: DecodeConfig = DecodeConfig(), depth: DepthStats = KDH3D_DEPTH,
                  cam: CameraIntrinsics = KDH3D_INTRINSICS, w_out: float = 480.0,
                  h_out: float = 512.0, readout: str = "universe",
                  ht_thresh: float = 0.5) -> dict[str, torch.Tensor]:
    """heat (B, Hg, Wg, K+1), zmap (B, Hg, Wg, K) normalized, align
    (B, Hg, Wg, 2K) normalized offsets, prior (B, Hp, Wp, A*(5+3K)).

    Returns boxes (B, M, 5) in pixels, joints2d (B, M, K, 2) in pixels,
    joints3d (B, M, K, 3) in metres, conf (B, M, K), valid (B, M).

    readout: "universe" (the default) replaces align offsets outside any
    heat peak's radius box by the offset toward the nearest peak of that
    joint type, reads the fused field heat-weighted, and re-reads z at the
    refined position; `ht_thresh` is its peak threshold. "gated" lets each
    window cell vote its align-corrected centre, heat-weighted, and keeps
    the prior subnet's direct prediction where local heat is weak (kept for
    ablations)."""
    if readout not in ("universe", "gated"):
        raise ValueError(f"unknown readout {readout!r}")
    K = ecfg.num_joints
    dev = heat.device
    heat, zmap, align = heat.float(), zmap.float(), align.float()
    anchors = torch.tensor(ecfg.anchors, dtype=torch.float32, device=dev)
    dets, valid = decode_prior_maps(
        prior, anchors, depth.mean, depth.std, num_joints=K,
        conf_threshold=dcfg.conf_threshold, nms_threshold=dcfg.nms_threshold,
        max_det=dcfg.max_people)
    B, M = valid.shape
    jx = dets[..., 5:5 + K]                      # normalized [0, 1] image coords
    jy = dets[..., 5 + K:5 + 2 * K]
    jz_prior = dets[..., 5 + 2 * K:5 + 3 * K]    # metres

    Hg, Wg = ecfg.agrid_h, ecfg.agrid_w
    r = 1                                        # readout radius
    span = float(ecfg.align_radius) + 0.5

    # joint positions on the align/heat grid
    gx = jx * Wg
    gy = jy * Hg
    cx = torch.floor(gx).clamp(0, Wg - 1).long()
    cy = torch.floor(gy).clamp(0, Hg - 1).long()

    dxo, dyo = _window_offsets(r, dev)
    gxw = (cx[..., None] + dxo).clamp(0, Wg - 1)  # (B, M, K, win)
    gyw = (cy[..., None] + dyo).clamp(0, Hg - 1)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    ki = torch.arange(K, device=dev)[None, None, :, None]
    heat_k = heat[..., :K]
    align2 = align.reshape(B, Hg, Wg, K, 2)

    def window(field, wy, wx):                   # (B, Hg, Wg, K) -> (B, M, K, win)
        return field[bi, wy, wx, ki]

    hwin = window(heat_k, gyw, gxw).clamp(min=0.0) + 1e-9
    axwin = window(align2[..., 0], gyw, gxw)
    aywin = window(align2[..., 1], gyw, gxw)
    wsum = _sum_last(hwin)
    heat_at = heat_k[bi[..., 0], cy, cx, ki[..., 0]]

    if readout == "gated":
        zwin = window(zmap, gyw, gxw)
        # candidate centres voted by each window cell (align-grid units)
        cand_x = gxw + 0.5 + axwin * span
        cand_y = gyw + 0.5 + aywin * span
        ref_x = _sum_last(cand_x * hwin) / wsum  # (B, M, K)
        ref_y = _sum_last(cand_y * hwin) / wsum
        z = (_sum_last(zwin * hwin) / wsum) * depth.std + depth.mean

        # where local heat evidence is weak, keep the prior's prediction
        use_align = heat_at > dcfg.thresh_heatmap
        out_x = torch.where(use_align, div_const(ref_x, Wg), jx) * w_out
        out_y = torch.where(use_align, div_const(ref_y, Hg), jy) * h_out
        out_z = torch.where(use_align, z, jz_prior)
    else:
        px, py, pk_valid = _int_peaks_batched(heat_k, ht_thresh, dcfg.max_peaks)  # (B, K, N)
        pkv = pk_valid[:, None, :, None, :]
        dxp = (px[:, None, :, None, :] - gxw[..., None]).float()  # (B, M, K, win, N)
        dyp = (py[:, None, :, None, :] - gyw[..., None]).float()
        inf = torch.full((), float("inf"), device=dev)
        d2 = torch.where(pkv, dxp * dxp + dyp * dyp, inf)
        nearest = d2.argmin(dim=-1, keepdim=True)        # 0 where no peak is valid
        far_x = dxp.gather(-1, nearest)[..., 0]
        far_y = dyp.gather(-1, nearest)[..., 0]
        ra = float(ecfg.align_radius)
        fg = ((dxp.abs() <= ra) & (dyp.abs() <= ra) & pkv).any(dim=-1)  # cell near a peak
        has_pk = pk_valid.any(dim=-1)[:, None, :, None]
        off_x = torch.where(has_pk & ~fg, far_x, axwin * span)
        off_y = torch.where(has_pk & ~fg, far_y, aywin * span)

        # heat-weighted offsets at the prior position's window
        dxv = off_x + (gxw - cx[..., None]) + 0.5
        dyv = off_y + (gyw - cy[..., None]) + 0.5
        ref_x = cx + _sum_last(dxv * hwin) / wsum        # grid units
        ref_y = cy + _sum_last(dyv * hwin) / wsum

        # z re-read (heat-weighted) at the refined position
        cx2 = ref_x.to(torch.int32).long().clamp(0, Wg - 1)
        cy2 = ref_y.to(torch.int32).long().clamp(0, Hg - 1)
        gxw2 = (cx2[..., None] + dxo).clamp(0, Wg - 1)
        gyw2 = (cy2[..., None] + dyo).clamp(0, Hg - 1)
        hwin2 = window(heat_k, gyw2, gxw2).clamp(min=0.0) + 1e-9
        zwin2 = window(zmap, gyw2, gxw2)
        z = (_sum_last(zwin2 * hwin2) / _sum_last(hwin2)) * depth.std + depth.mean

        out_x = div_const(ref_x, Wg) * w_out
        out_y = div_const(ref_y, Hg) * h_out
        out_z = z

    scale = torch.tensor([w_out, h_out, w_out, h_out, 1.0], device=dev)
    return {
        "boxes": dets[..., :5] * scale,
        "joints2d": torch.stack([out_x, out_y], dim=-1),
        "joints3d": back_project(out_x, out_y, out_z, cam),
        "conf": heat_at,
        "valid": valid,
    }
