"""Anchor-pose (prior map) decode + NMS.

- `decode_prior_maps`: one batched pass turning (B, H, W, A*naf) prior maps
  into fixed-size score-sorted detections with a validity mask. The
  suppression loop is the reference's triangular-IoU NMS, including its skip
  of the first and the final candidate.
- `parse_prior_pose`: host wrapper producing per-image (bboxes, humans,
  visibility) Python lists for the eval contract.

Detections: [cx, cy, w, h, conf] normalized to [0, 1], joints (K, 3) as
(x_norm, y_norm, z_meters); `scale_to_output` maps to pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.config import DepthStats
from popnet_tpu_torch.core.numerics import div_const


def stable_top_k(score: torch.Tensor, k: int):
    """The k largest along the last axis, in descending order, the lower
    index first among equal values (`torch.topk` promises no tie order; a
    stable sort does, on the CPU and on the card alike)."""
    val, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def decode_prior_maps(prior: torch.Tensor, anchors: torch.Tensor, depth_mean: float,
                      depth_std: float, num_joints: int = 15,
                      conf_threshold: float = 0.35, nms_threshold: float = 0.5,
                      max_det: int = 16, pred_vis: bool = False):
    """prior (B, H, W, A*naf), anchors (A, 2) -> (dets (B, M, naf), valid
    (B, M)).

    dets rows are [cx, cy, w, h, conf, K*x, K*y, K*z(, K*vis)] with box and
    joint (x, y) normalized by the prior grid, z in meters; rows are sorted
    by descending confidence (the earlier candidate first among equals) and
    NMS-filtered. The grid sizes divide as the JAX package's compiled decode
    divides by them (`core.numerics.div_const`), on the CPU and on the card
    alike."""
    b, h, w, _ = prior.shape
    a = anchors.shape[0]
    naf = prior.shape[-1] // a
    K = num_joints
    dev = prior.device
    p = prior.float().reshape(b, h, w, a, naf)

    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    aw = anchors[:, 0].float()[None, None, None, :]
    ah = anchors[:, 1].float()[None, None, None, :]

    cx = div_const(p[..., 0] + gx, w)
    cy = div_const(p[..., 1] + gy, h)
    bw = div_const(p[..., 2] * aw, w)
    bh = div_const(p[..., 3] * ah, h)
    conf = p[..., 4]
    jx = div_const(p[..., 5:5 + K] * (aw[..., None] * 0.5) + gx[..., None], w)
    jy = div_const(p[..., 5 + K:5 + 2 * K] * (ah[..., None] * 0.5) + gy[..., None], h)
    jz = p[..., 5 + 2 * K:5 + 3 * K] * depth_std + depth_mean

    fields = [cx[..., None], cy[..., None], bw[..., None], bh[..., None], conf[..., None],
              jx, jy, jz]
    if pred_vis:
        fields.append(p[..., 5 + 3 * K:])
    dets = torch.cat(fields, dim=-1).reshape(b, h * w * a, naf)

    ninf = torch.full((), float("-inf"), device=dev)
    score = torch.where(dets[..., 4] > conf_threshold, dets[..., 4], ninf)
    top_score, top_idx = stable_top_k(score, max_det)
    dets = torch.gather(dets, 1, top_idx[..., None].expand(-1, -1, naf))
    valid = torch.isfinite(top_score)

    # triangular IoU conflicts, then a sequential suppression that never
    # visits candidate 0 nor the last candidate
    x1 = dets[..., 0] - dets[..., 2] * 0.5
    y1 = dets[..., 1] - dets[..., 3] * 0.5
    x2 = dets[..., 0] + dets[..., 2] * 0.5
    y2 = dets[..., 1] + dets[..., 3] * 0.5
    dx = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0.0)
    dy = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0.0)
    inter = dx * dy
    areas = dets[..., 2] * dets[..., 3]
    union = areas[:, :, None] + areas[:, None, :] - inter
    ious = inter / union.clamp(min=1e-12)

    both_valid = valid[:, :, None] & valid[:, None, :]
    conflicting = torch.triu(((ious > nms_threshold) & both_valid).to(torch.int32), diagonal=1)
    keep = conflicting.sum(dim=1)                                # column sums
    for i in range(1, max_det - 1):
        keep = keep - (keep[:, i] > 0).to(torch.int32)[:, None] * conflicting[:, i, :]
    return dets, valid & (keep == 0)


def scale_to_output(dets: np.ndarray, valid: np.ndarray, num_joints: int,
                    w_out: float, h_out: float, vis_margin: float = 0.0,
                    pred_vis: bool = False):
    """Per-image lists (bboxes, humans (K, 3), visibility) in output pixels."""
    bboxes_out, humans_out, visibility_out = [], [], []
    for det, ok in zip(np.asarray(dets), np.asarray(valid)):
        det = det[ok].copy()
        if det.shape[0] == 0:
            bboxes_out.append([])
            humans_out.append([])
            visibility_out.append([])
            continue
        det[:, 0] *= w_out
        det[:, 2] *= w_out
        det[:, 1] *= h_out
        det[:, 3] *= h_out
        det[:, 0] -= det[:, 2] / 2
        det[:, 1] -= det[:, 3] / 2
        det[:, 2] += det[:, 0]
        det[:, 3] += det[:, 1]
        det[:, 5:5 + num_joints] *= w_out
        det[:, 5 + num_joints:5 + 2 * num_joints] *= h_out
        bboxes_out.append([row[:5] for row in det])
        humans_b, vis_b = [], []
        for row in det:
            human = row[5:5 + 3 * num_joints].reshape(3, -1).T
            humans_b.append(human)
            inb = np.logical_and(
                np.logical_and(human[:, 0] >= vis_margin, human[:, 0] <= w_out - 1 - vis_margin),
                np.logical_and(human[:, 1] >= vis_margin, human[:, 1] <= h_out - 1 - vis_margin),
            )
            vis_b.append(inb * row[5 + 3 * num_joints:] if pred_vis else inb)
        humans_out.append(humans_b)
        visibility_out.append(vis_b)
    return bboxes_out, humans_out, visibility_out


def parse_prior_pose(prior, anchors, num_joints: int, w_out: float, h_out: float,
                     depth: DepthStats, conf_threshold: float = 0.35,
                     nms_threshold: float = 0.5, pred_vis: bool = False,
                     vis_margin: float = 0.0, max_det: int = 16):
    """(B, H, W, A*naf) prior maps -> per-image (bboxes, humans, visibility)
    lists in output pixels; runs on the device `prior` lies on."""
    prior = torch.as_tensor(prior)
    dets, valid = decode_prior_maps(
        prior, torch.as_tensor(anchors, dtype=torch.float32, device=prior.device),
        depth.mean, depth.std, num_joints=num_joints, conf_threshold=conf_threshold,
        nms_threshold=nms_threshold, max_det=max_det, pred_vis=pred_vis)
    return scale_to_output(dets.cpu().numpy(), valid.cpu().numpy(), num_joints, w_out, h_out,
                           vis_margin, pred_vis)
