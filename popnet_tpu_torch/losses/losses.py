"""Training losses of the depth and RGB families (the JAX package's
`popnet_tpu/losses/losses.py`, weighted-MSE family and the per-model
composites).

The models' outputs come NCHW and the targets channels-last (as
`ops.encoders` makes them); each loss views the outputs channels-last, so
every product lines up with the JAX package's NHWC computation, and the
prior head's channel c = a * (5 + 3K) + f reads as anchor a, field f, as
JAX's (H, W, A, naf) reshape reads it. Every loss returns (total, logs),
logs a dict of 0-d tensors (the activation-range canaries too), left on
the device, but `a2j_loss`, which returns its two terms as the JAX
package's does.
"""

from __future__ import annotations

import torch


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def weighted_mse(pred, target, weights):
    """mean((pred - target)^2 * w) over all (broadcast) elements."""
    return torch.mean((pred - target) ** 2 * weights)


def _mse(pred, target):
    return torch.mean((pred - target) ** 2)


def _rtpose_light3d(saved_for_loss, heat_gt, paf_gt, z_gt, z_weight, num_stages: int):
    """Per stage, the PAF and heat MSE and the z MSE (weighted by `z_weight`
    where it is given, which also logs the z canaries)."""
    saved = [_nhwc(t) for t in saved_for_loss]
    logs = {}
    total = 0.0
    for j in range(num_stages):
        paf, heat, z = saved[3 * j], saved[3 * j + 1], saved[3 * j + 2]
        l1, l2 = _mse(paf, paf_gt), _mse(heat, heat_gt)
        l3 = _mse(z, z_gt) if z_weight is None else weighted_mse(z, z_gt, z_weight)
        total = total + l1 + l2 + l3
        logs[f"stage{j + 1}_paf"] = l1
        logs[f"stage{j + 1}_heat"] = l2
        logs[f"stage{j + 1}_z"] = l3
    logs["max_ht"] = saved[-2][..., :-1].max()
    logs["min_ht"] = saved[-2][..., :-1].min()
    logs["max_paf"] = saved[-3].max()
    logs["min_paf"] = saved[-3].min()
    if z_weight is not None:
        logs["max_z"] = saved[-1].max()
        logs["min_z"] = saved[-1].min()
    return total, logs


def rtpose_light3d_loss(saved_for_loss, heat_gt, paf_gt, z_gt, num_stages: int = 2):
    """Open-Pose+ without the foreground weight: per stage, the PAF, heat
    and z MSE (the pipelined step's loss). saved_for_loss: [paf1, heat1,
    z1, ...] (NCHW)."""
    return _rtpose_light3d(saved_for_loss, heat_gt, paf_gt, z_gt, None, num_stages)


def rtpose_light3d_loss_fgweight(saved_for_loss, heat_gt, paf_gt, z_gt, fg_mask_z):
    """Open-Pose+: per stage, PAF and heat MSE and the z MSE weighted
    0.1 + 0.9 * fg. saved_for_loss: [paf1, heat1, z1, paf2, heat2, z2]
    (NCHW)."""
    return _rtpose_light3d(saved_for_loss, heat_gt, paf_gt, z_gt, 0.1 + fg_mask_z * 0.9,
                           len(saved_for_loss) // 3)


def rtpose_light_loss(saved_for_loss, heat_gt, paf_gt):
    """The 2D CPMs (RTPoseVGG, RTPoseLight): per stage, the PAF and heat
    MSE. saved_for_loss: [paf1, heat1, ..., pafS, heatS] (NCHW)."""
    saved = [_nhwc(t) for t in saved_for_loss]
    logs = {}
    total = 0.0
    for j in range(len(saved) // 2):
        l1, l2 = _mse(saved[2 * j], paf_gt), _mse(saved[2 * j + 1], heat_gt)
        total = total + l1 + l2
        logs[f"stage{j + 1}_paf"] = l1
        logs[f"stage{j + 1}_heat"] = l2
    return total, logs


def _prior_loss(prior_pred, prior_gt, mask_conf, mask_coord, weight_map, num_joints,
                pred_vis: bool = False):
    """The prior subnet's (coord, objectness, self-pose) losses, weighted by
    the pose-rarity map: prior_pred (B, A*naf, H, W) NCHW, prior_gt
    (B, H, W, A*naf), the masks and weight_map (B, H, W, A). The self-pose
    term is weighted by 3K, or 4K with the visibility channels
    (`pred_vis`)."""
    b, h, w, _ = prior_gt.shape
    a = mask_conf.shape[-1]
    pred = _nhwc(prior_pred).reshape(b, h, w, a, -1)
    gt = prior_gt.reshape(b, h, w, a, -1)
    mc = mask_coord[..., None]
    wm = weight_map[..., None]
    coords_pred, conf_pred, joints_pred = pred[..., :4], pred[..., 4], pred[..., 5:]
    coords_gt, conf_gt, joints_gt = gt[..., :4], gt[..., 4], gt[..., 5:]
    loss_coord = weighted_mse(coords_pred * mc, coords_gt * mc, wm) * 4
    loss_obj = weighted_mse(conf_pred * mask_conf, conf_gt * mask_conf, weight_map)
    joint_factor = (4 if pred_vis else 3) * num_joints
    loss_selfpose = weighted_mse(joints_pred * mc, joints_gt * mc, wm) * joint_factor
    return loss_coord, loss_obj, loss_selfpose


def yolo_loss(pred, prior_gt, mask_conf, mask_coord, weight_map, num_joints):
    """Yolo-Pose+: the prior loss of its (B, A*naf, H, W) output."""
    loss_coord, loss_obj, loss_selfpose = _prior_loss(pred, prior_gt, mask_conf, mask_coord,
                                                      weight_map, num_joints)
    total = loss_coord + loss_obj + loss_selfpose
    logs = {"loss_prior": total, "loss_bbox": loss_coord, "loss_obj": loss_obj,
            "loss_selfpose": loss_selfpose}
    return total, logs


def popnet_loss(saved_for_loss, heat_gt, zmap_gt, fg_mask_z, alignmap_gt, fg_mask_align,
                prior_gt, prior_mask_conf, prior_mask_coord, prior_weight_map, num_joints,
                pred_vis: bool = False):
    """PoP-Net: per stage heat (weighted 0.1 + 0.9 * fg, background 1), z
    (0.1 + 0.9 * fg) and align (fg) MSE, plus the pose-weighted prior loss
    (with `pred_vis`, of the prior with visibility channels).
    saved_for_loss: [heat1, z1, align1, ..., heatS, zS, alignS, prior]
    (NCHW)."""
    saved = [_nhwc(t) for t in saved_for_loss[:-1]]
    logs = {}
    total = 0.0
    weight_z = 0.1 + fg_mask_z * 0.9
    weight_ht = torch.cat([weight_z, torch.ones_like(weight_z[..., :1])], -1)
    for j in range(len(saved) // 3):
        heat, z, align = saved[3 * j], saved[3 * j + 1], saved[3 * j + 2]
        l1 = weighted_mse(heat, heat_gt, weight_ht)
        l2 = weighted_mse(z, zmap_gt, weight_z)
        l3 = weighted_mse(align, alignmap_gt, fg_mask_align)
        total = total + l1 + l2 + l3
        logs[f"stage{j + 1}_heat"] = l1
        logs[f"stage{j + 1}_z"] = l2
        logs[f"stage{j + 1}_align"] = l3
    loss_coord, loss_obj, loss_selfpose = _prior_loss(
        saved_for_loss[-1], prior_gt, prior_mask_conf, prior_mask_coord, prior_weight_map,
        num_joints, pred_vis)
    loss_prior = loss_coord + loss_obj + loss_selfpose
    total = total + loss_prior
    logs["loss_prior"] = loss_prior
    logs["loss_bbox"] = loss_coord
    logs["loss_obj"] = loss_obj
    logs["loss_selfpose"] = loss_selfpose
    logs["max_ht"] = saved[-3][..., :-1].max()
    logs["min_ht"] = saved[-3][..., :-1].min()
    logs["max_z"] = saved[-2].max()
    logs["min_z"] = saved[-2].min()
    logs["max_alignf"] = (saved[-1] * fg_mask_align).max()
    logs["min_alignf"] = (saved[-1] * fg_mask_align).min()
    return total, logs


def popnet_rgb_loss(saved_for_loss, heat_gt, alignmap_gt, fg_mask_align, prior_gt,
                    prior_mask_conf, prior_mask_coord, num_joints):
    """PopNetRGB: per stage the heat MSE (weighted 0.1 + 0.9 * the joint's
    align foreground, background 1) and the align MSE (weighted by its
    foreground), plus the prior loss: box (x4) and objectness as the depth
    prior's unweighted terms, and the self-pose over the 3K joint channels
    (K x, K y, K visibilities), the positions masked by the GT visibility,
    the visibilities by the coordinate mask alone, times 3K.
    saved_for_loss: [heat1, align1, ..., heatS, alignS, prior] (NCHW)."""
    saved = [_nhwc(t) for t in saved_for_loss[:-1]]
    logs = {}
    total = 0.0
    fg = fg_mask_align[..., :num_joints]
    weight_ht = torch.cat([0.1 + fg * 0.9, torch.ones_like(fg[..., :1])], -1)
    for j in range(len(saved) // 2):
        l1 = weighted_mse(saved[2 * j], heat_gt, weight_ht)
        l2 = weighted_mse(saved[2 * j + 1], alignmap_gt, fg_mask_align)
        total = total + l1 + l2
        logs[f"stage{j + 1}_heat"] = l1
        logs[f"stage{j + 1}_align"] = l2
    b, h, w, _ = prior_gt.shape
    a = prior_mask_conf.shape[-1]
    pred = _nhwc(saved_for_loss[-1]).reshape(b, h, w, a, -1)
    gt = prior_gt.reshape(b, h, w, a, -1)
    mc = prior_mask_coord[..., None]
    joints_gt = gt[..., 5:]
    loss_coord = weighted_mse(pred[..., :4], gt[..., :4], mc) * 4
    loss_obj = weighted_mse(pred[..., 4], gt[..., 4], prior_mask_conf)
    vis_gt = joints_gt[..., 2 * num_joints:]
    selfpose_mask = torch.cat([(mc * vis_gt[..., :num_joints]).repeat(1, 1, 1, 1, 2),
                               mc.repeat(1, 1, 1, 1, num_joints)], -1)
    loss_selfpose = weighted_mse(pred[..., 5:], joints_gt, selfpose_mask) * 3 * num_joints
    loss_prior = loss_coord + loss_obj + loss_selfpose
    total = total + loss_prior
    logs["loss_prior"] = loss_prior
    logs["loss_bbox"] = loss_coord
    logs["loss_obj"] = loss_obj
    logs["loss_selfpose"] = loss_selfpose
    return total, logs


A2J_SPATIAL_FACTOR = 0.5   # the weight of A2J's in-plane regression term


def _smooth_l1(diff):
    """Smooth-L1 with beta 1 of non-negative differences."""
    return torch.where(diff <= 1.0, 0.5 * diff ** 2, diff - 0.5)


def a2j_loss(heads, annotations, all_anchors):
    """A2J's anchor-weighted loss: heads (cls (B, N, K), reg (B, N, K, 2),
    dep (B, N, K)) from `models.A2J`, annotations (B, K, 3) as (y, x, z),
    all_anchors (N, 2) in (h, w) -> (anchor_loss, regression_loss), which
    the caller combines as anchor + regression * factor. The softmax over
    the anchors is written as the JAX package writes it, exp(cls - max) /
    sum; the anchor and regression terms are smooth-L1 of the weighted
    positions, the regression term times A2J_SPATIAL_FACTOR, plus the plain
    L1 of the weighted depth."""
    cls, reg, dep = heads
    anchors = all_anchors[None, :, None, :]
    w = torch.exp(cls - cls.amax(dim=1, keepdim=True))
    w = w / w.sum(dim=1, keepdim=True)
    gt_xy = annotations[..., :2]
    anchor_pos = (w[..., None] * anchors).sum(dim=1)
    anchor_loss = torch.mean(_smooth_l1((gt_xy - anchor_pos).abs()))
    reg_pos = (w[..., None] * (anchors + reg)).sum(dim=1)
    reg_loss = torch.mean(_smooth_l1((gt_xy - reg_pos).abs())) * A2J_SPATIAL_FACTOR
    z_diff = (annotations[..., 2] - (w * dep).sum(dim=1)).abs()
    return anchor_loss, reg_loss + torch.mean(z_diff)
