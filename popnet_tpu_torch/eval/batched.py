"""Batched evaluation on the device: PCK/PCKh and the mAP assignment step.

The torch twin of the JAX package's `popnet_tpu/eval/batched.py`: the NumPy
metrics (`eval/pck.py`, `eval/map.py`) are the semantic source of truth,
and these run a whole dataset's matching as tensor operations over padded
(N, P, K, ...) arrays, on the card unless the caller passes device="cpu".

Padding conventions: per-image person counts become validity masks; invalid
joints are [-1, -1] exactly like the JSON contract. Semantics follow the
reference for well-formed inputs (every valid human has >= 1 valid joint).
Among equal IoUs and equal PCKs the lower index wins, as np.argmax and
jnp.argmax take it (`torch.argmax` returns the first maximal index).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from popnet_tpu_torch.core.device import resolve_device
from popnet_tpu_torch.eval.map import get_rpc, voc_ap

BIG = 1e9


def pack_human_sets(set2d, set3d=None, conf=None, max_people=None, num_joints=15):
    """Per-image human lists -> padded arrays + mask (NumPy)."""
    n = len(set2d)
    P = max_people or max((len(h) for h in set2d), default=1) or 1
    out2 = np.full((n, P, num_joints, 2), -1.0, np.float32)
    out3 = np.zeros((n, P, num_joints, 3), np.float32)
    cf = np.zeros((n, P, num_joints), np.float32)
    valid = np.zeros((n, P), bool)
    for i, humans in enumerate(set2d):
        for j, h in enumerate(humans[:P]):
            out2[i, j] = np.asarray(h, np.float32).reshape(num_joints, 2)
            valid[i, j] = True
            if set3d is not None and j < len(set3d[i]):
                out3[i, j] = np.asarray(set3d[i][j], np.float32).reshape(num_joints, 3)
            if conf is not None and j < len(conf[i]):
                cf[i, j] = np.asarray(conf[i][j], np.float32)
    return out2, out3, cf, valid


def _t(x, device, dtype=None):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device, dtype=dtype)


def _bboxes(j2, person_valid):
    """(N, P, 4) tight boxes over valid joints; invalid persons get
    degenerate far-away boxes."""
    ok = ~torch.all(j2 == -1.0, dim=-1)  # (N, P, K)
    x = torch.where(ok, j2[..., 0], BIG).amin(-1)
    y = torch.where(ok, j2[..., 1], BIG).amin(-1)
    xmax = torch.where(ok, j2[..., 0], -BIG).amax(-1)
    ymax = torch.where(ok, j2[..., 1], -BIG).amax(-1)
    far = ~person_valid
    x = torch.where(far, 2 * BIG, x)
    y = torch.where(far, 2 * BIG, y)
    xmax = torch.where(far, 2 * BIG + 1, xmax)
    ymax = torch.where(far, 2 * BIG + 1, ymax)
    return torch.stack([x, y, xmax, ymax], -1)


def _iou(b1, b2):
    """(N, Pg, 4) x (N, Pp, 4) -> (N, Pg, Pp)."""
    dx = (torch.minimum(b1[..., :, None, 2], b2[..., None, :, 2])
          - torch.maximum(b1[..., :, None, 0], b2[..., None, :, 0])).clamp(min=0.0)
    dy = (torch.minimum(b1[..., :, None, 3], b2[..., None, :, 3])
          - torch.maximum(b1[..., :, None, 1], b2[..., None, :, 1])).clamp(min=0.0)
    inter = dx * dy
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (a1[..., :, None] + a2[..., None, :] - inter)


def _match_dists(gt2, gt_valid, pred2, pred_valid, gt3=None, pred3=None, iou_th=0.5,
                 mode="2d"):
    """(N, Pg, K) joint distances with -1 semantics, matching
    match_humans_2d/3d."""
    ious = _iou(_bboxes(gt2, gt_valid), _bboxes(pred2, pred_valid))
    ious = torch.where(pred_valid[:, None, :], ious, -1.0)
    any_pred = pred_valid.any(dim=1)  # empty pred list -> all -1
    best = ious.argmax(dim=-1)  # (N, Pg)
    matched = (ious.amax(dim=-1) >= iou_th) & any_pred[:, None]

    def gather(t):  # the matched prediction of each GT: (N, Pg, K, C)
        return torch.gather(t, 1, best[:, :, None, None].expand(-1, -1, *t.shape[2:]))

    p2 = gather(pred2)
    if mode == "3d":
        d = torch.sqrt(((gt3 - gather(pred3)) ** 2).sum(-1))
    else:
        d = torch.sqrt(((gt2 - p2) ** 2).sum(-1))
    d = torch.where(torch.all(p2 == -1.0, dim=-1), -1.0, d)
    if mode == "3d":
        d = torch.where(torch.all(gt2 == -1.0, dim=-1), -1.0, d)
    return torch.where(matched[..., None], d, -1.0)


def _avg_matched(d, matched):
    """Per-joint mean over matched distances; NaN when a joint has no
    matches, like the NumPy reference's np.mean of an empty slice."""
    n = matched.sum((0, 1))
    avg = torch.where(matched, d, 0.0).sum((0, 1)) / n.clamp(min=1)
    return torch.where(n > 0, avg, torch.nan)


def _pck(d, gv, thresh):
    """(avg (K,), pck (K,)) as NumPy from (N, Pg, K) distances and hit
    thresholds that broadcast against them."""
    d = torch.where(gv[..., None], d, -1.0)
    matched = d >= 0
    hits = (matched & (d < thresh)).sum((0, 1))
    return _avg_matched(d, matched).cpu().numpy(), (hits / gv.sum()).cpu().numpy()


def eval_pck2d_batched(gt2, gt_valid, pred2, pred_valid, dist_th=10.0, iou_th=0.5,
                       device: str | torch.device = "cuda"):
    """(avg_dist (K,), pck (K,)) — eval_human_dataset_2d, batched."""
    dev = resolve_device(device)
    gt2, gv = _t(gt2, dev, torch.float32), _t(gt_valid, dev, torch.bool)
    d = _match_dists(gt2, gv, _t(pred2, dev, torch.float32), _t(pred_valid, dev, torch.bool),
                     iou_th=iou_th, mode="2d")
    return _pck(d, gv, dist_th)


def eval_pckh2d_batched(gt2, gt_valid, pred2, pred_valid, head_id=0, neck_id=1, h_th=0.5,
                        iou_th=0.5, device: str | torch.device = "cuda"):
    """eval_human_dataset_2d_pckh, batched."""
    dev = resolve_device(device)
    gt2, gv = _t(gt2, dev, torch.float32), _t(gt_valid, dev, torch.bool)
    d = _match_dists(gt2, gv, _t(pred2, dev, torch.float32), _t(pred_valid, dev, torch.bool),
                     iou_th=iou_th, mode="2d")
    hsz = 2.0 * torch.sqrt(((gt2[:, :, head_id] - gt2[:, :, neck_id]) ** 2).sum(-1))
    return _pck(d, gv, (hsz * h_th)[..., None])


def eval_pck3d_batched(gt2, gt3, gt_valid, pred2, pred3, pred_valid, dist_th=0.1, iou_th=0.5,
                       device: str | torch.device = "cuda"):
    """eval_human_dataset_3d, batched."""
    dev = resolve_device(device)
    f32 = torch.float32
    gv = _t(gt_valid, dev, torch.bool)
    d = _match_dists(_t(gt2, dev, f32), gv, _t(pred2, dev, f32), _t(pred_valid, dev, torch.bool),
                     _t(gt3, dev, f32), _t(pred3, dev, f32), iou_th=iou_th, mode="3d")
    return _pck(d, gv, dist_th)


def assign_gt_multi_batched(pred2, pred_conf, pred_valid, gt2, gt_vis, gt_valid, ref_dist,
                            thresh=0.5):
    """Batched assignGTmulti on tensors of one device.

    pred2 (N, Pp, K, C), pred_conf (N, Pp, K), pred_valid (N, Pp) bool,
    gt2 (N, Pg, K, C), gt_vis (N, Pg, K), gt_valid (N, Pg) bool,
    ref_dist (N, Pg). Returns (scores (N, Pp, K), labels (N, Pp, K),
    has_pred (N, Pp, K), n_gt (N, K)). The host flattens valid entries per
    joint and runs getRPC/VOCap."""
    has_pred = pred_valid[..., None].expand(pred_conf.shape).to(pred_conf.dtype)
    has_gt = gt_vis * gt_valid[..., None]  # (N, Pg, K)

    d = torch.sqrt(((pred2[:, :, None] - gt2[:, None, :]) ** 2).sum(-1))  # (N, Pp, Pg, K)
    d = d / ref_dist[:, None, :, None]
    usable = has_pred[:, :, None] * has_gt[:, None]  # (N, Pp, Pg, K)
    d = torch.where(usable > 0, d, torch.inf)

    match = (d <= thresh).to(torch.int32)  # (N, Pp, Pg, K)
    n_gt_per = has_gt.sum(-1)  # (N, Pg)
    pck = match.sum(-1) / n_gt_per[:, None, :].clamp(min=1)  # (N, Pp, Pg)
    pck = torch.where(gt_valid[:, None, :], pck, -torch.inf)
    pck = torch.where(pred_valid[..., None], pck, -torch.inf)

    # keep each prediction's best GT only, then invert: GT -> best pred
    Pg, Pp = gt2.shape[1], pred2.shape[1]
    best_gt = pck.argmax(-1)  # (N, Pp)
    only_best = torch.where(F.one_hot(best_gt, Pg).bool(), pck, -torch.inf)
    only_best = torch.where(only_best == -torch.inf, 0.0, only_best)
    val = only_best.amax(1)  # (N, Pg)
    pred_to_gt = torch.where(val == 0, -1, only_best.argmax(1))  # (N, Pg)

    # pred p is assigned to the first gt g with pred_to_gt[g] == p
    assign = pred_to_gt[:, None, :] == torch.arange(Pp, device=pred2.device)[None, :, None]
    is_assigned = assign.any(-1)
    first_gt = assign.to(torch.int32).argmax(-1)  # (N, Pp)

    matched_labels = torch.gather(
        match, 2, first_gt[:, :, None, None].expand(-1, -1, 1, match.shape[-1]))[:, :, 0]
    labels = torch.where(is_assigned[..., None], matched_labels, 0)
    labels = labels * has_pred.to(torch.int32)
    # the reference counts the GT joints of an image only where it has a
    # prediction (eval/map.py assign_gt_multi fills has_gt under n_pred > 0)
    n_gt = (has_gt * pred_valid.any(1)[:, None, None]).sum(1)
    return pred_conf * has_pred, labels, has_pred, n_gt


def eval_ap_batched(pred2, pred_conf, pred_valid, gt2, gt_vis, gt_valid, ref_dist, thresh=0.5,
                    device: str | torch.device = "cuda"):
    """Full batched mAP: the assignment on the device, RPC/VOCap on the host.
    Returns (K+1,) APs like eval_ap_mpii_v2."""
    dev = resolve_device(device)
    f32 = torch.float32
    scores, labels, has_pred, n_gt = assign_gt_multi_batched(
        _t(pred2, dev, f32), _t(pred_conf, dev, f32), _t(pred_valid, dev, torch.bool),
        _t(gt2, dev, f32), _t(gt_vis, dev, f32), _t(gt_valid, dev, torch.bool),
        _t(ref_dist, dev, f32), thresh)
    scores, labels = scores.cpu().numpy(), labels.cpu().numpy()
    has_pred, n_gt = has_pred.cpu().numpy() > 0, n_gt.cpu().numpy()

    K = scores.shape[-1]
    ap = np.zeros(K + 1)
    for k in range(K):
        sel = has_pred[..., k]
        p, r = get_rpc(scores[..., k][sel], labels[..., k][sel], n_gt[:, k].sum())
        ap[k] = voc_ap(r, p) * 100
    ap[-1] = ap[:-1].mean()
    return ap
