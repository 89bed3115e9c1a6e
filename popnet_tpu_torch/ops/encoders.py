"""Dense GT targets of the depth families, batched over frames (torch).

The port's copy of `popnet_tpu/ops/encoders.py`: each target is one
broadcast expression over (frames, people, joints, grid), batched over the
frames directly where the JAX package vmaps a per-frame function. Targets
are channels-last, as the JAX package makes them:

- heatmaps (B, H, W, K+1): per-joint Gaussians on the stride grid, summed
  over people and clipped at 1, and a background channel;
- pafs (B, H, W, 2L): unit limb vectors painted within one grid cell of the
  limb, averaged over the people that paint a cell;
- zmaps and fg_masks_z (B, H, W, K): each joint's depth on a box around it,
  the nearest person winning, the downsampled input depth elsewhere,
  normalized;
- align_maps and fg_masks_align (B, H, W, 2K): truncated normalized offsets
  to the nearest joint of the type (the first person among equals);
- prior_map (B, H, W, A*(5+3K)) and prior_mask_conf, prior_mask_coord,
  prior_weight_map (B, H, W, A): the anchor targets of the prior subnet;
  with `pred_vis`, (B, H, W, A*(5+4K)), each joint's visibility inferred
  from the encoded z-maps (`infer_joint_visibility`) appended per anchor.

Conventions: a joint takes part iff 0 <= x < input_x and 0 <= y < input_y
and its person is valid; heat cell (i, j) has pixel centre
(j * stride + stride / 2 - 0.5, ...), align cell (i, j) grid centre
(j + 0.5, i + 0.5); box bounds floor, then clamp to the grid.

Divisions by constants multiply by the float32 reciprocal, as XLA's CPU
compiler computes the JAX targets (`core.numerics.div_const`).

People are written into the prior targets one at a time in order, so where
two valid people share a (cell, anchor) the later one's target stands, and
the later one's pose weight on every anchor of the cell, as the JAX
package's sequential loop leaves them.
"""

from __future__ import annotations

import torch

from popnet_tpu_torch.core.config import DepthStats, EncoderConfig
from popnet_tpu_torch.core.numerics import div_const
from popnet_tpu_torch.core.skeleton import LIMBS

_GAUSS_CUTOFF = 4.6052  # exp(-4.6052) ~= 0.01


def _inbound(joints2d: torch.Tensor, person_valid: torch.Tensor, cfg: EncoderConfig):
    """(B, P, K) mask of joints inside the input image, of valid people."""
    x, y = joints2d[..., 0], joints2d[..., 1]
    ok = (x >= 0) & (x < cfg.input_x) & (y >= 0) & (y < cfg.input_y)
    return ok & person_valid[..., None]


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=like.device)


def encode_heatmaps(joints2d, person_valid, cfg: EncoderConfig):
    """(B, grid_h, grid_w, K+1) Gaussian part confidences and background
    max(1 - max_k heat_k, 0)."""
    H, W, s = cfg.grid_h, cfg.grid_w, cfg.stride
    start = s / 2.0 - 0.5
    xs, ys = _arange(W, joints2d) * s + start, _arange(H, joints2d) * s + start
    inb = _inbound(joints2d, person_valid, cfg)                          # (B, P, K)
    dx = xs - joints2d[..., 0, None, None]                               # (B, P, K, 1, W)
    dy = ys[:, None] - joints2d[..., 1, None, None]                      # (B, P, K, H, 1)
    expo = div_const(dx * dx + dy * dy, 2.0 * cfg.sigma * cfg.sigma)     # (B, P, K, H, W)
    g = torch.exp(-expo) * (expo <= _GAUSS_CUTOFF) * inb[..., None, None]
    heat = g.sum(1).clamp(0.0, 1.0)                                      # (B, K, H, W)
    bg = (1.0 - heat.amax(1)).clamp_min(0.0)
    return torch.cat([heat, bg[:, None]], 1).permute(0, 2, 3, 1)


def encode_pafs(joints2d, person_valid, cfg: EncoderConfig, limbs=LIMBS):
    """(B, grid_h, grid_w, 2L) part-affinity fields, (x, y) of limb l in
    channels 2l, 2l+1."""
    H, W = cfg.grid_h, cfg.grid_w
    src = torch.as_tensor([a for a, _ in limbs], device=joints2d.device)
    dst = torch.as_tensor([b for _, b in limbs], device=joints2d.device)
    inb = _inbound(joints2d, person_valid, cfg)
    gj = div_const(joints2d, cfg.stride)                                 # grid units
    cA, cB = gj[:, :, src], gj[:, :, dst]                                # (B, P, L, 2)
    valid = inb[:, :, src] & inb[:, :, dst]
    vec = cB - cA
    norm = torch.sqrt((vec * vec).sum(-1))
    valid = valid & (norm > 0.0)
    unit = vec / norm.clamp_min(1e-12)[..., None]

    thre = cfg.paf_width
    min_xy = torch.round(torch.minimum(cA, cB) - thre)
    max_xy = torch.round(torch.maximum(cA, cB) + thre)
    min_x, min_y = min_xy[..., 0].clamp_min(0.0), min_xy[..., 1].clamp_min(0.0)
    max_x, max_y = max_xy[..., 0].clamp_max(W - 1.0), max_xy[..., 1].clamp_max(H - 1.0)
    xx, yy = _arange(W, joints2d), _arange(H, joints2d)[:, None]
    e = (..., None, None)
    in_box = (xx >= min_x[e]) & (xx <= max_x[e]) & (yy >= min_y[e]) & (yy <= max_y[e])

    ba_x = xx - cA[..., 0][e]                                            # (B, P, L, 1, W)
    ba_y = yy - cA[..., 1][e]                                            # (B, P, L, H, 1)
    width = (ba_x * unit[..., 1][e] - ba_y * unit[..., 0][e]).abs()
    paint = in_box & (width < thre) & valid[e]                           # (B, P, L, H, W)

    total = (paint[..., None] * unit[:, :, :, None, None, :]).sum(1)     # (B, L, H, W, 2)
    count = paint.sum(1)                                                 # (B, L, H, W)
    paf = total / count.clamp_min(1)[..., None]
    B, L = joints2d.shape[0], len(limbs)
    return paf.permute(0, 2, 3, 1, 4).reshape(B, H, W, 2 * L)


def _box_mask(centers, valid, radius, h: int, w: int):
    """(B, P, K, H, W) mask of the floor-clamped (2r+1)^2 boxes around grid
    centres."""
    min_x = torch.floor(centers[..., 0] - radius).clamp_min(0.0)
    max_x = torch.floor(centers[..., 0] + radius).clamp_max(w - 1.0)
    min_y = torch.floor(centers[..., 1] - radius).clamp_min(0.0)
    max_y = torch.floor(centers[..., 1] + radius).clamp_max(h - 1.0)
    xx, yy = _arange(w, centers), _arange(h, centers)[:, None]
    e = (..., None, None)
    m = (xx >= min_x[e]) & (xx <= max_x[e]) & (yy >= min_y[e]) & (yy <= max_y[e])
    return m & valid[e]


def encode_zmaps(joints2d, joints_z, person_valid, depth_resize, cfg: EncoderConfig,
                 depth: DepthStats):
    """(B, zgrid_h, zgrid_w, K) normalized pose-depth maps and their
    foreground masks: the smallest joint depth over people inside the boxes,
    the downsampled input depth (B, zgrid_h, zgrid_w) elsewhere, clipped to
    [0, depth.max]."""
    H, W = cfg.zgrid_h, cfg.zgrid_w
    inb = _inbound(joints2d, person_valid, cfg)
    box = _box_mask(div_const(joints2d, cfg.stride_z), inb, cfg.z_radius, H, W)
    cand = torch.where(box, joints_z[..., None, None], torch.full((), float("inf"),
                                                                   device=box.device))
    zfg = cand.amin(1)                                                   # (B, K, H, W)
    fg = box.any(1)
    z = torch.where(fg, zfg, depth_resize[:, None])
    z = div_const(z.clamp(0.0, depth.max) - depth.mean, depth.std)
    return z.permute(0, 2, 3, 1), fg.float().permute(0, 2, 3, 1)


def encode_alignmaps(joints2d, person_valid, cfg: EncoderConfig):
    """(B, agrid_h, agrid_w, 2K) truncated offset fields (dx, dy of joint k
    in channels 2k, 2k+1) and their foreground masks; among overlapping
    instances of a joint type the nearest wins, the first person on a tie."""
    H, W = cfg.agrid_h, cfg.agrid_w
    r = float(cfg.align_radius)
    max_dist = 2.0 * (r + 0.5)
    inb = _inbound(joints2d, person_valid, cfg)
    centers = div_const(joints2d, cfg.stride_align)                      # (B, P, K, 2)
    box = _box_mask(centers, inb, cfg.align_radius, H, W)                # (B, P, K, H, W)
    xx, yy = _arange(W, joints2d), _arange(H, joints2d)[:, None]
    dx = -(xx + 0.5 - centers[..., 0, None, None])
    dy = -(yy + 0.5 - centers[..., 1, None, None])
    dx = div_const(dx.clamp(-(r + 0.5), r + 0.5), r + 0.5)
    dy = div_const(dy.clamp(-(r + 0.5), r + 0.5), r + 0.5)
    dx, dy = torch.broadcast_tensors(dx, dy)

    dist = torch.where(box, torch.sqrt(dx * dx + dy * dy),
                       torch.full((), max_dist, device=box.device))
    win_dist, winner = dist.min(1)                                       # (B, K, H, W)
    has_fg = win_dist < max_dist
    wdx = torch.gather(dx, 1, winner[:, None])[:, 0]
    wdy = torch.gather(dy, 1, winner[:, None])[:, 0]
    zero = torch.zeros((), device=dx.device)
    amap = torch.stack([torch.where(has_fg, wdx, zero), torch.where(has_fg, wdy, zero)], -1)
    fg2 = box.any(1)[..., None].expand(*box.shape[:1], *box.shape[2:], 2).float()
    B, K = joints2d.shape[0], joints2d.shape[2]
    return (amap.permute(0, 2, 3, 1, 4).reshape(B, H, W, 2 * K),
            fg2.permute(0, 2, 3, 1, 4).reshape(B, H, W, 2 * K))


def _wh_iou(wh: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Centred-box IoU by (w, h) only: wh (..., 2), anchors (A, 2) -> (..., A)."""
    w, h = wh[..., 0, None], wh[..., 1, None]
    inter = torch.minimum(w, anchors[:, 0]) * torch.minimum(h, anchors[:, 1])
    union = w * h + anchors[:, 0] * anchors[:, 1] - inter
    return inter / union


def infer_joint_visibility(joints2d, joints_z, zmaps_norm, cfg: EncoderConfig,
                           depth: DepthStats, depth_thresh: float = 0.03):
    """(B, P, K) float32 visibility of each joint in the z-buffered pose-depth
    map: 1 where the joint's z-grid cell (its coordinates over stride_z,
    truncated) lies on the grid and the normalized z-map zmaps_norm
    (B, zgrid_h, zgrid_w, K) there agrees with the joint's depth within
    `depth_thresh` metres."""
    H, W = cfg.zgrid_h, cfg.zgrid_w
    xj = torch.trunc(div_const(joints2d[..., 0], cfg.stride_z)).long()       # (B, P, K)
    yj = torch.trunc(div_const(joints2d[..., 1], cfg.stride_z)).long()
    inb = (xj >= 0) & (xj < W) & (yj >= 0) & (yj < H)
    B, P, K = xj.shape
    b = torch.arange(B, device=xj.device)[:, None, None]
    k = torch.arange(K, device=xj.device)[None, None, :]
    zread = zmaps_norm[b, yj.clamp(0, H - 1), xj.clamp(0, W - 1), k]
    zj_norm = div_const(joints_z - depth.mean, depth.std)
    agree = (zread - zj_norm).abs() * depth.std <= depth_thresh
    return (inb & agree).float()


def encode_prior_targets(bboxes, joints2d, joints_z, pose_weights, person_valid,
                         cfg: EncoderConfig, depth: DepthStats, noobject_scale: float = 0.1,
                         object_scale: float = 1.0, visibility=None):
    """Anchor targets of the prior subnet: (prior_map (B, H, W, A*naf),
    mask_conf, mask_coord, weight_map (B, H, W, A)). A valid person's
    target [dx, dy, w/aw, h/ah, 1, K x-offsets / (aw/2), K y-offsets /
    (ah/2), K normalized z] (naf = 5 + 3K), followed by its K visibilities
    where `visibility` (B, P, K) is given (naf = 5 + 4K), goes to its box
    centre's cell and its best anchor by IoU; people are written in order,
    the later standing."""
    H, W, A = cfg.prior_h, cfg.prior_w, cfg.num_anchors
    dev = bboxes.device
    anchors = torch.as_tensor(cfg.anchors, dtype=torch.float32, device=dev)   # (A, 2)
    B, P = bboxes.shape[:2]
    s = float(cfg.stride_prior)
    cx = div_const(div_const(bboxes[..., 0] + bboxes[..., 2], 2.0), s)        # (B, P)
    cy = div_const(div_const(bboxes[..., 1] + bboxes[..., 3], 2.0), s)
    bw = div_const(bboxes[..., 2] - bboxes[..., 0], s)
    bh = div_const(bboxes[..., 3] - bboxes[..., 1], s)
    jx = div_const(joints2d[..., 0], s)                                       # (B, P, K)
    jy = div_const(joints2d[..., 1], s)
    jz = div_const(joints_z - depth.mean, depth.std)

    best_n = _wh_iou(torch.stack([bw, bh], -1), anchors).argmax(-1)           # (B, P)
    gi = torch.floor(cx).clamp(0, W - 1).long()
    gj = torch.floor(cy).clamp(0, H - 1).long()
    aw, ah = anchors[best_n, 0], anchors[best_n, 1]
    gif, gjf = gi.float(), gj.float()
    target = torch.cat([
        torch.stack([cx - gif, cy - gjf, bw / aw, bh / ah, torch.ones_like(cx)], -1),
        (jx - gif[..., None]) / div_const(aw, 2.0)[..., None],
        (jy - gjf[..., None]) / div_const(ah, 2.0)[..., None],
        jz,
    ] + ([] if visibility is None else [visibility]), -1)                     # (B, P, naf)
    naf = target.shape[-1]

    prior = torch.zeros((B, H, W, A, naf), dtype=torch.float32, device=dev)
    mconf = torch.full((B, H, W, A), noobject_scale, dtype=torch.float32, device=dev)
    mcoord = torch.zeros((B, H, W, A), dtype=torch.float32, device=dev)
    wmap = torch.ones((B, H, W, A), dtype=torch.float32, device=dev)
    frames = torch.arange(B, device=dev)
    for p in range(P):                   # in order: the later person's write stands
        b = frames[person_valid[:, p]]
        y, x, n = gj[b, p], gi[b, p], best_n[b, p]
        prior[b, y, x, n] = target[b, p]
        mconf[b, y, x, n] = object_scale
        mcoord[b, y, x, n] = 1.0
        wmap[b, y, x] = pose_weights[b, p, None]
    return prior.reshape(B, H, W, A * naf), mconf, mcoord, wmap


def encode_targets(joints2d, joints3d, bboxes, pose_weights, person_valid, depth_resize,
                   cfg: EncoderConfig, depth: DepthStats, pose_align: bool = True,
                   with_prior: bool = True, pred_vis: bool = False) -> dict:
    """The full GT-target bundle of a batch: joints2d (B, P, K, 2),
    joints3d (B, P, K, 3), bboxes (B, P, 4), pose_weights (B, P),
    person_valid (B, P) bool, depth_resize (B, zgrid_h, zgrid_w) -> the
    dict of channels-last targets named as the JAX package names them; with
    `pred_vis`, the prior carries each joint's visibility inferred from the
    encoded z-maps."""
    joints_z = joints3d[..., 2]
    out = {"heatmaps": encode_heatmaps(joints2d, person_valid, cfg),
           "pafs": encode_pafs(joints2d, person_valid, cfg)}
    out["zmaps"], out["fg_masks_z"] = encode_zmaps(joints2d, joints_z, person_valid,
                                                   depth_resize, cfg, depth)
    if pose_align:
        out["align_maps"], out["fg_masks_align"] = encode_alignmaps(joints2d, person_valid, cfg)
    if with_prior:
        vis = (infer_joint_visibility(joints2d, joints_z, out["zmaps"], cfg, depth)
               if pred_vis else None)
        (out["prior_map"], out["prior_mask_conf"], out["prior_mask_coord"],
         out["prior_weight_map"]) = encode_prior_targets(
            bboxes, joints2d, joints_z, pose_weights, person_valid, cfg, depth, visibility=vis)
    return out
