"""Two-stage Yolo->A2J evaluation: detector boxes -> per-person A2J crops.

The port's counterpart of the JAX package's `popnet_tpu/cli/yolo_a2j.py`:
stage 1 takes boxes from the Yolo-Pose+ detector (or from the labels), stage
2 crops every box to 288x288 on the device (one gather per crop batch), runs
A2J and its anchor vote there, and the host uncrops, back-projects and
groups the joints per frame in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from popnet_tpu_torch.core.camera import back_project_np
from popnet_tpu_torch.core.config import DecodeConfig, EncoderConfig
from popnet_tpu_torch.data.a2j_crops import CROP, crop_resize_batch, uncrop_keypoints
from popnet_tpu_torch.decode import prior as prior_decode
from popnet_tpu_torch.decode.a2j import a2j_post_process
from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors

CROP_BATCH = 32   # A2J crops a forward pass


def stage1_detect_boxes(
    infer_yolo,
    dataset,
    batch_size: int = 16,
    ecfg: EncoderConfig = EncoderConfig(),
    dcfg: DecodeConfig = DecodeConfig(),
):
    """Run the detector over the dataset; returns (image_idx (N,),
    boxes (N, 4) in original-image pixels)."""
    w_org, h_org = dataset.dcfg.width, dataset.dcfg.height
    image_idx, boxes = [], []
    n = len(dataset)
    for s in range(0, n, batch_size):
        idx = list(range(s, min(s + batch_size, n)))
        prior_map = infer_yolo(dataset.get_batch(idx)["image"])
        bxs, _, _ = prior_decode.parse_prior_pose(
            prior_map, np.asarray(ecfg.anchors, np.float32), ecfg.num_joints,
            w_org, h_org, dataset.dcfg.depth,
            conf_threshold=dcfg.conf_threshold, nms_threshold=dcfg.nms_threshold,
            max_det=dcfg.max_people,
        )
        for b, img_i in enumerate(idx):
            for box in bxs[b]:
                x0, y0, x1, y1 = box[:4]
                cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
                w2, h2 = (x1 - x0) / 2, (y1 - y0) / 2
                image_idx.append(img_i)
                boxes.append([cx - w2, cy - h2, cx + w2, cy + h2])
    return np.asarray(image_idx, np.int32), np.asarray(boxes, np.float32)


def stage1_gt_boxes(dataset):
    """Stage 1 from the labels' person bboxes instead of the detector (the
    A2J-in-isolation ablation row)."""
    image_idx, boxes = [], []
    for i in range(len(dataset)):
        _, anns = dataset.load_composited(i)
        for a in anns:
            if "bbox" not in a:
                continue
            x0, y0, x1, y1 = np.asarray(a["bbox"][:4], np.float64)
            cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
            w2, h2 = (x1 - x0) / 2, (y1 - y0) / 2
            image_idx.append(i)
            boxes.append([cx - w2, cy - h2, cx + w2, cy + h2])
    return (
        np.asarray(image_idx, np.int32),
        np.asarray(boxes, np.float32).reshape(-1, 4),
    )


def run_yolo_a2j_eval(
    infer_yolo,
    infer_a2j,
    dataset,
    batch_size: int = 16,
    ecfg: EncoderConfig = EncoderConfig(),
    dcfg: DecodeConfig = DecodeConfig(),
    gt_boxes: bool = False,
):
    """Full two-stage inference over an eval dataset -> benchmark eval_data.

    `infer_a2j(crops (N, 288, 288, 1))`, normalized crops on the dataset's
    device, returns the (cls, reg, depth) heads as tensors. With
    gt_boxes=True stage 1 reads the labels' bboxes and `infer_yolo` may be
    None."""
    cam = dataset.intrinsics or dataset.dcfg.intrinsics
    depth = dataset.dcfg.depth
    dev = dataset.device

    if gt_boxes:
        image_idx, boxes = stage1_gt_boxes(dataset)
    else:
        image_idx, boxes = stage1_detect_boxes(infer_yolo, dataset, batch_size, ecfg, dcfg)

    all_anchors = torch.as_tensor(
        shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
        dtype=torch.float32, device=dev,
    )

    # raw full-resolution frames for cropping, on the device in one copy
    raw = torch.from_numpy(np.stack(
        [dataset.load_composited(i)[0] for i in range(len(dataset))]).astype(np.float32)).to(dev)

    preds = []
    for s in range(0, len(boxes), CROP_BATCH):
        bi = torch.as_tensor(image_idx[s:s + CROP_BATCH], device=dev)
        bb = torch.as_tensor(boxes[s:s + CROP_BATCH], device=dev)
        crops = crop_resize_batch(raw, bi, bb, depth.mean, depth.std)
        kp = a2j_post_process(infer_a2j(crops[..., None]), all_anchors)  # (n, K, 3) (y, x, z)
        preds.append(kp.cpu().numpy())
    pred_yxz = np.concatenate(preds, 0) if preds else np.zeros((0, ecfg.num_joints, 3))

    pred_xyz = uncrop_keypoints(pred_yxz, boxes, CROP) if len(boxes) else pred_yxz

    # group rows by image
    pred2d_set = [[] for _ in range(len(dataset))]
    pred3d_set = [[] for _ in range(len(dataset))]
    conf_set = [[] for _ in range(len(dataset))]
    for n in range(len(boxes)):
        i = int(image_idx[n])
        x, y, z = pred_xyz[n].T
        pred2d_set[i].append(np.stack([x, y], 1).tolist())
        pred3d_set[i].append(back_project_np(x, y, z, cam).tolist())
        conf_set[i].append([1.0] * ecfg.num_joints)

    gt2d_set, gt3d_set = dataset.gt_human_lists()
    return {
        "human_pred_set_2d": pred2d_set,
        "human_pred_set_3d": pred3d_set,
        "human_pred_set_part_conf": conf_set,
        "human_gt_set_2d": gt2d_set,
        "human_gt_set_3d": gt3d_set,
    }
