"""Train steps of the depth and RGB families, on one device.

Each factory returns `step(state, batch) -> (state, logs)`, the JAX
package's contract (`popnet_tpu/train/steps.py`): the forward in train mode
(BatchNorm normalizes by the batch and moves its running statistics as
Flax does, `models.layers.BatchNorm`), the loss, the backward, and the
optimizer's update, in place. `logs` holds the loss's parts and `loss` as
0-d tensors on the device: reading one waits for the step. The
`make_*_eval_loss` factories score a batch in eval mode, as the JAX
command line's validation does. Under a parallel layout (`state.layout`,
`parallel/`), the batch is this rank's rows (`layout.shard_batch`), the
layout runs the forward, the gradients are reduced over its groups before
the update, and the logs are the global batch's.

The batch is `data.datasets.prepare_batch`'s dict: "image" (B, H, W, 1)
and the channels-last targets; A2J's is `data.a2j_crops.A2JCropDataset`'s,
"crops" (N, S, S, 1) and "labels"; RTPoseVGG's `data.coco_dataset`'s and
PopNetRGB's `data.mpii`'s, "image" (B, H, W, 3) and their targets.
"""

from __future__ import annotations

import torch

from popnet_tpu_torch.losses.losses import (a2j_loss, popnet_loss, popnet_rgb_loss,
                                            rtpose_light3d_loss_fgweight, rtpose_light_loss,
                                            yolo_loss)


def _nchw(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) with plain NCHW strides. An image
    permuted from NHWC reads as channels-last (one channel or three),
    cuDNN keeps that layout through the stem, and the CUDA backward of the
    stem's `F.avg_pool2d` is wrong on channels-last input (PyTorch 2.11,
    CUDA 12.8: the whole gradient off by its own size), so the batch is
    copied to the plain layout."""
    return image.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)


def _rtpose_loss(out, batch):
    _, saved = out
    return rtpose_light3d_loss_fgweight(saved, batch["heatmaps"], batch["pafs"], batch["zmaps"],
                                        batch["fg_masks_z"])


def _popnet_loss(out, batch, num_joints: int = 15, pred_vis: bool = False):
    _, saved = out
    return popnet_loss(saved, batch["heatmaps"], batch["zmaps"], batch["fg_masks_z"],
                       batch["align_maps"], batch["fg_masks_align"], batch["prior_map"],
                       batch["prior_mask_conf"], batch["prior_mask_coord"],
                       batch["prior_weight_map"], num_joints, pred_vis)


def _yolo_loss(out, batch, num_joints: int = 15):
    return yolo_loss(out, batch["prior_map"], batch["prior_mask_conf"],
                     batch["prior_mask_coord"], batch["prior_weight_map"], num_joints)


def _rtpose_vgg_loss(out, batch):
    _, saved = out
    return rtpose_light_loss(saved, batch["heat"], batch["paf"])


def _popnet_rgb_loss(out, batch, num_joints: int = 16):
    _, saved = out
    return popnet_rgb_loss(saved, batch["heatmaps"], batch["align_maps"], batch["fg_masks_align"],
                           batch["prior_map"], batch["prior_mask_conf"], batch["prior_mask_coord"],
                           num_joints)


def _forward(state, x):
    return state.model(x) if state.layout is None else state.layout.forward(state.model, x)


def _make_step(loss_fn, image_key: str = "image"):
    def step(state, batch):
        model, opt, layout = state.model, state.optimizer, state.layout
        model.train()
        opt.zero_grad(set_to_none=True)
        loss, logs = loss_fn(_forward(state, _nchw(batch[image_key])), batch)
        loss.backward()
        if layout is not None:
            layout.reduce_gradients(model)
        opt.step()
        logs = {k: v.detach() for k, v in logs.items()}
        logs["loss"] = loss.detach()
        if layout is not None:
            logs = layout.reduce_logs(logs)
        return state, logs

    return step


def _make_eval_loss(loss_fn, image_key: str = "image"):
    def eval_loss(state, batch) -> torch.Tensor:
        state.model.eval()
        with torch.no_grad():
            return loss_fn(_forward(state, _nchw(batch[image_key])), batch)[0]

    return eval_loss


def make_rtpose_train_step():
    """Open-Pose+ with the fg-weighted loss."""
    return _make_step(_rtpose_loss)


def make_popnet_train_step(num_joints: int = 15, pred_vis: bool = False):
    """PoP-Net with the composite loss, pose-weighted; with `pred_vis`, for
    `PopNet(pred_vis=True)` and targets with visibility channels."""
    return _make_step(lambda out, batch: _popnet_loss(out, batch, num_joints, pred_vis))


def make_yolo_train_step(num_joints: int = 15):
    """Yolo-Pose+ with the prior loss, pose-weighted."""
    return _make_step(lambda out, batch: _yolo_loss(out, batch, num_joints))


def make_rtpose_eval_loss():
    return _make_eval_loss(_rtpose_loss)


def make_popnet_eval_loss(num_joints: int = 15, pred_vis: bool = False):
    return _make_eval_loss(lambda out, batch: _popnet_loss(out, batch, num_joints, pred_vis))


def make_yolo_eval_loss(num_joints: int = 15):
    return _make_eval_loss(lambda out, batch: _yolo_loss(out, batch, num_joints))


def make_rtpose_vgg_train_step():
    """RTPoseVGG on COCO batches: per stage heat and PAF MSE."""
    return _make_step(_rtpose_vgg_loss)


def make_rtpose_vgg_eval_loss():
    return _make_eval_loss(_rtpose_vgg_loss)


def make_popnet_rgb_train_step(num_joints: int = 16):
    """PopNetRGB on MPII batches (`losses.popnet_rgb_loss`)."""
    return _make_step(lambda out, batch: _popnet_rgb_loss(out, batch, num_joints))


def make_popnet_rgb_eval_loss(num_joints: int = 16):
    return _make_eval_loss(lambda out, batch: _popnet_rgb_loss(out, batch, num_joints))


A2J_REG_FACTOR = 3.0   # loss = anchor + regression * A2J_REG_FACTOR, A2J's recipe


def _a2j_loss(all_anchors):
    """(heads, batch) -> (anchor + regression * A2J_REG_FACTOR, logs), the
    anchors moved once to each device and dtype the heads come in."""
    moved = {}

    def loss_fn(heads, batch):
        key = (heads[0].device, heads[0].dtype)
        if key not in moved:
            moved[key] = torch.as_tensor(all_anchors).to(device=key[0], dtype=key[1])
        anchor_l, reg_l = a2j_loss(heads, batch["labels"], moved[key])
        return anchor_l + reg_l * A2J_REG_FACTOR, {"loss_cls": anchor_l, "loss_reg": reg_l}

    return loss_fn


def make_a2j_train_step(all_anchors):
    """A2J on {"crops": (N, S, S, 1), "labels": (N, K, 3) (y, x, z) in crop
    space}: loss = anchor + regression * A2J_REG_FACTOR (`a2j_loss`);
    all_anchors (W*H*A, 2) of the crop's grid (`models.a2j.shift_anchors`)."""
    return _make_step(_a2j_loss(all_anchors), image_key="crops")


def make_a2j_eval_loss(all_anchors):
    return _make_eval_loss(_a2j_loss(all_anchors), image_key="crops")
