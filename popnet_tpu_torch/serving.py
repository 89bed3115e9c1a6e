"""Serving: raw depth or RGB frames -> packed human tensors.

`build_openpose_pipeline`, `build_popnet_pipeline`, `build_yolo_pipeline`
and `build_yolo_a2j_pipeline` return a callable that takes a (B, H, W)
batch of raw depth in metres and returns ONE packed buffer per batch on the
device (f32, or the uint16 fixed-point wire format), so a batch leaves the
card in one copy; `build_rtpose_vgg_pipeline` does the same for (B, H, W, 3)
BGR frames with COCO's 18 joints in 2D (f32 only). `serve_stream` keeps a
few batches in flight; the copy to the host is its synchronization point.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, CameraIntrinsics, back_project
from popnet_tpu_torch.core.config import KDH3D_DEPTH, DecodeConfig, DepthStats, EncoderConfig
from popnet_tpu_torch.core.device import resolve_device
from popnet_tpu_torch.core.numerics import div_const
from popnet_tpu_torch.data.a2j_crops import CROP, crop_resize_batch
from popnet_tpu_torch.decode.prior import decode_prior_maps
from popnet_tpu_torch.ops.resize import resize_bilinear_cv2


def preproc_depth(raw_depth: torch.Tensor, depth: DepthStats = KDH3D_DEPTH,
                  out_h: int = 224, out_w: int = 224) -> torch.Tensor:
    """clip -> cv2-parity bilinear resize -> normalize -> (B, out_h, out_w, 1)."""
    x = raw_depth.float().clamp(0.0, depth.max)
    x = resize_bilinear_cv2(x, out_h, out_w)
    return ((x - depth.mean) / depth.std)[..., None]


def pack_outputs(*tensors: torch.Tensor) -> torch.Tensor:
    """Flatten per-batch outputs into ONE f32 (B, L) buffer."""
    B = tensors[0].shape[0]
    return torch.cat([t.float().reshape(B, -1) for t in tensors], dim=1)


def unpack_outputs(buf: np.ndarray, max_people: int, num_joints: int):
    """Host inverse of pack_outputs for the (joints2d, joints3d, conf,
    counts) layout. Returns numpy views. Open-Pose+ packs one person count
    per frame there; PoP-Net packs its (max_people,) validity flags, which
    come back under the same key, "counts"."""
    buf = np.asarray(buf)
    B = buf.shape[0]
    s1, s2, s3 = max_people * num_joints * 2, max_people * num_joints * 3, max_people * num_joints
    return {
        "joints2d": buf[:, :s1].reshape(B, max_people, num_joints, 2),
        "joints3d": buf[:, s1:s1 + s2].reshape(B, max_people, num_joints, 3),
        "conf": buf[:, s1 + s2:s1 + s2 + s3].reshape(B, max_people, num_joints),
        "counts": buf[:, s1 + s2 + s3:],
    }


# q16 wire format: (joints2d, z, conf, counts) as uint16 fixed point —
# joints at 1/16 px, depth at 1/4096 m, confidence at 1/512, all offset by 2
# so the -1 hole sentinel is in range; the host back-projects joints3d.
_Q16_OFF = 2.0
_Q16_XY = 16.0
_Q16_Z = 4096.0
_Q16_CONF = 512.0


def pack_outputs_q16(joints2d, z, conf, counts) -> torch.Tensor:
    """(B,P,K,2), (B,P,K), (B,P,K), (B,) -> (B, L) uint16 wire buffer."""
    B = joints2d.shape[0]

    def q(t, scale):
        t = (t.float() + _Q16_OFF) * scale
        return torch.round(t).clamp(0, 65535).to(torch.int32).reshape(B, -1)

    buf = torch.cat([q(joints2d, _Q16_XY), q(z, _Q16_Z), q(conf, _Q16_CONF),
                     counts.to(torch.int32).reshape(B, -1)], dim=1)
    # 0..65535 -> the same 16 bits as int16 (casts wrap), read as uint16
    return buf.to(torch.int16).view(torch.uint16)


def unpack_outputs_q16(buf: np.ndarray, max_people: int, num_joints: int,
                       cam: CameraIntrinsics = KDH3D_INTRINSICS):
    """Host inverse of pack_outputs_q16: dequantize and back-project.
    Hole joints come back as exactly (-1, -1) with z = -1."""
    buf = np.asarray(buf)
    B = buf.shape[0]
    Pp, K = max_people, num_joints
    s1, s2, s3 = Pp * K * 2, Pp * K, Pp * K

    def dq(a, scale):
        return a.astype(np.float32) / np.float32(scale) - np.float32(_Q16_OFF)

    j2 = dq(buf[:, :s1], _Q16_XY).reshape(B, Pp, K, 2)
    z = dq(buf[:, s1:s1 + s2], _Q16_Z).reshape(B, Pp, K)
    conf = dq(buf[:, s1 + s2:s1 + s2 + s3], _Q16_CONF).reshape(B, Pp, K)
    x = (j2[..., 0] - np.float32(cam.cx)) / np.float32(cam.fx) * z
    y = (j2[..., 1] - np.float32(cam.cy)) / np.float32(cam.fy) * z
    return {
        "joints2d": j2,
        "joints3d": np.stack([x, y, z], axis=-1),
        "conf": conf,
        "counts": buf[:, s1 + s2 + s3:].astype(np.int32),
    }


_QUANT_MODES = (None, "none", "", "int8")


def _check_build_args(device, pack: str) -> torch.device:
    if pack not in ("f32", "q16"):
        raise ValueError(f"unknown pack {pack!r}")
    return resolve_device(device)


def deploy_model(model: torch.nn.Module, device, dtype: torch.dtype, fold_bn: bool = False,
                 quant: str | None = None, rounding: str = "compiled") -> torch.nn.Module:
    """A float32 `model` as it serves, changed in place: in eval mode, its
    Conv -> BatchNorm pairs folded and fused with `fold_bn`
    (`ops.fold_bn.fold_module`), then with `quant="int8"` its eligible
    convs dynamic-int8 (`ops.quant.quantize_convs`, with `rounding`), in
    that order, as the JAX builders fold before they quantize; then in
    `dtype` on `device` with float32 BatchNorm (int8 convs keep float32
    weights and scales)."""
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32
    from popnet_tpu_torch.ops.fold_bn import fold_module
    from popnet_tpu_torch.ops.quant import quantize_convs

    if quant not in _QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}")
    model.eval()
    if fold_bn:
        fold_module(model)
    if quant == "int8":
        quantize_convs(model, rounding=rounding)
    return keep_batchnorm_float32(model.to(device=device, dtype=dtype))


def build_openpose_pipeline(weights: dict[str, np.ndarray],
                            dtype: torch.dtype = torch.bfloat16,
                            device: str | torch.device = "cuda",
                            stage: str = "full", pack: str = "f32",
                            quant: str | None = None, fold_bn: bool = False):
    """Open-Pose+ serving fn: (B, H, W) raw depth -> (B, L) packed buffer.

    weights: the model's Flax variables as {'/'-joined path: array}
    (`interop.load_npz`). The CNN runs in `dtype` with float32 BatchNorm;
    the decode runs in float32. stage="cnn" stops after the CNN and packs
    per-image reductions (to attribute time between CNN and decode).
    pack="q16" emits the uint16 wire buffer instead of f32. Geometry,
    thresholds, depth statistics and camera are the KDH3D defaults.
    fold_bn=True folds the BatchNorms into the convs, and quant="int8" runs
    the eligible convs in dynamic int8 (`deploy_model`), as the JAX
    builders do; quant is None, "none", "" or "int8"."""
    from popnet_tpu_torch.decode.openpose_infer import openpose_decode
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseLight3D

    if stage not in ("full", "cnn"):
        raise ValueError(f"unknown stage {stage!r}")
    device = _check_build_args(device, pack)
    model = deploy_model(load_into(RTPoseLight3D(), weights), device, dtype, fold_bn, quant)

    @torch.inference_mode()
    def pipeline(raw_depth) -> torch.Tensor:
        raw_depth = torch.as_tensor(raw_depth, device=device)
        x = preproc_depth(raw_depth)                                      # (B, 224, 224, 1)
        (paf, heat, z), _ = model(x.permute(0, 3, 1, 2).to(dtype))
        if stage == "cnn":
            return pack_outputs(heat.amax(dim=(2, 3)), paf.float().mean(dim=(2, 3)))
        nhwc = lambda t: t.permute(0, 2, 3, 1)                            # views, no copy
        # the readouts read z in the CNN's type; peaks and PAF run in float32
        out = openpose_decode(nhwc(heat).float(), nhwc(paf).float(), nhwc(z), x)
        if pack == "q16":
            return pack_outputs_q16(out["joints2d"], out["joints3d"][..., 2],
                                    out["conf"], out["counts"])
        return pack_outputs(out["joints2d"], out["joints3d"], out["conf"], out["counts"])

    return pipeline


def build_popnet_pipeline(weights: dict[str, np.ndarray],
                          dtype: torch.dtype = torch.bfloat16,
                          device: str | torch.device = "cuda",
                          readout: str = "universe", pack: str = "f32",
                          quant: str | None = None, fold_bn: bool = False):
    """PoP-Net serving fn: (B, H, W) raw depth -> (B, L) packed buffer of
    (joints2d, joints3d, conf, valid), or the q16 wire of (joints2d, z,
    conf, valid); `unpack_outputs` / `unpack_outputs_q16` read both.

    weights: the model's Flax variables as {'/'-joined path: array}
    (`interop.load_npz`). The CNN runs in `dtype` with float32 BatchNorm;
    the decode runs in float32. readout: see `popnet_decode`. fold_bn and
    quant: see `build_openpose_pipeline`."""
    from popnet_tpu_torch.decode.popnet_infer import popnet_decode
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import PopNet

    if readout not in ("universe", "gated"):
        raise ValueError(f"unknown readout {readout!r}")
    device = _check_build_args(device, pack)
    model = deploy_model(load_into(PopNet(), weights), device, dtype, fold_bn, quant)

    @torch.inference_mode()
    def pipeline(raw_depth) -> torch.Tensor:
        raw_depth = torch.as_tensor(raw_depth, device=device)
        x = preproc_depth(raw_depth)                                      # (B, 224, 224, 1)
        maps, _ = model(x.permute(0, 3, 1, 2).to(dtype))
        heat, z, align, prior = (t.float().permute(0, 2, 3, 1) for t in maps)
        out = popnet_decode(heat, z, align, prior, readout=readout)
        if pack == "q16":
            return pack_outputs_q16(out["joints2d"], out["joints3d"][..., 2],
                                    out["conf"], out["valid"])
        return pack_outputs(out["joints2d"], out["joints3d"], out["conf"], out["valid"])

    return pipeline


_ECFG, _DCFG = EncoderConfig(), DecodeConfig()


def yolo_decode(prior: torch.Tensor, w_out: float, h_out: float) -> dict[str, torch.Tensor]:
    """Yolo-Pose+ decode of float32 prior maps (B, Hp, Wp, A*(5+3K)) with
    the KDH3D anchors, thresholds, depth statistics and camera: the prior
    decode and NMS, then joints scaled to the (w_out, h_out) frame's pixels
    and back-projected. Returns dets (B, M, 5+3K) as `decode_prior_maps`
    gives them, valid (B, M), joints2d (B, M, K, 2), joints3d (B, M, K, 3),
    conf (B, M, K): the row's confidence where valid, else 0."""
    K = _ECFG.num_joints
    anchors = torch.tensor(_ECFG.anchors, dtype=torch.float32, device=prior.device)
    dets, valid = decode_prior_maps(
        prior, anchors, KDH3D_DEPTH.mean, KDH3D_DEPTH.std, num_joints=K,
        conf_threshold=_DCFG.conf_threshold, nms_threshold=_DCFG.nms_threshold,
        max_det=_DCFG.max_people)
    jx = dets[..., 5:5 + K] * w_out
    jy = dets[..., 5 + K:5 + 2 * K] * h_out
    jz = dets[..., 5 + 2 * K:5 + 3 * K]
    return {
        "dets": dets,
        "valid": valid,
        "joints2d": torch.stack([jx, jy], dim=-1),
        "joints3d": back_project(jx, jy, jz, KDH3D_INTRINSICS),
        "conf": dets[..., 4:5].expand_as(jz) * valid[..., None],
    }


def build_yolo_pipeline(weights: dict[str, np.ndarray],
                        dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device = "cuda", pack: str = "f32",
                        quant: str | None = None, fold_bn: bool = False):
    """Yolo-Pose+ serving fn: (B, H, W) raw depth -> (B, L) packed buffer of
    (joints2d, joints3d, conf, valid), or the q16 wire of (joints2d, z,
    conf, valid); `unpack_outputs` / `unpack_outputs_q16` read both.

    weights: YoloPoseNet's Flax variables as {'/'-joined path: array}
    (`interop.load_npz`). The CNN runs in `dtype` with float32 BatchNorm;
    the decode (`yolo_decode`) runs in float32. The committed weights
    expect people over a depth background: on an empty one they find none.
    fold_bn and quant: see `build_openpose_pipeline`."""
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import YoloPoseNet

    device = _check_build_args(device, pack)
    model = deploy_model(load_into(YoloPoseNet(), weights), device, dtype, fold_bn, quant)

    @torch.inference_mode()
    def pipeline(raw_depth) -> torch.Tensor:
        raw_depth = torch.as_tensor(raw_depth, device=device)
        x = preproc_depth(raw_depth)                                      # (B, 224, 224, 1)
        prior = model(x.permute(0, 3, 1, 2).to(dtype)).float().permute(0, 2, 3, 1)
        out = yolo_decode(prior, raw_depth.shape[-1], raw_depth.shape[-2])
        if pack == "q16":
            return pack_outputs_q16(out["joints2d"], out["joints3d"][..., 2],
                                    out["conf"], out["valid"])
        return pack_outputs(out["joints2d"], out["joints3d"], out["conf"], out["valid"])

    return pipeline


def a2j_boxes(dets: torch.Tensor, max_crops: int, w_out: float, h_out: float) -> torch.Tensor:
    """The first `max_crops` (the most confident) detection rows of
    (B, M, >=4) -> (B * max_crops, 4) [xmin, ymin, xmax, ymax] boxes in
    (w_out, h_out) pixels."""
    d = dets[:, :max_crops]
    cx, cy = d[..., 0] * w_out, d[..., 1] * h_out
    bw, bh = d[..., 2] * w_out, d[..., 3] * h_out
    boxes = torch.stack([cx - bw * 0.5, cy - bh * 0.5, cx + bw * 0.5, cy + bh * 0.5], dim=-1)
    return boxes.reshape(-1, 4)


def a2j_uncrop(kp: torch.Tensor, boxes: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Keypoints (N, K, 3) as (y, x, z) in the CROP x CROP crops of `boxes`
    (N, 4) -> image-space (x, y, z), each (N, K)."""
    bx0, by0 = boxes[:, 0:1], boxes[:, 1:2]
    jx = div_const(kp[..., 1], CROP) * (boxes[:, 2:3] - bx0) + bx0
    jy = div_const(kp[..., 0], CROP) * (boxes[:, 3:4] - by0) + by0
    return jx, jy, kp[..., 2]


def build_yolo_a2j_pipeline(yolo_weights: dict[str, np.ndarray],
                            a2j_weights: dict[str, np.ndarray] | None = None,
                            dtype: torch.dtype = torch.bfloat16,
                            device: str | torch.device = "cuda", pack: str = "f32",
                            max_crops: int = 4, seed: int = 0, quant: str | None = None,
                            fold_bn: bool = False):
    """Two-stage Yolo->A2J serving fn: (B, H, W) raw depth -> (B, L) packed
    buffer with `max_crops` rows a frame: (joints2d, joints3d, conf, valid),
    or the q16 wire; `unpack_outputs(buf, max_crops, K)` reads it.

    The Yolo-Pose+ detector and its decode, the `max_crops` most confident
    boxes a frame, one nearest-neighbour gather of (B * max_crops, 288, 288)
    normalized crops, A2J and its anchor vote, then the keypoints uncropped
    to image pixels and back-projected. Empty slots ride along masked
    (valid 0, conf 0).

    yolo_weights / a2j_weights: Flax variables as {'/'-joined path: array}.
    Without `a2j_weights`, A2J is initialised from a `torch.Generator`
    seeded with `seed` (`A2J.init_seeded`); those values differ from the
    JAX builder's Flax init at PRNGKey(0). Both CNNs run in `dtype` with
    float32 BatchNorm; crops, decode and vote run in float32. fold_bn and
    quant apply to both stages (see `build_openpose_pipeline`)."""
    from popnet_tpu_torch.decode.a2j import a2j_post_process
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import A2J, YoloPoseNet
    from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors

    device = _check_build_args(device, pack)
    yolo = deploy_model(load_into(YoloPoseNet(), yolo_weights), device, dtype, fold_bn, quant)
    a2j = A2J().init_seeded(seed) if a2j_weights is None else load_into(A2J(), a2j_weights)
    a2j = deploy_model(a2j, device, dtype, fold_bn, quant)
    all_anchors = torch.as_tensor(shift_anchors((CROP // 16, CROP // 16), 16, generate_anchors()),
                                  dtype=torch.float32, device=device)
    C = max_crops

    @torch.inference_mode()
    def pipeline(raw_depth) -> torch.Tensor:
        raw_depth = torch.as_tensor(raw_depth, device=device)
        B, H, W = raw_depth.shape
        x = preproc_depth(raw_depth)
        prior = yolo(x.permute(0, 3, 1, 2).to(dtype)).float().permute(0, 2, 3, 1)
        det = yolo_decode(prior, W, H)
        valid = det["valid"][:, :C]
        boxes = a2j_boxes(det["dets"], C, W, H)                           # (B*C, 4)
        image_idx = torch.arange(B, device=device).repeat_interleave(C)
        crops = crop_resize_batch(raw_depth.float(), image_idx, boxes, KDH3D_DEPTH.mean,
                                  KDH3D_DEPTH.std)
        heads = a2j(crops[:, None].to(dtype))
        kp = a2j_post_process(tuple(h.float() for h in heads), all_anchors)  # (B*C, K, 3)
        jx, jy, jz = (t.reshape(B, C, -1) for t in a2j_uncrop(kp, boxes))
        joints2d = torch.stack([jx, jy], dim=-1)
        conf = valid[..., None].float().expand_as(jz)
        if pack == "q16":
            return pack_outputs_q16(joints2d, jz, conf, valid)
        return pack_outputs(joints2d, back_project(jx, jy, jz, KDH3D_INTRINSICS), conf, valid)

    return pipeline


def unpack_outputs_2d(buf: np.ndarray, max_people: int, num_joints: int):
    """Host inverse of the RGB pipeline's (joints2d, conf, counts) f32 pack
    layout. Returns numpy views."""
    buf = np.asarray(buf)
    B = buf.shape[0]
    s1, s2 = max_people * num_joints * 2, max_people * num_joints
    return {
        "joints2d": buf[:, :s1].reshape(B, max_people, num_joints, 2),
        "conf": buf[:, s1:s1 + s2].reshape(B, max_people, num_joints),
        "counts": buf[:, s1 + s2:],
    }


_RGB_MODES = ("rtpose", "vgg", "inception")   # the normalizations of the RGB pipeline


def preproc_rgb(frames: torch.Tensor, input_size: int = 368,
                preprocess: str = "rtpose") -> torch.Tensor:
    """(B, H, W, 3) BGR frames -> (B, 3, input_size, input_size) float32:
    the square cv2-bilinear resize of every channel, then the `preprocess`
    normalization (`rtpose`, `vgg` or `inception`), as the JAX RGB
    pipeline does before its CNN."""
    from popnet_tpu_torch.data.preprocessing import PREPROCESSORS

    if preprocess not in _RGB_MODES:
        raise ValueError(f"unsupported preprocess mode {preprocess!r}")
    x = resize_bilinear_cv2(frames.float().permute(0, 3, 1, 2), input_size, input_size)
    return PREPROCESSORS[preprocess](x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def build_rtpose_vgg_pipeline(weights: dict[str, np.ndarray] | None = None,
                              dtype: torch.dtype = torch.bfloat16,
                              device: str | torch.device = "cuda", trunk: str = "vgg19",
                              input_size: int = 368, preprocess: str = "rtpose",
                              pack: str = "f32", quant: str | None = None,
                              fold_bn: bool = False):
    """COCO RGB serving fn: (B, H, W, 3) BGR frames -> (B, L) f32 buffer of
    (joints2d, conf, counts); `unpack_outputs_2d(buf, 16, 18)` reads it.

    A square cv2-bilinear resize to `input_size` and the `preprocess`
    normalization (`preproc_rgb`), RTPoseVGG (its `trunk`: "vgg19" or
    "mobilenet") in `dtype`, then the 2D PAF decode with the COCO-18 tables
    (`paf_decode_2d`: K1, K3, K6 on the card) in float32, joints scaled to
    the source frame's pixels.

    weights: RTPoseVGG's Flax variables as {'/'-joined path: array}
    (`interop.load_npz`). Without them the CNN is initialised from a
    `torch.Generator` seeded with 0 (`RTPoseVGG.init_seeded`); no COCO
    weights are committed. The RGB path has no depth channel, so only the
    f32 wire is defined. fold_bn and quant: see `build_openpose_pipeline`
    (the VGG19 trunk has no BatchNorm to fold)."""
    from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS
    from popnet_tpu_torch.decode.openpose_infer import paf_decode_2d
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseVGG

    if pack != "f32":
        raise ValueError("the RGB pipeline has no depth channel; only the f32 wire is defined")
    if preprocess not in _RGB_MODES:
        raise ValueError(f"unsupported preprocess mode {preprocess!r}")
    device = _check_build_args(device, pack)
    model = RTPoseVGG(trunk=trunk)
    model = model.init_seeded(0) if weights is None else load_into(model, weights)
    model = deploy_model(model, device, dtype, fold_bn, quant)

    @torch.inference_mode()
    def pipeline(frames) -> torch.Tensor:
        frames = torch.as_tensor(frames, device=device)
        B, H, W, _ = frames.shape
        x = preproc_rgb(frames, input_size, preprocess)
        (paf, heat), _ = model(x.to(dtype))
        nhwc = lambda t: t.permute(0, 2, 3, 1)                            # views, no copy
        out = paf_decode_2d(nhwc(heat), nhwc(paf), COCO_NUM_JOINTS, _DCFG, COCO_LIMBS,
                            sx=W / input_size, sy=H / input_size)
        return pack_outputs(out["joints2d"], out["conf"], out["counts"])

    return pipeline


def serve_stream(pipeline, batches, queue_depth: int = 3):
    """Run `pipeline` over an iterable of raw-depth batches with up to
    `queue_depth` batches in flight; yields each batch's packed buffer as a
    host numpy array, in order. The copy to the host is the sync point."""
    q: deque = deque()
    for b in batches:
        q.append(pipeline(b))
        if len(q) > queue_depth:
            yield q.popleft().cpu().numpy()
    while q:
        yield q.popleft().cpu().numpy()
