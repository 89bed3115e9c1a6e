"""Open-Pose+ and PoP-Net serving: raw depth frames -> packed 3D human
tensors.

`build_openpose_pipeline` and `build_popnet_pipeline` return a callable
that takes a (B, H, W) batch of raw depth in metres and returns ONE packed
buffer per batch on the device (f32, or the uint16 fixed-point wire
format), so a batch leaves the card in one copy. `serve_stream` keeps a few
batches in flight; the copy to the host is its synchronization point.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, CameraIntrinsics
from popnet_tpu_torch.core.config import KDH3D_DEPTH, DepthStats
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


def _check_build_args(device, pack: str) -> torch.device:
    if pack not in ("f32", "q16"):
        raise ValueError(f"unknown pack {pack!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def build_openpose_pipeline(weights: dict[str, np.ndarray],
                            dtype: torch.dtype = torch.bfloat16,
                            device: str | torch.device = "cuda",
                            stage: str = "full", pack: str = "f32"):
    """Open-Pose+ serving fn: (B, H, W) raw depth -> (B, L) packed buffer.

    weights: the model's Flax variables as {'/'-joined path: array}
    (`interop.load_npz`). The CNN runs in `dtype` with float32 BatchNorm;
    the decode runs in float32. stage="cnn" stops after the CNN and packs
    per-image reductions (to attribute time between CNN and decode).
    pack="q16" emits the uint16 wire buffer instead of f32. Geometry,
    thresholds, depth statistics and camera are the KDH3D defaults."""
    from popnet_tpu_torch.decode.openpose_infer import openpose_decode
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32

    if stage not in ("full", "cnn"):
        raise ValueError(f"unknown stage {stage!r}")
    device = _check_build_args(device, pack)
    model = load_into(RTPoseLight3D(), weights).eval().to(device=device, dtype=dtype)
    keep_batchnorm_float32(model)

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
                          readout: str = "universe", pack: str = "f32"):
    """PoP-Net serving fn: (B, H, W) raw depth -> (B, L) packed buffer of
    (joints2d, joints3d, conf, valid), or the q16 wire of (joints2d, z,
    conf, valid); `unpack_outputs` / `unpack_outputs_q16` read both.

    weights: the model's Flax variables as {'/'-joined path: array}
    (`interop.load_npz`). The CNN runs in `dtype` with float32 BatchNorm;
    the decode runs in float32. readout: see `popnet_decode`."""
    from popnet_tpu_torch.decode.popnet_infer import popnet_decode
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import PopNet
    from popnet_tpu_torch.models.layers import keep_batchnorm_float32

    if readout not in ("universe", "gated"):
        raise ValueError(f"unknown readout {readout!r}")
    device = _check_build_args(device, pack)
    model = load_into(PopNet(), weights).eval().to(device=device, dtype=dtype)
    keep_batchnorm_float32(model)

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
