"""Frozen configuration dataclasses, with the JAX package's defaults."""

from __future__ import annotations

import dataclasses

from popnet_tpu_torch.core.camera import ITOP_INTRINSICS, KDH3D_INTRINSICS, CameraIntrinsics
from popnet_tpu_torch.core.skeleton import NUM_JOINTS, NUM_LIMBS


@dataclasses.dataclass(frozen=True)
class DepthStats:
    """Depth normalization statistics: clip to `max`, then (x - mean) / std."""

    mean: float = 3.0
    std: float = 2.0
    max: float = 6.0


KDH3D_DEPTH = DepthStats(mean=3.0, std=2.0, max=6.0)
# ITOP clips at 5 m
ITOP_DEPTH = DepthStats(mean=3.0, std=2.0, max=5.0)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Network input size, grid strides, target widths, anchors and the cap
    on people a frame (the JAX EncoderConfig's fields, same defaults)."""

    input_x: int = 224          # network input width
    input_y: int = 224          # network input height
    stride: int = 8             # heatmap/PAF grid stride
    stride_z: int = 8           # z-map grid stride
    stride_align: int = 8       # align-map grid stride
    stride_prior: int = 16      # prior (anchor) grid stride
    sigma: float = 7.0          # heatmap Gaussian sigma (input pixels)
    paf_width: float = 1.0      # PAF limb half-width (grid cells)
    z_radius: int = 2           # z-map box radius (grid cells)
    align_radius: int = 2       # align-map box radius (grid cells)
    num_joints: int = NUM_JOINTS
    num_limbs: int = NUM_LIMBS
    anchors: tuple[tuple[float, float], ...] = ((6.0, 3.0), (12.0, 6.0))
    max_people: int = 8         # static cap on people per image

    @property
    def grid_w(self) -> int:
        return self.input_x // self.stride

    @property
    def grid_h(self) -> int:
        return self.input_y // self.stride

    @property
    def zgrid_w(self) -> int:
        return self.input_x // self.stride_z

    @property
    def zgrid_h(self) -> int:
        return self.input_y // self.stride_z

    @property
    def agrid_w(self) -> int:
        return self.input_x // self.stride_align

    @property
    def agrid_h(self) -> int:
        return self.input_y // self.stride_align

    @property
    def prior_w(self) -> int:
        return self.input_x // self.stride_prior

    @property
    def prior_h(self) -> int:
        return self.input_y // self.stride_prior

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Post-processing thresholds (the JAX defaults)."""

    downsample: int = 8             # heatmap->image upsample factor
    thresh_heatmap: float = 0.1     # peak detection threshold
    thresh_paf: float = 0.05        # PAF sample score threshold
    num_intermed_pts: int = 10      # PAF line-integral samples
    win_size: int = 2               # subpixel refinement patch half-size
    max_peaks: int = 16             # static cap on peaks per joint type
    max_people: int = 16            # static cap on decoded people
    min_parts: int = 3              # drop people with fewer joints
    min_score: float = 0.2          # drop people with lower mean score
    conf_threshold: float = 0.5     # prior (anchor) decode: confidence
    nms_threshold: float = 0.5      # prior (anchor) decode: IoU of the NMS


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """A depth dataset's frame size, camera and depth statistics (the JAX
    DatasetConfig's, same defaults: the MP-3DHP Kinect frames; ITOP_DATASET
    for ITOP's 320x240 frames)."""

    width: int = 480
    height: int = 512
    intrinsics: CameraIntrinsics = KDH3D_INTRINSICS
    depth: DepthStats = KDH3D_DEPTH


KDH3D_DATASET = DatasetConfig()
ITOP_DATASET = DatasetConfig(width=320, height=240, intrinsics=ITOP_INTRINSICS, depth=ITOP_DEPTH)
