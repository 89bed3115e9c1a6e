"""Frozen configuration dataclasses, with the JAX package's defaults."""

from __future__ import annotations

import dataclasses

from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, CameraIntrinsics
from popnet_tpu_torch.core.skeleton import NUM_JOINTS


@dataclasses.dataclass(frozen=True)
class DepthStats:
    """Depth normalization statistics: clip to `max`, then (x - mean) / std."""

    mean: float = 3.0
    std: float = 2.0
    max: float = 6.0


KDH3D_DEPTH = DepthStats(mean=3.0, std=2.0, max=6.0)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Network input size, grid strides, anchors and joint count (the
    fields of the JAX EncoderConfig that the serving paths read, same
    defaults)."""

    input_x: int = 224          # network input width
    input_y: int = 224          # network input height
    stride_align: int = 8       # align-map grid stride
    stride_prior: int = 16      # prior (anchor) grid stride
    align_radius: int = 2       # align-map box radius (grid cells)
    num_joints: int = NUM_JOINTS
    anchors: tuple[tuple[float, float], ...] = ((6.0, 3.0), (12.0, 6.0))

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
    DatasetConfig's, same defaults: the MP-3DHP Kinect frames)."""

    width: int = 480
    height: int = 512
    intrinsics: CameraIntrinsics = KDH3D_INTRINSICS
    depth: DepthStats = KDH3D_DEPTH


KDH3D_DATASET = DatasetConfig()
