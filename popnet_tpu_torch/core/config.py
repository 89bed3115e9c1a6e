"""Frozen configuration dataclasses, with the JAX package's defaults."""

from __future__ import annotations

import dataclasses

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
    """Network input size and joint count (the fields of the JAX
    EncoderConfig that this slice reads, same defaults)."""

    input_x: int = 224          # network input width
    input_y: int = 224          # network input height
    num_joints: int = NUM_JOINTS


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Open-Pose+ post-processing thresholds (the JAX defaults)."""

    downsample: int = 8             # heatmap->image upsample factor
    thresh_heatmap: float = 0.1     # peak detection threshold
    thresh_paf: float = 0.05        # PAF sample score threshold
    num_intermed_pts: int = 10      # PAF line-integral samples
    win_size: int = 2               # subpixel refinement patch half-size
    max_peaks: int = 16             # static cap on peaks per joint type
    max_people: int = 16            # static cap on decoded people
    min_parts: int = 3              # drop people with fewer joints
    min_score: float = 0.2          # drop people with lower mean score
