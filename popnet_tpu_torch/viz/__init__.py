"""Visualization: cv2's rasterizer (`raster`) and the GT and prediction
viewers (`draw`)."""

from popnet_tpu_torch.viz.draw import (  # noqa: F401
    depth_to_gray,
    draw_humans,
    draw_humans_visibility,
    overlay_seg,
    visualize_gt,
    visualize_pred,
)
