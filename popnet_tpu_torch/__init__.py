"""popnet_tpu_torch: the PyTorch/CUDA port of popnet_tpu.

Open-Pose+, PoP-Net, Yolo-Pose+ and Yolo->A2J depth serving and COCO RGB
serving on an NVIDIA Hopper card: the CNNs (RTPoseLight3D, PopNet,
YoloPoseNet, A2J, RTPoseVGG) through cuDNN, and the Open-Pose+, PoP-Net and
COCO decodes through hand-written CUDA kernels (`ops/kernels.py`, sources
in `csrc/`). The JAX package `popnet_tpu` is the reference the port is held
against; this package imports nothing of it.

    from popnet_tpu_torch import build_openpose_pipeline, load_npz, serve_stream
    pipe = build_openpose_pipeline(load_npz("examples/results/bench_weights_openpose.npz"))
    for buf in serve_stream(pipe, batches):   # batches of (B, 512, 480) depth, metres
        ...

`build_popnet_pipeline(load_npz(".../bench_weights_popnet.npz"))` serves
PoP-Net the same way, `build_yolo_pipeline(load_npz(".../bench_weights_yolo.npz"))`
Yolo-Pose+, and `build_yolo_a2j_pipeline(<the same>, a2j_weights)` the
detector followed by A2J on its `max_crops` best boxes a frame.
`build_rtpose_vgg_pipeline()` serves (B, H, W, 3) BGR frames with COCO's 18
joints in 2D (RTPoseVGG from a seeded init: no COCO weights are committed).
`python -m popnet_tpu_torch.cli.main evaluate` runs the MP-3DHP evaluation
drivers of the four depth families (`cli/`), and `benchmark` scores their
prediction JSON.
"""

from popnet_tpu_torch.interop.from_jax import load_npz, state_dict_from_jax
from popnet_tpu_torch.serving import (
    build_openpose_pipeline,
    build_popnet_pipeline,
    build_rtpose_vgg_pipeline,
    build_yolo_a2j_pipeline,
    build_yolo_pipeline,
    serve_stream,
)

__all__ = ["build_openpose_pipeline", "build_popnet_pipeline", "build_rtpose_vgg_pipeline",
           "build_yolo_a2j_pipeline", "build_yolo_pipeline", "load_npz", "serve_stream",
           "state_dict_from_jax"]
