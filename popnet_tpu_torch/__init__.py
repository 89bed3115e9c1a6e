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
Every builder also takes `fold_bn=True` (BatchNorm folded into the convs,
`ops/fold_bn.py`) and `quant="int8"` (dynamic int8 convs, `ops/quant.py`),
as the JAX builders do.
`python -m popnet_tpu_torch.cli.main evaluate` runs the MP-3DHP evaluation
drivers of the four depth families (`cli/`), and `benchmark` scores their
prediction JSON. `train` trains Open-Pose+, PoP-Net and Yolo-Pose+ on a
KDH3D-format dataset (`ops/encoders.py`, `data/datasets.py`, `losses/`,
`train/`), and A2J on person crops of it (`data/augment_host.py`,
`data/a2j_crops.py`), writing checkpoints that `evaluate --ckpt` reads.
COCO results are scored by `data.preprocessing.rgb_infer` ->
`decode.openpose_infer.paf_decode_2d` -> `data.coco.coco_eval_results` ->
`data.coco.run_coco_eval`, and `generate-augset` freezes MP-3DHP test
sets (`data/construction.py`). `visualize-gt` and `visualize-pred` draw the
GT or predicted skeletons over the depth and write cv2.imwrite's JPEG
bytes (`viz/`: cv2's rasterizer in `viz/raster.py` and `csrc/draw_u8.cpp`,
the writer `data.image_io.imwrite_jpeg` in `csrc/jpeg_encode.cpp`).
`interop/torch_import.py` loads the reference's PyTorch `.pth` checkpoints
into the models (`import_rtpose_light3d`, `import_yolo_posenet`,
`import_a2j`, `use_vgg`) and exports them back (`export_state_dict`).

Layout:
    core/      constants, camera geometry, configuration, device choice
    csrc/      the CUDA kernels (*.cu) and the host C++ sources (*.cpp: the
               JPEG reader and writer, the uint8 transforms, the rasterizer)
    ops/       the kernels' wrappers and builds, GT encoders, resize, fold, int8
    data/      datasets, augmentation, compositing, JPEG files, COCO, MPII
    models/    the CNNs
    losses/    training losses
    decode/    post-processing (maps -> people), on the card and the host
    eval/      PCK, mAP and COCO OKS metrics
    train/     training steps and loop, checkpoints, schedules
    parallel/  layouts over torch.distributed
    interop/   Flax variables (from_jax) and reference .pth checkpoints
               (torch_import)
    viz/       the GT and prediction viewers and cv2's rasterizer
    cli/       command-line entry points and the tables
    tools/     measurement helpers
    serving.py the serving pipelines
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
