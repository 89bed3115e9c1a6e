"""The port's CUDA kernels against their plain PyTorch versions, and the
slice on the card against the slice on the CPU. Every test needs an NVIDIA
card (marker `cuda`) and skips without one. This file imports nothing of
the JAX package, so it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from popnet_tpu_torch import build_openpose_pipeline, load_npz
from popnet_tpu_torch.core.skeleton import LIMBS
from popnet_tpu_torch.ops import kernels
from popnet_tpu_torch.serving import unpack_outputs, unpack_outputs_q16

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "results", "bench_weights_openpose.npz")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def peak_heat(seed, B, K=16):
    """Uniform heat with an exact tie, border peaks and a plane without a
    peak above the threshold."""
    heat = np.random.default_rng(seed).uniform(0, 1, (B, K, 28, 28)).astype(np.float32)
    heat[0, 0, 5, 5] = heat[0, 0, 5, 9] = 0.9
    heat[0, 1, 0, 3] = heat[0, 2, 27, 27] = heat[B - 1, 3, 5, 0] = 5.0
    heat[B - 1, 4] *= 0.09
    return heat


def test_find_peaks_kernel_matches_plain(cuda):
    h = torch.as_tensor(peak_heat(1, 5), device=cuda)[:, :15]   # strided, as in the pipeline
    kernels.reset_launches()
    got = kernels.find_peaks(h)
    torch.cuda.synchronize()
    assert kernels.find_peaks.launches == 1
    for a, b in zip(got, kernels.find_peaks_plain(h)):
        assert torch.equal(a, b)


def test_paf_score_kernel_matches_plain(cuda):
    from popnet_tpu_torch.decode.device import find_peaks_batched

    rng = np.random.default_rng(7)
    heat = torch.as_tensor(peak_heat(2, 3), device=cuda).permute(0, 2, 3, 1)
    paf = torch.as_tensor(rng.uniform(-1, 1, (3, 28, 28, 28)).astype(np.float32),
                          device=cuda).permute(0, 2, 3, 1)
    peaks, valid = find_peaks_batched(heat)
    s, ok = kernels.paf_score(paf, peaks, valid, LIMBS)
    s_p, ok_p = kernels.paf_score_plain(paf, peaks, valid, LIMBS)
    assert torch.equal(ok, ok_p) and ok.any()
    assert float((s - s_p).abs().max()) <= 1e-5


def test_readout_kernels_match_plain(cuda):
    rng = np.random.default_rng(3)
    z = torch.as_tensor(rng.uniform(0.5, 6, (2, 15, 28, 28)).astype(np.float32),
                        device=cuda).permute(0, 2, 3, 1)
    h = torch.as_tensor(rng.uniform(-0.2, 1, (2, 15, 28, 28)).astype(np.float32),
                        device=cuda).permute(0, 2, 3, 1)
    cx = torch.as_tensor(rng.integers(-3, 31, (2, 6, 15)), dtype=torch.int32, device=cuda)
    cy = torch.as_tensor(rng.integers(-3, 31, (2, 6, 15)), dtype=torch.int32, device=cuda)
    err = (kernels.window_readout(z, h, cx, cy) - kernels.window_readout_plain(z, h, cx, cy))
    assert float(err.abs().max()) <= 1e-5
    img = torch.as_tensor(rng.uniform(0.5, 6, (2, 64, 48)).astype(np.float32), device=cuda)
    px = torch.as_tensor(rng.integers(-2, 50, (2, 17)), dtype=torch.int32, device=cuda)
    py = torch.as_tensor(rng.integers(-2, 66, (2, 17)), dtype=torch.int32, device=cuda)
    assert torch.equal(kernels.point_readout(img, px, py), kernels.point_readout_plain(img, px, py))


def test_slice_on_the_card_matches_the_cpu(cuda):
    """float32 pipeline on the card (cuDNN without TF32, the four kernels)
    against the same pipeline on the CPU (plain versions)."""
    rng = np.random.default_rng(0)
    frames = np.zeros((4, 512, 480), np.float32)
    for b in range(4):
        for cx in (120, 250, 380)[: 2 + b % 2]:
            for _ in range(15):
                x, y = rng.integers(cx - 60, cx + 60), rng.integers(120, 420)
                frames[b, y - 18:y + 18, x - 18:x + 18] = rng.uniform(2.5, 4.0)
    weights = load_npz(WEIGHTS)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kernels.reset_launches()
        gpu = build_openpose_pipeline(weights, dtype=torch.float32)(frames)
        torch.cuda.synchronize()
        assert all(n == 1 for n in kernels.launch_counts().values()), kernels.launch_counts()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = build_openpose_pipeline(weights, dtype=torch.float32, device="cpu")(frames)
    a, b = unpack_outputs(gpu.cpu().numpy(), 16, 15), unpack_outputs(cpu.numpy(), 16, 15)
    np.testing.assert_array_equal(a["counts"], b["counts"])
    np.testing.assert_array_equal(a["joints2d"][..., 0] >= 0, b["joints2d"][..., 0] >= 0)
    np.testing.assert_allclose(a["joints2d"], b["joints2d"], atol=2.3)
    np.testing.assert_allclose(a["joints3d"][..., 2], b["joints3d"][..., 2], atol=1e-3)


def test_q16_pipeline_on_the_card(cuda):
    weights = load_npz(WEIGHTS)
    frames = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 6.0, (8, 512, 480)),
                             dtype=torch.float32, device=cuda)
    buf = build_openpose_pipeline(weights, pack="q16")(frames)
    assert buf.dtype == torch.uint16 and buf.device.type == "cuda"
    out = unpack_outputs_q16(buf.cpu().numpy(), 16, 15)
    assert out["joints2d"].shape == (8, 16, 15, 2) and np.isfinite(out["joints3d"]).all()
