"""The port's CUDA kernels against their plain PyTorch versions, and the
slice on the card against the slice on the CPU. Every test needs an NVIDIA
card (marker `cuda`) and skips without one. This file imports nothing of
the JAX package, so it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

from popnet_tpu_torch import (
    build_openpose_pipeline,
    build_popnet_pipeline,
    build_rtpose_vgg_pipeline,
    build_yolo_a2j_pipeline,
    build_yolo_pipeline,
    load_npz,
)
from popnet_tpu_torch.core.camera import KDH3D_INTRINSICS, back_project
from popnet_tpu_torch.core.skeleton import LIMBS
from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS
from popnet_tpu_torch.data.a2j_crops import crop_resize_batch
from popnet_tpu_torch.decode.a2j import a2j_post_process
from popnet_tpu_torch.decode.assemble_device import assemble_inputs
from popnet_tpu_torch.decode.device import find_peaks_batched, peak_planes
from popnet_tpu_torch.decode.openpose_infer import openpose_decode, paf_decode_2d
from popnet_tpu_torch.decode.popnet_infer import popnet_decode
from popnet_tpu_torch.interop.from_jax import load_into
from popnet_tpu_torch.models import PopNet, RTPoseLight3D, YoloPoseNet
from popnet_tpu_torch.models.a2j import generate_anchors, shift_anchors
from popnet_tpu_torch.ops import kernels
from popnet_tpu_torch.serving import (
    a2j_boxes,
    a2j_uncrop,
    preproc_depth,
    unpack_outputs,
    unpack_outputs_2d,
    unpack_outputs_q16,
    yolo_decode,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "results", "bench_weights_openpose.npz")
WEIGHTS_POPNET = os.path.join(ROOT, "examples", "results", "bench_weights_popnet.npz")
WEIGHTS_YOLO = os.path.join(ROOT, "examples", "results", "bench_weights_yolo.npz")

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


def sparse_heat(seed, B, H=28, W=28, K=16):
    """Heat in the serving path's regime: noise below the threshold and up
    to four bumps a plane, anywhere (borders included); many planes have
    none."""
    rng = np.random.default_rng(seed)
    heat = rng.uniform(0, 0.08, (B, K, H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    for p in (0.45, 0.3, 0.2, 0.1):
        amp = np.where(rng.uniform(size=(B, K)) < p, rng.uniform(0.3, 1.0, (B, K)), 0.0)
        cy, cx = rng.integers(0, H, (B, K)), rng.integers(0, W, (B, K))
        d2 = (ys - cy[..., None, None]) ** 2 + (xs - cx[..., None, None]) ** 2
        heat = np.maximum(heat, (amp[..., None, None] * np.exp(-d2 / 2.0)).astype(np.float32))
    return heat


def test_find_peaks_kernel_matches_plain(cuda):
    h = torch.as_tensor(peak_heat(1, 5), device=cuda)[:, :15]   # strided, as in the pipeline
    kernels.reset_launches()
    got = kernels.find_peaks(h)
    torch.cuda.synchronize()
    assert kernels.find_peaks.launches == 1
    for a, b in zip(got, kernels.find_peaks_plain(h)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grid,max_peaks", [((28, 28), 16), ((12, 10), 32), ((9, 40), 5)])
def test_find_peaks_row_kernel_matches_plain_and_find_peaks(cuda, grid, max_peaks):
    """The per-frame kernel: exact against the plain version and bit-equal
    to the per-plane kernel, on other grids and peak counts too."""
    H, W = grid
    heat = np.random.default_rng(5).uniform(0, 1, (4, 16, H, W)).astype(np.float32)
    heat[0, 0, 3, 3] = heat[0, 0, 3, 7] = 0.95                 # exact tie
    heat[0, 1, 0, 2] = heat[1, 2, H - 1, W - 1] = heat[3, 3, 4, 0] = 5.0
    heat[2, 4] *= 0.09                                         # no peak over the threshold
    heat[2, 5] = np.round(heat[2, 5] * 4) / 4                  # plateaus: many equal survivors
    h = torch.as_tensor(heat, device=cuda)[:, :15]
    kernels.reset_launches()
    row = kernels.find_peaks_row(h, max_peaks=max_peaks)
    torch.cuda.synchronize()
    assert kernels.find_peaks_row.launches == 1 and kernels.find_peaks.launches == 0
    for a, b, c in zip(row, kernels.find_peaks_plain(h, max_peaks=max_peaks),
                       kernels.find_peaks(h, max_peaks=max_peaks)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not row[4][2, 4].any() and row[4][0, 0].sum() > 1


@pytest.mark.parametrize("memory", ["channels_last", "nchw"])
@pytest.mark.parametrize("grid,max_peaks", [((28, 28), 16), ((12, 10), 32), ((9, 40), 5)])
def test_find_peaks_kernels_on_sparse_heat(cuda, memory, grid, max_peaks):
    """A few peaks on some planes and none on the others, the regime of the
    serving path (most slots empty, one corner refine a plane): both
    kernels bit-equal to the plain version, in channels-last memory (the
    CNN's) and in NCHW memory, one launch each."""
    heat = torch.as_tensor(sparse_heat(3, 6, *grid), device=cuda)
    if memory == "channels_last":
        heat = heat.contiguous(memory_format=torch.channels_last)
    h = heat[:, :15]
    kernels.reset_launches()
    got = kernels.find_peaks(h, max_peaks=max_peaks)
    row = kernels.find_peaks_row(h, max_peaks=max_peaks)
    torch.cuda.synchronize()
    assert kernels.find_peaks.launches == 1 and kernels.find_peaks_row.launches == 1
    for a, b, c in zip(got, kernels.find_peaks_plain(h, max_peaks=max_peaks), row):
        assert torch.equal(a, b) and torch.equal(c, b)
    valid = got[4]
    assert valid.any() and (~valid.any(-1)).any()       # planes with peaks and without


def test_find_peaks_kernels_refuse_what_they_do_not_build(cuda):
    """The kernels refine 5x5 windows upsampled 8x and keep at most 32 peaks:
    other settings raise on the card instead of running something else."""
    h = torch.rand((1, 15, 28, 28), device=cuda)
    for fn in (kernels.find_peaks, kernels.find_peaks_row):
        with pytest.raises(ValueError, match="win_size=2"):
            fn(h, win_size=3)
        with pytest.raises(ValueError, match="factor=8"):
            fn(h, factor=4)
        with pytest.raises(ValueError, match="at most 32 peaks"):
            fn(h, max_peaks=33)


def test_peak_local_max_kernel_matches_plain(cuda):
    """Exact, plateaus and borders included, on NCHW memory read as NHWC
    and on channel, row and column slices, and on NHWC memory (which the
    kernel walks channel fastest); with and without the threshold."""
    heat = np.round(np.random.default_rng(0).uniform(0, 1, (3, 16, 28, 28)) * 8) / 8
    heat[0, 0, 4:7, 4:8] = heat[0, 0, 0:2, 25:] = 2.0
    heat[1, 1, 0, 0] = heat[1, 1, 27, 27] = heat[1, 1, 27, 5] = heat[1, 1, 9, 0] = 3.0
    heat[2, 2] = 0.5
    h = torch.as_tensor(heat.astype(np.float32), device=cuda)
    nhwc_memory = h.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    kernels.reset_launches()
    for planes in (h, h[:, :15], h[:, ::2], h[:, 1:, 1:], h[..., 1:25], nhwc_memory,
                   nhwc_memory[:, :15], nhwc_memory[:, 3:4]):
        for thresh in (float("-inf"), 0.5):
            assert torch.equal(kernels.peak_local_max(planes, thresh),
                               kernels.peak_local_max_plain(planes, thresh))
    nhwc = h.permute(0, 2, 3, 1)[..., :15]
    got = kernels.peak_mask(nhwc, 0.5)
    assert got.shape == nhwc.shape
    assert torch.equal(got, kernels.peak_mask(nhwc.cpu(), 0.5).to(cuda))
    assert kernels.peak_local_max.launches == 17
    assert got[0, 4:7, 4:8, 0].all() and got[2, :, :, 2].sum() == 0   # 0.5 is not > 0.5


def dense_candidates(seed, density, B=8, K=15, M=16):
    """Random candidate tensors: dense ok matrices force long merge chains
    and person creation well past max_people."""
    rng = np.random.default_rng(seed)
    L = len(LIMBS)
    n_valid = rng.integers(0, M + 1, size=(B, K))
    valid = np.arange(M)[None, None, :] < n_valid[:, :, None]
    peak_score = np.where(valid, rng.uniform(0.1, 1.0, size=(B, K, M)), 0.0).astype(np.float32)
    scores = rng.uniform(0.01, 2.0, size=(B, L, M, M)).astype(np.float32)
    if M > 9:
        scores[0, 3, 2, 5] = scores[0, 3, 7, 1] = scores[0, 3, 7, 9] = 1.75   # tied pair scores
    ok = rng.uniform(size=(B, L, M, M)) < density
    limbs = np.asarray(LIMBS)
    ok &= valid[:, limbs[:, 0]][:, :, :, None] & valid[:, limbs[:, 1]][:, :, None, :]
    return peak_score, np.where(ok, scores, -np.inf).astype(np.float32)


def tied_candidates(seed, B=8, K=15, M=16):
    """Pair scores quantized to 1/8 (many equal), +0.0 and -0.0 among them,
    half the pairs candidates and all 256 of limb 4."""
    rng = np.random.default_rng(seed)
    L = len(LIMBS)
    peak_score = rng.uniform(0.1, 1.0, (B, K, M)).astype(np.float32)
    scores = (np.round(rng.uniform(-0.25, 1.0, (B, L, M, M)) * 8) / 8).astype(np.float32)
    zero = scores == 0
    scores[zero] = np.where(rng.uniform(size=int(zero.sum())) < 0.5, -0.0, 0.0)
    ok = rng.uniform(size=(B, L, M, M)) < 0.5
    ok[:, 4] = True
    return peak_score, np.where(ok, scores, -np.inf).astype(np.float32)


def many_slot_candidates(seed, B=8, K=15, M=16):
    """Each limb's candidates pair peaks that no limb before it used, so
    every accepted connection opens a slot: 56 a frame."""
    rng = np.random.default_rng(seed)
    L = len(LIMBS)
    peak_score = rng.uniform(0.1, 1.0, (B, K, M)).astype(np.float32)
    scores = rng.uniform(0.01, 2.0, (B, L, M, M)).astype(np.float32)
    ok = np.zeros((B, L, M, M), bool)
    used = np.zeros(K, int)
    for limb, (a, c) in enumerate(LIMBS):
        ok[:, limb, used[a]:used[a] + 4, used[c]:used[c] + 4] = True
        used[a] += 4
        used[c] += 4
    return peak_score, np.where(ok, scores, -np.inf).astype(np.float32)


ASSEMBLY_CASES = {"0.0": lambda: dense_candidates(0, 0.0), "0.08": lambda: dense_candidates(0, 0.08),
                  "0.3": lambda: dense_candidates(1, 0.3), "0.7": lambda: dense_candidates(2, 0.7),
                  "1.0": lambda: dense_candidates(3, 1.0), "ties": lambda: tied_candidates(4),
                  "56 slots": lambda: many_slot_candidates(5)}


@pytest.mark.parametrize("case", list(ASSEMBLY_CASES))
def test_assemble_kernel_matches_plain(cuda, case):
    """ids and counts exact, from no candidate at all to every pair a
    candidate (224 merge steps, slots created far past max_people); on
    scores quantized to 1/8 with +0.0 and -0.0 (ties fall to the lower flat
    index) and a limb of 256 candidates; and with 56 slots a frame, more
    than one warp's 32, kept by min_parts=2 in 40 rows."""
    ps, sm = (torch.as_tensor(a, device=cuda) for a in ASSEMBLY_CASES[case]())
    kernels.reset_launches()
    ids, counts = kernels.assemble_ids(ps, sm, LIMBS)
    torch.cuda.synchronize()
    assert kernels.assemble_ids.launches == 1
    ref_ids, ref_counts = kernels.assemble_ids_plain(ps.cpu(), sm.cpu(), LIMBS)
    assert torch.equal(counts.cpu(), ref_counts) and torch.equal(ids.cpu(), ref_ids)
    assert (counts.sum() > 0) == (case != "0.0" and case != "56 slots")
    for kw in (dict(max_people=3, min_parts=2, min_score=0.5),
               dict(max_people=40, min_parts=2, min_score=0.0)):
        got = kernels.assemble_ids(ps, sm, LIMBS, **kw)
        ref = kernels.assemble_ids_plain(ps.cpu(), sm.cpu(), LIMBS, **kw)
        assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    if case == "56 slots":
        assert (got[1] == 40).all()


@pytest.mark.parametrize("M", [5, 20, 32])
def test_assemble_kernel_at_other_peak_counts(cuda, M):
    """M = 16 has its own build of the kernel; every other M up to 32 takes
    the build for 32, padded, and stays exact; more than 32 peaks raise."""
    for density in (0.3, 1.0):
        ps, sm = (torch.as_tensor(a, device=cuda) for a in dense_candidates(M, density, M=M))
        ids, counts = kernels.assemble_ids(ps, sm, LIMBS)
        ref_ids, ref_counts = kernels.assemble_ids_plain(ps.cpu(), sm.cpu(), LIMBS)
        assert torch.equal(counts.cpu(), ref_counts) and torch.equal(ids.cpu(), ref_ids)
        assert counts.sum() > 0
    with pytest.raises(ValueError, match="at most 32"):
        kernels.assemble_ids(torch.zeros((1, 15, 33), device=cuda),
                             torch.zeros((1, len(LIMBS), 33, 33), device=cuda), LIMBS)


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
    assert torch.equal(s, s_p)


@pytest.mark.parametrize("paf_memory", ["nhwc", "sliced"])
def test_paf_score_kernel_with_shared_coordinates(cuda, paf_memory):
    """Peaks that share coordinates: K1's empty slots, two valid slots at one
    point, x or y of +0.0 against -0.0, a limb's two ends at one point (limb
    0 is torso 8 -> right hip 9); and peaks so far off the map that their
    line's taps fall beyond the pad. The kernel integrates each distinct pair
    once; score and ok stay bit-equal to the plain version, on the contiguous
    NHWC maps of the serving path and on a slice of larger maps."""
    from popnet_tpu_torch.decode.device import find_peaks_batched

    rng = np.random.default_rng(8)
    heat = torch.as_tensor(sparse_heat(4, 4), device=cuda).permute(0, 2, 3, 1)
    peaks, valid = find_peaks_batched(heat)
    peaks[0, 8, 1, :2] = peaks[0, 8, 0, :2]
    peaks[0, 9, 0, :2] = torch.tensor([0.0, 5.0])
    peaks[0, 9, 1, :2] = torch.tensor([-0.0, 5.0])
    peaks[1, 8, 0, :2] = torch.tensor([7.0, 0.0])
    peaks[1, 8, 1, :2] = torch.tensor([7.0, -0.0])
    peaks[1, 9, 0, :2] = peaks[1, 8, 0, :2]
    peaks[2, 8, 0, :2] = torch.tensor([1e8, 3.0])
    peaks[2, 9, 0, :2] = torch.tensor([-1e8, 5.0])
    valid[0:3, 8:10, :2] = True
    big = torch.as_tensor(rng.uniform(-0.2, 1, (4, 31, 30, 33)).astype(np.float32), device=cuda)
    paf = big[:, 2:30, 1:29, 3:31] if paf_memory == "sliced" else big[:, :28, :28, :28].contiguous()
    kernels.reset_launches()
    s, ok = kernels.paf_score(paf, peaks, valid, LIMBS)
    torch.cuda.synchronize()
    assert kernels.paf_score.launches == 1
    s_p, ok_p = kernels.paf_score_plain(paf, peaks, valid, LIMBS)
    assert torch.equal(s, s_p) and torch.equal(ok, ok_p)
    assert torch.signbit(peaks[0, 9, 1, 0]) and not torch.signbit(peaks[0, 9, 0, 0])
    assert (~valid).any() and ok.any()


@pytest.mark.parametrize("memory", ["channels_last", "sliced"])
@pytest.mark.parametrize("radius", [1, 2])
def test_readout_kernels_match_plain(cuda, radius, memory):
    """window_readout bit for bit, centres on the borders and off the map
    included, at the decode's radius 1 (the kernel's unrolled window) and at
    radius 2 (its loop), on channels-last maps and on slices of larger NHWC
    maps; point_readout exact."""
    rng = np.random.default_rng(3)

    def maps(lo, hi):
        if memory == "channels_last":                          # the CNN's memory
            a = rng.uniform(lo, hi, (2, 15, 28, 28)).astype(np.float32)
            return torch.as_tensor(a, device=cuda).permute(0, 2, 3, 1)
        a = rng.uniform(lo, hi, (2, 31, 30, 17)).astype(np.float32)
        return torch.as_tensor(a, device=cuda)[:, 2:30, 1:29, 1:16]

    z, h = maps(0.5, 6), maps(-0.2, 1)
    cx = torch.as_tensor(rng.integers(-3, 31, (2, 6, 15)), dtype=torch.int32, device=cuda)
    cy = torch.as_tensor(rng.integers(-3, 31, (2, 6, 15)), dtype=torch.int32, device=cuda)
    cx[0, 0], cy[0, 0] = 0, 27                                 # windows on the borders
    kernels.reset_launches()
    got = kernels.window_readout(z, h, cx, cy, radius)
    torch.cuda.synchronize()
    assert kernels.window_readout.launches == 1
    assert torch.equal(got, kernels.window_readout_plain(z, h, cx, cy, radius))
    img = torch.as_tensor(rng.uniform(0.5, 6, (2, 64, 48)).astype(np.float32), device=cuda)
    px = torch.as_tensor(rng.integers(-2, 50, (2, 17)), dtype=torch.int32, device=cuda)
    py = torch.as_tensor(rng.integers(-2, 66, (2, 17)), dtype=torch.int32, device=cuda)
    assert torch.equal(kernels.point_readout(img, px, py), kernels.point_readout_plain(img, px, py))


@pytest.mark.parametrize("memory", ["channels_last", "sliced"])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("z_dtype,img_dtype", [("float32", "float32"), ("bfloat16", "float32"),
                                               ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
def test_readouts_kernel_matches_plain(cuda, z_dtype, img_dtype, radius, memory):
    """K4 and K5 in one launch from the normalized maps, bit for bit against
    the plain version (the affines over the whole maps, then the two plain
    readouts): z and image in float32 or bfloat16, radius 1 and 2,
    channels-last and sliced maps, joints off the maps, on the borders and
    at holes, B = 256 and B = 1; one launch a call, counted once for each
    readout."""
    rng = np.random.default_rng(21)
    B = 256
    if memory == "channels_last":
        z = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, 15, 28, 28)).astype(np.float32),
                            device=cuda).permute(0, 2, 3, 1)
    else:
        big = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, 31, 30, 17)).astype(np.float32),
                              device=cuda)
        z = big[:, 2:30, 1:29, 1:16]
    heat = torch.as_tensor(rng.uniform(-0.2, 1, (B, 16, 28, 28)).astype(np.float32),
                           device=cuda).permute(0, 2, 3, 1)[..., :15]
    img = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, 224, 224, 1)).astype(np.float32),
                          device=cuda)[..., 0]
    joints = torch.as_tensor(rng.uniform(-20, 250, (B, 16, 15, 3)).astype(np.float32),
                             device=cuda)
    joints[:, 0, :, :2] = -1.0
    joints[:, 1, :3, 0] = torch.tensor([0.0, 223.0, 223.99])
    z, img = z.to(getattr(torch, z_dtype)), img.to(getattr(torch, img_dtype))
    for b in (B, 1):
        args = (z[:b], heat[:b], joints[:b], img[:b], 2.0, 3.0, 8, radius)
        kernels.reset_launches()
        got = kernels.readouts(*args)
        torch.cuda.synchronize()
        assert kernels.readouts.launches == 1
        counts = kernels.launch_counts()
        assert counts["window_readout"] == counts["point_readout"] == 1
        ref = kernels.readouts_plain(*args)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_point_readout_keeps_negative_zero(cuda):
    """The standalone point readout takes the build without the affine: an
    image of +0.0 and -0.0 reads back with its signs."""
    rng = np.random.default_rng(22)
    img = torch.where(torch.as_tensor(rng.uniform(size=(3, 40, 36)) < 0.5, device=cuda),
                      torch.tensor(-0.0, device=cuda), torch.tensor(0.0, device=cuda))
    px = torch.as_tensor(rng.integers(-2, 38, (3, 300)), dtype=torch.int32, device=cuda)
    py = torch.as_tensor(rng.integers(-2, 42, (3, 300)), dtype=torch.int32, device=cuda)
    got = kernels.point_readout(img, px, py)
    ref = kernels.point_readout_plain(img, px, py)
    assert torch.equal(torch.signbit(got), torch.signbit(ref)) and torch.signbit(got).any()


def k2_heat(seed, K, H, W):
    """(3, K + 1, H + 3, W + 4) heat: uniform with a lattice of at least 12
    peaks in plane 0 of frame 0 and a flat plane below the threshold in
    frame 1; and the same size of sparse heat."""
    rng = np.random.default_rng(seed)
    dense = rng.uniform(0, 1, (3, K + 1, H + 3, W + 4)).astype(np.float32)
    dense[0, 0, 1:H:3, 1:W:3] = 2.0 + rng.uniform(0, 1, dense[0, 0, 1:H:3, 1:W:3].shape)
    dense[1, 0] = 0.05
    sparse = np.zeros_like(dense)
    sparse[:, :, :H, :W] = sparse_heat(seed, 3, H, W, K + 1)
    return dense, sparse


@pytest.mark.parametrize("grid", [(12, 10), (28, 28), (46, 46)])
@pytest.mark.parametrize("K", [1, 5, 15, 16])
def test_find_peaks_row_cluster_matches_plain_and_find_peaks(cuda, K, grid):
    """The per-frame kernel (2 CTAs a frame, planes loaded through
    distributed shared memory) bit-equal to the plain version and to
    find_peaks: K of 1 (one CTA owns nothing), odd and even; dense heat
    with 32 peaks kept, sparse heat and a flat plane; planes of NCHW and
    NHWC memory and slices of larger maps. One launch a call."""
    H, W = grid
    for heat, M in zip(k2_heat(K * 100 + H, K, H, W), (32, 16)):
        t = torch.as_tensor(heat, device=cuda)
        for h in (t[:, :K, :H, :W].contiguous(),
                  t[:, :K, :H, :W].contiguous(memory_format=torch.channels_last),
                  t[:, 1:, 2:H + 2, 3:W + 3]):
            kernels.reset_launches()
            row = kernels.find_peaks_row(h, max_peaks=M)
            torch.cuda.synchronize()
            assert kernels.find_peaks_row.launches == 1
            for a, b, c in zip(row, kernels.find_peaks_plain(h, max_peaks=M),
                               kernels.find_peaks(h, max_peaks=M)):
                assert torch.equal(a, b) and torch.equal(a, c)
        if M == 32:
            assert row[4].any()
    dense = torch.as_tensor(k2_heat(K * 100 + H, K, H, W)[0], device=cuda)[:, :K, :H, :W]
    assert kernels.find_peaks_row(dense, max_peaks=32)[4][0, 0].sum() >= 12


def test_find_peaks_row_on_large_planes(cuda):
    """A single 195x195 plane, which the kernel of the previous design took
    too: the CTA holds it in one round of one plane and stays bit-equal. A
    255x255 plane is too large for K2's shared memory: find_peaks_row
    refuses it by a query of the sizes, and find_peaks takes it by
    find_peaks_plane, bit for bit against the plain version."""
    heat = torch.as_tensor(sparse_heat(9, 2, 195, 195, 1), device=cuda)
    for a, b in zip(kernels.find_peaks_row(heat), kernels.find_peaks_plain(heat)):
        assert torch.equal(a, b)
    big = torch.as_tensor(sparse_heat(10, 1, 255, 255, 1), device=cuda)
    with pytest.raises(ValueError, match="find_peaks_row cannot hold"):
        kernels.find_peaks_row(big)
    assert kernels.find_peaks_route(1, 255, 255, 16) == "find_peaks_plane"
    kernels.reset_launches()
    got = kernels.find_peaks(big)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["find_peaks_plane"] == 1
    for a, b in zip(got, kernels.find_peaks_plain(big)):
        assert torch.equal(a, b)
    assert bool(got[4].any())


def test_slice_on_the_card_matches_the_cpu(cuda):
    """float32 pipeline on the card (cuDNN without TF32, the five kernels
    of its path) against the same pipeline on the CPU (plain versions)."""
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
        on_path = {"find_peaks", "paf_score", "assemble_ids", "window_readout", "point_readout"}
        assert kernels.launch_counts() == {k.__name__: int(k.__name__ in on_path)
                                           for k in kernels.KERNELS}
        assert kernels.readouts.launches == 1      # K4 and K5 in one launch, counted for each
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


def test_popnet_slice_on_the_card_matches_the_cpu(cuda):
    """float32 PoP-Net pipeline on the card (cuDNN without TF32, kernel K7)
    against the same pipeline on the CPU: valid exact, joints and depth of
    the valid rows within 1e-2 px and 1e-3 m."""
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:512, 0:480]
    frames = np.repeat((4.0 + 1.5 * np.sin(xs / 60.0) * np.cos(ys / 80.0))[None], 4, 0)
    frames = frames.astype(np.float32)
    for b in range(4):
        for cx in (120, 250, 380)[: 2 + b % 2]:
            z = rng.uniform(2.5, 4.0)
            for dx, dy in ((0, -96), (0, -62), (-30, -56), (30, -56), (-32, -14), (32, -14),
                           (-34, 26), (34, 26), (0, 0), (-20, 46), (20, 46), (-22, 96),
                           (22, 96), (-22, 144), (22, 144)):
                x, y = cx + dx, 250 + dy
                frames[b, y - 18:y + 18, x - 18:x + 18] = z
    weights = load_npz(WEIGHTS_POPNET)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kernels.reset_launches()
        gpu = build_popnet_pipeline(weights, dtype=torch.float32)(frames)
        torch.cuda.synchronize()
        assert kernels.peak_local_max.launches == 1
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = build_popnet_pipeline(weights, dtype=torch.float32, device="cpu")(frames)
    a, b = unpack_outputs(gpu.cpu().numpy(), 16, 15), unpack_outputs(cpu.numpy(), 16, 15)
    np.testing.assert_array_equal(a["counts"], b["counts"])
    ok = a["counts"] > 0
    assert ok.any(axis=1).all()
    np.testing.assert_allclose(a["joints2d"][ok], b["joints2d"][ok], atol=1e-2)
    np.testing.assert_allclose(a["joints3d"][ok][..., 2], b["joints3d"][ok][..., 2], atol=1e-3)


def figure_frames(seed, B, background=True):
    """(B, 512, 480) frames of 2 or 3 standing figures of 15 depth blocks,
    over the smooth 2.5-5.5 m background the PoP-Net and Yolo weights were
    trained on (a phase per frame), or over zeros."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:512, 0:480]
    frames = np.zeros((B, 512, 480), np.float32)
    for b in range(B):
        if background:
            frames[b] = 4.0 + 1.5 * np.sin(xs / 60.0 + 0.7 * b) * np.cos(ys / 80.0)
        for cx in (120, 250, 380)[: 2 + b % 2]:
            z = rng.uniform(2.5, 4.0)
            for dx, dy in ((0, -96), (0, -62), (-30, -56), (30, -56), (-32, -14), (32, -14),
                           (-34, 26), (34, 26), (0, 0), (-20, 46), (20, 46), (-22, 96),
                           (22, 96), (-22, 144), (22, 144)):
                x, y = cx + dx + int(rng.integers(-6, 7)), 250 + dy + int(rng.integers(-6, 7))
                frames[b, y - 18:y + 18, x - 18:x + 18] = z
    return frames


def _cnn_maps(model_cls, weights, frames, cuda):
    """The float32 CNN's NHWC maps on the card (cuDNN without TF32) and the
    preprocessed input, for decoding the same maps on both devices."""
    model = load_into(model_cls(), load_npz(weights)).eval().to(cuda)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            x = preproc_depth(torch.as_tensor(frames, device=cuda))
            out = model(x.permute(0, 3, 1, 2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    maps = out[0] if isinstance(out, tuple) else (out,)
    return [t.permute(0, 2, 3, 1).contiguous() for t in maps], x


def _decode_on_both(path, cuda):
    """(card, host) outputs of one path's decode of the same card-made maps."""
    if path == "openpose":
        (paf, heat, z), x = _cnn_maps(RTPoseLight3D, WEIGHTS, figure_frames(11, 4, False), cuda)
        return (openpose_decode(heat, paf, z, x),
                openpose_decode(heat.cpu(), paf.cpu(), z.cpu(), x.cpu()))
    if path == "popnet":
        maps, _ = _cnn_maps(PopNet, WEIGHTS_POPNET, figure_frames(12, 4), cuda)
        return popnet_decode(*maps), popnet_decode(*[t.cpu() for t in maps])
    if path == "yolo":
        (prior,), _ = _cnn_maps(YoloPoseNet, WEIGHTS_YOLO, figure_frames(13, 4), cuda)
        return yolo_decode(prior, 480, 512), yolo_decode(prior.cpu(), 480, 512)
    # the A2J tail: crop-space keypoints of 4 frames x 4 crops, uncropped
    # from the detector's boxes and back-projected
    (prior,), _ = _cnn_maps(YoloPoseNet, WEIGHTS_YOLO, figure_frames(14, 4), cuda)
    boxes = a2j_boxes(yolo_decode(prior, 480, 512)["dets"], 4, 480, 512)
    kp = torch.as_tensor(np.random.default_rng(15).uniform(-20, 300, (16, 15, 3)),
                         dtype=torch.float32, device=cuda)

    def tail(kp, boxes):
        jx, jy, jz = a2j_uncrop(kp, boxes)
        return {"joints2d": torch.stack([jx, jy], -1),
                "joints3d": back_project(jx, jy, jz, KDH3D_INTRINSICS)}

    return tail(kp, boxes), tail(kp.cpu(), boxes.cpu())


@pytest.mark.parametrize("path", ["openpose", "popnet", "yolo", "a2j"])
def test_decode_on_the_card_equals_the_host_bit_for_bit(cuda, path):
    """Each path's decode of the same maps on the card and on the CPU:
    joints2d and joints3d bit for bit (the divisions by constants round
    alike on both, `core.numerics.div_const`), and the flags exact."""
    card, host = _decode_on_both(path, cuda)
    for k in ("joints2d", "joints3d"):
        assert torch.equal(card[k].cpu(), host[k]), k
    flag = {"openpose": "counts", "popnet": "valid", "yolo": "valid"}.get(path)
    if flag:
        assert torch.equal(card[flag].cpu(), host[flag]) and bool(host[flag].any())
    if path == "yolo":
        assert torch.equal(card["dets"].cpu(), host["dets"])


def test_crop_on_the_card_equals_the_cpu(cuda):
    """The A2J crop of boxes that reach past every edge, lie wholly outside,
    or have extents that share a factor with 288, bit for bit."""
    images = np.random.default_rng(16).uniform(0.5, 6.0, (3, 512, 480)).astype(np.float32)
    boxes = np.array([[100.3, 150.7, 260.1, 470.2], [-40.5, -12.25, 100.0, 200.0],
                      [20.0, 30.0, 116.0, 174.0], [300.0, 400.0, 876.0, 496.0],
                      [500.0, 600.0, 700.0, 800.0], [0.0, 0.0, 480.0, 512.0]], np.float32)
    idx = np.array([0, 1, 2, 0, 1, 2])
    args = [torch.from_numpy(a) for a in (images, idx, boxes)]
    got = crop_resize_batch(*(a.to(cuda) for a in args))
    ref = crop_resize_batch(*args)
    assert got.shape == (6, 288, 288) and torch.equal(got.cpu(), ref)


def test_a2j_post_process_on_the_card_matches_the_cpu(cuda):
    """The softmax vote over 5184 anchors on the card against the CPU:
    (y, x) within 4.5e-3 px and z within 9e-5 m, 1.5 times the largest
    readings over seeds 0-39 of these inputs on an H100 (2.98e-3 px,
    5.70e-5 m; seed 17 reads 1.007e-3 px, 1.62e-5 m;
    `popnet_tpu_torch/tools/measure.py vote`). The gap is the CPU's: its
    float32 softmax along the non-innermost anchor axis is 46-137 eps off
    the float64 weights, the card's 10-17, while the weighted sums are
    1.4-4.6 ulps off on both, so the CPU's vote is 70-195 ulps off the
    float64 one and the card's 3-12."""
    rng = np.random.default_rng(17)
    anchors = torch.as_tensor(shift_anchors((18, 18), 16, generate_anchors()), dtype=torch.float32)
    N = anchors.shape[0]
    heads = (rng.normal(0, 3, (8, N, 15)), rng.normal(0, 10, (8, N, 15, 2)),
             rng.normal(3, 0.5, (8, N, 15)))
    heads = [torch.as_tensor(h, dtype=torch.float32) for h in heads]
    got = a2j_post_process([h.to(cuda) for h in heads], anchors.to(cuda)).cpu()
    ref = a2j_post_process(heads, anchors)
    assert got.shape == (8, 15, 3)
    torch.testing.assert_close(got[..., :2], ref[..., :2], atol=4.5e-3, rtol=0)
    torch.testing.assert_close(got[..., 2], ref[..., 2], atol=9e-5, rtol=0)


def test_yolo_slice_on_the_card_matches_the_cpu(cuda):
    """The float32 Yolo-Pose+ pipeline on the card (cuDNN without TF32)
    against the same pipeline on the CPU: valid exact with people on every
    frame, joints2d within 1e-2 px, joints3d within 1e-3 m (the CNNs' sums
    run in other orders on the two devices)."""
    frames = figure_frames(18, 4)
    weights = load_npz(WEIGHTS_YOLO)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kernels.reset_launches()
        gpu = build_yolo_pipeline(weights, dtype=torch.float32)(frames)
        torch.cuda.synchronize()
        assert sum(kernels.launch_counts().values()) == 0     # no hand kernel on this path
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = build_yolo_pipeline(weights, dtype=torch.float32, device="cpu")(frames)
    a, b = unpack_outputs(gpu.cpu().numpy(), 16, 15), unpack_outputs(cpu.numpy(), 16, 15)
    np.testing.assert_array_equal(a["counts"], b["counts"])
    ok = a["counts"] > 0
    assert ok.any(axis=1).all()
    np.testing.assert_allclose(a["joints2d"][ok], b["joints2d"][ok], atol=1e-2)
    np.testing.assert_allclose(a["joints3d"][ok], b["joints3d"][ok], atol=1e-3)


def test_yolo_a2j_pipeline_on_the_card(cuda):
    """The default bf16 Yolo->A2J pipeline with the q16 wire on the card:
    shapes, finite values, conf equal to valid, and valid equal to the
    detector's first max_crops flags of the same frames."""
    frames = torch.as_tensor(figure_frames(19, 3), device=cuda)
    weights = load_npz(WEIGHTS_YOLO)
    buf = build_yolo_a2j_pipeline(weights, pack="q16", max_crops=4)(frames)
    assert buf.dtype == torch.uint16 and buf.device.type == "cuda"
    out = unpack_outputs_q16(buf.cpu().numpy(), 4, 15)
    assert out["joints2d"].shape == (3, 4, 15, 2) and np.isfinite(out["joints3d"]).all()
    det = unpack_outputs_q16(build_yolo_pipeline(weights, pack="q16")(frames).cpu().numpy(), 16, 15)
    np.testing.assert_array_equal(out["counts"], det["counts"][:, :4])
    np.testing.assert_array_equal(out["conf"], np.broadcast_to(out["counts"][..., None], (3, 4, 15)))


def coco_maps(seed, B, memory="channels_last"):
    """Painted COCO maps on the card, (B, 46, 46, 19) heat and (B, 46, 46,
    38) PAF views in channels-last or NCHW memory, and the people a frame
    (chip_smoke.coco_people_maps: 2-4 standing people of 18 joints)."""
    from chip_smoke import coco_people_maps

    heat, paf, people = coco_people_maps(np.random.default_rng(seed), B)
    fmt = torch.channels_last if memory == "channels_last" else torch.contiguous_format
    heat, paf = (torch.as_tensor(a, device="cuda").permute(0, 3, 1, 2).contiguous(
        memory_format=fmt).permute(0, 2, 3, 1) for a in (heat, paf))
    return heat, paf, people


@pytest.mark.parametrize("memory", ["channels_last", "nchw"])
def test_find_peaks_and_assembly_at_coco_sizes(cuda, memory):
    """K1 at 46x46 with K = 18 read through the 19-channel heat (one block
    an SM), and K6 with 19 limbs over its 16 warps (some warps match a
    second limb): bit for bit against the plain versions."""
    heat, paf, _ = coco_maps(20, 6, memory)
    h = peak_planes(heat, COCO_NUM_JOINTS)
    assert tuple(h.shape) == (6, 18, 46, 46)
    for a, b in zip(kernels.find_peaks(h), kernels.find_peaks_plain(h)):
        assert torch.equal(a, b)
    assert kernels.blocks_per_sm("find_peaks", 18, 46, 46, 16) >= 1
    peaks, valid = find_peaks_batched(heat, num_joints=COCO_NUM_JOINTS)
    s, ok = kernels.paf_score_plain(paf, peaks, valid, COCO_LIMBS)
    ps, sm = assemble_inputs(peaks, s, ok)
    ids, counts = kernels.assemble_ids(ps, sm, COCO_LIMBS)
    ref_ids, ref_counts = kernels.assemble_ids_plain(ps, sm, COCO_LIMBS)
    assert torch.equal(ids, ref_ids) and torch.equal(counts, ref_counts) and counts.sum() > 0


@pytest.mark.parametrize("memory", ["channels_last", "nchw", "sliced"])
@pytest.mark.parametrize("sizes,groups", [((46, 46, COCO_LIMBS, 18), 2), ((28, 28, LIMBS, 15), 1),
                                          ((70, 60, COCO_LIMBS, 18), 4)])
def test_paf_score_kernel_splits_large_maps_over_groups_of_limbs(cuda, sizes, groups, memory):
    """K3 at the COCO sizes takes 2 blocks a frame (10 + 9 limbs), at the
    depth sizes 1, at 70x60 with 19 limbs 4 (5 + 5 + 5 + 4): bit for bit
    against the plain version on the channels-last maps, on NCHW memory
    (a copy of 4 bytes) and on a slice of larger maps; one launch each."""
    H, W, limbs, K = sizes
    L = len(limbs)
    rng = np.random.default_rng(21)
    # the peaks from the plain version: K1 holds a frame's planes in one block
    heat = torch.as_tensor(sparse_heat(22, 4, H, W, K + 1)).permute(0, 2, 3, 1)
    peaks, valid = (t.to(cuda) for t in find_peaks_batched(heat, num_joints=K))
    peaks[0, 1, 1, :2] = peaks[0, 1, 0, :2]                    # two valid slots at one point
    valid[0, 1, :2] = True
    big = torch.as_tensor(rng.uniform(-0.2, 1, (4, H + 3, W + 2, 2 * L + 5)).astype(np.float32),
                          device=cuda)
    paf = {"channels_last": big[:, :H, :W, :2 * L].contiguous(),
           "nchw": big[:, :H, :W, :2 * L].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
           "sliced": big[:, 2:H + 2, 1:W + 1, 3:2 * L + 3]}[memory]
    assert kernels.paf_score_groups(K, L, 16, H, W)[0] == groups
    kernels.reset_launches()
    s, ok = kernels.paf_score(paf, peaks, valid, limbs)
    torch.cuda.synchronize()
    assert kernels.paf_score.launches == 1
    s_p, ok_p = kernels.paf_score_plain(paf, peaks, valid, limbs)
    assert torch.equal(s, s_p) and torch.equal(ok, ok_p) and ok.any()


def test_paf_score_kernel_refuses_maps_that_no_group_holds(cuda):
    """One limb's two channels of 200x200 maps take 320,000 bytes, over a
    block's 232,448: the wrapper raises and names the size."""
    assert kernels.paf_score_groups(18, 19, 16, 200, 200)[0] == 0
    paf = torch.zeros((1, 200, 200, 38), device=cuda)
    peaks = torch.zeros((1, 18, 16, 3), device=cuda)
    valid = torch.zeros((1, 18, 16), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match=r"cannot hold \(200, 200\) maps"):
        kernels.paf_score(paf, peaks, valid, COCO_LIMBS)


def test_coco_decode_on_the_card_equals_the_host_bit_for_bit(cuda):
    """paf_decode_2d with the COCO tables on painted people: joints2d, conf,
    visibility and counts on the card equal the host's bit for bit, K1, K3
    and K6 launched once each, the painted people found."""
    heat, paf, people = coco_maps(23, 8)
    kernels.reset_launches()
    card = paf_decode_2d(heat, paf, COCO_NUM_JOINTS, limbs=COCO_LIMBS, sx=640 / 368,
                         sy=480 / 368)
    torch.cuda.synchronize()
    on_path = {"find_peaks", "paf_score", "assemble_ids"}
    assert kernels.launch_counts() == {k.__name__: int(k.__name__ in on_path)
                                       for k in kernels.KERNELS}
    host = paf_decode_2d(heat.cpu(), paf.cpu(), COCO_NUM_JOINTS, limbs=COCO_LIMBS,
                         sx=640 / 368, sy=480 / 368)
    for k in ("joints2d", "conf", "visibility", "counts"):
        assert torch.equal(card[k].cpu(), host[k]), k
    np.testing.assert_array_equal(card["counts"].cpu().numpy(), people)


@pytest.mark.parametrize("trunk", ["vgg19", "mobilenet"])
def test_rtpose_vgg_pipeline_buffer_on_the_card(cuda, trunk):
    """The COCO builder on the card, seeded init: a float32 (B, 16*18*3 + 1)
    buffer of (joints2d, conf, counts) on the card, finite, unpacked by
    unpack_outputs_2d; one launch of K1, K3 and K6 a batch; q16 refused."""
    frames = torch.as_tensor(np.random.default_rng(24).uniform(0, 255, (3, 240, 320, 3)),
                             dtype=torch.float32, device=cuda)
    kernels.reset_launches()
    buf = build_rtpose_vgg_pipeline(dtype=torch.float32, trunk=trunk)(frames)
    torch.cuda.synchronize()
    assert buf.dtype == torch.float32 and buf.device.type == "cuda"
    assert buf.shape == (3, 16 * 18 * 3 + 1) and bool(torch.isfinite(buf).all())
    out = unpack_outputs_2d(buf.cpu().numpy(), 16, COCO_NUM_JOINTS)
    assert out["joints2d"].shape == (3, 16, 18, 2) and out["conf"].shape == (3, 16, 18)
    assert out["counts"].shape == (3, 1)
    assert {n: kernels.launch_counts()[n] for n in ("find_peaks", "paf_score",
                                                     "assemble_ids")} == dict.fromkeys(
        ("find_peaks", "paf_score", "assemble_ids"), 1)
    with pytest.raises(ValueError, match="f32"):
        build_rtpose_vgg_pipeline(pack="q16")


@pytest.fixture(scope="module")
def eval_sets(tmp_path_factory):
    """chip_smoke.py's two labelled sets (zero and depth backgrounds) at 16
    frames, written from the CPU."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("cuda_eval"))
    return chip_smoke.eval_sets(np.random.default_rng(31), "cpu", 16, root)


@pytest.mark.parametrize("family", ["openpose", "openpose_device_decode", "popnet", "yolo",
                                    "a2j"])
def test_eval_driver_on_the_card_equals_the_host(cuda, eval_sets, family):
    """Each MP-3DHP driver at 16 frames, batch 8, float32 CNNs with the
    committed weights (A2J seeded): on the card, then on the host with the
    same CNN outputs, whose images (and A2J crops) equal the card's bit for
    bit; the JSON equal bit for bit (A2J joints within the vote's 64-ulp
    bar), the four metrics equal; the Open-Pose+ and PoP-Net drivers launch
    their kernels."""
    import chip_smoke
    from popnet_tpu_torch.cli import evaluate as ev

    tag, model, frame_set, opts = [f for f in chip_smoke.EVAL_FAMILIES if f[0] == family][0]
    weights = {"openpose": WEIGHTS, "popnet": WEIGHTS_POPNET, "yolo": WEIGHTS_YOLO,
               "yolo_for_a2j": WEIGHTS_YOLO}
    kernels.reset_launches()
    card, host, timing, a2j = chip_smoke.eval_family(tag, model, opts, eval_sets[frame_set],
                                                     cuda, 8, weights)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    on_path = {"openpose": {"find_peaks", "paf_score"},
               "openpose_device_decode": {"find_peaks", "paf_score", "assemble_ids",
                                          "window_readout", "point_readout"},
               "popnet": {"peak_local_max"}}.get(family, set())
    assert {n for n, c in launches.items() if c} == on_path, launches
    assert len(card["human_pred_set_2d"]) == 16 and timing["seconds"] > 0
    chip_smoke.compare_eval_json(tag, card, host, chip_smoke.a2j_bars(a2j) if a2j else None)
    m_card, m_host = ev.evaluate_eval_data(card, verbose=False), \
        ev.evaluate_eval_data(host, verbose=False)
    for k in ("pck2d", "pck3d", "map2d", "map3d"):
        assert m_card[k] == m_host[k] or (np.isnan(m_card[k]) and np.isnan(m_host[k])), k


@pytest.mark.parametrize("family", ["openpose", "popnet", "yolo"])
def test_batched_metrics_on_the_card_equal_numpy(cuda, eval_sets, family):
    """eval/batched.py on the card against the NumPy metrics on an evaluation driver's
    JSON: 2D PCKh and 3D PCK within 1e-6, 2D and 3D AP within 1e-6."""
    import chip_smoke

    tag, model, frame_set, opts = [f for f in chip_smoke.EVAL_FAMILIES if f[0] == family][0]
    weights = {"openpose": WEIGHTS, "popnet": WEIGHTS_POPNET, "yolo": WEIGHTS_YOLO}
    card = chip_smoke.eval_family(tag, model, opts, eval_sets[frame_set], cuda, 8, weights)[0]
    e_pck, e_ap = chip_smoke.check_batched_twin(tag, card, cuda)
    assert e_pck <= 1e-6 and e_ap <= 1e-6


@pytest.mark.parametrize("device_decode", [False, True])
def test_painted_openpose_oracle_on_the_card(cuda, eval_sets, device_decode):
    """The painted Open-Pose+ oracle through run_openpose_eval on the card clears
    pck2d 0.95, pck3d 0.9, map2d 0.9, map3d 0.85 and perfect_2d 0.95."""
    import chip_smoke

    m, abl = chip_smoke.painted_oracle(eval_sets["zero"], cuda, 8, device_decode)
    assert all(m[k] > bar for k, bar in chip_smoke.ORACLE_BARS.items()), m
    assert abl["perfect_2d"] > 0.95


def test_evaluate_subcommand_on_the_card(cuda, eval_sets, tmp_path):
    """python -m popnet_tpu_torch.cli.main evaluate on the card (its
    default device) writes the JSON, and benchmark scores it as evaluate
    did."""
    from popnet_tpu_torch.cli.main import main

    img_dir, labels = eval_sets["bg"]
    res = main(["evaluate", "--model", "yolo", "--data-root", os.path.dirname(img_dir),
                "--out-dir", str(tmp_path), "--batch-size", "8", "--weights", WEIGHTS_YOLO])
    got = main(["benchmark", "--gt", labels, "--pred", str(tmp_path / "yolo_results.json")])
    for k in ("pck2d", "pck3d", "map2d", "map3d"):
        assert res[k] == got[k], k


# -- training (chip_smoke.py phase 7's checks at a small size) -----------------------


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    """chip_smoke.py's KDH3D-format training set at 8 + 4 frames, written
    from the CPU."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("cuda_train"))
    chip_smoke.write_train_set(np.random.default_rng(41), "cpu", root, 8, 4)
    return root


@pytest.mark.parametrize("family", ["openpose", "popnet", "yolo"])
@pytest.mark.parametrize("transfer", ["f32", "u16mm"])
def test_training_batch_on_the_card_equals_the_cpu(cuda, train_set, family, transfer):
    """A batch of 8 augmented, bg_aug frames made on the card against the
    CPU's from the same seed: image, z-maps and masks bit for bit, the
    other maps within 2e-6."""
    import chip_smoke

    idx = np.arange(8)
    card = chip_smoke.train_dataset(train_set, family, cuda, transfer=transfer).get_batch(idx)
    host = chip_smoke.train_dataset(train_set, family, "cpu", transfer=transfer).get_batch(idx)
    assert chip_smoke.compare_batches(family, card, host) <= chip_smoke.TARGETS_BAR


def test_prior_encoder_last_person_wins_on_the_card(cuda):
    import chip_smoke

    chip_smoke.shared_prior_check(cuda)


@pytest.mark.parametrize("family", ["openpose", "popnet", "yolo"])
def test_train_step_on_the_card_matches_the_cpu(cuda, train_set, family):
    """One step from the committed weights on 4 frames, card against CPU,
    TF32 off: in float64 at the step bars (loss 1e-5, each tensor's update
    within 1e-3 of the CPU's largest, BatchNorm statistics 1e-5), in
    float32 the loss within 1e-5 and the card's step no further from its
    float64 step than chip_smoke.F32_GAP_FACTOR times the CPU's from its
    own."""
    import chip_smoke

    idx = np.arange(4)
    card = chip_smoke.train_dataset(train_set, family, cuda).get_batch(idx)
    host = chip_smoke.train_dataset(train_set, family, "cpu").get_batch(idx)
    chip_smoke.train_step_checks(family, family, card, host, cuda)


def test_train_subcommand_on_the_card_writes_checkpoints_that_evaluate_reads(cuda, train_set,
                                                                             tmp_path):
    """`train` on the card (its default device), 2 epochs at batch 4, then
    `evaluate --ckpt` of its checkpoint on the card."""
    from popnet_tpu_torch.cli.main import main

    out = str(tmp_path / "run")
    trainer = main(["train", "--model", "yolo", "--data-root", train_set, "--bg-aug",
                    "--batch-size", "4", "--epochs", "2", "--val-labels", "labels_val.json",
                    "--lr", "0.05", "--out-dir", out])
    assert trainer.device.type == "cuda" and len(trainer.history) == 2
    assert all(np.isfinite(h["train_loss"]) for h in trainer.history)
    assert os.listdir(os.path.join(out, "ckpt")) and os.listdir(os.path.join(out, "ckpt_best"))
    res = main(["evaluate", "--model", "yolo", "--data-root", train_set, "--labels",
                "labels_val.json", "--ckpt", os.path.join(out, "ckpt"), "--batch-size", "4",
                "--out-dir", str(tmp_path / "ev")])
    assert os.path.exists(tmp_path / "ev" / "yolo_results.json") and "pck2d" in res


# -- mp-aug training (chip_smoke.py phase 8's checks at a small size) ----------------------


@pytest.fixture(scope="module")
def mpaug_set(tmp_path_factory):
    """chip_smoke.py's mp-aug set: 5 location files of 8 recordings, 8
    backgrounds, 4 + 4 frames of labels.json and labels_val.json, written
    from the CPU."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("cuda_mpaug"))
    rng = np.random.default_rng(43)
    chip_smoke.write_train_set(rng, "cpu", root, 4, 4)
    chip_smoke.write_mpaug_bank(rng, "cpu", root, 8)
    return root


@pytest.mark.parametrize("name", ["KDH3DMPAugDataset", "DeviceMPAugDataset",
                                  "KDH3DMPAugAdvDataset"])
def test_mpaug_batch_on_the_card_equals_the_cpu(cuda, mpaug_set, name):
    """A batch of 8 with PoP-Net's targets and the visibility prior, made on
    the card and on the CPU from the same seed: image, z-maps, masks and
    visibility channels bit for bit, the other maps within 2e-6; the
    generators in lockstep."""
    import chip_smoke
    from popnet_tpu_torch.data import datasets

    cls = getattr(datasets, name)
    cds = chip_smoke.mpaug_dataset(cls, mpaug_set, cuda, pred_vis=True)
    hds = chip_smoke.mpaug_dataset(cls, mpaug_set, "cpu", pred_vis=True)
    idx = np.arange(8)
    chip_smoke.compare_vis(name, cds.get_batch(idx), hds.get_batch(idx))
    assert cds.rng.bit_generator.state == hds.rng.bit_generator.state


def test_stream_on_the_card_equals_the_cpu_and_the_full_bank(cuda, mpaug_set):
    """A staged shard's batch on the card equals the CPU's and the card's
    full bank's bit for bit; a streamed epoch on the card covers every index
    once with at most two shards resident, none after it."""
    import torch

    import chip_smoke
    from popnet_tpu_torch.data.datasets import DeviceMPAugDataset
    from popnet_tpu_torch.data.streaming import StreamingDeviceMPAugDataset

    mk = lambda where: chip_smoke.mpaug_dataset(StreamingDeviceMPAugDataset, mpaug_set, where,
                                                shard_indices=4)
    card, host = mk(cuda), mk("cpu")
    full = chip_smoke.mpaug_dataset(DeviceMPAugDataset, mpaug_set, cuda)
    idx = np.arange(4, 8)
    batches = []
    for ds in (card, host):
        shard = ds._stage(1)
        batches.append(chip_smoke.shard_batch(ds, shard, idx))
        ds._release(shard)
    chip_smoke.compare_batches("stream", *batches)
    ref = full.get_batch(idx)
    assert all(torch.equal(ref[k], batches[0][k]) for k in ref)
    stream = mk(cuda)
    seen, inner = [], stream._bank_batch
    stream._bank_batch = lambda i, *r: seen.append([int(x) for x in i]) or inner(i, *r)
    for _ in stream.iter_batches(2):
        pass
    assert sorted(sum(seen, [])) == list(range(len(stream)))
    assert stream.max_live_shards <= 2 and stream._live_shards == 0


def test_pred_vis_step_on_the_card_matches_the_cpu(cuda, mpaug_set):
    """PoP-Net --pred-vis, one step on 4 device-bank frames, card against
    CPU at chip_smoke.train_step_checks' bars."""
    import chip_smoke
    from popnet_tpu_torch.data.datasets import DeviceMPAugDataset

    idx = np.arange(4)
    card, host = (chip_smoke.mpaug_dataset(DeviceMPAugDataset, mpaug_set, where, pred_vis=True)
                  .get_batch(idx) for where in (cuda, "cpu"))
    chip_smoke.train_step_checks("popnet --pred-vis", "popnet", card, host, cuda, pred_vis=True)


@pytest.mark.parametrize("extra", [["--device-bank"], ["--stream-bank", "4", "--stream-repeats",
                                                       "2"]])
def test_train_mp_aug_on_the_card(cuda, mpaug_set, tmp_path, extra):
    """`train --mp-aug` on the card, 1 epoch at batch 4, finite losses."""
    from popnet_tpu_torch.cli.main import main

    trainer = main(["train", "--model", "popnet", "--data-root", mpaug_set, "--mp-aug",
                    "--batch-size", "4", "--epochs", "1", "--lr", "0.05", "--out-dir",
                    str(tmp_path / "run"), *extra])
    assert trainer.device.type == "cuda" and np.isfinite(trainer.history[0]["train_loss"])


# -- A2J training (chip_smoke.py phase 9's checks at a small size) -------------------------


def test_a2j_warps_on_the_card_equal_the_cpu(cuda, mpaug_set):
    """Rotate, and RenderDepth then Resize, on 4 mp-aug composites of
    512x480: card against CPU bit for bit."""
    import torch

    import chip_smoke

    ds = chip_smoke.a2j_dataset(mpaug_set, "cpu")
    frames = [torch.from_numpy(ds.inner.load_composited(i)[0]) for i in range(4)]
    ms = chip_smoke.a2j_warp_checks(frames, np.random.default_rng(5), cuda)
    assert set(ms) == {"Rotate", "RenderDepth + Resize"}


def test_a2j_crop_batch_on_the_card_equals_the_cpu(cuda, mpaug_set):
    """An A2JCropDataset batch of 8 at 288² (augmented, erasing on) made on
    the card against the CPU's from the same seed: frames, boxes, crops
    before erasing and labels bit for bit, the erasing bit for bit given
    the card's draws, the generators' next draws equal."""
    import torch

    import chip_smoke
    from popnet_tpu_torch.data.a2j_crops import CROP, apply_erasing, erasing_draws, \
        erasing_rectangles

    cds, hds = chip_smoke.a2j_dataset(mpaug_set, cuda), chip_smoke.a2j_dataset(mpaug_set, "cpu")
    idx = np.arange(8)
    fc, fh = cds.frames(idx), hds.frames(idx)
    assert torch.equal(fc[0].cpu(), fh[0])
    assert all(np.array_equal(a, b) for a, b in zip(fc[1:], fh[1:]))
    cds.erase = hds.erase = False
    card, host = cds.crop_frames(*fc), hds.crop_frames(*fh)
    assert all(torch.equal(card[k].cpu(), host[k]) for k in host)
    u, noise = erasing_draws(8, CROP, cds.erase_generator)
    assert u.device.type == noise.device.type == "cuda"
    erased = apply_erasing(card["crops"], erasing_rectangles(u, CROP), noise)
    ref = apply_erasing(host["crops"], erasing_rectangles(u.cpu(), CROP), noise.cpu())
    assert torch.equal(erased.cpu(), ref)
    assert cds.rng.integers(0, 1 << 30) == hds.rng.integers(0, 1 << 30)


def test_a2j_train_step_on_the_card_matches_the_cpu(cuda, mpaug_set):
    """One A2J step (seeded init, Adam-L2) on 4 crops of 288², card against
    CPU: float64 at the step bars, float32's gap to float64 within
    chip_smoke.F32_GAP_FACTOR times the CPU's; one train-mode forward moves
    every BatchNorm's statistics by Flax's momentum 0.99."""
    import chip_smoke

    cds, hds = chip_smoke.a2j_dataset(mpaug_set, cuda), chip_smoke.a2j_dataset(mpaug_set, "cpu")
    cds.erase = hds.erase = False
    card, host = cds.get_batch(np.arange(4)), hds.get_batch(np.arange(4))
    chip_smoke.train_step_checks("a2j", "a2j", card, host, cuda)
    chip_smoke.a2j_batchnorm_check(card["crops"], cuda)


def test_train_a2j_subcommand_on_the_card(cuda, mpaug_set, tmp_path):
    """`train --model a2j --mp-aug` on the card (its default device), 1
    epoch at batch 4, then `evaluate --model a2j --ckpt --gt-boxes` of its
    checkpoint on the card."""
    from popnet_tpu_torch.cli.main import main

    out = str(tmp_path / "run")
    trainer = main(["train", "--model", "a2j", "--data-root", mpaug_set, "--mp-aug",
                    "--batch-size", "4", "--epochs", "1", "--val-labels", "labels_val.json",
                    "--out-dir", out])
    assert trainer.device.type == "cuda" and np.isfinite(trainer.history[0]["train_loss"])
    res = main(["evaluate", "--model", "a2j", "--data-root", mpaug_set, "--labels",
                "labels_val.json", "--ckpt", os.path.join(out, "ckpt"), "--gt-boxes",
                "--batch-size", "4", "--out-dir", str(tmp_path / "ev")])
    assert os.path.exists(tmp_path / "ev" / "a2j_results.json") and "pck2d" in res


# -- the deployment transforms: exact BatchNorm folding and dynamic int8 ----------------------

# (C_in, C_out, kernel, stride, pad, dilation, H, W)
INT8_SHAPES = [
    (64, 32, 3, 2, 1, 1, 56, 56),      # stride 2
    (512, 512, 3, 1, 2, 2, 18, 18),    # dilated by 2 (A2J's layer4)
    (3, 64, 7, 2, 3, 1, 72, 72),       # K = 147 padded to 152 (A2J's stem)
    (128, 100, 3, 1, 1, 1, 14, 14),    # C_out = 100 padded to 104 (PoP-Net's prior head)
    (128, 38, 1, 1, 0, 1, 46, 46),     # a 1x1 head of 38 padded to 40 (RTPoseVGG's PAF)
    (256, 1024, 1, 1, 0, 1, 18, 18),   # 1x1 at stride 1: the input in NHWC is the im2col
    (64, 64, 3, 1, 1, 1, 2, 2),        # 8 rows, padded to the 17 _int_mm takes
]


@pytest.mark.parametrize("shape", INT8_SHAPES, ids=[
    "stride2", "dilated", "padded-K", "padded-N", "1x1-padded-N", "1x1-direct", "few-rows"])
def test_int8_conv_on_the_card_equals_the_plain_version(cuda, shape):
    """The int32 product on the card (im2col and torch._int_mm, counted in
    quant.int8_conv.launches) equals its plain version on the CPU bit for bit; the
    whole Int8Conv2d on float32 input equals the CPU's, both roundings (the
    card's epilogue is one fused multiply-add, torch.addcmul, as fma_f32
    rounds it on the CPU), and in bf16."""
    from popnet_tpu_torch.ops import quant

    cin, cout, k, s, p, d, H, W = shape
    rng = np.random.default_rng(cin + cout)
    x_q = torch.as_tensor(rng.integers(-127, 128, (2, cin, H, W)), dtype=torch.int8)
    w_q = torch.as_tensor(rng.integers(-127, 128, (cout, cin, k, k)), dtype=torch.int8)
    quant.int8_conv.launches = 0
    got = quant.int8_conv(x_q.to(cuda), quant.weight_matrix(w_q).to(cuda), w_q.to(cuda),
                          (s, s), (p, p), (d, d))
    torch.cuda.synchronize()
    assert quant.int8_conv.launches == 1 and got.dtype == torch.int32
    ref = quant.int8_conv_plain(x_q, w_q, (s, s), (p, p), (d, d)).permute(0, 2, 3, 1)
    assert torch.equal(got.cpu(), ref)

    conv = torch.nn.Conv2d(cin, cout, k, stride=s, padding=p, dilation=d)
    x = torch.as_tensor(rng.normal(0, 2, (2, cin, H, W)), dtype=torch.float32)
    with torch.inference_mode():
        for rounding in ("compiled", "eager"):
            host = quant.Int8Conv2d(conv, rounding)
            card = quant.Int8Conv2d(conv, rounding).to(cuda)
            assert torch.equal(card(x.to(cuda)).cpu(), host(x)), rounding
        card = quant.Int8Conv2d(conv).to(cuda, torch.bfloat16)
        xb = x.to(torch.bfloat16)
        assert torch.equal(card(xb.to(cuda)).cpu(), quant.Int8Conv2d(conv)(xb))


def _deploy_frames(background):
    return figure_frames(31, 4, background=background)


DEPLOY_PATHS = {"openpose": (build_openpose_pipeline, WEIGHTS, False),
                "popnet": (build_popnet_pipeline, WEIGHTS_POPNET, True),
                "yolo": (build_yolo_pipeline, WEIGHTS_YOLO, True)}
DEPLOY_CASES = [(m, t) for m in DEPLOY_PATHS for t in ("fold", "int8", "fold+int8")]


@pytest.mark.parametrize("path,transform", DEPLOY_CASES,
                         ids=[f"{m}-{t}" for m, t in DEPLOY_CASES])
def test_deploy_transforms_on_the_card_match_the_cpu(cuda, path, transform):
    """A depth builder with fold_bn and/or quant="int8", float32 (cuDNN
    without TF32), on the card against the CPU on the same 4 frames. Folded:
    people equal, joints2d within 2.3 px and depth within 1e-3 m, as the
    exact path's test holds them. int8: the float convs between the int8
    convs round apart on the two devices, and an ulp across a rounding
    boundary of x / s_x moves a quantized value a step: people per frame
    equal and 95% of the joints both see within 2.3 px (Open-Pose+, whose
    committed weights localize little, within one and 80%: measured 88.6%
    on an H100). Every eligible conv ran in int8 on the card, once a
    batch."""
    from popnet_tpu_torch.ops import quant

    build, w, background = DEPLOY_PATHS[path]
    kw = {"fold_bn": "fold" in transform}
    if "int8" in transform:
        kw["quant"] = "int8"
    frames = _deploy_frames(background)
    weights = load_npz(w)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        quant.int8_conv.launches = 0
        gpu = build(weights, dtype=torch.float32, **kw)(frames)
        torch.cuda.synchronize()
        assert quant.int8_conv.launches == ({"openpose": 32, "popnet": 38, "yolo": 24}[path]
                                  if "quant" in kw else 0)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = build(weights, dtype=torch.float32, device="cpu", **kw)(frames)
    a, b = unpack_outputs(gpu.cpu().numpy(), 16, 15), unpack_outputs(cpu.numpy(), 16, 15)
    assert np.isfinite(a["joints3d"]).all()
    va, vb = a["joints2d"][..., 0] >= 0, b["joints2d"][..., 0] >= 0
    if path != "openpose":
        va, vb = va & (a["counts"] > 0)[..., None], vb & (b["counts"] > 0)[..., None]
    if "quant" not in kw:
        np.testing.assert_array_equal(a["counts"], b["counts"])
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_allclose(a["joints2d"][va], b["joints2d"][va], atol=2.3)
        np.testing.assert_allclose(a["joints3d"][va][..., 2], b["joints3d"][va][..., 2], atol=1e-3)
        return
    ca, cb = a["counts"].sum(axis=1), b["counts"].sum(axis=1)
    assert np.abs(ca - cb).max() <= (1 if path == "openpose" else 0), (ca, cb)
    both = va & vb
    assert both.sum() >= 9
    d = np.linalg.norm(a["joints2d"] - b["joints2d"], axis=-1)[both]
    assert (d <= 2.3).mean() >= (0.8 if path == "openpose" else 0.95)


@pytest.mark.parametrize("transform", ["fold", "fold+int8"])
def test_yolo_a2j_deploy_transforms_on_the_card_match_the_cpu(cuda, transform):
    """Yolo->A2J (A2J seeded) in float32 with fold_bn, and with int8 too,
    on both stages, card (cuDNN without TF32) against CPU on 2 frames, 2
    crops a frame: the detector's flags and confidences equal, every value
    finite, every eligible conv int8 on the card (24 + 68 a batch).
    Folded, the joints lie within 1% of each output's largest magnitude
    (the exact path's bar against JAX: an ulp in a box flips a
    nearest-neighbour tap of the crop); with int8 a quantization step moves
    the seeded init's sharp vote by whole anchors, so the joints are not
    compared."""
    from popnet_tpu_torch.ops import quant

    kw = {"fold_bn": True, **({"quant": "int8"} if "int8" in transform else {})}
    frames = figure_frames(34, 2)
    weights = load_npz(WEIGHTS_YOLO)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        quant.int8_conv.launches = 0
        gpu = build_yolo_a2j_pipeline(weights, dtype=torch.float32, max_crops=2, **kw)(frames)
        torch.cuda.synchronize()
        assert quant.int8_conv.launches == (24 + 68 if "quant" in kw else 0)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = build_yolo_a2j_pipeline(weights, dtype=torch.float32, device="cpu", max_crops=2,
                                  **kw)(frames)
    a, b = unpack_outputs(gpu.cpu().numpy(), 2, 15), unpack_outputs(cpu.numpy(), 2, 15)
    assert np.isfinite(a["joints3d"]).all() and a["counts"].any()
    np.testing.assert_array_equal(a["counts"], b["counts"])
    np.testing.assert_array_equal(a["conf"], b["conf"])
    if "quant" not in kw:
        for k in ("joints2d", "joints3d"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-2 * np.abs(b[k]).max(), err_msg=k)


def test_coco_deploy_transforms_on_the_card_match_the_cpu(cuda):
    """COCO RGB in float32 with fold_bn and int8, card against CPU on 2
    frames at input_size 184: RTPoseVGG's MobileNet trunk from its seeded
    init (9 BatchNorms fold; maps near zero, nobody found) within 1e-4 of
    the CPU's buffer; the VGG19 trunk with chip_smoke's scaled heads
    (`coco_weights`, people found): its int8 CNN's maps on the card closer
    to the CPU's int8 maps on average than those lie to the CPU's float32
    maps, and within twice that gap at most (a float ulp moves a quantized
    value a step here and there, and the step spreads), and the builder's
    people within 30% of the CPU's (its seeded maps are noise near the
    decode's thresholds: an H100 read 10 against 13); every value finite;
    79 and 85 int8 convs a batch on the card, K1, K3, K6 once."""
    from chip_smoke import coco_weights
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseVGG
    from popnet_tpu_torch.ops import quant
    from popnet_tpu_torch.serving import deploy_model, preproc_rgb

    rgb = np.random.default_rng(33).uniform(0, 255, (2, 240, 320, 3)).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for weights, trunk, n_int8 in ((None, "mobilenet", 79), (coco_weights(), "vgg19", 85)):
            kw = dict(dtype=torch.float32, trunk=trunk, input_size=184, fold_bn=True,
                      quant="int8")
            kernels.reset_launches()
            quant.int8_conv.launches = 0
            gpu = build_rtpose_vgg_pipeline(weights, **kw)(rgb)
            torch.cuda.synchronize()
            assert quant.int8_conv.launches == n_int8
            assert all(kernels.launch_counts()[n] == 1 for n in ("find_peaks", "paf_score",
                                                                  "assemble_ids"))
            cpu = build_rtpose_vgg_pipeline(weights, device="cpu", **kw)(rgb).numpy()
            got = gpu.cpu().numpy()
            assert np.isfinite(got).all()
            if trunk == "mobilenet":
                np.testing.assert_allclose(got, cpu, atol=1e-4)
                continue
            ca, cb = (unpack_outputs_2d(o, 16, COCO_NUM_JOINTS)["counts"].sum()
                      for o in (got, cpu))
            assert cb > 0 and abs(ca - cb) <= 0.3 * cb, (ca, cb)
            x = preproc_rgb(torch.as_tensor(rgb), 184)
            card, host, exact = (
                deploy_model(load_into(RTPoseVGG(), weights), dev, torch.float32,
                             quant=q)(x.to(dev))[0] for dev, q in ((cuda, "int8"),
                                                                   ("cpu", "int8"), ("cpu", None)))
            for a, b, e in zip(card, host, exact):
                d, gap = (a.cpu() - b).abs(), (b - e).abs()
                print("COCO int8 map, card vs CPU mean and max |err|:", float(d.mean()),
                      float(d.max()), "; int8 vs float32 on the CPU:", float(gap.mean()),
                      float(gap.max()))
                assert d.mean() < gap.mean() and d.max() <= 2 * gap.max()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def test_evaluate_deploy_flags_on_the_card(cuda, eval_sets, tmp_path):
    """`evaluate --fold-bn` and `--quant int8` of PoP-Net (the committed
    weights, chip_smoke's 16 frames over the background) on the card
    against the same command on the CPU: the int8 run goes through int8
    convs on the card; folded, the four metrics equal the CPU's within
    1e-6 (the card's float32 convs sum in other orders); int8, each frame's
    people equal and the metrics within 0.02 (an ulp of a float layer
    moves a quantized value a step here and there)."""
    from popnet_tpu_torch.cli.main import main
    from popnet_tpu_torch.ops import quant

    root = os.path.dirname(eval_sets["bg"][0])
    for flags, bar in ((("--fold-bn",), 1e-6), (("--quant", "int8"), 0.02)):
        res, people = {}, {}
        for dev in ("cuda", "cpu"):
            quant.int8_conv.launches = 0
            out = str(tmp_path / dev)
            res[dev] = main(["evaluate", "--model", "popnet", "--data-root", root,
                             "--out-dir", out, "--batch-size", "8", "--device", dev,
                             "--weights", WEIGHTS_POPNET, *flags])
            assert (quant.int8_conv.launches > 0) == ("--quant" in flags and dev == "cuda")
            with open(os.path.join(out, "popnet_results.json")) as f:
                people[dev] = [len(p) for p in json.load(f)["human_pred_set_2d"]]
        assert people["cuda"] == people["cpu"], (flags, people)
        for k in ("pck2d", "pck3d", "map2d", "map3d"):
            assert abs(res["cuda"][k] - res["cpu"][k]) <= bar, (flags, k, res)


# -- ITOP and the exact host decode (chip_smoke.py phase 11's checks at a small size) -------

@pytest.fixture(scope="module")
def itop_root(tmp_path_factory):
    """chip_smoke.py's synthetic ITOP sets: 64 training frames (labels.json)
    and 64 validation frames (labels_val.json), 320x240."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("cuda_itop"))
    chip_smoke.write_itop_sets(root)
    return root


@pytest.mark.parametrize("stats", ["absolute", "relative"])
def test_itop_crops_on_the_card_equal_the_cpu(cuda, itop_root, stats):
    """itop_relative_stats on the card within 1e-12 of the CPU's; an
    ITOPA2JCropDataset batch of 16 with its box shifts made on the card
    equals the CPU's bit for bit (crops, labels, the erasing on the card's
    draws), at the absolute and at the relative statistics."""
    import chip_smoke
    from popnet_tpu_torch.data.a2j_crops import (CROP, ITOPA2JCropDataset, apply_erasing,
                                                 erasing_draws, erasing_rectangles)
    from popnet_tpu_torch.data.itop_a2j import itop_relative_stats

    kc, _ = chip_smoke.itop_datasets(itop_root, cuda)
    kh, _ = chip_smoke.itop_datasets(itop_root, "cpu")
    mean, std = itop_relative_stats(kc)
    ref = itop_relative_stats(kh)
    assert abs(mean - ref[0]) <= 1e-12 * abs(ref[0]) and abs(std - ref[1]) <= 1e-12 * ref[1]
    kw = {"mean": mean, "std": std} if stats == "relative" else {}
    cds = ITOPA2JCropDataset(kc, seed=2, erase=False, **kw)
    hds = ITOPA2JCropDataset(kh, seed=2, erase=False, **kw)
    idx = np.arange(16)
    card, host = cds.get_batch(idx), hds.get_batch(idx)
    for k in host:
        assert torch.equal(card[k].cpu(), host[k]), k
    u, noise = erasing_draws(16, CROP, cds.erase_generator)
    ec = apply_erasing(card["crops"], erasing_rectangles(u, CROP), noise)
    eh = apply_erasing(host["crops"], erasing_rectangles(u.cpu(), CROP), noise.cpu())
    assert torch.equal(ec.cpu(), eh)
    assert cds.rng.integers(0, 1 << 30) == hds.rng.integers(0, 1 << 30)


def test_itop_drivers_on_the_card_equal_the_host(cuda, itop_root):
    """The two ITOP drivers on the validation frames with oracle heads and
    maps, on the card and on the host: acc@10cm over 0.995 (A2J) and 0.9
    (Open-Pose+); the A2J predictions within the vote's 64-ulp bar of the
    host's, the Open-Pose+ output equal (the host's images equal the card's
    bit for bit)."""
    import chip_smoke
    from popnet_tpu_torch.cli.itop_eval import run_itop_a2j_eval, run_itop_openpose_eval

    kc, mc = chip_smoke.itop_datasets(itop_root, cuda, "labels_val.json")
    kh, mh = chip_smoke.itop_datasets(itop_root, "cpu", "labels_val.json")
    a_card = run_itop_a2j_eval(chip_smoke.itop_a2j_oracle(kc), kc, 16)
    a_host = run_itop_a2j_eval(chip_smoke.itop_a2j_oracle(kh), kh, 16)
    pc, ph = np.asarray(a_card["pred_uvz"]), np.asarray(a_host["pred_uvz"])
    assert np.abs(pc - ph).max() <= 2.0 ** -18 * np.abs(ph).max()
    kernels.reset_launches()
    rec = chip_smoke.Recorder(chip_smoke.itop_openpose_oracle(mc, cuda), "itop images")
    o_card = run_itop_openpose_eval(rec, mc, 16)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["find_peaks"] > 0 and kernels.launch_counts()["paf_score"] > 0
    o_host = run_itop_openpose_eval(rec.replay(), mh, 16)
    assert o_card == o_host
    assert a_card["acc_10cm"] > 0.995 and o_card["acc_10cm"] > 0.9


def test_exact_decode_on_the_cards_maps(cuda, eval_sets):
    """run_openpose_eval(fast=False) with the painted oracle's maps on the
    card clears the oracle's bars, and its output equals the same decode of
    the same maps handed over on the CPU."""
    import chip_smoke
    from popnet_tpu_torch.cli import evaluate as ev
    from popnet_tpu_torch.data.datasets import MPRealDataset

    m, abl = chip_smoke.painted_oracle(eval_sets["zero"], cuda, 8, False, fast=False)
    assert all(m[k] > bar for k, bar in chip_smoke.ORACLE_BARS.items()), m
    assert abl["perfect_2d"] > 0.95
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ds = MPRealDataset(*eval_sets["zero"], device=dev)
        pos = {"i": 0}

        def infer(images, ds=ds, pos=pos, dev=dev):
            idx = range(pos["i"], pos["i"] + images.shape[0])
            pos["i"] += images.shape[0]
            maps = chip_smoke.openpose_painted_maps([ds.anno_dic[ds.ids[i]] for i in idx])
            heat, paf, z = (torch.from_numpy(a).to(dev) for a in maps)
            return paf, heat, z

        out[dev.type] = ev.run_openpose_eval(infer, ds, 8, fast=False)
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("model", ["a2j", "openpose"])
def test_train_and_evaluate_itop_on_the_card(cuda, itop_root, tmp_path, model):
    """`train --model a2j|openpose --dataset itop` on the card (its default
    device), one epoch at batch 16 validating on the validation frames:
    finite losses and a checkpoint; then `evaluate --dataset itop` of that
    checkpoint (A2J with --gt-boxes) writes its JSON for all 64 frames."""
    from popnet_tpu_torch.cli.main import main

    out = str(tmp_path / "run")
    trainer = main(["train", "--model", model, "--dataset", "itop", "--data-root", itop_root,
                    "--batch-size", "16", "--epochs", "1", "--val-labels", "labels_val.json",
                    "--out-dir", out, *(["--lr", "0.05"] if model == "openpose" else [])])
    h = trainer.history
    assert len(h) == 1 and np.isfinite([h[0]["train_loss"], h[0]["val_loss"]]).all()
    ev = ["evaluate", "--model", model, "--dataset", "itop", "--data-root", itop_root,
          "--labels", "labels_val.json", "--ckpt", os.path.join(out, "ckpt"), "--batch-size",
          "16", "--out-dir", str(tmp_path / "ev"), *(["--gt-boxes"] if model == "a2j" else [])]
    main(ev)
    with open(tmp_path / "ev" / f"{model}_results.json") as f:
        data = json.load(f)
    assert len(data["human_pred_set_2d"]) == 64


# -- COCO and MPII RGB training (chip_smoke.py phase 12's checks at a small size) -------------


def test_jpeg_fixtures_decode_to_cv2s_hashes(cuda):
    """The committed JPEG fixtures read by the port's reader on the card's
    host: each to the sha256 of cv2.imread's output recorded beside it, the
    progressive ones included (the card's machine has no cv2); the timed
    pair's ms are positive."""
    import chip_smoke

    with open(os.path.join(chip_smoke.FIXTURES, "hashes.json")) as f:
        recorded = json.load(f)
    n, ms = chip_smoke.check_jpeg_fixtures()
    assert n == len(recorded["decoded"]) >= 17
    assert sorted(ms) == sorted(recorded["timed"]) and all(v > 0 for v in ms.values())


@pytest.fixture(scope="module")
def rgb_set(tmp_path_factory):
    """chip_smoke.py's RGB sets (painted people as baseline JPEG, COCO and
    MPII labels) at 8 + 4 frames."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("cuda_rgb"))
    chip_smoke.write_rgb_sets(np.random.default_rng(43), root, 8, 4)
    return root


@pytest.mark.parametrize("dataset", ["coco", "mpii"])
def test_rgb_batch_on_the_card_equals_the_cpu(cuda, rgb_set, dataset):
    """A batch of 8 at 64² (COCO with rotation, scale jitter, blur and flips;
    MPII with flips) made on the card against the CPU's from the same seed:
    image, scales, masks and prior targets bit for bit, the maps within
    chip_smoke.TARGETS_BAR, the generators equal."""
    import chip_smoke

    card = chip_smoke.rgb_dataset(rgb_set, dataset, cuda, 64)
    host = chip_smoke.rgb_dataset(rgb_set, dataset, "cpu", 64)
    idx = np.arange(8)
    assert chip_smoke.compare_rgb_batches(dataset, card.get_batch(idx),
                                          host.get_batch(idx)) <= chip_smoke.TARGETS_BAR
    assert card.rng.bit_generator.state == host.rng.bit_generator.state


@pytest.mark.parametrize("dataset,family", [("coco", "rtpose_vgg"), ("mpii", "popnet_rgb")])
def test_rgb_train_step_on_the_card_matches_the_cpu(cuda, rgb_set, dataset, family):
    """One step of RTPoseVGG (VGG19) or PopNetRGB from the seeded init on 4
    frames at 64², card against CPU, TF32 off: in float64 at the step bars,
    in float32 the loss within 1e-5 and the card's step no further from its
    float64 step than chip_smoke.F32_GAP_FACTOR times the CPU's."""
    import chip_smoke

    idx = np.arange(4)
    card = chip_smoke.rgb_dataset(rgb_set, dataset, cuda, 64).get_batch(idx)
    host = chip_smoke.rgb_dataset(rgb_set, dataset, "cpu", 64).get_batch(idx)
    chip_smoke.train_step_checks(family, family, card, host, cuda)


@pytest.mark.parametrize("dataset,family", [("coco", "rtpose_vgg"), ("mpii", "popnet_rgb")])
def test_train_rgb_subcommand_on_the_card(cuda, rgb_set, tmp_path, dataset, family):
    """`train --dataset coco|mpii` on the card (its default device), 2 epochs
    at 64² and batch 4 (COCO with the MobileNet trunk and every
    augmentation): finite losses, the training loss falling, checkpoints
    written, and 1 epoch + --resume 1 ending where the 2-epoch run ends."""
    from popnet_tpu_torch.cli.main import main
    from popnet_tpu_torch.train import checkpoint

    cli = ["train", "--dataset", dataset, "--model", family, "--data-root", rgb_set,
           "--labels", f"{dataset}_train.json", "--val-labels", f"{dataset}_val.json",
           "--input-size", "64", "--batch-size", "4", "--lr", "0.05"]
    if dataset == "coco":
        cli += ["--trunk", "mobilenet", "--rotate-aug", "30", "--scale-jitter", "0.6,1.0",
                "--blur-aug", "1.5"]
    with torch.backends.cudnn.flags(enabled=True, deterministic=True):
        trainer = main([*cli, "--epochs", "2", "--out-dir", str(tmp_path / "whole")])
        main([*cli, "--epochs", "1", "--out-dir", str(tmp_path / "split")])
        main([*cli, "--epochs", "1", "--out-dir", str(tmp_path / "split"), "--resume"])
    hist = trainer.history
    assert trainer.device.type == "cuda" and len(hist) == 2
    assert all(np.isfinite([h["train_loss"] for h in hist] + [h["val_loss"] for h in hist]))
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    a = checkpoint.restore_params(str(tmp_path / "whole" / "ckpt"))[0]
    b = checkpoint.restore_params(str(tmp_path / "split" / "ckpt"))[0]
    assert all(torch.equal(v, b[k]) for k, v in a.items())


# -- COCO evaluation at the evaluation canvas, and generate-augset ----------------------------


@pytest.mark.parametrize("H,W", [(46, 62), (62, 46), (46, 69), (46, 70), (46, 82), (46, 123),
                                 (46, 46)])
def test_find_peaks_takes_k2_where_k1_cannot_hold_the_maps(cuda, H, W):
    """find_peaks at the evaluation grids of non-square COCO images (18
    planes of 46x62, 62x46, 46x69, 46x70, 46x82 and 46x123 do not fit one
    block of K1), a batch of 3: the call launches find_peaks_plane, the
    faster of the two kernels that take them, and counts it there, none on
    K1 or K2, exact against the plain version; K2 (find_peaks_row), which
    launches only by name, exact too; at 46x46 K1 itself launches."""
    heat = torch.as_tensor(sparse_heat(31, 3, H, W, 19), device=cuda)
    h = peak_planes(heat.permute(0, 2, 3, 1), COCO_NUM_JOINTS)
    route = kernels.find_peaks_route(18, H, W, 16)
    assert route == ("find_peaks" if (H, W) == (46, 46) else "find_peaks_plane")
    kernels.reset_launches()
    got = kernels.find_peaks(h)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts[route] == 1 and sum(counts.values()) == 1
    ref = kernels.find_peaks_plain(h)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool(got[4].any())
    for a, b in zip(kernels.find_peaks_row(h), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(1, 18, 46, 256), (1, 1, 255, 255), (2, 3, 300, 300)])
def test_find_peaks_plane_at_any_size_bit_for_bit(cuda, shape):
    """find_peaks_plane, the third kernel, on maps K1 and K2 cannot hold
    (NCHW, channels-last and a slice of larger maps): every output equal to
    the plain version, dense heat with 32 peaks kept and sparse heat with
    16."""
    B, K, H, W = shape
    rng = np.random.default_rng(H * W + K)
    dense = rng.uniform(0, 1, (B, K + 1, H + 3, W + 4)).astype(np.float32)
    dense[0, 0, 1:H:5, 1:W:5] = 2.0 + rng.uniform(0, 1, dense[0, 0, 1:H:5, 1:W:5].shape)
    dense[0, 0, 7, 9] = dense[0, 0, H - 2, W - 1] = 4.0             # an exact tie
    sparse = np.zeros_like(dense)
    sparse[:, :, :H, :W] = sparse_heat(H + W, B, H, W, K + 1)
    for heat, M in ((dense, 32), (sparse, 16)):
        t = torch.as_tensor(heat, device=cuda)
        for h in (t[:, :K, :H, :W].contiguous(),
                  t[:, :K, :H, :W].contiguous(memory_format=torch.channels_last),
                  t[:, 1:, 2:H + 2, 3:W + 3]):
            kernels.reset_launches()
            got = kernels.find_peaks_plane(h, max_peaks=M)
            torch.cuda.synchronize()
            assert kernels.find_peaks_plane.launches == 1
            for a, b in zip(got, kernels.find_peaks_plain(h, max_peaks=M)):
                assert torch.equal(a, b)
    assert int(got[4].sum()) > 0


def test_find_peaks_refuses_grids_over_255_cells_naming_the_canvas(cuda):
    """Maps with a side over 255 cells, which K1 and K2 cannot take (their
    survivor keys hold a cell in 16 bits; a 368x2048 canvas gives 46x256
    maps): find_peaks routes them to find_peaks_plane by a query of the
    sizes and equals the plain version bit for bit, one launch counted
    there and none on K1 or K2."""
    for shape in ((1, 18, 46, 256), (2, 3, 300, 300)):
        B, K, H, W = shape
        heat = torch.as_tensor(sparse_heat(H + W, B, H, W, K), device=cuda)
        assert kernels.find_peaks_route(K, H, W, 16) == "find_peaks_plane"
        kernels.reset_launches()
        got = kernels.find_peaks(heat)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert (counts["find_peaks_plane"], counts["find_peaks"], counts["find_peaks_row"]) == \
            (1, 0, 0)
        for a, b in zip(got, kernels.find_peaks_plain(heat)):
            assert torch.equal(a, b)
        assert bool(got[4].any())


COCO_CANVASES = ((46, 62), (62, 46), (46, 69), (69, 46))   # maps of the non-square canvases


def memory_variants(heat, dev):
    """(B, K, H, W) heat on the card in NCHW and channels-last memory, and
    as a slice of larger maps."""
    B, K, H, W = heat.shape
    big = np.zeros((B, K + 1, H + 3, W + 4), np.float32)
    big[:, 1:, 2:H + 2, 3:W + 3] = heat
    t = torch.as_tensor(heat, device=dev)
    return (t, t.contiguous(memory_format=torch.channels_last),
            torch.as_tensor(big, device=dev)[:, 1:, 2:H + 2, 3:W + 3])


def plane_matches_plain(h, M):
    """find_peaks_plane on h: one launch, every output equal to the plain
    version; returns its outputs."""
    kernels.reset_launches()
    got = kernels.find_peaks_plane(h, max_peaks=M)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["find_peaks_plane"] == 1
    for a, b in zip(got, kernels.find_peaks_plain(h, max_peaks=M)):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("H,W", [*COCO_CANVASES, (46, 70), (46, 276)])
def test_find_peaks_plane_on_band_edges_at_batch_1(cuda, H, W):
    """find_peaks_plane on one frame of 18 planes (a cluster of CTAs a
    plane, each taking a band of rows): peaks, a plateau and exact ties on
    the rows where two CTAs' bands meet, equal values held by different
    CTAs of a cluster, plateau heat, dense heat keeping 32 and a frame
    without a survivor, in NCHW, channels-last and sliced memory, every
    output equal to the plain version. find_peaks routes these maps to it,
    one frame and a batch of 2."""
    from chip_smoke import band_edge_heat, plane_edges

    K = COCO_NUM_JOINTS
    assert kernels.find_peaks_plane_config(1, K, H, W, 32)["cluster"] == 8
    edges = plane_edges(1, K, H, W)
    assert len(edges) == 7
    rng = np.random.default_rng(H * W)
    edge = band_edge_heat(rng, 1, K, H, W, edges)
    plateau = (np.round(rng.uniform(0, 1, (1, K, H, W)) * 4) / 4).astype(np.float32)
    dense = rng.uniform(0, 1, (1, K, H, W)).astype(np.float32)
    none = rng.uniform(0, 0.09, (1, K, H, W)).astype(np.float32)
    for heat, M in ((edge, 16), (edge, 32), (plateau, 32), (dense, 32), (none, 16)):
        for h in memory_variants(heat, cuda):
            got = plane_matches_plain(h, M)
        if heat is dense:
            assert bool(got[4].all())
        if heat is none:
            assert not bool(got[4].any())
    assert int(plane_matches_plain(torch.as_tensor(edge, device=cuda), 32)[4][0, 0].sum()) == 32
    assert kernels.find_peaks_route(K, H, W, 16) == "find_peaks_plane"
    two = np.concatenate([edge, edge[..., ::-1]])
    for h in (torch.as_tensor(edge, device=cuda), torch.as_tensor(two, device=cuda)):
        h = h.contiguous(memory_format=torch.channels_last)
        kernels.reset_launches()
        got = kernels.find_peaks(h)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert (counts["find_peaks_plane"], counts["find_peaks"], counts["find_peaks_row"]) == \
            (1, 0, 0)
        for a, b in zip(got, kernels.find_peaks_plain(h)):
            assert torch.equal(a, b)


def test_find_peaks_plane_takes_a_2048_plane_in_bands(cuda):
    """A 1x1x2048x2048 plane: each of the cluster's 8 CTAs takes its 256
    rows in successive bands, its warps' running top-M kept across them;
    peaks, plateaus and ties on every edge between bands and between CTAs,
    and sparse heat; every output equal to the plain version."""
    from chip_smoke import band_edge_heat, plane_edges

    cfg = kernels.find_peaks_plane_config(1, 1, 2048, 2048, 16)
    assert cfg["cluster"] == 8 and cfg["rows"] < 256
    edges = plane_edges(1, 1, 2048, 2048)
    assert len(edges) > 8
    edge = band_edge_heat(np.random.default_rng(2048), 1, 1, 2048, 2048, edges)
    for heat, M in ((edge, 32), (sparse_heat(2048, 1, 2048, 2048, 1), 16)):
        for h in memory_variants(heat, cuda):
            got = plane_matches_plain(h, M)
    assert int(plane_matches_plain(torch.as_tensor(edge, device=cuda), 32)[4].sum()) == 32


def test_find_peaks_plane_at_the_depth_planes(cuda):
    """The serving path's planes, 256 frames of 15 planes of 28x28 in the
    CNN's channels-last memory (one CTA a plane): find_peaks_plane equal to
    the plain version and to K1."""
    heat = sparse_heat(41, 256, 28, 28, 19)
    h = peak_planes(torch.as_tensor(heat, device=cuda).permute(0, 2, 3, 1).contiguous())
    assert kernels.find_peaks_plane_config(256, 15, 28, 28, 16)["cluster"] == 1
    got = plane_matches_plain(h, 16)
    for a, b in zip(got, kernels.find_peaks(h)):
        assert torch.equal(a, b)
    assert bool(got[4].any()) and bool((~got[4].any(-1)).any())


def test_find_peaks_plane_refuses_what_it_cannot_take(cuda):
    """Rows too wide for three of them in a CTA's shared memory raise a
    ValueError naming the sizes, through find_peaks too (a side over 255
    cells routes there); so do the refine settings the kernels do not
    build. Nothing runs something else instead."""
    h = torch.rand((1, 1, 3, 20000), device=cuda)
    assert kernels.find_peaks_plane_config(1, 1, 3, 20000, 16) is None
    for fn in (kernels.find_peaks_plane, kernels.find_peaks):
        with pytest.raises(ValueError, match="find_peaks_plane cannot take 1 frames of 1 planes "
                                             "of 3x20000"):
            fn(h)
    small = torch.rand((1, 2, 300, 9), device=cuda)
    for kw, match in ((dict(win_size=3), "win_size=2"), (dict(factor=4), "factor=8"),
                      (dict(max_peaks=33), "at most 32 peaks")):
        with pytest.raises(ValueError, match=match):
            kernels.find_peaks_plane(small, **kw)


@pytest.mark.parametrize("H,W", [(46, 62), (62, 46), (46, 69), (46, 123)])
def test_paf_score_at_the_evaluation_grids(cuda, H, W):
    """K3 with the COCO tables at the evaluation grids: bit for bit against
    the plain version, one launch."""
    heat = torch.as_tensor(sparse_heat(32, 2, H, W, 19)).permute(0, 2, 3, 1)
    peaks, valid = (t.to(cuda) for t in find_peaks_batched(heat, num_joints=18))
    paf = torch.as_tensor(np.random.default_rng(33).uniform(-0.2, 1, (2, H, W, 38)),
                          dtype=torch.float32, device=cuda)
    kernels.reset_launches()
    s, ok = kernels.paf_score(paf, peaks, valid, COCO_LIMBS)
    torch.cuda.synchronize()
    assert kernels.paf_score.launches == 1
    s_p, ok_p = kernels.paf_score_plain(paf, peaks, valid, COCO_LIMBS)
    assert torch.equal(s, s_p) and torch.equal(ok, ok_p) and ok.any()


@pytest.mark.parametrize("flip", [False, True])
def test_rgb_infer_on_the_card_matches_the_cpu(cuda, flip):
    """rgb_infer of a 240x320 image at dest_size 184 (maps 23x31), VGG19
    RTPoseVGG with chip_smoke's scaled heads, float32 with TF32 off: the
    card's maps within 1e-4 of the CPU's over their largest magnitude, the
    same scale; the decode of the card's maps on the card equals the
    host's."""
    from chip_smoke import coco_weights
    from popnet_tpu_torch.core.skeleton_coco import COCO_SWAP_INDICES
    from popnet_tpu_torch.data.preprocessing import rgb_infer
    from popnet_tpu_torch.models import RTPoseVGG

    weights = coco_weights()
    img = np.random.default_rng(34).integers(0, 256, (240, 320, 3), dtype=np.uint8)

    def infer_of(model):
        def infer(x):
            with torch.inference_mode():
                (paf, heat), _ = model(x.permute(0, 3, 1, 2))
            return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)
        return infer

    kw = dict(mode="rtpose", dest_size=184, flip=flip, limbs=COCO_LIMBS,
              swap_indices=COCO_SWAP_INDICES)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = rgb_infer(infer_of(load_into(RTPoseVGG(), weights).eval().to(cuda)), img, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    host = rgb_infer(infer_of(load_into(RTPoseVGG(), weights).eval()), img, device="cpu", **kw)
    assert card[2] == host[2] == 184 / 240
    for a, b in zip(card[:2], host[:2]):
        assert a.device.type == "cuda" and tuple(a.shape[:2]) == (23, 31)
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
    s = card[2]
    dk = paf_decode_2d(card[1][None], card[0][None], COCO_NUM_JOINTS, limbs=COCO_LIMBS,
                       sx=1 / s, sy=1 / s)
    dh = paf_decode_2d(card[1][None].cpu(), card[0][None].cpu(), COCO_NUM_JOINTS,
                       limbs=COCO_LIMBS, sx=1 / s, sy=1 / s)
    for k in ("joints2d", "conf", "visibility", "counts"):
        assert torch.equal(dk[k].cpu(), dh[k]), k


@pytest.mark.parametrize("kind", ["bgaug", "mpaug"])
def test_generate_augset_card_composite_equals_the_host(cuda, tmp_path, kind):
    """generate-augset --augment on the card (its default: the composite and
    the transforms there) and with --device cpu on chip_smoke's KDH3D layout
    (8 frames, 8 recordings a location): the same files, byte for byte."""
    from chip_smoke import write_mpaug_bank, write_train_set
    from popnet_tpu_torch.cli.main import main

    rng = np.random.default_rng(35)
    data = str(tmp_path / "data")
    write_train_set(rng, cuda, data, 8, 0)
    write_mpaug_bank(rng, cuda, data, 8)
    outs = []
    for extra in ([], ["--device", "cpu"]):
        out = tmp_path / (extra[-1] if extra else "card")
        main(["generate-augset", "--kind", kind, "--data-root", data, "--out-dir", str(out),
              "--augment", *extra])
        outs.append({p.relative_to(out): p.read_bytes() for p in out.rglob("*") if p.is_file()})
    assert outs[0] == outs[1] and len(outs[0]) == 9


# -- parallel layouts (chip_smoke.py phase 15's checks at a small size) ---------------------------

def _card_batch(root, family, cuda):
    import chip_smoke

    return {k: v.cpu().numpy() for k, v in
            chip_smoke.train_dataset(root, family, cuda).get_batch(np.arange(4)).items()}


def test_data_parallel_trainer_at_world_size_one_equals_the_plain_one(cuda, train_set):
    """(a) at batch 4 (two steps of the 8-frame set): PoP-Net's Trainer over
    a mesh of one rank over NCCL, losses and parameters bit for bit."""
    import chip_smoke
    from popnet_tpu_torch.parallel import distributed

    with distributed.single_rank_job(cuda):
        a = chip_smoke.parallel_trainers(train_set, cuda, 4)
    assert a["loss"][0] == a["loss"][1] and a["gap"] == 0.0, a


def test_data_parallel_over_gloo_with_two_ranks_on_one_card(cuda, train_set):
    """(b) at 2 frames a rank: two processes on cuda:0 over gloo against
    world size 1 (loss rtol 1e-5, parameters 1e-5)."""
    import chip_smoke

    g = chip_smoke.parallel_gloo(_card_batch(train_set, "popnet", cuda), cuda)
    assert "error" not in g, g.get("error")
    assert abs(g["loss"][1] - g["loss"][0]) <= 1e-5 * abs(g["loss"][0]) and g["gap"] <= 1e-5, g


def test_tensor_spatial_and_pipeline_at_group_size_one(cuda, train_set):
    """(c) at 4 frames: model=1 and spatial=1 equal the plain paths bit for
    bit, pipe=1 within 1e-5 of the sequential eval-mode model, forward,
    loss and the state after one step."""
    import chip_smoke
    from popnet_tpu_torch.parallel import distributed

    frames = np.random.default_rng(3).uniform(-1.5, 1.5, (1, 1, 512, 480)).astype(np.float32)
    with distributed.single_rank_job(cuda):
        c = chip_smoke.parallel_group_of_one(train_set, cuda,
                                             _card_batch(train_set, "openpose", cuda), frames)
    assert c["tp_loss"][0] == c["tp_loss"][1] and c["tp_gap"] == 0.0, c
    assert c["sp_gap"] == 0.0 and c["pp_gap"] <= 1e-5, c
    assert abs(c["pp_loss"][1] - c["pp_loss"][0]) <= 1e-5 * abs(c["pp_loss"][0]), c
    assert c["pp_state_gap"] <= 1e-5, c


def test_roi_batch_on_the_card_equals_the_cpu(cuda, train_set):
    """A ROIDataset batch of 8 frames made on the card against the CPU's
    from the same seed: image, z-maps and masks bit for bit, the other maps
    within 2e-6, the generators equal."""
    import chip_smoke
    from popnet_tpu_torch.data.datasets import ROIDataset

    dss = {d: ROIDataset(os.path.join(train_set, "depth_maps"),
                         os.path.join(train_set, "labels.json"), seed=3, device=d)
           for d in (cuda, "cpu")}
    idx = np.arange(8)
    card, host = dss[cuda].get_batch(idx), dss["cpu"].get_batch(idx)
    assert chip_smoke.compare_batches("roi", card, host) <= chip_smoke.TARGETS_BAR
    assert dss[cuda].rng.bit_generator.state == dss["cpu"].rng.bit_generator.state


def test_visualizers_draw_the_same_image_from_the_card(cuda):
    """The grey map and the seg overlay made on the card equal the CPU's
    bit for bit (IEEE float64 on both), and so do the drawn skeletons."""
    from popnet_tpu_torch.viz import depth_to_gray, overlay_seg, visualize_gt, visualize_pred

    rng = np.random.default_rng(17)
    depth = torch.from_numpy(rng.uniform(-1, 8, (512, 480)))
    seg = torch.from_numpy((rng.random((512, 480)) < 0.3).astype(np.uint8))
    grey = depth_to_gray(depth.to(cuda))
    assert grey.device.type == "cuda" and torch.equal(grey.cpu(), depth_to_gray(depth))
    assert torch.equal(overlay_seg(grey, seg, color=(10, 200, 77), alpha=0.3).cpu(),
                       overlay_seg(grey.cpu(), seg, color=(10, 200, 77), alpha=0.3))
    humans = [rng.uniform(-20, 500, (15, 2)) for _ in range(3)]
    anns = [{"2d_joints": h.tolist()} for h in humans]
    vis = rng.uniform(0, 1, (3, 15))
    assert np.array_equal(visualize_pred(depth.to(cuda), humans, vis),
                          visualize_pred(depth, humans, vis))
    assert np.array_equal(visualize_gt(depth.to(cuda), anns, seg), visualize_gt(depth, anns, seg))
