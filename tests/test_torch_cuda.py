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
    too: the CTA holds it in one round of one plane and stays bit-equal;
    planes too large for the shared memory still raise."""
    heat = torch.as_tensor(sparse_heat(9, 2, 195, 195, 1), device=cuda)
    for a, b in zip(kernels.find_peaks_row(heat), kernels.find_peaks_plain(heat)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernels.find_peaks_row(torch.rand((1, 1, 255, 255), device=cuda))


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
