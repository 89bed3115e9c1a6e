"""The port's decode kernels: plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode on the CPU) and XLA paths. The
CUDA kernels against their plain versions: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from popnet_tpu.decode.assemble_device import assemble_batched as jax_assemble
from popnet_tpu.decode.assemble_pallas import assemble_ids_pallas
from popnet_tpu.decode.device import find_peaks_batched as jax_find_peaks
from popnet_tpu.decode.device import score_limb_pairs_batched as jax_score_pairs
from popnet_tpu.decode.openpose_infer import window_readout_heat_weighted as jax_window
from popnet_tpu.ops.pallas_kernels import (
    find_peaks_pallas,
    find_peaks_pallas_bt,
    paf_sample_pallas,
    peak_local_max_pallas,
    point_readout_pallas,
    window_readout_pallas,
)
from popnet_tpu.ops.pallas_kernels import peak_mask as jax_peak_mask
from popnet_tpu_torch.core.skeleton import LIMBS, NUM_JOINTS
from popnet_tpu_torch.decode.assemble_device import assemble_batched
from popnet_tpu_torch.decode.device import find_peaks_batched, score_limb_pairs_batched
from popnet_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def peak_heat(seed, B, K=15):
    """(B, K, 28, 28) uniform heat with an exact tie, border peaks and a
    plane with no peak above the threshold (not a flat one: on a flat plane
    the refine argmax of the invalid slots is decided by rounding)."""
    heat = np.random.default_rng(seed).uniform(0, 1, (B, K, 28, 28)).astype(np.float32)
    heat[0, 0, 5, 5] = heat[0, 0, 5, 9] = 0.9      # exact tie: pick order must match
    heat[0, 1, 0, 3] = heat[0, 2, 27, 27] = 5.0    # border peaks
    heat[B - 1, 3, 5, 0] = 5.0
    heat[B - 1, 4] *= 0.09                         # below threshold everywhere
    return heat


@pytest.fixture(scope="module")
def heat2():
    """Two frames: the shape of the flat-plane case below, so the batch-tiled
    Pallas kernel compiles once for both."""
    return peak_heat(11, 2)


@pytest.mark.parametrize("which", ["bt", "row"])
def test_find_peaks_plain_matches_pallas(heat2, which):
    """px, py, loc and valid exact (invalid slots included), score 1e-5."""
    if which == "bt":
        ref = find_peaks_pallas_bt(jnp.asarray(heat2), bt=2, interpret=True)
    else:
        ref = find_peaks_pallas(jnp.asarray(heat2), interpret=True)
    got = kernels.find_peaks_plain(torch.from_numpy(heat2))
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-5)
    assert not got[4][1, 4].any() and got[4][0].sum() > 0


@pytest.mark.parametrize("H,W", [(260, 9), (9, 260)])
def test_find_peaks_plain_matches_pallas_on_maps_over_255_cells(H, W):
    """One plane with a side over 255 cells (the maps find_peaks_plane takes
    on the card) against the per-frame Pallas kernel, which takes any size:
    px, py, loc and valid exact, score 1e-5; an exact tie among the top
    values and a peak on the far border, past cell 255."""
    heat = np.random.default_rng(H * 1000 + W).uniform(0, 1, (1, 1, H, W)).astype(np.float32)
    heat[0, 0, H - 1, W - 1] = 3.0                 # far corner, flat index over 255 * 255
    heat[0, 0, 4, 2] = heat[0, 0, H - 5, W - 3] = 2.0  # exact tie: the lower flat index first
    ref = find_peaks_pallas(jnp.asarray(heat), interpret=True)
    got = kernels.find_peaks_plain(torch.from_numpy(heat))
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-5)
    assert got[4].all()
    assert (int(got[0][0, 0, 0]), int(got[1][0, 0, 0])) == (W - 1, H - 1)
    assert (int(got[0][0, 0, 1]), int(got[1][0, 0, 1])) == (2, 4)


def test_find_peaks_on_a_flat_plane_agrees_with_pallas_but_for_the_tied_refine():
    """The documented tolerance case of the peak refine. On a plane of one
    value below the threshold every slot is invalid and refines the corner
    (0, 0) over a window whose upsampled values are all equal up to
    rounding, so their argmax `loc` is decided by the rounding order: the
    Pallas kernel's patch @ Q and the port's separable U * patch * U^T may
    pick different cells (here 663 and 858, scores 0.050000004 and
    0.05000001). valid and every valid slot's outputs agree exactly, the
    invalid slots' px and py too, and every score within 1e-5."""
    heat = peak_heat(11, 2)
    heat[1, 6] = 0.05                              # the flat plane
    ref = [np.asarray(a) for a in find_peaks_pallas_bt(jnp.asarray(heat), bt=2, interpret=True)]
    got = [a.numpy() for a in kernels.find_peaks_plain(torch.from_numpy(heat))]
    valid = ref[4]
    np.testing.assert_array_equal(got[4], valid)
    assert valid.sum() > 20 and not valid[1, 6].any()
    for i in (0, 1, 2):
        np.testing.assert_array_equal(got[i][valid], ref[i][valid])
    for i in (0, 1):
        np.testing.assert_array_equal(got[i][~valid], 0)
        np.testing.assert_array_equal(ref[i][~valid], 0)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-5)
    np.testing.assert_allclose(got[3][1, 6], 0.05, atol=1e-5)


def test_find_peaks_batched_matches_xla(heat2):
    heat = np.concatenate([heat2, np.zeros_like(heat2[:, :1])], 1).transpose(0, 2, 3, 1)
    pk_x, v_x = jax_find_peaks(jnp.asarray(heat), refine="xla")
    pk, v = find_peaks_batched(torch.from_numpy(np.ascontiguousarray(heat)))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_x))
    np.testing.assert_allclose(pk.numpy(), np.asarray(pk_x), atol=1e-5)


@pytest.fixture(scope="module")
def pair_case():
    rng = np.random.default_rng(7)
    heat = rng.uniform(0, 1, (2, 28, 28, 16)).astype(np.float32)
    paf = rng.uniform(-1, 1, (2, 28, 28, 28)).astype(np.float32)
    peaks, valid = jax_find_peaks(jnp.asarray(heat))
    return paf, np.asarray(peaks), np.asarray(valid)


def test_paf_line_sums_plain_matches_pallas(pair_case):
    """Sums within 1e-4, counts exact, against paf_sample_pallas on the same
    pair geometry and the same edge-padded planes."""
    paf, peaks, valid = pair_case
    B, H, W, C = paf.shape
    L, M = C // 2, peaks.shape[2]
    sx, sy, dx, dy, _, ux, uy = kernels._pair_geometry(torch.from_numpy(peaks), LIMBS)
    geo = [a.reshape(B, L, M * M) for a in (sx, sy, dx, dy, ux, uy)]
    pafp = np.pad(paf.transpose(0, 3, 1, 2).reshape(B, L, 2, H, W),
                  ((0, 0), (0, 0), (0, 0), (2, 2), (2, 2)), mode="edge")
    ref_sum, ref_cnt = paf_sample_pallas(
        jnp.asarray(pafp.transpose(0, 1, 2, 4, 3)), *[jnp.asarray(g.numpy()) for g in geo],
        interpret=True)
    got_sum, got_cnt = kernels.paf_line_sums_plain(torch.from_numpy(paf), *geo)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(ref_cnt))
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(ref_sum), atol=1e-4)


@pytest.mark.parametrize("method", ["pallas", "onehot"])
def test_paf_score_plain_matches_jax(pair_case, method):
    paf, peaks, valid = pair_case
    ref_s, ref_ok = jax_score_pairs(jnp.asarray(paf), jnp.asarray(peaks), jnp.asarray(valid),
                                    method=method)
    got_s, got_ok = score_limb_pairs_batched(torch.from_numpy(paf), torch.from_numpy(peaks),
                                             torch.from_numpy(valid))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5)
    assert got_ok.any()


def test_paf_taps_beyond_the_pad_read_zero():
    """A line point far off the map: its taps fall outside the 2-wide edge
    pad and contribute 0 instead of the clamped edge value."""
    paf = torch.ones((1, 28, 28, 2))
    geo = [torch.tensor([[[v]]], dtype=torch.float32) for v in (-60.0, 100.0, 0.0, 0.0, 1.0, 0.0)]
    s, c = kernels.paf_line_sums_plain(paf, *geo)
    assert float(s) == 0.0 and float(c) == 0.0
    geo[0] = torch.tensor([[[-17.0]]])        # lx = -2.5: taps at padded -2..1, two inside
    s, _ = kernels.paf_line_sums_plain(paf, *geo)
    assert 0.0 < float(s) < 10.0


@pytest.mark.parametrize("radius", [1, 2])
def test_window_readout_plain_matches_pallas(radius):
    """1e-5 including border-shrunken and collapsed (off-map centre) windows,
    at the decode's radius 1 and at radius 2."""
    rng = np.random.default_rng(3)
    B, H, W, K, P = 2, 28, 28, 15, 6
    z = rng.uniform(0.5, 6.0, (B, H, W, K)).astype(np.float32)
    heat = rng.uniform(-0.2, 1.0, (B, H, W, K)).astype(np.float32)
    cx = rng.integers(-3, W + 3, (B, P, K)).astype(np.int32)
    cy = rng.integers(-3, H + 3, (B, P, K)).astype(np.int32)
    ref = jax_window(jnp.asarray(z), jnp.asarray(heat), jnp.asarray(cx), jnp.asarray(cy),
                     radius=radius, use_pallas=True)
    got = kernels.window_readout_plain(*(torch.from_numpy(a) for a in (z, heat, cx, cy)),
                                       radius=radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_point_readout_plain_matches_pallas():
    rng = np.random.default_rng(5)
    B, H, W, P = 3, 64, 48, 17
    img = rng.uniform(0.5, 6.0, (B, H, W)).astype(np.float32)
    cx = rng.integers(0, W, (B, P)).astype(np.int32)
    cy = rng.integers(0, H, (B, P)).astype(np.int32)
    ref = point_readout_pallas(jnp.asarray(img), jnp.asarray(cx), jnp.asarray(cy), interpret=True)
    got = kernels.point_readout_plain(*(torch.from_numpy(a) for a in (img, cx, cy)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius", [1, 2])
def test_readouts_plain_matches_pallas(radius, dtype):
    """The fused readouts' plain version against the JAX composition: the
    Pallas window and point readouts (interpret mode) of z * std + mean and
    img * std + mean at the joints' centres trunc(x / 8) and points
    trunc(clip(x)); normalized z and image in float32 or bfloat16 (the same
    rounded values on both sides), joints off the maps and at holes
    included. 1e-5 for both outputs, K4's bar: XLA on the CPU may contract
    the affine into one rounding, so the points are not held exact here (on
    the card the kernel is held exact against this plain version)."""
    rng = np.random.default_rng(17)
    B, H, W, K, P, Hi, Wi = 2, 28, 28, 15, 6, 64, 48
    std, mean = 2.0, 3.0
    z = rng.uniform(-1.5, 1.5, (B, H, W, K)).astype(np.float32)
    heat = rng.uniform(-0.2, 1.0, (B, H, W, K)).astype(np.float32)
    img = rng.uniform(-1.5, 1.5, (B, Hi, Wi)).astype(np.float32)
    joints = rng.uniform(-20, 260, (B, P, K, 3)).astype(np.float32)
    joints[:, 0, :, :2] = -1.0                     # holes
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    z_t, img_t = torch.from_numpy(z).to(tdt), torch.from_numpy(img).to(tdt)
    z_j, img_j = (jnp.asarray(a, dtype=jdt).astype(jnp.float32) for a in (z, img))
    gx, gy = (np.trunc(joints[..., i] / 8).astype(np.int32) for i in (0, 1))
    rx = np.trunc(np.clip(joints[..., 0], 0, Wi - 1)).astype(np.int32).reshape(B, P * K)
    ry = np.trunc(np.clip(joints[..., 1], 0, Hi - 1)).astype(np.int32).reshape(B, P * K)
    ref_pose = window_readout_pallas(z_j * std + mean, jnp.asarray(heat), jnp.asarray(gx),
                                     jnp.asarray(gy), radius=radius, interpret=True)
    ref_raw = point_readout_pallas(img_j * std + mean, jnp.asarray(rx), jnp.asarray(ry),
                                   interpret=True)
    got_pose, got_raw = kernels.readouts_plain(z_t, torch.from_numpy(heat),
                                               torch.from_numpy(joints), img_t, std, mean,
                                               radius=radius)
    assert got_pose.shape == got_raw.shape == (B, P, K)
    np.testing.assert_allclose(got_pose.numpy(), np.asarray(ref_pose), atol=1e-5)
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(ref_raw).reshape(B, P, K), atol=1e-5)
    got = kernels.readouts(z_t, torch.from_numpy(heat), torch.from_numpy(joints), img_t, std,
                           mean, radius=radius)             # on the CPU: the plain version
    assert torch.equal(got[0], got_pose) and torch.equal(got[1], got_raw)


def plateau_heat(seed, N, H=28, W=28):
    """(N, H, W) heat quantized to 1/8 so equal neighbours are common, with
    a flat plateau, a plateau touching two borders, corner and edge maxima,
    and a constant plane."""
    heat = np.round(np.random.default_rng(seed).uniform(0, 1, (N, H, W)) * 8) / 8
    heat[0, 4:7, 4:8] = 2.0                        # interior plateau: every cell is marked
    heat[0, 0:2, W - 3:] = 2.0                     # plateau on the top and right borders
    heat[1, 0, 0] = heat[1, H - 1, W - 1] = heat[1, H - 1, 5] = heat[1, 9, 0] = 3.0
    heat[2] = 0.5                                  # constant plane: all cells marked
    return heat.astype(np.float32)


def test_peak_local_max_plain_matches_pallas():
    """Exact, ties (plateaus) and borders included."""
    heat = plateau_heat(0, 4)
    ref = np.asarray(peak_local_max_pallas(jnp.asarray(heat), interpret=True)) > 0
    got = kernels.peak_local_max_plain(torch.from_numpy(heat)[None])[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 4:7, 4:8].all() and got[0, 0:2, 25:].all() and got[2].all()
    assert got[1, 0, 0] and got[1, 27, 27] and got[1, 27, 5] and got[1, 9, 0]
    assert 0.05 < got[3].mean() < 0.6


@pytest.mark.parametrize("thresh", [0.5, 0.1])
def test_peak_mask_matches_jax(thresh):
    """Exact against the JAX package's XLA branch on (B, H, W, C) maps; a
    strided (channel-sliced) input gives the same mask."""
    heat = plateau_heat(1, 2 * 16).reshape(2, 16, 28, 28).transpose(0, 2, 3, 1)
    ref = np.asarray(jax_peak_mask(jnp.asarray(heat[..., :15]), thresh, use_pallas=False))
    got = kernels.peak_mask(torch.from_numpy(np.ascontiguousarray(heat))[..., :15], thresh)
    assert got.dtype == torch.bool and got.shape == (2, 28, 28, 15)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any() and not ref.all()


def _assembly_case(family, seed):
    """(peaks, valid, scores, ok) of the three case families of the JAX
    package's assembly tests: decoded synthetic scenes, dense random
    candidates (long merge chains, overflow past max_people), nothing; and
    two more: `ties`, pair scores quantized to 1/8 with +0.0 and -0.0 among
    them and a limb whose 256 pairs are all candidates (the greedy matching
    must pick equal scores by the lower flat index, +0.0 equal to -0.0), and
    `slots`, where each limb's candidates pair peaks that no limb before it
    used, so every accepted connection opens a slot (56 a frame)."""
    B, K, M, L = 3, NUM_JOINTS, 16, len(LIMBS)
    if family == "synth":
        from tests.test_decode_device import synth

        heat, paf = synth(seed, 2 + seed % 4, B=B)
        peaks, valid = jax_find_peaks(jnp.asarray(heat))
        scores, ok = jax_score_pairs(jnp.asarray(paf), peaks, valid)
        return tuple(np.asarray(a) for a in (peaks, valid, scores, ok))
    if family == "empty":
        return (np.zeros((B, K, M, 3), np.float32), np.zeros((B, K, M), bool),
                np.zeros((B, L, M, M), np.float32), np.zeros((B, L, M, M), bool))
    rng = np.random.default_rng(seed)
    if family in ("ties", "slots"):
        peaks = np.zeros((B, K, M, 3), np.float32)
        peaks[..., :2] = rng.uniform(0, 223, size=(B, K, M, 2))
        peaks[..., 2] = rng.uniform(0.1, 1.0, size=(B, K, M))
        valid = np.ones((B, K, M), bool)
        if family == "ties":
            scores = (np.round(rng.uniform(-0.25, 1.0, (B, L, M, M)) * 8) / 8).astype(np.float32)
            zero = scores == 0
            scores[zero] = np.where(rng.uniform(size=int(zero.sum())) < 0.5, -0.0, 0.0)
            ok = rng.uniform(size=(B, L, M, M)) < 0.5
            ok[:, 4] = True
            assert np.signbit(scores[ok & zero]).any() and not np.signbit(scores[ok & zero]).all()
        else:
            scores = rng.uniform(0.01, 2.0, size=(B, L, M, M)).astype(np.float32)
            ok = np.zeros((B, L, M, M), bool)
            used = np.zeros(K, int)
            for limb, (a, c) in enumerate(LIMBS):
                ok[:, limb, used[a]:used[a] + 4, used[c]:used[c] + 4] = True
                used[a] += 4
                used[c] += 4
        return peaks, valid, scores, ok
    density = (0.08, 0.3, 0.7, 1.0)[seed % 4]
    n_valid = rng.integers(0, M + 1, size=(B, K))
    valid = np.arange(M)[None, None, :] < n_valid[:, :, None]
    peaks = np.zeros((B, K, M, 3), np.float32)
    peaks[..., :2] = rng.uniform(0, 223, size=(B, K, M, 2))
    peaks[..., 2] = rng.uniform(0.1, 1.0, size=(B, K, M))
    peaks[~valid] = 0.0
    scores = rng.uniform(0.01, 2.0, size=(B, L, M, M)).astype(np.float32)
    scores[0, 3, 2, 5] = scores[0, 3, 7, 1] = scores[0, 3, 7, 9] = 1.75   # tied pair scores
    ok = rng.uniform(size=(B, L, M, M)) < density
    limbs = np.asarray(LIMBS)
    ok &= valid[:, limbs[:, 0]][:, :, :, None] & valid[:, limbs[:, 1]][:, :, None, :]
    return peaks, valid, scores, ok


@pytest.mark.parametrize("family,seed", [("synth", 0), ("synth", 5), ("dense", 0), ("dense", 1),
                                         ("dense", 2), ("dense", 3), ("empty", 0), ("ties", 0),
                                         ("ties", 1), ("slots", 0)])
def test_assemble_ids_plain_matches_pallas_and_scan(family, seed):
    """ids and counts exact against assemble_ids_pallas (interpret mode);
    the joints that follow exact against the JAX scan. The `slots` case
    keeps its two-joint slots (min_parts=2) in 40 rows."""
    peaks, valid, scores, ok = _assembly_case(family, seed)
    s_masked = np.where(ok, scores, -np.inf).astype(np.float32)
    kw = dict(max_people=40, min_parts=2, min_score=0.0) if family == "slots" else {}
    ref_ids, ref_cnt = assemble_ids_pallas(jnp.asarray(peaks[..., 2]), jnp.asarray(s_masked),
                                           limbs=LIMBS, interpret=True, **kw)
    got_ids, got_cnt = kernels.assemble_ids_plain(
        torch.from_numpy(np.ascontiguousarray(peaks[..., 2])), torch.from_numpy(s_masked), LIMBS,
        **kw)
    assert got_ids.dtype == torch.int32
    assert got_ids.shape == (3, kw.get("max_people", 16), NUM_JOINTS)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(ref_cnt))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
    scan_j, scan_c = jax_assemble(*(jnp.asarray(a) for a in (peaks, valid, scores, ok)),
                                  method="scan", **kw)
    for method in (None, "kernel", "scan"):        # on CPU tensors all three are the plain loops
        j, c = assemble_batched(*(torch.from_numpy(a) for a in (peaks, valid, scores, ok)),
                                method=method, **kw)
        np.testing.assert_array_equal(c.numpy(), np.asarray(scan_c))
        np.testing.assert_array_equal(j.numpy(), np.asarray(scan_j))
    if family == "slots":
        assert (got_cnt == 40).all()                # 56 slots a frame, 40 rows kept
    if family == "empty":
        assert (got_cnt == 0).all() and (got_ids == -1).all()
    else:
        assert got_cnt.sum() > 0


@pytest.mark.parametrize("grid,max_peaks", [((28, 28), 16), ((12, 10), 32)])
def test_find_peaks_row_path_matches_pallas_row(grid, max_peaks):
    """find_peaks_batched(refine="kernel_row") against the JAX package's
    per-frame kernel (refine="pallas_row", interpret mode): valid exact,
    x and y exact up to rounding and score within 1e-5."""
    H, W = grid
    heat = np.random.default_rng(13).uniform(0, 1, (2, H, W, 16)).astype(np.float32)
    heat[0, 3, 3, 0] = heat[0, 3, 7, 0] = 0.95     # exact tie
    heat[0, 0, 2, 1] = heat[1, H - 1, W - 1, 2] = 5.0
    heat[1, :, :, 4] *= 0.09
    ref_pk, ref_v = jax_find_peaks(jnp.asarray(heat), max_peaks=max_peaks, refine="pallas_row")
    got_pk, got_v = find_peaks_batched(torch.from_numpy(heat), max_peaks=max_peaks,
                                       refine="kernel_row")
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(got_pk.numpy(), np.asarray(ref_pk), atol=1e-5)
    assert not got_v[1, 4].any() and got_v[0, 0].sum() > 1
    with pytest.raises(ValueError, match="unknown refine"):
        find_peaks_batched(torch.from_numpy(heat), refine="pallas")


@pytest.mark.parametrize("B,K,H,W,M", [(1, 2, 46, 62, 32), (1, 1, 69, 46, 16)])
def test_find_peaks_plain_matches_pallas_on_band_edges(B, K, H, W, M):
    """One frame of a COCO evaluation canvas (the maps that find_peaks_plane
    takes on the card, its rows in bands over 8 CTAs) with peaks, a plateau
    across the edge and values equal in every band on the rows where two
    bands meet (chip_smoke.band_edge_heat): the plain version, the card's
    reference, against the per-frame Pallas kernel; px, py, loc and valid
    exact, score 1e-5, the plane's top-M taken across the edges."""
    from chip_smoke import band_edge_heat

    share = -(-H // 8)
    heat = band_edge_heat(np.random.default_rng(H * W + M), B, K, H, W, range(share, H, share))
    ref = find_peaks_pallas(jnp.asarray(heat), max_peaks=M, interpret=True)
    got = kernels.find_peaks_plain(torch.from_numpy(heat), max_peaks=M)
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-5)
    assert int(got[4].sum(-1).min()) == min(M, 35)
