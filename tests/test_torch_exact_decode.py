"""The exact host decode of the port (popnet_tpu_torch.decode.peaks_np,
paf_np, human_list, align and run_openpose_eval(fast=False)) against the
JAX package's on the CPU, and its cv2-free bicubic upsample against
cv2 5.0.0.

cv2.resize(INTER_CUBIC) of a float32 image runs cv2's own code for images
of more than 4 channels or a side under 4 pixels, and Intel IPP's for the
rest (the 4x4 to 5x5 refine patches) where its build has IPP. The port
equals cv2's own code bit for bit; IPP rounds apart by a few ulps. So the
decode is held to JAX's exactly with IPP off, and with cv2's default the
refined peak positions still equal JAX's on every map here (0 of 18,850
peaks flip on painted, noisy and uniform maps), the scores within 4 ulps."""


import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from popnet_tpu.cli import evaluate as jev
from popnet_tpu.data.datasets import MPRealDataset as JaxDataset
from popnet_tpu.decode import align as jalign
from popnet_tpu.decode import paf_np as jpaf
from popnet_tpu.decode import peaks_np as jpeaks
from popnet_tpu.decode.human_list import paf_to_human_list as j_human_list
from popnet_tpu_torch.cli import evaluate as pev
from popnet_tpu_torch.data.datasets import MPRealDataset
from popnet_tpu_torch.decode import align as palign
from popnet_tpu_torch.decode import paf_np as ppaf
from popnet_tpu_torch.decode import peaks_np as ppeaks
from popnet_tpu_torch.decode.human_list import paf_to_human_list as p_human_list

import chip_smoke
from tests import synthetic_data

CV2_VERSION = "5.0.0"   # the version whose rounding the upsample is held against
BATCH = 4
SCORE_ULPS = 4 * 2.0 ** -23   # cv2's IPP refine against cv2's own code, of a score near 1


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ipp_off():
    """cv2's own code for every resize of the test (restored after)."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _cv2_cubic(img, f: int = 8):
    return cv2.resize(img, None, fx=f, fy=f, interpolation=cv2.INTER_CUBIC)


def test_cv2_is_the_version_held_against():
    assert cv2.__version__ == CV2_VERSION, (
        f"the upsample is held against cv2 {CV2_VERSION}'s rounding; this is {cv2.__version__}")


SHAPES = [(5, 5), (4, 5), (5, 4), (4, 4), (3, 5), (5, 3), (3, 3), (3, 4), (28, 28, 28),
          (28, 28), (46, 46, 38)]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_resize_cubic_equals_cv2_bit_for_bit(shape, ipp_off):
    """resize_cubic by 8 equals cv2.resize INTER_CUBIC (cv2's own code) bit
    for bit on float32 images of four scales, the decode's refine patches
    and PAF stacks among them."""
    rng = np.random.default_rng(sum(shape))
    for scale in (1e-3, 0.1, 1.0, 30.0):
        img = (rng.normal(0, 1, shape) * scale).astype(np.float32)
        got, ref = ppeaks.resize_cubic(img, 8), _cv2_cubic(img)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.array_equal(got, ref), (scale, int((got != ref).sum()))


def test_resize_cubic_beside_cv2_with_ipp():
    """With cv2's default, the PAF stack (28 channels) and patches with a
    side of 3 still go through cv2's own code and equal the port's; the
    patches of at least 4x4 go through IPP and lie within a few ulps."""
    rng = np.random.default_rng(3)
    for shape in [(28, 28, 28), (3, 5), (5, 3)]:
        img = rng.normal(0, 1, shape).astype(np.float32)
        assert np.array_equal(ppeaks.resize_cubic(img, 8), _cv2_cubic(img)), shape
    worst = 0.0
    for shape in [(5, 5), (4, 5), (5, 4), (4, 4)]:
        img = rng.uniform(0, 1, shape).astype(np.float32)
        ref = _cv2_cubic(img)
        worst = max(worst, float(np.abs(ppeaks.resize_cubic(img, 8) - ref).max()
                                 / np.abs(ref).max()))
    assert worst <= 8 * 2.0 ** -23, worst


def _painted(rng, n: int):
    """chip_smoke's painted Open-Pose+ maps of n person frames (2-3 people)."""
    _, people = chip_smoke.person_frames(rng, n, "cpu", people=True)
    anns = [[{"2d_joints": people["joints2d"][b, p].tolist(),
              "3d_joints": np.c_[people["joints2d"][b, p], people["z"][b, p]].tolist()}
             for p in np.flatnonzero(people["present"][b])] for b in range(n)]
    return chip_smoke.openpose_painted_maps(anns)


@pytest.fixture(scope="module")
def maps():
    """Painted maps of 8 frames, the same with noise, and uniform heat:
    (heat (n, 28, 28, 16), paf (n, 28, 28, 28)) float64 each."""
    rng = np.random.default_rng(11)
    heat, paf, _ = _painted(rng, 8)
    noisy = np.clip(heat + rng.normal(0, 0.05, heat.shape), 0, None)
    uniform = rng.uniform(0, 1, (2, 28, 28, 16))
    return {"painted": (heat, paf), "noisy": (noisy, paf),
            "uniform": (uniform, rng.uniform(-1, 1, (2, 28, 28, 28)))}


def _assert_peaks(got, ref, score_atol: float):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.array_equal(g[:, [0, 1, 3]], r[:, [0, 1, 3]])
        np.testing.assert_allclose(g[:, 2], r[:, 2], rtol=0, atol=score_atol)


@pytest.mark.parametrize("kind", ["painted", "noisy", "uniform"])
def test_nms_heatmaps_matches_jax(maps, kind):
    """nms_heatmaps against JAX's: equal with cv2's own code; with cv2's
    default (IPP), the same peaks and refined positions, the scores within
    4 ulps."""
    heat = maps[kind][0]
    was = cv2.ipp.useIPP()
    try:
        for ipp, atol in ((False, 0.0), (True, SCORE_ULPS)):
            cv2.ipp.setUseIPP(ipp)
            for h in heat:
                _assert_peaks(ppeaks.nms_heatmaps(h), jpeaks.nms_heatmaps(h), atol)
    finally:
        cv2.ipp.setUseIPP(was)
    assert sum(len(p) for p in ppeaks.nms_heatmaps(heat[0])) >= 15


def test_find_peaks_top_n_and_coords_match_jax(maps):
    heat = maps["noisy"][0][0, ..., 3]
    for top_n in (None, 1, 4):
        assert np.array_equal(ppeaks.find_peaks(0.1, heat, top_n),
                              jpeaks.find_peaks(0.1, heat, top_n))
    c = np.array([[3, 7], [0, 27]])
    assert np.array_equal(ppeaks.compute_resized_coords(c, 8), jpeaks.compute_resized_coords(c, 8))


@pytest.mark.parametrize("kind", ["painted", "noisy"])
def test_paf_to_pose_matches_jax(maps, kind, ipp_off):
    """paf_to_pose (peaks, the PAF upsample, the pair integrals, the greedy
    merge) and paf_to_human_list equal JAX's exactly with cv2's own code,
    on every frame."""
    heat, paf = maps[kind]
    people = 0
    for h, p in zip(heat, paf):
        jl, rows = ppaf.paf_to_pose(h, p)
        rjl, rrows = jpaf.paf_to_pose(h, p)
        assert np.array_equal(jl, rjl) and np.array_equal(rows, rrows)
        got, ref = p_human_list(jl, rows), j_human_list(rjl, rrows)
        assert got == ref
        people += len(rows)
    assert people >= 2 * len(heat) if kind == "painted" else people > 0


def test_paf_helpers_match_jax(ipp_off):
    """find_connected_joints and group_limbs_of_same_person on uniform maps
    of 12x12 cells (many candidates a limb) equal JAX's."""
    rng = np.random.default_rng(5)
    h, p = rng.uniform(0, 1, (12, 12, 16)), rng.uniform(-1, 1, (12, 12, 28))
    peaks = ppeaks.nms_heatmaps(h)
    up = ppeaks.resize_cubic(p, 8)
    got = ppaf.find_connected_joints(up, peaks)
    ref = jpaf.find_connected_joints(up, peaks)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.array_equal(np.asarray(g), np.asarray(r))
    jl = np.array([tuple(pk) + (t,) for t, pks in enumerate(peaks) for pk in pks])
    assert np.array_equal(ppaf.group_limbs_of_same_person(got, jl),
                          jpaf.group_limbs_of_same_person(ref, jl))


@pytest.fixture(scope="module")
def kdh3d_set(tmp_path_factory):
    return synthetic_data.build(str(tmp_path_factory.mktemp("exact_decode")), n_images=8)


def _feeder(batches, to):
    pos = {"i": 0}

    def infer(images):
        heat, paf = batches[pos["i"]]
        pos["i"] += 1
        z = np.full(heat.shape[:3] + (15,), 0.25, np.float32)
        return to(paf.astype(np.float32)), to(heat.astype(np.float32)), to(z)

    return infer


@pytest.mark.parametrize("ipp", [False, True], ids=["cv2_own_code", "cv2_default"])
def test_run_openpose_eval_exact_decode_matches_jax(kdh3d_set, maps, ipp):
    """run_openpose_eval(fast=False) against the JAX driver's exact decode on
    the same painted maps: with cv2's own code every key equal; with cv2's
    default the 2D joints, visibility and every 3D channel equal, the
    confidences within 4 ulps."""
    heat, paf = maps["painted"]
    batches = [(heat[s:s + BATCH], paf[s:s + BATCH]) for s in range(0, 8, BATCH)]
    pds = MPRealDataset(kdh3d_set["img_dir"], kdh3d_set["labels"], device="cpu")
    jds = JaxDataset(kdh3d_set["img_dir"], kdh3d_set["labels"])
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        got = pev.run_openpose_eval(_feeder(batches, torch.from_numpy), pds, BATCH, fast=False)
        ref = jev.run_openpose_eval(_feeder(batches, jnp.asarray), jds, BATCH, fast=False)
    finally:
        cv2.ipp.setUseIPP(was)
    assert sorted(got) == sorted(ref) and sum(len(h) for h in got["human_pred_set_2d"]) >= 16
    for k in ref:
        if k == "human_pred_set_part_conf" and ipp:
            for a, b in zip(got[k], ref[k]):
                np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=0,
                                           atol=SCORE_ULPS)
        else:
            assert got[k] == ref[k], k


def test_painted_oracle_through_the_exact_decode_clears_the_bars(tmp_path):
    """chip_smoke's painted Open-Pose+ oracle through run_openpose_eval(
    fast=False) clears tests/test_e2e_eval.py's bars, which the card's
    phase 11 holds it to."""
    frames, people = chip_smoke.person_frames(np.random.default_rng(12), 8, "cpu", people=True)
    img_dir, labels = chip_smoke.write_eval_set(str(tmp_path), frames, people)
    m, abl = chip_smoke.painted_oracle((img_dir, labels), "cpu", BATCH, False, fast=False)
    assert all(m[k] > bar for k, bar in chip_smoke.ORACLE_BARS.items()), m
    assert abl["perfect_2d"] > 0.95


@pytest.mark.parametrize("case", ["peaks", "visibility", "top_n"])
def test_universe_align_map_matches_jax(case):
    """universe_align_map equals JAX's on random heat and align maps: with
    peaks on some joints only, with a visibility vector, with top_n."""
    rng = np.random.default_rng({"peaks": 0, "visibility": 1, "top_n": 2}[case])
    heat = rng.uniform(0, 0.45, (28, 28, 16))
    for j in range(0, 15, 2):
        for _ in range(rng.integers(1, 4)):
            heat[rng.integers(0, 28), rng.integers(0, 28), j] = rng.uniform(0.6, 1.0)
    align = rng.normal(0, 2, (28, 28, 30)).astype(np.float32)
    kw = {"visibility": (rng.uniform(size=15) > 0.3).astype(float)} if case == "visibility" \
        else ({"top_n": 1} if case == "top_n" else {})
    got = palign.universe_align_map(heat, align, 15, 2, **kw)
    ref = jalign.universe_align_map(heat, align, 15, 2, **kw)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert not np.array_equal(got, align)
