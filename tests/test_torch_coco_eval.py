"""Port vs JAX on the COCO evaluation chain, on the CPU: the OKS scorer and
`run_coco_eval`, `coco_eval_results`, cv2's scale-given resize and
`crop_with_factor`, `rgb_infer` with a small RTPoseVGG, the 2D PAF decode
on non-square maps (the evaluation canvas of an image that is not square),
the plain kernel versions against the Pallas kernels in interpret mode on a
non-square grid, and the whole chain rgb_infer -> paf_decode_2d ->
coco_eval_results -> run_coco_eval."""

import json

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from popnet_tpu.core.config import DecodeConfig as JaxDecodeConfig
from popnet_tpu.core.config import EncoderConfig
from popnet_tpu.data import coco as jax_coco
from popnet_tpu.data import preprocessing as jax_pre
from popnet_tpu.decode.assemble_pallas import assemble_ids_pallas
from popnet_tpu.decode.device import find_peaks_batched as jax_find_peaks
from popnet_tpu.decode.device import score_limb_pairs_batched as jax_score_pairs
from popnet_tpu.decode.openpose_infer import paf_decode_2d as jax_paf_decode_2d
from popnet_tpu.eval import coco_oks as jax_oks
from popnet_tpu.models import RTPoseVGG as FlaxRTPoseVGG
from popnet_tpu.ops import encoders
from popnet_tpu_torch.core.skeleton_coco import (COCO_KEYPOINT_NAMES, COCO_LIMBS,
                                                 COCO_NUM_JOINTS, COCO_SWAP_INDICES)
from popnet_tpu_torch.data import augment_host as pah
from popnet_tpu_torch.data import coco, preprocessing
from popnet_tpu_torch.decode.device import find_peaks_batched
from popnet_tpu_torch.decode.openpose_infer import paf_decode_2d
from popnet_tpu_torch.eval import coco_oks
from popnet_tpu_torch.interop.from_jax import load_into
from popnet_tpu_torch.models import RTPoseVGG
from popnet_tpu_torch.ops import kernels
from tests.test_coco_oks import _grid_person, _shifted
from tests.test_coco_oks_independent import _scenario
from tests.test_torch_coco import flax_init


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the OKS scorer, run_coco_eval and coco_eval_results ----------------------------------------


def _assert_stats_equal(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for k in ("AP", "AP50", "AP75", "AR"):
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k])), (k, got[k], ref[k])
    np.testing.assert_array_equal(got["precision"], ref["precision"])


def test_oks_constants_and_compute_oks_equal_jax():
    np.testing.assert_array_equal(coco_oks.OKS_SIGMAS, jax_oks.OKS_SIGMAS)
    np.testing.assert_array_equal(coco_oks.IOU_THRS, jax_oks.IOU_THRS)
    np.testing.assert_array_equal(coco_oks.REC_THRS, jax_oks.REC_THRS)
    gts, dts = _scenario(11, n_images=4)
    for g, d in zip(gts, dts):
        for gt in g:
            np.testing.assert_array_equal(coco_oks.compute_oks(gt, d), jax_oks.compute_oks(gt, d))


@pytest.mark.parametrize("seed,flood", [(0, False), (1, False), (2, False), (3, False),
                                        (4, False), (5, True)])
def test_oks_ap_equals_jax_on_randomized_scenarios(seed, flood):
    """Crowds, annotations without keypoints, duplicates, spurious
    detections and floods past 20 detections an image: every statistic and
    the (10, 101) precision curve equal JAX's exactly."""
    gts, dts = _scenario(seed, flood=flood)
    _assert_stats_equal(coco_oks.oks_ap(gts, dts), jax_oks.oks_ap(gts, dts))


def _canonical(name):
    g, g1, g2 = _grid_person(200, 200), _grid_person(150, 200), _grid_person(450, 200)
    return {
        "exact": ([[g]], [[_shifted(g, 0.0, 0.9)]]),
        "straddle": ([[g]], [[_shifted(g, 10.3, 0.9)]]),
        "ranked": ([[g1, g2]], [[_shifted(g1, 0.0, 0.9), _shifted(g2, 10.3, 0.3)]]),
        "empty_gt_image": ([[g], []], [[_shifted(g, 0.0, 0.5)],
                                       [_shifted(_grid_person(300, 300), 0.0, 0.9)]]),
    }[name]


@pytest.mark.parametrize("name", ["exact", "straddle", "ranked", "empty_gt_image"])
def test_oks_ap_equals_jax_on_the_canonical_fixtures(name):
    gts, dts = _canonical(name)
    _assert_stats_equal(coco_oks.oks_ap(gts, dts), jax_oks.oks_ap(gts, dts))


def _gt_json(path, gts_per_image, other_category=False) -> str:
    images, anns = [], []
    for i, gts in enumerate(gts_per_image):
        images.append({"id": 100 + i, "file_name": f"{i:04d}.jpg", "width": 640, "height": 480})
        for g in gts:
            anns.append({**g, "id": len(anns) + 1, "image_id": 100 + i, "category_id": 1})
    if other_category:        # an annotation of another category is not scored
        anns.append({**gts_per_image[0][0], "id": len(anns) + 1, "image_id": 100,
                     "category_id": 2})
    cats = [{"id": 1, "name": "person"}, {"id": 2, "name": "dog"}]
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return str(path)


@pytest.mark.parametrize("seed", [0, 3])
def test_run_coco_eval_equals_jax(tmp_path, capsys, seed):
    """The vendored scorer's branch (pycocotools is not installed): the four
    statistics and the printed line equal JAX's."""
    gts, dts = _scenario(seed)
    gts[0] = gts[0] or [_grid_person(200, 200)]
    path = _gt_json(tmp_path / "gt.json", gts, other_category=True)
    results = [{**d, "image_id": 100 + i, "category_id": 1}
               for i, ds in enumerate(dts) for d in ds]
    got = coco.run_coco_eval(path, results)
    got_line = capsys.readouterr().out
    ref = jax_coco.run_coco_eval(path, results)
    ref_line = capsys.readouterr().out
    np.testing.assert_array_equal(got, ref)
    assert got_line == ref_line and "(vendored scorer)" in got_line
    _assert_stats_equal(coco_oks.score_results_json(path, results),
                        jax_oks.score_results_json(path, results))


def test_coco_eval_results_equals_jax():
    """rtpose-18 people with holes -> COCO-17 results, equal to JAX's."""
    rng = np.random.default_rng(3)
    humans = [rng.uniform(0, 400, (int(rng.integers(0, 4)), 18, 3)) for _ in range(5)]
    for h in humans:
        h[rng.uniform(size=h.shape[:2]) < 0.3] = -1.0
    scores = [rng.uniform(0, 1, len(h)) for h in humans]
    ids = [7, 8, 9, 10, 11]
    assert coco.coco_eval_results(humans, ids, scores) == \
        jax_coco.coco_eval_results(humans, ids, scores)


# -- cv2's scale-given resize and crop_with_factor ----------------------------------------------

SIZES = [(480, 640), (427, 640), (640, 427), (57, 91), (91, 57), (64, 64)]


def _image(rng, h, w, c=3, dtype=np.uint8):
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, c)[:3 if c else 2], dtype=np.uint8)
    return rng.uniform(0, 255, (h, w, c)[:3 if c else 2]).astype(np.float32)


@pytest.mark.parametrize("h,w", SIZES + [(736, 1000), (737, 1001), (5, 3)])
def test_resize_linear_scaled_u8_equals_cv2(h, w):
    """cv2.resize(im, None, fx=s, fy=s) on uint8, bit for bit, one and three
    channels, at the evaluation scale (short side to 368), at 48, and at
    an exact 2x downscale (cv2's INTER_AREA path, odd sides included)."""
    rng = np.random.default_rng(h * 1000 + w)
    for c in (3, None):
        im = _image(rng, h, w, c)
        for s in (368.0 / min(h, w), 48.0 / min(h, w), 0.5, 1.0):
            ref = cv2.resize(im, None, fx=s, fy=s)
            got = pah.resize_linear_scaled_u8(im, s, s)
            assert got.shape == ref.shape and got.dtype == np.uint8, (s, c)
            np.testing.assert_array_equal(got, ref, err_msg=f"s={s} c={c}")


def test_resize_linear_scaled_float32_within_two_ulps_of_cv2():
    """The float32 path: within 2**-15 of cv2 on values in [0, 255), two
    float32 ulps at [128, 256) (one of 609,408 values two ulps off, the
    rest at most one): cv2 5.0.0 hands 1-, 3- and 4-channel float resizes
    to Intel IPP, which rounds apart from the port's fused
    multiply-adds (ROADMAP Queue 3); the sizes equal cv2's."""
    rng = np.random.default_rng(2)
    for h, w in SIZES:
        im = _image(rng, h, w, 3, np.float32)
        s = 368.0 / min(h, w)
        ref = cv2.resize(im, None, fx=s, fy=s)
        got = pah.resize_linear_scaled(torch.from_numpy(im), s, s).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -15)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("factor", [8, 32])
@pytest.mark.parametrize("is_ceil", [True, False])
def test_crop_with_factor_equals_jax(h, w, factor, is_ceil):
    """The evaluation canvas, scale and resized shape equal JAX's (cv2)
    bit for bit on uint8 BGR; where is_ceil=False leaves a canvas smaller
    than the resized image, both refuse."""
    rng = np.random.default_rng(h * 7 + w)
    img = _image(rng, h, w)
    try:
        ref = jax_pre.crop_with_factor(img, 368, factor=factor, is_ceil=is_ceil)
    except ValueError:
        with pytest.raises(ValueError):
            preprocessing.crop_with_factor(img, 368, factor=factor, is_ceil=is_ceil)
        return
    got = preprocessing.crop_with_factor(img, 368, factor=factor, is_ceil=is_ceil)
    assert got[1] == ref[1] and tuple(got[2]) == tuple(ref[2])
    assert got[0].dtype == ref[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], ref[0])


def test_crop_with_factor_canvas_shapes_at_the_evaluation_size():
    """The canvases the evaluation feeds the CNN (368, stride 8): a 480x640
    image gives 368x496 and 46x62 maps, a 427x640 one 368x552 and 46x69."""
    for (h, w), shape in (((480, 640), (368, 496)), ((427, 640), (368, 552)),
                          ((640, 480), (496, 368)), ((640, 640), (368, 368))):
        canvas, s, _ = preprocessing.crop_with_factor(np.zeros((h, w, 3), np.uint8), 368, 8)
        assert canvas.shape[:2] == shape and s == 368 / min(h, w)


# -- rgb_infer -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_rtpose():
    """A 2-stage VGG19 RTPoseVGG from flax_init's signal-carrying variables:
    the JAX apply and the port's module."""
    tree, flat = flax_init("vgg19", np.random.default_rng(8))
    flax_model = FlaxRTPoseVGG(trunk="vgg19")
    port = load_into(RTPoseVGG(trunk="vgg19"), flat).eval()
    return flax_model, tree, port


@pytest.mark.parametrize("flip", [False, True])
def test_rgb_infer_matches_jax(small_rtpose, flip):
    """rgb_infer on a 70x100 BGR image at dest_size 48 (a 48x72 canvas, 6x9
    maps), vgg normalization, flip off and on: maps within 1e-5 of JAX's,
    the same scale."""
    flax_model, tree, port = small_rtpose
    img = np.random.default_rng(9).integers(0, 256, (70, 100, 3), dtype=np.uint8)

    def jax_infer(x):
        (paf, heat), _ = flax_model.apply(tree, jnp.asarray(x), train=False)
        return paf, heat

    def port_infer(x):
        with torch.no_grad():
            (paf, heat), _ = port(x.permute(0, 3, 1, 2))
        return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)

    kw = dict(mode="vgg", dest_size=48, factor=8, flip=flip, limbs=COCO_LIMBS,
              swap_indices=COCO_SWAP_INDICES)
    rp, rh, rs = jax_pre.rgb_infer(jax_infer, img, **kw)
    gp, gh, gs = preprocessing.rgb_infer(port_infer, img, device="cpu", **kw)
    assert gs == rs and tuple(gh.shape) == rh.shape == (6, 9, 19)
    assert tuple(gp.shape) == rp.shape == (6, 9, 38)
    assert np.abs(rh).max() > 0.05
    np.testing.assert_allclose(gh.numpy(), rh, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), rp, rtol=0, atol=1e-5)


def test_rgb_infer_defaults_to_cuda_and_never_runs_on_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocessing.rgb_infer(lambda x: (x, x), img, dest_size=16)


# -- the 2D decode on non-square maps ---------------------------------------------------------

# the rtpose-18 joints of a standing person, in units of a tenth of its height
TEMPLATE = np.array([
    (0.0, -3.0), (0.0, 0.0), (-2.5, 0.5), (-3.5, 4.0), (-4.0, 7.5), (2.5, 0.5), (3.5, 4.0),
    (4.0, 7.5), (-1.5, 9.0), (-1.8, 14.0), (-2.0, 19.0), (1.5, 9.0), (1.8, 14.0), (2.0, 19.0),
    (-0.8, -3.8), (0.8, -3.8), (-1.8, -3.4), (1.8, -3.4)])


def people(rng, n, w, h, height):
    """(n, 18, 2) standing people side by side across a w x h image, each
    about `height` px tall, jittered."""
    out = []
    for p in range(n):
        neck = np.array([(p + 0.5) * w / n + rng.uniform(-4, 4), 0.25 * h + rng.uniform(-4, 4)])
        s = height / 22.0 * rng.uniform(0.85, 1.0)
        out.append(neck + TEMPLATE * s + rng.normal(0, 0.5, (18, 2)))
    return np.stack(out)


def painted_maps(joints, H, W, noise_rng=None):
    """(heat (H, W, 19), paf (H, W, 38)) float32 of the people (P, 18, 2)
    in canvas pixels, encoded by the JAX package's GT encoders at an
    (8H, 8W) input, with a little noise."""
    cfg = EncoderConfig(input_x=8 * W, input_y=8 * H, num_joints=COCO_NUM_JOINTS,
                        num_limbs=len(COCO_LIMBS))
    j2 = np.full((cfg.max_people, COCO_NUM_JOINTS, 2), -1e6, np.float32)
    valid = np.zeros(cfg.max_people, bool)
    j2[:len(joints)] = joints
    valid[:len(joints)] = True
    heat = np.asarray(encoders.encode_heatmaps(jnp.asarray(j2), jnp.asarray(valid), cfg))
    paf = np.asarray(encoders.encode_pafs(jnp.asarray(j2), jnp.asarray(valid), cfg,
                                          limbs=COCO_LIMBS))
    assert heat.shape == (H, W, 19) and paf.shape == (H, W, 38)
    if noise_rng is not None:
        heat = heat + noise_rng.normal(0, 0.005, heat.shape)
        paf = paf + noise_rng.normal(0, 0.005, paf.shape)
    return heat.astype(np.float32), paf.astype(np.float32)


@pytest.mark.parametrize("H,W", [(46, 62), (62, 46)])
def test_paf_decode_2d_matches_jax_on_non_square_maps(H, W):
    """The decode on painted COCO maps at the evaluation canvas of a 480x640
    image and of its portrait twin, sx = sy = 1 / im_scale: counts and
    visibility exact, joints2d and conf within 1e-4 (the bars of
    tests/test_torch_coco.py), every person found."""
    rng = np.random.default_rng(H * 100 + W)
    maps = [painted_maps(people(rng, n, 8 * W, 8 * H, 0.6 * 8 * min(H, W)), H, W, rng)
            for n in (2, 3)]
    heat, paf = (np.stack(m) for m in zip(*maps))
    s = 1.0 / (368.0 / 480.0)
    ref = jax_paf_decode_2d(jnp.asarray(heat), jnp.asarray(paf), COCO_NUM_JOINTS,
                            JaxDecodeConfig(), COCO_LIMBS, sx=s, sy=s)
    got = paf_decode_2d(torch.from_numpy(heat), torch.from_numpy(paf), COCO_NUM_JOINTS,
                        limbs=COCO_LIMBS, sx=s, sy=s)
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(ref["counts"]))
    np.testing.assert_array_equal(got["visibility"].numpy(), np.asarray(ref["visibility"]))
    np.testing.assert_allclose(got["joints2d"].numpy(), np.asarray(ref["joints2d"]), atol=1e-4)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(ref["conf"]), atol=1e-4)
    assert got["counts"].tolist() == [2, 3]


def test_plain_kernels_match_the_pallas_kernels_on_a_non_square_grid():
    """K1's, K3's and K6's plain versions against find_peaks_pallas_bt,
    paf_sample_pallas and assemble_ids_pallas in interpret mode on painted
    COCO maps of 14x22 cells (H != W), over the planes of joints 0-6 and
    the five limbs among them (the Pallas kernels unroll over planes and
    limbs, so their interpret-mode cost grows with each; the grid is what
    tells H from W): the peaks within 1e-5 (the refine's patch @ Q rounds
    apart), validity exact; pair scores within 1e-5 and ok exact; ids and
    counts exact."""
    H, W, K = 14, 22, 7
    sel = (6, 7, 10, 11, 14)                       # (1, 2) (2, 3) (1, 5) (5, 6) (1, 0)
    limbs = tuple(COCO_LIMBS[i] for i in sel)
    rng = np.random.default_rng(21)
    heat, paf = painted_maps(people(rng, 2, 8 * W, 8 * H, 0.8 * 8 * H), H, W, rng)
    heat, paf = heat[None], paf[None, ..., [c for i in sel for c in (2 * i, 2 * i + 1)]]
    peaks, valid = (np.array(a) for a in jax_find_peaks(jnp.asarray(heat), refine="pallas",
                                                          num_joints=K))
    pk, v = find_peaks_batched(torch.from_numpy(heat), num_joints=K)
    np.testing.assert_array_equal(v.numpy(), valid)
    np.testing.assert_allclose(pk.numpy(), peaks, atol=1e-5)
    assert (valid.sum(-1) == 2).all()              # both people's every joint
    ref_s, ref_ok = jax_score_pairs(jnp.asarray(paf), jnp.asarray(peaks), jnp.asarray(valid),
                                    limbs=limbs, method="pallas")
    got_s, got_ok = kernels.paf_score_plain(torch.from_numpy(np.ascontiguousarray(paf)),
                                            torch.from_numpy(peaks), torch.from_numpy(valid),
                                            limbs)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5)
    assert got_ok.any()
    ok, s = np.array(ref_ok), np.array(ref_s)
    s_masked = np.where(ok, s, -np.inf).astype(np.float32)
    ref_ids, ref_cnt = assemble_ids_pallas(jnp.asarray(peaks[..., 2]), jnp.asarray(s_masked),
                                           limbs=limbs, interpret=True)
    got_ids, got_cnt = kernels.assemble_ids_plain(
        torch.from_numpy(np.ascontiguousarray(peaks[..., 2])), torch.from_numpy(s_masked),
        limbs)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(ref_cnt))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
    assert int(got_cnt[0]) == 2


# -- the whole chain -----------------------------------------------------------------------------


def coco17(joints18):
    """(18, 2) rtpose-18 joints -> 51 COCO-17 keypoint values, all labelled."""
    kp = np.zeros((17, 3))
    for i17, name in enumerate(coco.COCO17):
        kp[i17] = (*joints18[COCO_KEYPOINT_NAMES.index(name)], 2)
    return kp


def chain_fixture(tmp_path, h, w, dest):
    """A BGR image, the people on it and their person_keypoints JSON, and an
    oracle CNN for either package: the maps the GT encoders paint for those
    people on the evaluation canvas (the image content does not enter)."""
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    canvas, s, _ = preprocessing.crop_with_factor(img, dest, 8)
    Hm, Wm = canvas.shape[0] // 8, canvas.shape[1] // 8
    joints = people(rng, 2, w, h, 0.7 * min(h, w))
    heat, paf = painted_maps(joints * s, Hm, Wm)
    anns = []
    for j in joints:
        kp = coco17(j)
        x0, y0 = kp[:, :2].min(0) - 4
        x1, y1 = kp[:, :2].max(0) + 4
        anns.append({"id": len(anns) + 1, "image_id": 5, "category_id": 1, "iscrowd": 0,
                     "num_keypoints": 17, "keypoints": kp.ravel().tolist(),
                     "bbox": [x0, y0, x1 - x0, y1 - y0], "area": float((x1 - x0) * (y1 - y0))})
    gt = tmp_path / "person_keypoints.json"
    gt.write_text(json.dumps({"images": [{"id": 5, "file_name": "x.jpg", "width": w,
                                          "height": h}],
                              "annotations": anns, "categories": [{"id": 1, "name": "person"}]}))
    return img, heat, paf, str(gt), (Hm, Wm)


@pytest.mark.parametrize("h,w", [(240, 320), (320, 240)])
def test_coco_chain_matches_jax(tmp_path, capsys, h, w):
    """rgb_infer -> paf_decode_2d (sx = sy = 1 / im_scale) ->
    coco_eval_results -> run_coco_eval on a landscape and a portrait image
    at dest_size 184 (maps 23x31 and 31x23), with the oracle CNN: the
    results JSON's images, scores' order and holes equal JAX's, keypoints
    within 2e-4 px and scores within 1e-4, and the four statistics equal,
    AP 1."""
    img, heat, paf, gt, grid = chain_fixture(tmp_path, h, w, 184)
    assert grid == ((23, 31) if w > h else (31, 23))

    def run(pre, decode, fmt, infer, to_np, **kw):
        p, m, s = pre.rgb_infer(infer, img, mode="rtpose", dest_size=184, factor=8, **kw)
        out = decode(m[None], p[None], COCO_NUM_JOINTS, limbs=COCO_LIMBS, sx=1.0 / s,
                     sy=1.0 / s)
        n = int(to_np(out["counts"])[0])
        joints, conf = to_np(out["joints2d"])[0, :n], to_np(out["conf"])[0, :n]
        return fmt([joints], [5], [[float(c[c > 0].mean()) for c in conf]])

    ref = run(jax_pre, lambda *a, **k: jax_paf_decode_2d(*a, dcfg=JaxDecodeConfig(), **k),
              jax_coco.coco_eval_results,
              lambda x: (jnp.asarray(paf)[None], jnp.asarray(heat)[None]), np.asarray)
    ref_stats = jax_coco.run_coco_eval(gt, ref)
    got = run(preprocessing, paf_decode_2d, coco.coco_eval_results,
              lambda x: (torch.from_numpy(paf)[None], torch.from_numpy(heat)[None]),
              lambda t: t.numpy(), device="cpu")
    lines = capsys.readouterr().out
    got_stats = coco.run_coco_eval(gt, got)
    assert capsys.readouterr().out.splitlines()[-1] == lines.splitlines()[-1]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g["image_id"] == r["image_id"] and g["category_id"] == r["category_id"]
        kg, kr = np.asarray(g["keypoints"]), np.asarray(r["keypoints"])
        np.testing.assert_array_equal(kg[2::3], kr[2::3])
        np.testing.assert_allclose(kg, kr, atol=2e-4)
        assert abs(g["score"] - r["score"]) < 1e-4
    np.testing.assert_array_equal(got_stats, ref_stats)
    assert got_stats[0] == 1.0
