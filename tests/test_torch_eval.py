"""The MP-3DHP evaluation drivers of the port (popnet_tpu_torch.cli) against
the JAX package's, on the CPU: the pinned copies of the metrics, labels,
readouts and host assembler, the batched metric twin, the evaluation
dataset's images, the four drivers' prediction JSON on GT-map oracles, their
metrics, and the `evaluate` and `benchmark` subcommands."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from popnet_tpu.cli import evaluate as jev
from popnet_tpu.cli import yolo_a2j as jya
from popnet_tpu.cli.main import main as jax_main
from popnet_tpu.core import camera as jcamera
from popnet_tpu.core.config import KDH3D_DATASET as JAX_KDH3D_DATASET
from popnet_tpu.data import a2j_crops as ja2j_crops
from popnet_tpu.data import augment_device as jad
from popnet_tpu.data import labels as jlabels
from popnet_tpu.data.datasets import MPRealDataset as JaxDataset
from popnet_tpu.decode import assemble as jassemble
from popnet_tpu.decode import readout as jreadout
from popnet_tpu.eval import batched as jbatched
from popnet_tpu.eval import map as jmap
from popnet_tpu.eval import pck as jpck
from popnet_tpu_torch.cli import evaluate as pev
from popnet_tpu_torch.cli import yolo_a2j as pya
from popnet_tpu_torch.cli.main import main as port_main
from popnet_tpu_torch.core import camera as pcamera
from popnet_tpu_torch.core.config import KDH3D_DATASET
from popnet_tpu_torch.data import a2j_crops as pa2j_crops
from popnet_tpu_torch.data import augment_device as pad
from popnet_tpu_torch.data import labels as plabels
from popnet_tpu_torch.data.datasets import MPRealDataset
from popnet_tpu_torch.decode import assemble as passemble
from popnet_tpu_torch.decode import readout as preadout
from popnet_tpu_torch.eval import batched as pbatched
from popnet_tpu_torch.eval import map as pmap
from popnet_tpu_torch.eval import pck as ppck

import chip_smoke
from tests import synthetic_data
from tests.test_e2e_eval import ECFG as JAX_ECFG, make_oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = {m: os.path.join(ROOT, "examples", "results", f"bench_weights_{m}.npz")
           for m in ("openpose", "popnet", "yolo")}
K = 15
BATCH = 4
PRED_KEYS = ("human_pred_set_2d", "human_pred_set_3d", "human_pred_set_3d_read_raw_depth",
             "human_pred_set_3d_perfect_2d", "human_pred_set_3d_perfect_2d_read_raw_depth",
             "human_pred_set_part_conf", "human_pred_set_visibility",
             "human_pred_set_2d_aligned", "human_pred_set_3d_aligned")
GT_KEYS = ("human_gt_set_2d", "human_gt_set_2d_visible", "human_gt_set_3d")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_scene(rng, num_images=12, max_people=3, drop_prob=0.15, fp_prob=0.3):
    """Random multi-person scenes with dropped joints and false positives
    (the generator of tests/test_eval_golden.py make_scene)."""
    gt2d, gt3d, pred2d, pred3d, conf, vis = [], [], [], [], [], []
    for _ in range(num_images):
        g2, g3, p2, p3, cf, vs = [], [], [], [], [], []
        for _p in range(rng.integers(1, max_people + 1)):
            joints = rng.uniform(60, 400, size=2) + rng.normal(0, 40, size=(K, 2))
            z = rng.uniform(1.5, 5.0) + rng.normal(0, 0.2, size=K)
            g2.append(joints.tolist())
            g3.append(np.stack([(joints[:, 0] - 232) / 504 * z,
                                (joints[:, 1] - 320) / 504 * z, z], 1).tolist())
            vs.append((rng.uniform(size=K) > 0.1).astype(float).tolist())
            pj = joints + rng.normal(0, 6, size=(K, 2))
            pz = z + rng.normal(0, 0.05, size=K)
            pj[rng.uniform(size=K) < drop_prob] = -1.0
            p2.append(pj.tolist())
            p3.append(np.stack([(pj[:, 0] - 232) / 504 * pz,
                                (pj[:, 1] - 320) / 504 * pz, pz], 1).tolist())
            cf.append(rng.uniform(0.2, 1.0, size=K).tolist())
        if rng.uniform() < fp_prob:
            fp = rng.uniform(0, 460, size=(K, 2))
            fz = rng.uniform(1, 5, size=K)
            p2.append(fp.tolist())
            p3.append(np.stack([(fp[:, 0] - 232) / 504 * fz,
                                (fp[:, 1] - 320) / 504 * fz, fz], 1).tolist())
            cf.append(rng.uniform(0.0, 0.6, size=K).tolist())
        for lst, v in zip((gt2d, gt3d, pred2d, pred3d, conf, vis), (g2, g3, p2, p3, cf, vs)):
            lst.append(v)
    return gt2d, gt3d, pred2d, pred3d, conf, vis


def _equal(a, b):
    """Equal values, NaN equal to NaN, on nested results."""
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_json(got: dict, ref: dict, key: str, atol: float = 0.0, rtol: float = 0.0):
    """The key's per-image, per-person lists: the same shapes, values within
    the tolerance (0: equal)."""
    assert len(got[key]) == len(ref[key]), key
    for i, (a, b) in enumerate(zip(got[key], ref[key])):
        assert len(a) == len(b), (key, i, len(a), len(b))
        for ha, hb in zip(a, b):
            if atol == 0 and rtol == 0:
                np.testing.assert_array_equal(np.asarray(ha, float), np.asarray(hb, float),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(np.asarray(ha, float), np.asarray(hb, float),
                                           atol=atol, rtol=rtol, err_msg=key)


# -- the pinned copies ------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
def test_pinned_metric_copies_equal_the_jax_package(seed):
    """eval/pck.py and eval/map.py give the JAX package's results exactly,
    on scenes with holes, false positives and an image with no predictions,
    with and without GT visibility."""
    gt2d, gt3d, pred2d, pred3d, conf, vis = make_scene(np.random.default_rng(seed), 14)
    pred2d[2], pred3d[2], conf[2] = [], [], []
    names = [str(i) for i in range(K)]
    for v in (None, vis):
        _equal(ppck.eval_human_dataset_2d(pred2d, gt2d, human_gt_set_visibility=v),
               jpck.eval_human_dataset_2d(pred2d, gt2d, human_gt_set_visibility=v))
        _equal(ppck.eval_human_dataset_2d_pckh(pred2d, gt2d, 0, 1, human_gt_set_visibility=v),
               jpck.eval_human_dataset_2d_pckh(pred2d, gt2d, 0, 1, human_gt_set_visibility=v))
        _equal(ppck.eval_human_dataset_3d(pred2d, gt2d, pred3d, gt3d, human_gt_set_visibility=v),
               jpck.eval_human_dataset_3d(pred2d, gt2d, pred3d, gt3d, human_gt_set_visibility=v))
        vset = [] if v is None else v
        _equal(pmap.eval_ap_mpii_v2(pred2d, list(conf), gt2d, list(vset), 0, 1, names,
                                    verbose=False),
               jmap.eval_ap_mpii_v2(pred2d, list(conf), gt2d, list(vset), 0, 1, names,
                                    verbose=False))
        _equal(pmap.eval_ap_3d(pred3d, list(conf), gt3d, list(vset), names, verbose=False),
               jmap.eval_ap_3d(pred3d, list(conf), gt3d, list(vset), names, verbose=False))
    heads = [[[0, 0, 20 + i, 30 + i]] * len(g) for i, g in enumerate(gt2d)]
    _equal(ppck.eval_human_dataset_2d_pckh_rect(pred2d, gt2d, heads),
           jpck.eval_human_dataset_2d_pckh_rect(pred2d, gt2d, heads))
    _equal(pmap.eval_ap_mpii(pred2d, [], gt2d, [], heads, names, verbose=False),
           jmap.eval_ap_mpii(pred2d, [], gt2d, [], heads, names, verbose=False))
    rng = np.random.default_rng(seed)
    scores, labels = rng.uniform(size=50).round(1), rng.integers(0, 2, 50)
    _equal(pmap.get_rpc(scores, labels, 30), jmap.get_rpc(scores, labels, 30))
    r, p = np.sort(rng.uniform(size=20)), rng.uniform(size=20)
    assert pmap.voc_ap(r, p) == jmap.voc_ap(r, p)


def test_pinned_labels_readout_assemble_uncrop_copies_equal_the_jax_package(paths):
    """data/labels.py, decode/readout.py, decode/assemble.py and
    uncrop_keypoints give the JAX package's results exactly; the port's
    float64 back-projection equals the JAX host's, and its dataset
    configuration has the JAX one's fields."""
    anns, intr = plabels.load_label_file(paths["labels"])
    janns, jintr = jlabels.load_label_file(paths["labels"])
    assert anns == janns and dataclass_fields(intr) == dataclass_fields(jintr)
    for name in anns:
        for a, b in zip(dataclass_fields(plabels.pack_annotations(anns[name], 3)),
                        dataclass_fields(jlabels.pack_annotations(janns[name], 3))):
            np.testing.assert_array_equal(a, b)
    assert dataclass_fields(KDH3D_DATASET.depth) == dataclass_fields(JAX_KDH3D_DATASET.depth)
    assert dataclass_fields(KDH3D_DATASET.intrinsics) == \
        dataclass_fields(JAX_KDH3D_DATASET.intrinsics)
    assert (KDH3D_DATASET.width, KDH3D_DATASET.height) == (480, 512)

    rng = np.random.default_rng(5)
    z, heat = rng.normal(3, 1, (28, 28)), rng.normal(0, 1, (28, 28))
    align = rng.normal(0, 1, (28, 28, 2))
    for c in ([0, 0], [27, 27], [13, 5], [26, 1]):
        for fn, args in (("retrieve_depth_weighted", (z,)),
                         ("retrieve_depth_heat_weighted", (z, heat)),
                         ("retrieve_depth_heat_max", (z, heat)),
                         ("retrieve_offsets_weighted", (align,)),
                         ("retrieve_offsets_heat_weighted", (align, heat)),
                         ("retrieve_offsets_heat_max", (align, heat)),
                         ("retrieve_offsets_nn", (align,))):
            a = getattr(preadout, fn)(c, *[x.copy() for x in args])
            b = getattr(jreadout, fn)(c, *[x.copy() for x in args])
            assert a == b, (fn, c)
    assert preadout.retrieve_offsets_direct([3, 4], align) == \
        jreadout.retrieve_offsets_direct([3, 4], align)

    for trial in range(4):
        peaks = rng.uniform(0, 224, (3, K, 16, 3)).astype(np.float32)
        valid = rng.uniform(size=(3, K, 16)) < 0.4
        scores = rng.uniform(0, 1, (3, 14, 16, 16)).round(trial).astype(np.float32)
        ok = rng.uniform(size=(3, 14, 16, 16)) < 0.3
        _equal(passemble.assemble_batch(peaks, valid, scores, ok),
               jassemble.assemble_batch(peaks, valid, scores, ok))

    yxz = rng.uniform(0, 288, (5, K, 3))
    boxes = np.concatenate([rng.uniform(0, 200, (5, 2)), rng.uniform(250, 480, (5, 2))], 1)
    np.testing.assert_array_equal(pa2j_crops.uncrop_keypoints(yxz, boxes),
                                  ja2j_crops.uncrop_keypoints(yxz, boxes))
    x, y, zz = rng.uniform(0, 480, 15), rng.uniform(0, 512, 15), rng.uniform(1, 5, 15)
    np.testing.assert_array_equal(pcamera.back_project_np(x, y, zz, pcamera.KDH3D_INTRINSICS),
                                  jcamera.back_project(x, y, zz, jcamera.KDH3D_INTRINSICS))


def dataclass_fields(obj):
    import dataclasses

    return tuple(getattr(obj, f.name) for f in dataclasses.fields(obj))


# -- the batched twin ---------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 6])
def test_batched_twin_matches_numpy_and_jax(seed):
    """eval/batched.py on the CPU: pck within 1e-6 and avg within 1e-5
    relative of the NumPy metric and of JAX's batched twin; AP within 1e-6 of
    both (on scenes where every image has a prediction), and of the NumPy
    metric where an image has none: there JAX's twin counts that image's GT
    joints and the reference does not (ROADMAP Queue 3), and the port follows
    the reference."""
    gt2d, gt3d, pred2d, pred3d, conf, _ = make_scene(np.random.default_rng(seed), 20)
    g2, g3, _, gv = pbatched.pack_human_sets(gt2d, gt3d)
    p2, p3, cf, pv = pbatched.pack_human_sets(pred2d, pred3d, conf=conf)
    for a, b in zip(pbatched.pack_human_sets(gt2d, gt3d) + (p2, p3, cf, pv),
                    jbatched.pack_human_sets(gt2d, gt3d)
                    + jbatched.pack_human_sets(pred2d, pred3d, conf=conf)):
        np.testing.assert_array_equal(a, b)
    cases = (
        (pbatched.eval_pck2d_batched(g2, gv, p2, pv, dist_th=10.0, device="cpu"),
         jpck.eval_human_dataset_2d(pred2d, gt2d, dist_th=10.0),
         jbatched.eval_pck2d_batched(g2, gv, p2, pv, dist_th=10.0)),
        (pbatched.eval_pckh2d_batched(g2, gv, p2, pv, device="cpu"),
         jpck.eval_human_dataset_2d_pckh(pred2d, gt2d, head_id=0, neck_id=1),
         jbatched.eval_pckh2d_batched(g2, gv, p2, pv)),
        (pbatched.eval_pck3d_batched(g2, g3, gv, p2, p3, pv, dist_th=0.1, device="cpu"),
         jpck.eval_human_dataset_3d(pred2d, gt2d, pred3d, gt3d, dist_th=0.1),
         jbatched.eval_pck3d_batched(g2, g3, gv, p2, p3, pv, dist_th=0.1)),
    )
    for (avg, pck), (ref_avg, ref_pck), (j_avg, j_pck) in cases:
        np.testing.assert_allclose(pck, ref_pck, atol=1e-6)
        np.testing.assert_allclose(avg, ref_avg, rtol=1e-5)
        np.testing.assert_allclose(pck, j_pck, atol=1e-6)
        np.testing.assert_allclose(avg, j_avg, rtol=1e-5)

    hsz = 2.0 * np.sqrt(((g2[:, :, 0] - g2[:, :, 1]) ** 2).sum(-1))
    gvis = np.ones(g2.shape[:3], np.float32)
    names = [str(i) for i in range(K)]
    ap = pbatched.eval_ap_batched(p2, cf, pv, g2, gvis, gv, hsz, thresh=0.5, device="cpu")
    ref = jmap.eval_ap_mpii_v2(pred2d, [list(c) for c in conf], gt2d, [], 0, 1, names,
                               verbose=False)
    np.testing.assert_allclose(ap, ref, atol=1e-6)
    np.testing.assert_allclose(
        ap, jbatched.eval_ap_batched(p2, cf, pv, g2, gvis, gv, hsz, thresh=0.5), atol=1e-6)

    pred2d[2], pred3d[2], conf[2] = [], [], []        # an image without a prediction
    p2, p3, cf, pv = pbatched.pack_human_sets(pred2d, pred3d, conf=conf)
    ap = pbatched.eval_ap_batched(p2, cf, pv, g2, gvis, gv, hsz, thresh=0.5, device="cpu")
    ref = jmap.eval_ap_mpii_v2(pred2d, [list(c) for c in conf], gt2d, [], 0, 1, names,
                               verbose=False)
    np.testing.assert_allclose(ap, ref, atol=1e-6)
    ap3 = pbatched.eval_ap_batched(p3, cf, pv, g3, gvis, gv, np.ones(gv.shape, np.float32),
                                   thresh=0.1, device="cpu")
    ref3 = jmap.eval_ap_3d(pred3d, [list(c) for c in conf], gt3d, [], names, verbose=False)
    np.testing.assert_allclose(ap3, ref3, atol=1e-6)


# -- the dataset --------------------------------------------------------------


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return synthetic_data.build(str(tmp_path_factory.mktemp("torch_eval")), n_images=8)


@pytest.fixture(scope="module")
def jds(paths):
    return JaxDataset(paths["img_dir"], paths["labels"], ecfg=JAX_ECFG)


@pytest.fixture(scope="module")
def pds(paths):
    return MPRealDataset(paths["img_dir"], paths["labels"], device="cpu")


def test_dataset_images_equal_the_jax_ones(paths, jds, pds):
    """get_batch's images equal JAX's bit for bit (the warp rounds its
    multiply-adds as XLA's CPU compiler contracts them,
    `core.numerics.fma_f32`; without that 40,418 of 200,704 pixels of four
    frames differ by up to 9.5e-7); the GT lists, intrinsics and ids are
    equal."""
    for idx in ([0, 1, 2, 3], [7, 5]):
        a, b = jds.get_batch(idx), pds.get_batch(idx)
        assert b["image"].shape == (len(idx), 224, 224, 1) and b["image"].dtype == torch.float32
        np.testing.assert_array_equal(b["image"].numpy(), np.asarray(a["image"]))
        np.testing.assert_array_equal(b["index"], a["index"])
    assert pds.gt_human_lists() == jds.gt_human_lists() and pds.ids == jds.ids
    assert len(pds) == len(jds)
    assert dataclass_fields(pds.intrinsics) == dataclass_fields(jds.intrinsics)
    depth, anns = pds.load_composited(3)
    jdepth, janns = jds.load_composited(3)
    np.testing.assert_array_equal(depth, jdepth)
    assert anns == janns


def test_warp_equals_the_jax_warp_on_augmented_params():
    """warp_depth_batch against the JAX warp bit for bit, on the resize the
    evaluation draws and on the rotated, scaled and cropped maps of JAX's
    sample_augment_params; resize_inv_mat equals the inverse map JAX's
    dataset composes for evaluation."""
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 8, (4, 64, 48)).astype(np.float32)
    eval_params = jad.sample_augment_params(
        np.random.default_rng(0), 64, 48, 32, 24, rotate_deg=0.0, render_min=1.0,
        render_max=1.0, max_crop=0.0, hflip=False)
    np.testing.assert_array_equal(pad.resize_inv_mat(64, 48, 32, 24), eval_params.inv_mat)
    mats = [eval_params.inv_mat] + [
        jad.sample_augment_params(np.random.default_rng(i), 64, 48, 32, 24).inv_mat
        for i in range(4)]
    for inv in mats:
        got = pad.warp_depth_batch(torch.from_numpy(imgs), inv, 32, 24)
        ref = jad.warp_depth_batch(jnp.asarray(imgs), jnp.asarray(np.broadcast_to(inv, (4, 2, 3))),
                                   jnp.ones(4, jnp.float32), jnp.zeros(4, bool), 32, 24)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- the drivers on GT-map oracles --------------------------------------------


@pytest.fixture(scope="module")
def oracle(jds):
    """The JAX GT-map oracle's targets for the dataset, batch by batch, as
    NumPy."""
    targets = make_oracle(jds)
    return [{k: np.asarray(v) for k, v in targets(BATCH).items()}
            for _ in range(0, len(jds), BATCH)]


def feeder(batches, keys, to):
    """infer(images) that returns the next batch's `keys`, converted by `to`."""
    pos = {"i": 0}

    def infer(images):
        t = batches[pos["i"]]
        pos["i"] += 1
        assert images.shape[0] == t[keys[0]].shape[0]
        out = tuple(to(t[k]) for k in keys)
        return out[0] if len(out) == 1 else out

    return infer


JAX_IN = jnp.asarray


def PORT_IN(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def results(jds, pds, oracle):
    """Each family's JSON from the JAX driver and the port's driver on the
    same oracle maps."""
    op = ("pafs", "heatmaps", "zmaps")
    pn = ("heatmaps", "zmaps", "align_maps", "prior_map")
    out = {}
    for dd in (False, True):
        out[f"openpose_dd{int(dd)}"] = (
            pev.run_openpose_eval(feeder(oracle, op, PORT_IN), pds, BATCH, device_decode=dd),
            jev.run_openpose_eval(feeder(oracle, op, JAX_IN), jds, BATCH, ecfg=JAX_ECFG,
                                  use_native=False, device_decode=dd))
    out["yolo"] = (pev.run_yolo_eval(feeder(oracle, ("prior_map",), PORT_IN), pds, BATCH),
                   jev.run_yolo_eval(feeder(oracle, ("prior_map",), JAX_IN), jds, BATCH,
                                     ecfg=JAX_ECFG))
    for ro in ("gated", "universe"):
        out[f"popnet_{ro}"] = (
            pev.run_popnet_eval(feeder(oracle, pn, PORT_IN), pds, BATCH, readout=ro),
            jev.run_popnet_eval(feeder(oracle, pn, JAX_IN), jds, BATCH, ecfg=JAX_ECFG,
                                readout=ro))
    return out


def test_openpose_host_path_json_matches_jax(results):
    """device_decode=False: 2D joints and visibility equal, conf within 1e-5
    (K1's score contract), every 3D channel within 1e-6 m; the GT keys
    equal."""
    got, ref = results["openpose_dd0"]
    assert set(got) == set(ref)
    assert sum(len(h) for h in got["human_pred_set_2d"]) >= 8
    assert_json(got, ref, "human_pred_set_2d")
    assert_json(got, ref, "human_pred_set_visibility")
    assert_json(got, ref, "human_pred_set_part_conf", atol=1e-5)
    for key in ("human_pred_set_3d", "human_pred_set_3d_read_raw_depth",
                "human_pred_set_3d_perfect_2d", "human_pred_set_3d_perfect_2d_read_raw_depth"):
        assert_json(got, ref, key, atol=1e-6)
    for key in GT_KEYS:
        assert got[key] == ref[key]


def test_openpose_device_decode_json_matches_jax(results):
    """device_decode=True against JAX's device decode, at the bars of
    tests/test_e2e_eval.py (atol 2e-4, rtol 1e-4), visibility equal."""
    got, ref = results["openpose_dd1"]
    assert set(got) == set(ref)
    assert_json(got, ref, "human_pred_set_visibility")
    for key in PRED_KEYS[:6]:
        assert_json(got, ref, key, atol=2e-4, rtol=1e-4)


def test_yolo_json_matches_jax(results):
    """Yolo-Pose+: the prior decode equals JAX's bit for bit, and so the
    JSON does."""
    got, ref = results["yolo"]
    assert set(got) == set(ref)
    for key in ("human_pred_set_2d", "human_pred_set_3d", "human_pred_set_part_conf"):
        assert_json(got, ref, key)


@pytest.mark.parametrize("readout", ["gated", "universe"])
def test_popnet_json_matches_jax(results, readout):
    """PoP-Net, both readouts: the plain prior keys and the conf equal;
    the aligned joints within 1e-4 px and 1e-6 m (the alignment's window
    sums run in another order than XLA's)."""
    got, ref = results[f"popnet_{readout}"]
    assert set(got) == set(ref)
    for key in ("human_pred_set_2d", "human_pred_set_3d", "human_pred_set_part_conf"):
        assert_json(got, ref, key)
    assert_json(got, ref, "human_pred_set_2d_aligned", atol=1e-4)
    assert_json(got, ref, "human_pred_set_3d_aligned", atol=1e-6)


BARS = {"openpose_dd0": (0.95, 0.9, 0.9, 0.85), "openpose_dd1": (0.95, 0.9, 0.9, 0.85),
        "yolo": (0.99, 0.99, 0.99, 0.99), "popnet_gated": (0.95, 0.9, 0.0, 0.0),
        "popnet_universe": (0.95, 0.9, 0.0, 0.0)}


@pytest.mark.parametrize("family", sorted(BARS))
def test_metrics_match_jax_and_clear_the_oracle_bars(results, family):
    """The four metrics of the port's JSON within 1e-6 of the JAX JSON's,
    and over tests/test_e2e_eval.py's oracle bars; the ablation channels
    within 1e-6, and the perfect-2D ones over that file's bars."""
    got, ref = results[family]
    m, r = pev.evaluate_eval_data(got, verbose=False), jev.evaluate_eval_data(ref, verbose=False)
    for k, bar in zip(("pck2d", "pck3d", "map2d", "map3d"), BARS[family]):
        assert abs(m[k] - r[k]) <= 1e-6, (k, m[k], r[k])
        assert m[k] > bar, (k, m[k])
    if family.startswith("openpose"):
        a, b = pev.evaluate_ablation_channels(got), jev.evaluate_ablation_channels(ref)
        assert set(a) == set(b) and all(abs(a[k] - b[k]) <= 1e-6 for k in a), (a, b)
        assert a["perfect_2d"] > 0.95 and a["perfect_2d_visible"] > 0.95
        assert a["perfect_2d_raw_depth"] > 0.5


def test_yolo_a2j_gt_boxes_matches_jax(jds, pds):
    """Yolo->A2J with gt_boxes=True on seeded heads of A2J's shapes: the
    boxes and the crops equal JAX's, the joints within the vote's bar of
    tests/test_torch_yolo_a2j.py (5e-3 crop px and 1e-4 m) carried to image
    pixels and metres, and the four metrics within 1e-6."""
    n_anchors = 18 * 18 * 16
    crops = {}

    def heads(tag, to):
        calls = {"n": 0}

        def infer_a2j(c):
            crops.setdefault(tag, []).append(np.asarray(c))
            rng = np.random.default_rng([7, calls["n"]])
            calls["n"] += 1
            n = c.shape[0]
            return tuple(to(a) for a in (
                rng.normal(0, 3, (n, n_anchors, K)).astype(np.float32),
                rng.normal(0, 10, (n, n_anchors, K, 2)).astype(np.float32),
                rng.normal(3, 0.5, (n, n_anchors, K)).astype(np.float32)))

        return infer_a2j

    got = pya.run_yolo_a2j_eval(None, heads("port", PORT_IN), pds, gt_boxes=True)
    ref = jya.run_yolo_a2j_eval(None, heads("jax", JAX_IN), jds, gt_boxes=True)
    idx, boxes = pya.stage1_gt_boxes(pds)
    jidx, jboxes = jya.stage1_gt_boxes(jds)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(boxes, jboxes)
    assert len(boxes) == 8 and crops["port"][0].shape == (8, 288, 288, 1)
    np.testing.assert_array_equal(np.concatenate(crops["port"]), np.concatenate(crops["jax"]))

    ext = float(np.max(np.concatenate([boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]])))
    atol2 = 5e-3 * ext / 288
    g2 = np.concatenate([np.asarray(h) for h in got["human_pred_set_2d"]])
    g3 = np.concatenate([np.asarray(h) for h in got["human_pred_set_3d"]])
    cam = pcamera.KDH3D_INTRINSICS
    atol3 = atol2 / cam.fx * np.abs(g3[..., 2]).max() \
        + np.abs(g2 - [cam.cx, cam.cy]).max() / cam.fx * 1e-4 + 1e-4 * atol2
    assert_json(got, ref, "human_pred_set_2d", atol=atol2)
    assert_json(got, ref, "human_pred_set_3d", atol=max(atol3, 1e-4))
    assert_json(got, ref, "human_pred_set_part_conf")
    m, r = pev.evaluate_eval_data(got, verbose=False), jev.evaluate_eval_data(ref, verbose=False)
    for k in ("pck2d", "pck3d", "map2d", "map3d"):
        assert abs(m[k] - r[k]) <= 1e-6, (k, m[k], r[k])


@pytest.mark.parametrize("device_decode", [False, True])
def test_painted_openpose_oracle_clears_the_bars(tmp_path, device_decode):
    """chip_smoke.py's painted Open-Pose+ oracle (maps painted from the
    labels of its person frames) through the port on the CPU clears
    tests/test_e2e_eval.py's bars, which the card's eval phase holds it to:
    pck2d > 0.95, pck3d > 0.9, map2d > 0.9, map3d > 0.85, perfect_2d > 0.95."""
    frames, people = chip_smoke.person_frames(np.random.default_rng(11), 12, "cpu", people=True)
    img_dir, labels = chip_smoke.write_eval_set(str(tmp_path), frames, people)
    ds = MPRealDataset(img_dir, labels, device="cpu")
    assert len(ds) == 12 and sum(len(a) for a in ds.anno_dic.values()) >= 24
    maps = []
    for s in range(0, 12, BATCH):
        heat, paf, z = chip_smoke.openpose_painted_maps(
            [ds.anno_dic[ds.ids[i]] for i in range(s, s + BATCH)])
        maps.append({"paf": paf, "heat": heat, "z": z})
    data = pev.run_openpose_eval(feeder(maps, ("paf", "heat", "z"), PORT_IN), ds, BATCH,
                                 device_decode=device_decode)
    m = pev.evaluate_eval_data(data, verbose=False)
    assert m["pck2d"] > 0.95 and m["pck3d"] > 0.9 and m["map2d"] > 0.9 and m["map3d"] > 0.85, m
    assert pev.evaluate_ablation_channels(data)["perfect_2d"] > 0.95


# -- the subcommands ----------------------------------------------------------


def _jax_benchmark(capsys, gt, pred) -> dict:
    capsys.readouterr()
    jax_main(["benchmark", "--gt", gt, "--pred", pred])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


@pytest.mark.parametrize("model", ["openpose", "popnet", "yolo"])
def test_cli_evaluate_writes_the_json_and_benchmark_scores_it_as_jax_does(paths, tmp_path,
                                                                          capsys, model):
    """evaluate --device cpu with the committed weights writes
    <model>_results.json; benchmark scores it as the JAX package's
    `benchmark` does on the same JSON and labels."""
    root = os.path.dirname(paths["img_dir"])
    out = str(tmp_path)
    res = port_main(["evaluate", "--model", model, "--data-root", root, "--out-dir", out,
                     "--batch-size", "4", "--device", "cpu", "--weights", WEIGHTS[model]])
    pred = os.path.join(out, f"{model}_results.json")
    data = json.load(open(pred))
    assert len(data["human_pred_set_2d"]) == 8 and len(data["human_gt_set_2d"]) == 8
    if model == "popnet":
        assert "human_pred_set_2d_aligned" in data
    got = port_main(["benchmark", "--gt", paths["labels"], "--pred", pred])
    ref = _jax_benchmark(capsys, paths["labels"], pred)
    for k in ("pck2d", "pck3d", "map2d", "map3d"):
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k])), (k, got, ref)
        if model != "popnet":          # evaluate scores the aligned keys of PoP-Net's JSON
            assert res[k] == got[k] or (np.isnan(res[k]) and np.isnan(got[k]))


@pytest.mark.parametrize("argv,match", [
    (["--spatial", "2"], "item 13"),
    (["--ckpt", "x"], "no checkpoint of the port"),
    pytest.param(["--dataset", "coco"], "neither command line evaluates an RGB model; COCO results",
                 id="argv2-item 9b"),
    pytest.param(["--model", "rtpose_vgg"], "neither command line evaluates an RGB model",
                 id="argv3-item 9b"),
    (["--model", "a2j"], "--yolo-weights"),
])
def test_cli_evaluate_refuses_what_is_not_ported(paths, tmp_path, argv, match):
    root = os.path.dirname(paths["img_dir"])
    with pytest.raises(SystemExit, match=match):
        port_main(["evaluate", "--data-root", root, "--out-dir", str(tmp_path),
                   "--device", "cpu", *argv])


# -- evaluate --fold-bn and --quant int8 against the JAX command line ------------------------

@pytest.fixture
def jitted_jax_state_init(monkeypatch):
    """The JAX command line's `evaluate --ckpt` builds a train state from the
    model's init only to replace its variables with the checkpoint's: here
    that init runs as one jitted program instead of op by op (its values are
    never read), which spares a compile for each of its ops. The forward
    passes stay op by op, as the command line runs them."""
    import jax

    import popnet_tpu.train.state as jstate

    create = jstate.create_train_state

    class JittedInit:
        def __init__(self, model):
            self.model, self.apply = model, model.apply

        def init(self, rng, sample, train=False):
            return jax.jit(lambda r, a: self.model.init(r, a, train=train))(rng, sample)

    monkeypatch.setattr(jstate, "create_train_state",
                        lambda model, *a, **kw: create(JittedInit(model), *a, **kw))

@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    """tests/test_quant_int8.py's held-out set (frozen mp-aug composites of
    16 scenes at seed 777, people over backgrounds, where the committed
    PoP-Net and Yolo weights find them), and a JAX checkpoint directory of
    each family's committed weights, which the JAX command line's
    `evaluate --ckpt` reads."""
    from popnet_tpu.serving import variables_from_npz
    from popnet_tpu.train.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("torch_eval_deploy")
    scenes, data = str(root / "scenes"), str(root / "frozen")
    synthetic_data.build(scenes, n_images=16, n_locations=5, seed=777)
    jax_main(["generate-augset", "--kind", "mpaug", "--data-root", scenes, "--out-dir", data,
              "--seed", "777"])
    with open(os.path.join(data, "labels_test.json")) as f:
        labels = json.load(f)
    first = {k: v for k, v in list(labels.items())[:8]}
    if "intrinsics" in labels:
        first["intrinsics"] = labels["intrinsics"]
    with open(os.path.join(data, "labels_test_8.json"), "w") as f:
        json.dump(first, f)
    ckpts = {}
    for model in ("popnet", "yolo"):
        ckpts[model] = str(root / f"ckpt_{model}")
        save_checkpoint(ckpts[model], dict(variables_from_npz(WEIGHTS[model])), 0)
    return data, ckpts


DEPLOY_CASES = [("yolo", ["--fold-bn"]), ("popnet", ["--quant", "int8"])]


@pytest.mark.parametrize("model,flags", DEPLOY_CASES,
                         ids=[f"{m}{''.join(f)}" for m, f in DEPLOY_CASES])
def test_cli_evaluate_deploy_flags_match_the_jax_command_line(frozen, tmp_path, capsys, model,
                                                             flags, jitted_jax_state_init):
    """`evaluate --fold-bn` and `--quant int8` on the CPU against the JAX
    command line's `evaluate` with the same flags, weights and frames
    (the set's first 8 frames, batch 8: JAX's command line calls the model
    op by op, slowly on the CPU): the same people in every frame, and the
    prediction JSON's values within bars. Folded: joints2d 1e-3 px, the rest 1e-5 (measured
    1.7e-4 px and 1.9e-6). int8 (JAX's command line calls the model op by
    op, and the port rounds as it does, `rounding="eager"`; the float
    layers between the int8 convs round apart by ulps, which moves a
    quantized value a step here and there): 98% of the joints within 2.3
    px, their depths within 0.1 m and confidences within 0.01 (measured:
    all but one aligned joint at 10.5 px; 0.07 m, 0.0025), and the four
    metrics within 0.02 of JAX's."""
    data, ckpts = frozen
    common = ["evaluate", "--model", model, "--data-root", data, "--labels",
              "labels_test_8.json", "--batch-size", "8", *flags]
    jax_main([*common, "--ckpt", ckpts[model], "--out-dir", str(tmp_path / "jax")])
    capsys.readouterr()
    got_m = port_main([*common, "--weights", WEIGHTS[model], "--device", "cpu",
                       "--out-dir", str(tmp_path / "port")])
    ref = json.load(open(tmp_path / "jax" / f"{model}_results.json"))
    got = json.load(open(tmp_path / "port" / f"{model}_results.json"))
    assert sorted(got) == sorted(ref)
    for k in GT_KEYS[::2]:
        assert got[k] == ref[k], k
    int8 = "--quant" in flags
    for k in (k for k in PRED_KEYS if k in ref):
        assert [len(a) for a in got[k]] == [len(a) for a in ref[k]], k
        atol = {"2d": 2.3 if int8 else 1e-3, "3d": 0.1 if int8 else 1e-5,
                "conf": 0.01 if int8 else 1e-5}[k.split("_")[3] if "part" not in k else "conf"]
        if not int8:
            assert_json(got, ref, k, atol=atol)
            continue
        err = np.concatenate([np.abs(np.asarray(a, float) - np.asarray(b, float)).reshape(
            len(a), -1).max(axis=1) for ga, ra in zip(got[k], ref[k]) for a, b in zip(ga, ra)])
        assert (err <= atol).mean() >= 0.98, (k, (err <= atol).mean())
    ref_m = pev.evaluate_eval_data(ref, verbose=False)
    for k in ("pck2d", "pck3d", "map2d", "map3d"):
        assert abs(got_m[k] - ref_m[k]) <= (0.02 if int8 else 1e-6), (k, got_m, ref_m)


def test_cli_evaluate_a2j_ignores_quant_and_says_so(paths, tmp_path, monkeypatch, capsys):
    """As the JAX command line's a2j path never reads --quant, the port's
    `evaluate --model a2j --quant int8` builds both stages without int8
    (and folds both with --fold-bn), after printing one line that says so."""
    import popnet_tpu_torch.cli.main as cli

    seen = {}

    def stop(*args, **kwargs):
        seen.update(kwargs)
        raise RuntimeError("stop")

    monkeypatch.setattr(cli, "make_infers", stop)
    root = os.path.dirname(paths["img_dir"])
    with pytest.raises(RuntimeError, match="stop"):
        port_main(["evaluate", "--model", "a2j", "--gt-boxes", "--data-root", root,
                   "--out-dir", str(tmp_path), "--device", "cpu", "--quant", "int8",
                   "--fold-bn"])
    assert seen["quant"] is None and seen["fold_bn"] is True
    out = capsys.readouterr().out.splitlines()
    assert [ln for ln in out if "--quant is ignored" in ln] == [
        "evaluate --model a2j: --quant is ignored, as the JAX command line ignores it (both "
        "stages run float32 convs)"]
