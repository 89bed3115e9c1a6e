"""Port vs JAX on the COCO RGB path (float32, on the CPU): the COCO-18
tables, the RGB normalizations, RTPoseVGG with both trunks, the 2D PAF
decode with the COCO tables at the serving grid (46x46), its plain kernel
versions at COCO sizes, flip averaging and the whole serving pipeline."""

import fractions

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from popnet_tpu.core.config import DecodeConfig as JaxDecodeConfig
from popnet_tpu.core.config import EncoderConfig
from popnet_tpu.core import skeleton_coco as jax_coco
from popnet_tpu.data import preprocessing as jax_pre
from popnet_tpu.decode.assemble_device import assemble_batched as jax_assemble
from popnet_tpu.decode.assemble_pallas import assemble_ids_pallas
from popnet_tpu.decode.device import find_peaks_batched as jax_find_peaks
from popnet_tpu.decode.device import score_limb_pairs_batched as jax_score_pairs
from popnet_tpu.decode.flip_average import flip_average_infer as jax_flip_average
from popnet_tpu.decode.openpose_infer import paf_decode_2d as jax_paf_decode_2d
from popnet_tpu.models import RTPoseVGG as FlaxRTPoseVGG
from popnet_tpu.ops import encoders
from popnet_tpu.ops.resize import resize_bilinear_cv2 as jax_resize
from popnet_tpu.serving import build_rtpose_vgg_pipeline as jax_build
from popnet_tpu.serving import unpack_outputs_2d as jax_unpack_2d
from popnet_tpu_torch import build_rtpose_vgg_pipeline
from popnet_tpu_torch.core import skeleton_coco
from popnet_tpu_torch.core.numerics import fma_f32
from popnet_tpu_torch.core.skeleton_coco import COCO_LIMBS, COCO_NUM_JOINTS, COCO_SWAP_INDICES
from popnet_tpu_torch.data import preprocessing
from popnet_tpu_torch.decode.assemble_device import assemble_batched
from popnet_tpu_torch.decode.device import find_peaks_batched
from popnet_tpu_torch.decode.flip_average import flip_average_infer
from popnet_tpu_torch.decode.openpose_infer import paf_decode_2d
from popnet_tpu_torch.interop.from_jax import load_into
from popnet_tpu_torch.models import RTPoseVGG
from popnet_tpu_torch.ops import kernels
from popnet_tpu_torch.serving import preproc_rgb, unpack_outputs_2d

COCO_CFG = EncoderConfig(input_x=368, input_y=368, num_joints=COCO_NUM_JOINTS,
                         num_limbs=len(COCO_LIMBS))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads a test process: the suite runs in several."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_coco_skeleton_copy_matches_jax():
    assert skeleton_coco.COCO_KEYPOINT_NAMES == jax_coco.COCO_KEYPOINT_NAMES
    assert COCO_LIMBS == jax_coco.COCO_LIMBS and skeleton_coco.COCO_NUM_LIMBS == 19
    assert COCO_NUM_JOINTS == jax_coco.COCO_NUM_JOINTS == 18
    assert COCO_SWAP_INDICES == jax_coco.COCO_SWAP_INDICES


def bgr_images(seed, shape=(2, 37, 53, 3)):
    """BGR values in [0, 255]: uniform floats, the 256 integers, and values
    below 1, where the fused multiply-add of `vgg` rounds apart from two
    roundings most often."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    flat = x.reshape(-1, 3)
    flat[:256] = np.arange(256, dtype=np.float32)[:, None]
    flat[256:512] = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    return x


@pytest.mark.parametrize("mode", ["rtpose", "vgg", "inception", "ssd"])
def test_normalizations_match_jax(mode):
    """Against the JAX package's NumPy normalizations and their inverses:
    exact, but `vgg`, which the port rounds as the compiled JAX pipeline
    does: a fused multiply-add and a multiply by the reciprocal of the std
    against NumPy's three roundings and a division, within 4 float32 ulps
    of values below 4 (3 seen)."""
    x = bgr_images(0)
    got = preprocessing.preprocess(torch.from_numpy(x), mode).numpy()
    ref = jax_pre.preprocess(x, mode)
    assert got.dtype == np.float32 and got.shape == ref.shape
    if mode == "vgg":
        np.testing.assert_allclose(got, ref, rtol=0, atol=4 * 2.0 ** -22)
        assert (got != ref).any()                   # the two roundings differ somewhere
    else:
        np.testing.assert_array_equal(got, ref)
    inverse = {"rtpose": "inverse_rtpose_preprocess", "vgg": "inverse_vgg_preprocess",
               "inception": "inverse_inception_preprocess"}.get(mode)
    if inverse:
        y = ref.copy()
        np.testing.assert_array_equal(getattr(preprocessing, inverse)(torch.from_numpy(y)).numpy(),
                                      getattr(jax_pre, inverse)(y))
    passthrough = torch.from_numpy(x)
    assert preprocessing.preprocess(passthrough, "unknown") is passthrough


def _jax_norm(mode):
    """The JAX RGB pipeline's normalization (popnet_tpu/serving.py
    build_rtpose_vgg_pipeline `_norm`), compiled as the pipeline compiles it."""
    def norm(x):
        if mode == "rtpose":
            return x / 256.0 - 0.5
        if mode == "vgg":
            x = x[..., ::-1] / 255.0
            return (x - jnp.asarray(jax_pre._VGG_MEANS)) / jnp.asarray(jax_pre._VGG_STDS)
        return x[..., ::-1] / 128.0 - 1.0
    return jax.jit(norm)


@pytest.mark.parametrize("mode", ["rtpose", "vgg", "inception"])
def test_pipeline_normalizations_equal_the_compiled_jax_ones_bit_for_bit(mode):
    """XLA multiplies by float32 reciprocals and fuses vgg's x * (1/255) -
    mean into one rounding; the port equals it bit for bit."""
    x = bgr_images(1)
    ref = np.asarray(_jax_norm(mode)(jnp.asarray(x)))
    got = preprocessing.PREPROCESSORS[mode](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_fma_f32_rounds_once():
    """a * b + c against the exactly rounded value (rational arithmetic) and
    against XLA's contraction, on values whose sums fall on or next to the
    halfway points between float32 values, where rounding twice fails."""
    rng = np.random.default_rng(2)
    n = 4096
    a = rng.uniform(0, 2, n).astype(np.float32)
    b = np.float32(1.0) / np.float32(255.0)
    c = -rng.uniform(0.3, 0.6, n).astype(np.float32)
    # a[i] * b + c[i] exactly halfway between two float32 values: the tie
    # cases, and their neighbours one ulp of a away
    exact = [fractions.Fraction(float(ai)) * fractions.Fraction(float(b)) for ai in a[:512]]
    for i in range(512):
        s = np.float32(float(exact[i]) + float(c[i]))
        half = fractions.Fraction(float(np.spacing(np.abs(s)))) / 2
        c[i] = np.float32(float(fractions.Fraction(float(s)) + half - exact[i]))
    got = fma_f32(torch.from_numpy(a), b, torch.from_numpy(c)).numpy()
    for i in range(n):
        want = np.float32(float(fractions.Fraction(float(a[i])) * fractions.Fraction(float(b))
                                + fractions.Fraction(float(c[i]))))
        assert got[i] == want, (i, a[i], c[i], got[i], want)
    xla = np.asarray(jax.jit(lambda a, c: a * b + c)(jnp.asarray(a), jnp.asarray(c)))
    np.testing.assert_array_equal(got, xla)


def _jax_first_stage(frames, size, mode):
    """The JAX RGB pipeline up to its CNN: frames folded into channels,
    resized, unfolded, normalized (popnet_tpu/serving.py
    build_rtpose_vgg_pipeline)."""
    norm = _jax_norm(mode)

    @jax.jit
    def stage(frames):
        B, H, W, _ = frames.shape
        x = jnp.transpose(frames, (1, 2, 0, 3)).reshape(H, W, -1)
        x = jax_resize(x.astype(jnp.float32), size, size)
        return norm(x.reshape(size, size, B, 3).transpose(2, 0, 1, 3))

    return np.asarray(stage(jnp.asarray(frames)))


@pytest.mark.parametrize("mode", ["rtpose", "vgg", "inception"])
def test_rgb_preproc_matches_jax_first_stage(mode):
    frames = np.random.default_rng(3).uniform(0, 255, (3, 120, 160, 3)).astype(np.float32)
    ref = _jax_first_stage(frames, 64, mode)
    got = preproc_rgb(torch.from_numpy(frames), 64, mode).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def flax_init(trunk, rng):
    """Flax RTPoseVGG variables at 64x64 (the tree of its init), every conv
    kernel drawn at He gain and every bias and BatchNorm value at random, so
    the maps carry signal through 15 trunk and 36 branch convs (the init's
    normal(0.01) kernels would leave them near zero).
    Returns the variables as a tree and as {'/'-joined path: array}."""
    variables = jax.eval_shape(lambda: FlaxRTPoseVGG(trunk=trunk).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    flat = {"/".join(getattr(k, "key", str(k)) for k in kp): np.zeros(v.shape, np.float32)
            for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]}
    for k, v in flat.items():
        if k.endswith("/kernel"):
            fan_in = v.shape[0] * v.shape[1] * v.shape[2]
            flat[k] = (rng.normal(0, 1, v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        elif k.endswith("/bias"):
            flat[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
        elif k.endswith("/mean"):
            flat[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree, flat


@pytest.fixture(scope="module", params=["vgg19", "mobilenet"])
def carried(request):
    """(trunk, tree, flat) of `flax_init` for each trunk, shared by the
    model and pipeline tests."""
    return (request.param, *flax_init(request.param, np.random.default_rng(4)))


def test_rtpose_vgg_matches_flax(carried):
    """All 12 saved maps within 1e-4 of Flax (float32, 64x64 input), from a
    Flax init carried across by name (the MobileNet trunk's depthwise
    kernels and BatchNorm statistics included)."""
    trunk, tree, flat = carried
    rng = np.random.default_rng(5)
    if trunk == "mobilenet":
        assert flat["params/trunk/Conv_1/kernel"].shape == (3, 3, 1, 32)
        assert "batch_stats/trunk/BatchNorm_8/var" in flat
    x = rng.normal(0, 0.5, (2, 64, 64, 3)).astype(np.float32)
    (paf, heat), saved = FlaxRTPoseVGG(trunk=trunk).apply(tree, jnp.asarray(x), train=False)
    model = load_into(RTPoseVGG(trunk=trunk), flat).eval()
    if trunk == "mobilenet":
        assert model.trunk.Conv_1.groups == 32 and model.trunk.Conv_1.weight.shape == (32, 1, 3, 3)
    with torch.no_grad():
        (tpaf, theat), tsaved = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(tpaf.shape) == (2, 38, 8, 8) and tuple(theat.shape) == (2, 19, 8, 8)
    assert len(tsaved) == len(saved) == 12
    for ref, got in zip(saved, tsaved):
        ref, got = np.asarray(ref), got.permute(0, 2, 3, 1).numpy()
        assert ref.std() > 0.05                     # the maps carry signal
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("trunk", ["vgg19", "mobilenet"])
def test_rtpose_vgg_init_seeded_follows_the_flax_initialisers(trunk):
    """normal(0.01) kernels in the VGG19 trunk and every branch, truncated
    LeCun-normal ones in the MobileNet trunk, zero biases, unit BatchNorm;
    the same seed gives the same values."""
    a, b = RTPoseVGG(trunk=trunk).init_seeded(3), RTPoseVGG(trunk=trunk).init_seeded(3)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    w = a.stage2_paf.ConvBN_0.Conv_0.weight
    assert abs(float(w.detach().std()) - 0.01) < 2e-4
    assert float(a.stage2_paf.Conv_0.bias.detach().abs().max()) == 0
    if trunk == "vgg19":
        assert abs(float(a.trunk.conv4_1.weight.detach().std()) - 0.01) < 2e-4
    else:
        w = a.trunk.Conv_2.weight.detach()                     # a 1x1 conv over 32 channels
        std = (1 / 32) ** 0.5
        assert abs(float(w.std()) - std) < 0.01 and float(w.abs().max()) <= 2 * 1.14 * std
        assert torch.equal(a.trunk.BatchNorm_3.running_var, torch.ones(64))


def coco_maps(seed, B=3, people=(2, 3, 3)):
    """(heat (B, 46, 46, 19), paf (B, 46, 46, 38)) of 2-3 people a frame,
    encoded by the JAX package's GT encoders at the serving grid, with a
    little noise."""
    rng = np.random.default_rng(seed)
    heats, pafs = [], []
    for b in range(B):
        j2 = np.full((COCO_CFG.max_people, COCO_NUM_JOINTS, 2), -1e6, np.float32)
        valid = np.zeros(COCO_CFG.max_people, bool)
        for p in range(people[b % len(people)]):
            j2[p] = np.clip(rng.uniform(90, 280, 2) + rng.normal(0, 30, (COCO_NUM_JOINTS, 2)),
                            8, 359)
            valid[p] = True
        h = np.asarray(encoders.encode_heatmaps(jnp.asarray(j2), jnp.asarray(valid), COCO_CFG))
        f = np.asarray(encoders.encode_pafs(jnp.asarray(j2), jnp.asarray(valid), COCO_CFG,
                                            limbs=COCO_LIMBS))
        heats.append(h + rng.normal(0, 0.005, h.shape))
        pafs.append(f + rng.normal(0, 0.005, f.shape))
    return np.stack(heats).astype(np.float32), np.stack(pafs).astype(np.float32)


def test_paf_decode_2d_matches_jax_on_coco_maps():
    """The decode on encoded COCO maps at 46x46, scaled to a 640x480 frame:
    counts and visibility exact, joints2d and conf within 1e-4."""
    heat, paf = coco_maps(5)
    assert heat.shape == (3, 46, 46, 19) and paf.shape == (3, 46, 46, 38)
    sx, sy = 640 / 368, 480 / 368
    ref = jax_paf_decode_2d(jnp.asarray(heat), jnp.asarray(paf), COCO_NUM_JOINTS,
                            JaxDecodeConfig(), COCO_LIMBS, sx=sx, sy=sy)
    got = paf_decode_2d(torch.from_numpy(heat), torch.from_numpy(paf), COCO_NUM_JOINTS,
                        limbs=COCO_LIMBS, sx=sx, sy=sy)
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(ref["counts"]))
    np.testing.assert_array_equal(got["visibility"].numpy(), np.asarray(ref["visibility"]))
    np.testing.assert_allclose(got["joints2d"].numpy(), np.asarray(ref["joints2d"]), atol=1e-4)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(ref["conf"]), atol=1e-4)
    assert (got["counts"] >= 2).all()


def test_paf_score_and_assembly_plain_match_jax_at_coco_sizes():
    """K3's and K6's plain versions at 18 joints, 19 limbs and 46x46 maps
    against the JAX decode's functions: pair scores within 1e-5 and ok exact
    (the XLA path, which the Pallas kernel equals in the JAX package's
    tests; the Pallas kernel in interpret mode takes 50 s at these sizes);
    ids and counts exact against assemble_ids_pallas and the joints against
    the JAX scan."""
    heat, paf = coco_maps(6)
    peaks, valid = (np.array(a) for a in jax_find_peaks(jnp.asarray(heat),
                                                           num_joints=COCO_NUM_JOINTS))
    ref_s, ref_ok = jax_score_pairs(jnp.asarray(paf), jnp.asarray(peaks), jnp.asarray(valid),
                                    limbs=COCO_LIMBS, method="onehot")
    got_s, got_ok = kernels.paf_score_plain(torch.from_numpy(paf), torch.from_numpy(peaks),
                                            torch.from_numpy(valid), COCO_LIMBS)
    assert tuple(got_s.shape) == (3, 19, 16, 16)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5)
    assert got_ok.any()
    ok, s = np.array(ref_ok), np.array(ref_s)
    s_masked = np.where(ok, s, -np.inf).astype(np.float32)
    ref_ids, ref_cnt = assemble_ids_pallas(jnp.asarray(peaks[..., 2]), jnp.asarray(s_masked),
                                           limbs=COCO_LIMBS, interpret=True)
    got_ids, got_cnt = kernels.assemble_ids_plain(
        torch.from_numpy(np.ascontiguousarray(peaks[..., 2])), torch.from_numpy(s_masked),
        COCO_LIMBS)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(ref_cnt))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
    scan_j, scan_c = jax_assemble(*(jnp.asarray(a) for a in (peaks, valid, s, ok)),
                                  limbs=COCO_LIMBS, method="scan")
    j, c = assemble_batched(*(torch.from_numpy(a) for a in (peaks, valid, s, ok)),
                            limbs=COCO_LIMBS)
    np.testing.assert_array_equal(c.numpy(), np.asarray(scan_c))
    np.testing.assert_array_equal(j.numpy(), np.asarray(scan_j))
    # K1 reads the first 18 of 19 heat channels through a strided view
    pk, v = find_peaks_batched(torch.from_numpy(heat), num_joints=COCO_NUM_JOINTS)
    np.testing.assert_array_equal(v.numpy(), valid)
    np.testing.assert_allclose(pk.numpy(), peaks, atol=1e-5)


def test_flip_average_matches_jax():
    """flip_average_infer with the COCO tables: the mirrored pass brought
    back (width flip, left/right swaps, PAF x negated) and averaged, equal
    to JAX's."""
    rng = np.random.default_rng(7)
    images = rng.normal(0, 1, (2, 16, 12, 3)).astype(np.float32)
    wp = rng.normal(0, 1, (3, 38)).astype(np.float32)
    wh = rng.normal(0, 1, (3, 19)).astype(np.float32)

    def infer_np(x):                       # a map per pixel, not flip-equivariant
        return x @ wp, x @ wh, x.sum(-1)

    ref = jax_flip_average(lambda x: tuple(jnp.asarray(t) for t in infer_np(np.asarray(x))),
                           jnp.asarray(images), COCO_LIMBS, COCO_SWAP_INDICES)
    got = flip_average_infer(lambda x: tuple(torch.from_numpy(t) for t in infer_np(x.numpy())),
                             torch.from_numpy(images), COCO_LIMBS, COCO_SWAP_INDICES)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_rtpose_vgg_pipeline_matches_jax_pipeline(carried):
    """The serving pipeline at input_size 64 on 2 frames of 120x160, from
    one Flax init carried across: the packed (joints2d, conf, counts)
    buffer within 1e-4 of JAX's, people found."""
    trunk, tree, flat = carried
    rng = np.random.default_rng(8)
    frames = rng.uniform(0, 255, (2, 120, 160, 3)).astype(np.float32)
    ref = np.asarray(jax_build(tree, dtype=jnp.float32, trunk=trunk, input_size=64)(
        jnp.asarray(frames)))
    got = build_rtpose_vgg_pipeline(flat, dtype=torch.float32, device="cpu", trunk=trunk,
                                    input_size=64)(frames).numpy()
    assert got.shape == ref.shape == (2, 16 * 18 * 3 + 1)
    a, b = unpack_outputs_2d(got, 16, 18), jax_unpack_2d(ref, 16, 18)
    np.testing.assert_array_equal(a["counts"], b["counts"])
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert b["counts"].sum() > 0


def test_rtpose_vgg_builder_refuses_what_it_does_not_serve():
    with pytest.raises(ValueError, match="only the f32 wire"):
        build_rtpose_vgg_pipeline(device="cpu", pack="q16")
    with pytest.raises(ValueError, match="preprocess"):
        build_rtpose_vgg_pipeline(device="cpu", preprocess="ssd")
    with pytest.raises(ValueError, match="trunk"):
        RTPoseVGG(trunk="resnet")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_rtpose_vgg_pipeline()
