"""The port's native host assembler (popnet_tpu_torch.native, csrc/assembler.cpp)
against the JAX package's (popnet_tpu.native) bit for bit, and against the
NumPy assembler (decode/assemble.py) wherever at most max_people people
survive: seeded candidates, tied scores, people exactly at min_parts and at
min_score, frames with no candidate, and a crowd frame on which the NumPy
assembler finds 32 people and the native ones stop at 16. Without a host
C++ compiler the call raises, naming it."""

import os

import numpy as np
import pytest

from popnet_tpu import native as jnative
from popnet_tpu.core.skeleton import LIMBS as JAX_LIMBS
from popnet_tpu.decode import assemble as jassemble
from popnet_tpu_torch import native
from popnet_tpu_torch.core.skeleton import LIMBS, NUM_JOINTS
from popnet_tpu_torch.decode.assemble import assemble_batch
from popnet_tpu_torch.ops import _build

import chip_smoke

K, M = NUM_JOINTS, 16
L = len(LIMBS)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builds():
    assert jnative.available(), "the JAX package's native assembler does not build"
    assert tuple(map(tuple, JAX_LIMBS)) == tuple(map(tuple, LIMBS))


def seeded(rng, B: int, density: float, n_valid=None, quantize: bool = False):
    """(peaks, valid, scores, ok): valid peaks first in each joint's slots
    (K1's contract), candidates among valid pairs at `density`; with
    `quantize`, scores on a 1/8 grid, so many tie."""
    n_valid = rng.integers(0, M + 1, (B, K)) if n_valid is None else n_valid
    valid = np.arange(M)[None, None] < n_valid[..., None]
    peaks = np.stack([rng.uniform(0, 224, (B, K, M)), rng.uniform(0, 224, (B, K, M)),
                      rng.uniform(0.05, 1.0, (B, K, M))], -1).astype(np.float32)
    peaks[~valid] = 0.0
    scores = rng.uniform(-0.2, 1.5, (B, L, M, M))
    if quantize:
        scores = np.round(scores * 8) / 8
    limbs = np.asarray(LIMBS)
    ok = (rng.uniform(size=(B, L, M, M)) < density) \
        & valid[:, limbs[:, 0], :, None] & valid[:, limbs[:, 1], None, :]
    return peaks, valid, scores.astype(np.float32), ok


def routes(cand, max_people=16, min_parts=3, min_score=0.2):
    """(port native, JAX native, port NumPy lists, JAX NumPy lists)."""
    kw = dict(min_parts=min_parts, min_score=min_score)
    got = native.assemble_batch_native(*cand, LIMBS, max_people=max_people, **kw)
    ref = jnative.assemble_batch_native(*cand, JAX_LIMBS, max_people=max_people, **kw)
    return got, ref, assemble_batch(*cand, **kw), jassemble.assemble_batch(*cand, **kw)


def check(cand, max_people=16, min_parts=3, min_score=0.2) -> list:
    """Port native = JAX native bit for bit (rows, holes, padding, counts);
    where no frame passes max_people, its rows = the NumPy assembler's (the
    port's and JAX's, which agree). Returns the per-frame people counts of
    the NumPy route."""
    (j, c), (jr, cr), lists, jlists = routes(cand, max_people, min_parts, min_score)
    assert j.dtype == np.float32 and c.dtype == np.int32
    assert j.shape == (cand[0].shape[0], max_people, K, 3)
    np.testing.assert_array_equal(j, jr)
    np.testing.assert_array_equal(c, cr)
    assert lists == jlists
    rows = native.human_lists(j, c, K)
    for b, (full, mine) in enumerate(zip(lists, rows)):
        n = len(full[0])
        assert int(c[b]) == min(n, max_people)
        assert mine == tuple(x[:max_people] for x in full), b
        assert not j[b, int(c[b]):].any()
    return [len(x[0]) for x in lists]


@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 0.8])
def test_seeded_candidates_match_jax_and_numpy(density):
    """Eight frames of seeded candidates at each density, from no candidate
    to most pairs."""
    counts = check(seeded(np.random.default_rng([20, int(density * 100)]), 8, density))
    if density == 0.0:
        assert counts == [0] * 8
    elif density >= 0.3:
        assert max(counts) >= 2


def test_tied_scores_keep_the_stable_order():
    """Scores on a 1/8 grid (ties in every limb, +0.0 and -0.0 among them):
    the stable sort keeps the candidates' scan order, as in JAX."""
    rng = np.random.default_rng(21)
    cand = seeded(rng, 8, 0.5, n_valid=np.full((8, K), M), quantize=True)
    cand[2][cand[2] == 0] = np.where(rng.uniform(size=int((cand[2] == 0).sum())) < 0.5, -0.0, 0.0)
    check(cand)


def test_people_at_min_parts_and_at_min_score():
    """A chain of exactly min_parts joints whose mean score is exactly
    min_score (0.25: peaks of 0.25, limbs of 0) is kept; one whose limb
    score is 2**-20 lower (exact in float32 and float64 alike) is dropped,
    and so is a chain of min_parts - 1 joints."""
    peaks = np.zeros((3, K, M, 3), np.float32)
    valid = np.zeros((3, K, M), bool)
    scores = np.zeros((3, L, M, M), np.float32)
    ok = np.zeros((3, L, M, M), bool)
    a, mid = LIMBS[1]
    c = next(d for s, d in LIMBS if s == mid)
    la, lb = LIMBS.index((a, mid)), LIMBS.index((mid, c))
    for b in range(3):
        valid[b, [a, mid, c], 0] = True
        peaks[b, [a, mid, c], 0] = [[10, 20, 0.25], [30, 40, 0.25], [50, 60, 0.25]]
        ok[b, la, 0, 0] = True
        ok[b, lb, 0, 0] = b != 2              # frame 2: two joints only
    scores[1, lb, 0, 0] = -2.0 ** -20
    assert check((peaks, valid, scores, ok), min_parts=3, min_score=0.25) == [1, 0, 0]


def test_no_candidate_at_all():
    """No valid peak, and valid peaks with no candidate pair: no person, the
    rows all zero."""
    rng = np.random.default_rng(22)
    for n_valid in (np.zeros((2, K), int), np.full((2, K), M)):
        peaks, valid, scores, ok = seeded(rng, 2, 0.0, n_valid=n_valid)
        assert check((peaks, valid, scores, ok)) == [0, 0]


def test_crowd_frame_stops_at_max_people():
    """chip_smoke.crowd_candidates: the NumPy assemblers find 32 people, the
    native ones 16, the NumPy route's first 16 (the fault of the port's
    `evaluate` before the native route, which returned 32)."""
    cand = chip_smoke.crowd_candidates()
    (j, c), (jr, cr), lists, jlists = routes(cand)
    assert len(lists[0][0]) == len(jlists[0][0]) == 32
    assert int(c[0]) == int(cr[0]) == 16
    np.testing.assert_array_equal(j, jr)
    assert native.human_lists(j, c, K)[0] == tuple(x[:16] for x in lists[0])
    assert chip_smoke.crowd_check() == (32, 16)
    # a smaller cap stops sooner, and a larger one keeps them all
    for cap in (5, 40):
        check(cand, max_people=cap)


def test_missing_compiler_raises_naming_it(tmp_path, monkeypatch):
    """$CXX pointing at a missing path and an empty build directory: the
    call raises host_library's error, which names the compiler; no silent
    fallback."""
    missing = str(tmp_path / "no-such-c++")
    monkeypatch.setenv("CXX", missing)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+"):
        native.assemble_batch_native(*chip_smoke.crowd_candidates(), LIMBS)
    assert not os.path.exists(tmp_path / "build" / "popnet_tpu_torch")
    assert not hasattr(native, "available")
