"""Parity of the port's ORB frontend (vo_tpu_torch.frontend.orb) with
vo_tpu's canvas path, at 240x320 with nfeatures=500 over 4 levels.

Slots are canonical (level-major, Harris-descending), so the two keypoint
lists are compared slot by slot. A Harris or FAST value that lands within
float rounding of a budget cut can swap a keypoint, so slots are held to
>= 99 % identical (measured: 100 % on both frames here).

BRIEF is bit-exact given the same smoothed image, keypoints and angles.
End to end, the angles come from 31-tap moment sums (~1e6) whose f32
rounding differs between XLA and torch by ~1e-7 relative, which moves a
rotated pattern point by ~1e-4 px and flips its round-half-even on rare
pairs: measured 2 of 127,488 bits on the agreeing slots of these frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.data.synthetic import SyntheticSequence
from vo_tpu.frontend import orb as jorb
from vo_tpu.ops import fast as jfast
from vo_tpu.ops.harris import harris_response as j_harris
from vo_tpu.ops.hamming import match_descriptors as j_match
from vo_tpu_torch.frontend import orb as torb
from vo_tpu_torch.ops import fast as tfast
from vo_tpu_torch.ops.harris import harris_response as t_harris
from vo_tpu_torch.ops.hamming import match_descriptors as t_match
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

CFG = dict(nfeatures=500, n_levels=4)


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence.generate(n_frames=3, shape=(240, 320),
                                     n_points=1500, seed=0)
    return [seq.frame(0), seq.frame(2)]


@pytest.fixture(scope="module")
def features(frames):
    out = []
    for img in frames:
        fj = jorb.orb_detect_and_compute(jnp.asarray(img),
                                         jorb.OrbConfig(**CFG))
        ft = torb.orb_detect_and_compute(torch.from_numpy(img),
                                         torb.OrbConfig(**CFG))
        out.append((fj, ft))
    return out


def test_dense_stages_match(frames):
    img = frames[0]
    fj = np.asarray(jfast.fast_score(jnp.asarray(img)))
    ft = tfast.fast_score(torch.from_numpy(img)).numpy()
    # FAST sums 16 absolute differences; only rounding order differs
    np.testing.assert_allclose(ft, fj, rtol=1e-6, atol=1e-4)
    hj = np.asarray(j_harris(jnp.asarray(img)))
    ht = t_harris(torch.from_numpy(img)).numpy()
    # Harris is a difference of products of blurred squares (~1e9 on
    # 0..255 images): hold it relative to the map's scale
    np.testing.assert_allclose(ht, hj, atol=1e-5 * np.abs(hj).max())


def test_keypoint_slots_and_bits_match(features):
    for fj, ft in features:
        assert fj.xs.shape == ft.xs.shape == (sum(torb.level_budgets(
            torb.OrbConfig(**CFG))),)
        xj, yj, vj = (np.asarray(a) for a in (fj.xs, fj.ys, fj.valid))
        xt, yt, vt = ft.xs.numpy(), ft.ys.numpy(), ft.valid.numpy()
        same = (vj == vt) & (np.abs(xj - xt) < 1e-3) & (np.abs(yj - yt) < 1e-3)
        assert same.mean() >= 0.99, f"identical slots {same.mean():.4f}"
        assert vj.sum() > 300
        agree = same & vj
        np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
        np.testing.assert_allclose(ft.angles.numpy()[agree],
                                   np.asarray(fj.angles)[agree], atol=1e-4)
        bits_same = ft.bits.numpy()[agree] == np.asarray(fj.bits)[agree]
        assert bits_same.mean() >= 0.9999, bits_same.mean()


def test_brief_bits_exact_on_same_inputs(frames):
    from vo_tpu.ops import brief as jbrief
    from vo_tpu.ops.integral import box_filter5 as j_box
    from vo_tpu_torch.ops import brief as tbrief
    from vo_tpu_torch.ops.integral import box_filter5 as t_box

    img = frames[0]
    rng = np.random.default_rng(2)
    ys = rng.integers(0, 240, 400).astype(np.float32)
    xs = rng.integers(0, 320, 400).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 400).astype(np.float32)
    sm_j = j_box(jnp.asarray(img))
    sm_t = t_box(torch.from_numpy(img))
    np.testing.assert_array_equal(sm_t.numpy(), np.asarray(sm_j))
    bj, pj = jbrief.brief_descriptors(jnp.asarray(img), jnp.asarray(ys),
                                      jnp.asarray(xs), jnp.asarray(ang))
    bt, pt = tbrief.brief_descriptors(torch.from_numpy(img),
                                      torch.from_numpy(ys),
                                      torch.from_numpy(xs),
                                      torch.from_numpy(ang))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_hamming_matching_matches(features):
    (fj0, ft0), (fj1, ft1) = features
    mj = j_match(fj0.bits, fj1.bits, fj0.valid, fj1.valid, 0.8)
    # the same descriptors on both sides, so the match sets are exact
    mt = t_match(torch.from_numpy(np.asarray(fj0.bits)),
                 torch.from_numpy(np.asarray(fj1.bits)),
                 torch.from_numpy(np.asarray(fj0.valid)),
                 torch.from_numpy(np.asarray(fj1.valid)), 0.8)
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    v = np.asarray(mj.valid)
    np.testing.assert_array_equal(mt.idx.numpy()[v], np.asarray(mj.idx)[v])
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
    assert v.sum() > 100
