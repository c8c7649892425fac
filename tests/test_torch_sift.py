"""Parity of the port's SIFT frontend (vo_tpu_torch.frontend.sift, on the
plain versions of B2, B3 and B4 here) with vo_tpu's canvas path, at
120x160 with nfeatures=200 over 3 octaves (6 octaves are built and packed).

Tolerances, and what was measured on this case:
- scale-space layers within 1e-3 on a 0..255 image (f32 sums in another
  order; measured <= 6.1e-5);
- of vo_tpu's valid keypoints (88 and 100 on the two frames), >= 98 % have
  a port keypoint within 0.01 px (measured 100 %, <= 6.1e-5 px); of those,
  >= 98 % have the same angle within 1e-3 rad and a descriptor within
  relative L2 1e-3 (measured 100 %: <= 1.1e-5 rad, <= 3.5e-4). A keypoint
  with a secondary orientation peak is emitted twice at one position, so
  each is paired with the port's keypoint at that position whose angle is
  nearest (vo_tpu_torch.frontend.sift.sift_pairs);
- the sample grids equal vo_tpu's bit for bit: a sample position is
  rounded to the nearest pixel, so the grid's last bit can move it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.data.synthetic import SyntheticSequence
from vo_tpu.frontend import sift as jsift
from vo_tpu.ops import hamming as jham
from vo_tpu.ops import scalespace as jss
from vo_tpu_torch.frontend import sift as tsift
from vo_tpu_torch.frontend.sift import SiftFeatures, sift_pairs
from vo_tpu_torch.ops import hamming as tham
from vo_tpu_torch.ops import scalespace as tss
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

CFG = dict(nfeatures=200, max_image_octaves=3)


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence.generate(n_frames=3, shape=(120, 160),
                                     n_points=1500, seed=0)
    return [seq.frame(0).astype(np.float32), seq.frame(2).astype(np.float32)]


@pytest.fixture(scope="module")
def features(frames):
    out = []
    for img in frames:
        fj = jsift.sift_detect_and_compute(jnp.asarray(img),
                                           jsift.SiftConfig(**CFG))
        ft = tsift.sift_detect_and_compute(torch.from_numpy(img),
                                           tsift.SiftConfig(**CFG))
        out.append((jax.tree.map(np.array, fj), ft))
    return out


@pytest.mark.parametrize("half,n", [(jsift._ORI_RADIUS_SIG, 13),
                                    (jsift._DESC_HALF_BINS, 16)])
def test_sample_grids_match_bit_for_bit(half, n):
    want = np.asarray(jax.jit(
        lambda: jnp.linspace(-half, half, n, dtype=jnp.float32))())
    np.testing.assert_array_equal(tsift.sample_grid(half, n), want)


def test_budgets_and_octaves_match():
    for nf in (200, 500, 3000):
        for n_oct in (3, 7, 8):
            assert tsift.octave_budgets(tsift.SiftConfig(nfeatures=nf),
                                        n_oct) == jsift.octave_budgets(
                jsift.SiftConfig(nfeatures=nf), n_oct)
    for shape in ((120, 160), (240, 320), (376, 1241)):
        for up in (True, False):
            assert tss.n_octaves_for(shape, up) == jss.n_octaves_for(shape, up)
            assert tss.octave_meta(shape, up) == jss.octave_meta(shape, up)
    # KITTI shape: 8 octaves down to 6x20 (the blur repair's case)
    assert tss.n_octaves_for((376, 1241), True) == 8


def test_scale_space_matches(frames):
    img = frames[0]
    gj, dj = jax.jit(jss.build_scale_space)(jnp.asarray(img))
    gt, dt = tss.build_scale_space(torch.from_numpy(img))
    assert len(gt) == len(gj) == 6
    for a, b in zip(gt + dt, gj + dj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3)


def test_keypoints_match(features):
    for fj, ft in features:
        assert ft.xs.shape == (CFG["nfeatures"],)
        assert int(fj.valid.sum()) > 50
        found, dang, rel = sift_pairs(fj, SiftFeatures(
            *(t.numpy() for t in ft)))
        assert found.mean() >= 0.98, found.mean()
        same = (dang[found] < 1e-3) & (rel[found] < 1e-3)
        assert same.mean() >= 0.98, (same.mean(), dang.max(), rel.max())
        # sizes and scores follow the keypoint
        v = fj.valid & ft.valid.numpy()
        np.testing.assert_allclose(ft.sizes.numpy()[v], fj.sizes[v],
                                   rtol=1e-4)


def test_output_order_is_raster(features):
    for _, ft in features:
        v = ft.valid.numpy()
        n = int(v.sum())
        assert v[:n].all() and not v[n:].any()  # invalid slots last
        key = (np.round(ft.ys.numpy()[:n] * 4).astype(np.int64) * 65536
               + np.round(ft.xs.numpy()[:n] * 4).astype(np.int64))
        assert (np.diff(key) >= 0).all()
        assert not ft.desc.numpy()[n:].any()


def test_l2_matching_matches(features):
    (fj0, _), (fj1, _) = features
    tj = np.array(jham.l2_table(jnp.asarray(fj0.desc),
                                jnp.asarray(fj1.desc)))
    tt = tham.l2_table(torch.tensor(fj0.desc), torch.tensor(fj1.desc))
    # squared distances up to 4 * 512^2: f32 products summed in another order
    np.testing.assert_allclose(tt.numpy(), tj, rtol=0, atol=0.5)
    mj = jham.knn2_ratio_match(jnp.asarray(tj), jnp.asarray(fj0.valid),
                               jnp.asarray(fj1.valid), 0.8, squared=True)
    mt = tham.knn2_ratio_match(torch.from_numpy(tj),
                               torch.from_numpy(fj0.valid),
                               torch.from_numpy(fj1.valid), 0.8, squared=True)
    # the same table on both sides: the same matches
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    v = np.asarray(mj.valid)
    np.testing.assert_array_equal(mt.idx.numpy()[v], np.asarray(mj.idx)[v])
    assert v.sum() > 20
    # the ratio is squared on a squared table
    loose = tham.knn2_ratio_match(torch.from_numpy(tj),
                                  torch.from_numpy(fj0.valid),
                                  torch.from_numpy(fj1.valid), 0.8)
    assert int(loose.valid.sum()) >= int(mt.valid.sum())
