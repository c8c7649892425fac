"""B4's plain versions (vo_tpu_torch/ops/rowconv_cuda.py) against vo_tpu's
Pallas row convolution in interpret mode and against the SIFT gradient
maps, the two-pass entry point against the single-axis ones, and
reflect-101 past the edge of an axis (the repair that SIFT's smallest
octaves need) against vo_tpu's jnp.pad.

Tolerance: 1e-5 of max |input| against the Pallas kernel (its column pass
is transpose, row pass, transpose; the sums are the same taps in the same
order); measured 0 on every case here. The gradient maps and the periodic
reflection agree bit for bit: both sides run the same shift-add slices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.frontend import sift as jsift
from vo_tpu.ops.conv import gaussian_kernel_1d, separable_conv_same
from vo_tpu.ops.pallas_conv import conv_cols_pallas, conv_rows_pallas
from vo_tpu_torch.frontend import sift as tsift
from vo_tpu_torch.ops import blur_cuda, rowconv_cuda
from vo_tpu_torch.ops import conv as tconv
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

DIFF = (-0.5, 0.0, 0.5)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize(
    "shape,taps",
    [
        ((70, 530), DIFF),
        ((33, 45), tuple(gaussian_kernel_1d(15, 3.0))),
    ],
)
def test_conv_matches_pallas(rng, shape, taps):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    tol = 1e-5 * np.abs(img).max()
    x = torch.from_numpy(img)
    before = rowconv_cuda.launches
    rows = rowconv_cuda.conv_rows(x, taps).numpy()
    cols = rowconv_cuda.conv_cols(x, taps).numpy()
    assert rowconv_cuda.launches == before  # CPU tensors: plain version only
    want_r = np.asarray(conv_rows_pallas(jnp.asarray(img), taps,
                                         interpret=True))
    want_c = np.asarray(conv_cols_pallas(jnp.asarray(img), taps,
                                         interpret=True))
    np.testing.assert_allclose(rows, want_r, rtol=0, atol=tol)
    np.testing.assert_allclose(cols, want_c, rtol=0, atol=tol)


def test_grad_maps_match_sift(rng):
    """Gradients of a layer stack over its layer-flattened array: the
    column pass reads the neighbouring layer's rows at a layer boundary
    and reflects only at the two ends, as vo_tpu's does."""
    g = rng.uniform(0, 255, (6, 24, 40)).astype(np.float32)
    jgx, jgy = (np.asarray(a) for a in jsift._grad_maps(jnp.asarray(g)))
    before = rowconv_cuda.launches
    tgx, tgy = tsift._grad_maps(torch.from_numpy(g))
    assert rowconv_cuda.launches == before  # CPU tensors: plain version only
    np.testing.assert_array_equal(tgx.numpy(), jgx.reshape(-1, 40))
    np.testing.assert_array_equal(tgy.numpy(), jgy.reshape(-1, 40))
    # a boundary row really reads its neighbour layer (row 24 = layer 1's
    # first row): no reflection inside the flattened array
    flat = g.reshape(-1, 40)
    np.testing.assert_array_equal(
        tgy.numpy()[24], np.float32(-0.5) * flat[23] + np.float32(0.5) * flat[25])


@pytest.mark.parametrize("n,pad", [(5, 12), (6, 12), (12, 12), (2, 7), (1, 3),
                                   (3, 20), (7, 6), (4, 1)])
def test_reflect_pad_past_the_edge(rng, n, pad):
    img = rng.uniform(0, 255, (n, n + 3)).astype(np.float32)
    want = np.asarray(jnp.pad(jnp.asarray(img), ((pad, pad), (pad, pad)),
                              mode="reflect"))
    got = tconv.reflect_pad(torch.from_numpy(img), pad, pad).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(6, 20), (12, 39), (2, 6, 20)])
def test_blur_past_the_edge_matches_reference(rng, shape):
    """SIFT's smallest octaves at KITTI shape (12x39, 6x20) under its
    widest incremental blur (25 taps): periodic reflect-101, as vo_tpu's
    separable_conv_same gives (its Pallas blur falls back to it there)."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    k = gaussian_kernel_1d(25, 3.09).astype(np.float32)
    want = np.asarray(separable_conv_same(jnp.asarray(img), k, k))
    got = blur_cuda.separable_blur(torch.from_numpy(img), k, k).numpy()
    np.testing.assert_array_equal(got, want)
    rows = rowconv_cuda.conv_rows(torch.from_numpy(img), k).numpy()
    want_r = np.asarray(separable_conv_same(jnp.asarray(img), [1.0], k))
    np.testing.assert_array_equal(rows, want_r)


def test_rowconv_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        rowconv_cuda.conv_rows(torch.zeros(8, 8), (0.5, 0.5))
    with pytest.raises(ValueError):
        rowconv_cuda.conv_cols(torch.zeros(200, 200), np.ones(131) / 131)
    with pytest.raises(ValueError):
        rowconv_cuda.conv_rows(torch.zeros(8), DIFF)


@pytest.mark.parametrize(
    "shape,taps",
    [
        ((6 * 24, 40), DIFF),  # SIFT's layer-flattened stack
        ((2, 6, 20), DIFF),  # planes of SIFT's smallest octave
        ((3, 33, 45), tuple(gaussian_kernel_1d(5, 1.0))),
        ((1, 2, 7), tuple(gaussian_kernel_1d(9, 2.0))),  # radius past both axes
    ],
)
def test_conv_rows_cols_matches_single_axis(rng, shape, taps):
    """Both passes from one call: bit for bit the two single-axis calls."""
    x = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
    before = rowconv_cuda.launches
    rows, cols = rowconv_cuda.conv_rows_cols(x, taps)
    assert rowconv_cuda.launches == before  # CPU tensors: plain version only
    np.testing.assert_array_equal(rows.numpy(),
                                  rowconv_cuda.conv_rows(x, taps).numpy())
    np.testing.assert_array_equal(cols.numpy(),
                                  rowconv_cuda.conv_cols(x, taps).numpy())


def test_conv_rows_cols_rejects_what_the_kernel_cannot_take():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError):  # radius above MAX_PAIR_RADIUS
        rowconv_cuda.conv_rows_cols(x, gaussian_kernel_1d(11, 2.0))
    with pytest.raises(ValueError):
        rowconv_cuda.conv_rows_cols(x, (0.5, 0.5))
    with pytest.raises(ValueError):
        rowconv_cuda.conv_rows_cols(torch.zeros(8), DIFF)
