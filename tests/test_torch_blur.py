"""B2's plain version (vo_tpu_torch/ops/blur_cuda.py) against
vo_tpu.ops.conv.separable_conv_same, on the cases of
tests/test_pallas_blur.py, at the atol 2e-3 that vo_tpu holds its own
Pallas blur to on 0..255 images (f32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.ops.conv import BINOMIAL_5, gaussian_kernel_1d, separable_conv_same
from vo_tpu_torch.ops import blur_cuda
from vo_tpu_torch.ops import conv as tconv
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize(
    "shape,ky,kx",
    [
        ((96, 128), BINOMIAL_5, BINOMIAL_5),
        ((94, 155), gaussian_kernel_1d(9, 1.2), gaussian_kernel_1d(9, 1.2)),
        ((37, 51), BINOMIAL_5, BINOMIAL_5),
        ((64, 96), gaussian_kernel_1d(5, 1.0), gaussian_kernel_1d(9, 2.0)),
        ((3, 40, 56), gaussian_kernel_1d(7, 1.4), gaussian_kernel_1d(7, 1.4)),
    ],
)
def test_blur_matches_reference(rng, shape, ky, kx):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(separable_conv_same(jnp.asarray(img), ky, kx))
    before = blur_cuda.launches
    out = blur_cuda.separable_blur(torch.from_numpy(img), ky, kx)
    assert blur_cuda.launches == before  # CPU tensors: plain version only
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)
    # the port's conv module routes odd taps through the same wrapper
    via_conv = tconv.separable_conv_same(torch.from_numpy(img), ky, kx)
    np.testing.assert_array_equal(via_conv.numpy(), out.numpy())


def test_blur_rejects_what_the_kernel_cannot_take():
    # a radius past the edge of an axis is taken (periodic reflect-101,
    # tests/test_torch_rowconv.py); a 1-D input is not
    with pytest.raises(ValueError):
        blur_cuda.separable_blur(torch.zeros(40), BINOMIAL_5, BINOMIAL_5)
    with pytest.raises(ValueError):
        blur_cuda.separable_blur(torch.zeros(20, 20), np.ones(4) / 4,
                                 BINOMIAL_5)
    with pytest.raises(ValueError):
        blur_cuda.separable_blur(torch.zeros(200, 200), np.ones(131) / 131,
                                 BINOMIAL_5)
