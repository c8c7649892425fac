"""B3's plain versions (vo_tpu_torch/ops/crop_cuda.py) against vo_tpu's
Pallas crop in interpret mode (inside its domain: S % 8 == 0, 8-aligned
rows, windows inside the image) and against vo_tpu/ops/lk.py:_crop_windows
(any S, windows past the right edge read 0); the two-map entry point
against two single-map crops. A crop copies values, so every comparison is
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.ops.lk import _crop_windows
from vo_tpu.ops.pallas_crop import crop_windows_pallas
from vo_tpu_torch.ops import crop_cuda
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _crop(img, ox, oy, S):
    before = crop_cuda.launches
    out = crop_cuda.crop_windows(torch.from_numpy(img), torch.from_numpy(ox),
                                 torch.from_numpy(oy), S).numpy()
    assert crop_cuda.launches == before  # CPU tensors: plain version only
    return out


@pytest.mark.parametrize("N,S", [(70, 40)])
def test_crop_matches_pallas(rng, N, S):
    H, W = 96, 300
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    ox = rng.integers(0, W - S + 1, N).astype(np.int32)
    oy = (rng.integers(0, (H - S) // 8 + 1, N) * 8).astype(np.int32)
    want = np.asarray(crop_windows_pallas(jnp.asarray(img), jnp.asarray(ox),
                                          jnp.asarray(oy), S, interpret=True))
    np.testing.assert_array_equal(_crop(img, ox, oy, S), want)


@pytest.mark.parametrize("S", [37, 79, 21, 8])
def test_crop_matches_lk_crop(rng, S):
    """Any S and row origin, windows reaching past the right edge."""
    H, W, N = 120, 200, 50
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    ox = rng.integers(0, W, N).astype(np.int32)
    oy = rng.integers(0, H - S + 1, N).astype(np.int32)
    want = np.asarray(_crop_windows(jnp.asarray(img), jnp.asarray(ox),
                                    jnp.asarray(oy), S))
    np.testing.assert_array_equal(_crop(img, ox, oy, S), want)


def test_crop_reads_zero_outside_the_image(rng):
    H, W, S = 30, 50, 16
    img = rng.uniform(1, 255, (H, W)).astype(np.float32)
    ox = np.array([-20, -3, 40, 45, 0, 60], np.int32)
    oy = np.array([-5, 20, -16, 25, 30, 0], np.int32)
    pad = np.zeros((H + 2 * 40, W + 2 * 40), np.float32)
    pad[40:40 + H, 40:40 + W] = img
    want = np.stack([pad[y + 40:y + 40 + S, x + 40:x + 40 + S]
                     for x, y in zip(ox, oy)])
    np.testing.assert_array_equal(_crop(img, ox, oy, S), want)


def test_crop_rejects_what_the_kernel_cannot_take():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        crop_cuda.crop_windows(torch.zeros(200, 200), z, z, 129)
    with pytest.raises(ValueError):
        crop_cuda.crop_windows(torch.zeros(2, 20, 20), z, z, 8)
    with pytest.raises(ValueError):
        crop_cuda.crop_windows(torch.zeros(20, 20), z, z[:3], 8)


def _pair(a, b, ox, oy, S):
    before = crop_cuda.launches
    out = crop_cuda.crop_windows_pair(
        *(torch.from_numpy(v) for v in (a, b, ox, oy)), S).numpy()
    assert crop_cuda.launches == before  # CPU tensors: plain version only
    return out


@pytest.mark.parametrize("S", [37, 79, 8])
def test_crop_pair_matches_crops_and_lk_crop(rng, S):
    """Two maps at the same origins: two single-map crops, stacked, and
    vo_tpu's crop of each (its domain: rows inside, any column origin)."""
    H, W, N = 120, 200, 40
    a = rng.uniform(0, 255, (H, W)).astype(np.float32)
    b = rng.uniform(-1, 1, (H, W)).astype(np.float32)
    ox = rng.integers(0, W, N).astype(np.int32)
    oy = rng.integers(0, H - S + 1, N).astype(np.int32)
    got = _pair(a, b, ox, oy, S)
    assert got.shape == (2, N, S, S)
    for m, img in enumerate((a, b)):
        np.testing.assert_array_equal(got[m], _crop(img, ox, oy, S))
        np.testing.assert_array_equal(
            got[m], np.asarray(_crop_windows(jnp.asarray(img),
                                             jnp.asarray(ox),
                                             jnp.asarray(oy), S)))


def test_crop_pair_reads_zero_past_every_edge(rng):
    H, W, S = 30, 50, 16
    maps = [rng.uniform(1, 255, (H, W)).astype(np.float32) for _ in range(2)]
    ox = np.array([-20, -3, 40, 45, 0, 60, -16, 49], np.int32)
    oy = np.array([-5, 20, -16, 25, 30, 0, 29, -15], np.int32)
    want = []
    for img in maps:
        pad = np.zeros((H + 2 * 40, W + 2 * 40), np.float32)
        pad[40:40 + H, 40:40 + W] = img
        want.append(np.stack([pad[y + 40:y + 40 + S, x + 40:x + 40 + S]
                              for x, y in zip(ox, oy)]))
    np.testing.assert_array_equal(_pair(*maps, ox, oy, S), np.stack(want))


def test_crop_pair_rejects_what_the_kernel_cannot_take():
    z = torch.zeros(4, dtype=torch.int32)
    m = torch.zeros(200, 200)
    for bad in [
        (m, m, z, z, 129),  # S above 128
        (m, m, z, z, 0),
        (m, torch.zeros(200, 199), z, z, 8),  # maps of two shapes
        (torch.zeros(2, 20, 20), torch.zeros(2, 20, 20), z, z, 8),
        (m, m, z, z[:3], 8),
    ]:
        with pytest.raises(ValueError):
            crop_cuda.crop_windows_pair(*bad)
