"""B1's plain version (vo_tpu_torch/ops/lk_cuda.py, reached through the
port's LK tracker on CPU tensors) against vo_tpu's LK, lanes layout.

The port terminates per point. vo_tpu's lanes path does the same when its
global early exit cannot fire before every point has stopped
(exit_mult = N + 1); against that, only the f32 sums' order differs, so
endpoints agree to ~1e-4 px. Against the default lanes config (exit at
96 % converged) the slow tail keeps iterating in the port, which the
bounds of tests/test_lk_pallas.py cover.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.ops import lk as jlk
from vo_tpu.ops.conv import gaussian_blur
from vo_tpu_torch.ops import lk as tlk
from vo_tpu_torch.ops import lk_cuda
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")


def _scene(seed, H=240, W=320, N=256):
    rng = np.random.default_rng(seed)
    img = rng.uniform(10, 60, (H, W)).astype(np.float32)
    for y, x in zip(rng.integers(8, H - 8, 160), rng.integers(8, W - 8, 160)):
        img[y - 2:y + 3, x - 2:x + 3] += rng.uniform(80, 160)
    img1 = np.asarray(gaussian_blur(jnp.asarray(img), 1.2))
    img2 = np.roll(np.roll(img1, -2, axis=0), 3, axis=1)
    pts = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)],
                   axis=1).astype(np.float32)
    valid = rng.random(N) > 0.05
    return img1, img2, pts, valid


def _track_both(img1, img2, pts, valid, precision, exit_mult, max_level=3):
    jcfg = jlk.LKConfig(max_level=max_level, layout="lanes",
                        precision=precision, exit_mult=exit_mult)
    pj, sj = jlk.lk_pyramid_track(
        jlk.lk_build_pyramid(jnp.asarray(img1), jcfg),
        jlk.lk_build_pyramid(jnp.asarray(img2), jcfg),
        jnp.asarray(pts), jnp.asarray(valid), jcfg)
    tcfg = tlk.LKConfig(max_level=max_level, precision=precision)
    before = lk_cuda.launches
    pt, st = tlk.lk_pyramid_track(
        tlk.lk_build_pyramid(torch.from_numpy(img1), tcfg),
        tlk.lk_build_pyramid(torch.from_numpy(img2), tcfg),
        torch.from_numpy(pts), torch.from_numpy(valid), tcfg)
    assert lk_cuda.launches == before  # CPU tensors: plain version only
    return np.asarray(pj), np.asarray(sj), pt.numpy(), st.numpy()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_matches_per_point_termination(precision):
    img1, img2, pts, valid = _scene(7)
    pj, sj, pt, st = _track_both(img1, img2, pts, valid, precision,
                                 exit_mult=len(pts) + 1)
    np.testing.assert_array_equal(st, sj)
    d = np.abs(pj[sj] - pt[sj]).max(axis=1)
    # f32 sums over the 21x21 patch in another order: ~1e-5 px per
    # iteration; a convergence test within that of eps could add a step
    assert np.percentile(d, 99) < 1e-3, np.percentile(d, 99)
    assert d.max() < 2e-2, d.max()
    err = np.abs(pt[st] - pts[st] - np.array([3.0, -2.0])).max(axis=1)
    assert np.median(err) < 0.05


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_matches_default_lanes_early_exit(precision):
    img1, img2, pts, valid = _scene(11)
    pj, sj, pt, st = _track_both(img1, img2, pts, valid, precision,
                                 exit_mult=jlk.LKConfig().exit_mult,
                                 max_level=2)
    # the bounds vo_tpu holds its own Pallas kernel to against lanes
    assert (sj == st).mean() > 0.98
    both = sj & st
    d = np.abs(pj[both] - pt[both]).max(axis=1)
    assert np.percentile(d, 90) < 1e-2
    assert d.max() < 0.5


def test_refine_level_reference_matches_jax_level():
    """One level in isolation: same windows, same inputs."""
    img1, img2, pts, valid = _scene(3, N=128)
    cfg_j = jlk.LKConfig(layout="lanes", precision="f32", exit_mult=129)
    S = 35
    p = jnp.asarray(pts)
    ox1, oy1 = jlk._window_origins(p, S, *img1.shape)
    ox2, oy2 = jlk._window_origins(p + jnp.asarray([2.5, -1.5]), S,
                                   *img1.shape)
    w1 = jlk._to_layout(jlk._crop_windows(jnp.asarray(img1), ox1, oy1, S),
                        cfg_j)
    w2 = jlk._to_layout(jlk._crop_windows(jnp.asarray(img2), ox2, oy2, S),
                        cfg_j)
    o1 = jnp.stack([ox1, oy1], 1).astype(jnp.float32)
    o2 = jnp.stack([ox2, oy2], 1).astype(jnp.float32)
    flow = jnp.zeros_like(p)
    vj, okj = jlk._refine_level(w1, o1, w2, o2, p, flow, jnp.asarray(valid),
                                S, True, cfg_j, *img1.shape)

    t = lambda a: torch.from_numpy(np.asarray(a))
    half = 11
    q1 = t(p - o1)
    tmpl_out = ((q1 < half - 1) | (q1 > S - half)).any(dim=1)
    vt, solv, iters = lk_cuda.refine_level(
        t(img1), t(img2), q1, t(p - o2), t(flow),
        t(valid) & ~tmpl_out, t(o1), t(o2), S,
        tlk.LKConfig(precision="f32"))
    okj = np.asarray(okj)
    assert iters.max() <= 30 and iters.float().mean() > 1
    d = np.abs(np.asarray(vj) - vt.numpy()).max(axis=1)[okj]
    assert np.percentile(d, 99) < 1e-3 and d.max() < 2e-2
