"""Card-only tests of the port: each CUDA kernel against its plain version
on the card, the tracking pipelines through the kernels, and one BA solve
and one matching step on the card against the same on the CPU.

They need a CUDA device and skip without one. On a machine with a card
(which need not have jax) run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import lk_stats, lk_within
from vo_tpu_torch.data.synthetic import SyntheticSequence
from vo_tpu_torch.ops import blur_cuda, crop_cuda, lk_cuda, rowconv_cuda
from vo_tpu_torch.ops import lk as tlk
from vo_tpu_torch.ops.conv import gaussian_kernel_1d
from vo_tpu_torch.runtime.presets import get_preset

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize(
    "win,max_level,shape,sizes",
    [
        # the compiled window; S=30 at the 30x40 level
        (21, 3, (240, 320), {30, 35}),
        # the presets' S=35 and S=47 (a 47-row coarsest level, as KITTI's)
        (21, 2, (188, 320), {35, 47}),
        (15, 2, (188, 320), {29, 47}),  # generic window, odd
        (20, 2, (188, 320), {34, 47}),  # generic, even: two border columns
    ],
)
def test_lk_kernel_matches_plain(cuda, precision, win, max_level, shape,
                                 sizes):
    """Every level of a track, 701 points (no multiple of the warps per
    block), some of whose templates reach outside their window (the
    kernel's checked template reads)."""
    H, W = shape
    seq = SyntheticSequence.generate(n_frames=2, shape=shape, seed=3)
    cfg = tlk.LKConfig(precision=precision, win=win, max_level=max_level)
    pyr1 = tlk.lk_build_pyramid(torch.from_numpy(seq.frame(0)).to(cuda), cfg)
    pyr2 = tlk.lk_build_pyramid(torch.from_numpy(seq.frame(1)).to(cuda), cfg)
    n = 701
    rng = np.random.default_rng(0)
    pts = torch.tensor(np.stack([rng.uniform(5, W - 5, n),
                                 rng.uniform(5, H - 5, n)], 1),
                       dtype=torch.float32, device=cuda)
    calls = []
    real = lk_cuda.refine_level

    def spy(*args):
        calls.append(args)
        return real(*args)

    lk_cuda.refine_level = spy
    try:
        before = lk_cuda.launches
        tlk.lk_pyramid_track(pyr1, pyr2, pts, torch.ones(n, dtype=torch.bool,
                                                         device=cuda), cfg)
    finally:
        lk_cuda.refine_level = real
    assert lk_cuda.launches - before == len(calls) == max_level + 1
    assert {args[8] for args in calls} == sizes
    half = (win + 1) // 2
    outside = 0
    for args in calls:
        q1, S = args[2], args[8]
        outside += int(((q1 < half - 1) | (q1 > S - half)).any(1).sum())
        out = real(*args)
        ref = lk_cuda.refine_level_reference(*args)
        torch.cuda.synchronize()
        # f32 sums in another order (and FMA contraction) on the card,
        # with an f64 run as witness of the rounding-sensitive points: the
        # bounds of chip_smoke.py, except that random points, weak texture
        # included, reach more of them (readings on an H100: sensitive
        # share <= 2.3 %, band share <= 2.1 %, one unmarked point 1.0e-3
        # px off at a level whose tail has median condition 91), so
        # shares up to 5 % and 1e-2 px there; flag agreement >= 99 % too
        st = lk_stats(args, out, ref)
        print(precision, win, S, st)
        assert lk_within(st, cfg.eps, max_share=0.05, max_band=0.05,
                         max_rest=1e-2), str(st)
        assert st["agree"] >= 0.99, str(st)
    assert outside > 0


def test_lk_kernel_no_points(cuda):
    img = torch.rand((120, 160), device=cuda)
    e = torch.zeros((0, 2), device=cuda)
    before = lk_cuda.launches
    v, solv, its = lk_cuda.refine_level(
        img, img, e, e, e, torch.zeros(0, dtype=torch.bool, device=cuda), e,
        e, 35, tlk.LKConfig())
    assert lk_cuda.launches == before  # nothing to launch
    assert v.shape == (0, 2) and solv.shape == (0,) and its.shape == (0,)


@pytest.mark.parametrize(
    "shape,ky,kx,atol",
    [
        ((3, 181, 333), 7, 7, 2e-3),
        ((1, 37, 51), 5, 9, 2e-3),
        ((2, 200, 300), 129, 3, 5e-3),
    ],
)
def test_blur_kernel_matches_plain(cuda, shape, ky, kx, atol):
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    x = torch.rand(shape, generator=g, device=cuda) * 255.0
    ty = gaussian_kernel_1d(ky, ky / 6.0)
    tx = gaussian_kernel_1d(kx, kx / 6.0)
    before = blur_cuda.launches
    out = blur_cuda.separable_blur(x, ty, tx)
    torch.cuda.synchronize()
    assert blur_cuda.launches == before + 1
    ref = blur_cuda.separable_blur_reference(x, ty, tx)
    assert (out - ref).abs().max().item() <= atol


@pytest.mark.parametrize("radius", [3, 5, 6, 8, 10, 12, 2, 17, 64])
@pytest.mark.parametrize(
    "shape", [(6, 20), (12, 39), (2, 181, 333), (376, 1241), (3, 400, 1000)])
def test_blur_kernel_radii(cuda, shape, radius):
    """The compiled radii (3: Harris; 5-12: SIFT) and generic ones, on
    SIFT's two smallest octaves (periodic reflect-101) and on shapes that
    are no multiple of any tile: 181x333 takes the 16x32 tiles, 376x1241
    the 32x64 ones, 3x400x1000 the 64x64 ones."""
    g = torch.Generator(device=cuda)
    g.manual_seed(radius)
    x = torch.rand(shape, generator=g, device=cuda) * 255.0
    taps = gaussian_kernel_1d(2 * radius + 1, radius / 3.0)
    before = blur_cuda.launches
    out = blur_cuda.separable_blur(x, taps, taps)
    torch.cuda.synchronize()
    assert blur_cuda.launches == before + 1
    ref = blur_cuda.separable_blur_reference(x, taps, taps)
    assert (out - ref).abs().max().item() <= (2e-3 if radius <= 17 else 5e-3)


def test_blur_kernel_rejects_float64(cuda):
    with pytest.raises(TypeError):
        blur_cuda.separable_blur(torch.zeros(20, 20, dtype=torch.float64,
                                             device=cuda), [1.0], [1.0])


def test_pipeline_runs_through_the_kernels(cuda):
    seq = SyntheticSequence.generate(n_frames=10, shape=(240, 320),
                                     dropouts=((5, 6),), dropout_keep=0.0)
    preset = get_preset("tracking_orb")
    vo = preset.build(seq.K)
    assert vo.device.type == "cuda"
    lk0, blur0 = lk_cuda.launches, blur_cuda.launches
    est, gt, _, stats = preset.run(seq, vo)
    assert lk_cuda.launches > lk0 and blur_cuda.launches > blur0
    assert np.isfinite(est).all()
    assert any(s["fallback"] for s in stats[1:])


def _origins(g, N, S, H, W, device):
    """N window origins, some windows past every edge of an (H, W) map."""
    ox = torch.randint(-S, W, (N,), generator=g, device=device)
    oy = torch.randint(-S, H, (N,), generator=g, device=device)
    return ox, oy


@pytest.mark.parametrize("S", [8, 21, 37, 40, 79, 128])
def test_crop_kernel_matches_plain(cuda, S):
    """Bit for bit, the compiled S (37, 79) and the generic one, windows
    past every edge included; N = 1001, so N*S*S is no multiple of 4 at
    odd S (the ragged tail)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    img = torch.rand((300, 500), generator=g, device=cuda) * 255.0
    ox, oy = _origins(g, 1001, S, 300, 500, cuda)
    before = crop_cuda.launches
    out = crop_cuda.crop_windows(img, ox, oy, S)
    torch.cuda.synchronize()
    assert crop_cuda.launches == before + 1
    assert out.shape == (1001, S, S) and out.is_contiguous()
    assert torch.equal(out, crop_cuda.crop_windows_reference(img, ox, oy, S))


@pytest.mark.parametrize("S", [8, 21, 37, 40, 79, 128])
def test_crop_pair_kernel_matches_plain(cuda, S):
    """Both maps in one launch: bit for bit the plain pair and two
    single-map kernel calls."""
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    a = torch.rand((300, 500), generator=g, device=cuda) * 255.0
    b = torch.rand((300, 500), generator=g, device=cuda) - 0.5
    ox, oy = _origins(g, 1001, S, 300, 500, cuda)
    before = crop_cuda.launches
    out = crop_cuda.crop_windows_pair(a, b, ox, oy, S)
    torch.cuda.synchronize()
    assert crop_cuda.launches == before + 1
    assert out.shape == (2, 1001, S, S)
    assert torch.equal(out, crop_cuda.crop_windows_pair_reference(
        a, b, ox, oy, S))
    assert torch.equal(out[0], crop_cuda.crop_windows(a, ox, oy, S))
    assert torch.equal(out[1], crop_cuda.crop_windows(b, ox, oy, S))
    assert crop_cuda.launches == before + 3


@pytest.mark.parametrize(
    "N,S",
    [
        (0, 37),  # nothing to launch
        (7, 1),  # every sample its own window
        (3, 79),  # 18,723 samples: a 3-sample tail
        (6666, 79),  # the path's descriptor windows: many grid strides
        (5000, 37),
    ],
)
def test_crop_kernel_sizes(cuda, N, S):
    """N = 0, S = 1, the ragged tail and N*S*S large enough that the
    grid-stride loop goes round many times, on a map of the path's width,
    for both entry points."""
    g = torch.Generator(device=cuda)
    g.manual_seed(N + S)
    a = torch.rand((1000, 2560), generator=g, device=cuda) * 255.0
    b = torch.rand((1000, 2560), generator=g, device=cuda) * 255.0
    ox, oy = _origins(g, N, S, 1000, 2560, cuda)
    before = crop_cuda.launches
    one = crop_cuda.crop_windows(a, ox, oy, S)
    two = crop_cuda.crop_windows_pair(a, b, ox, oy, S)
    torch.cuda.synchronize()
    assert crop_cuda.launches == before + (2 if N else 0)
    assert one.shape == (N, S, S) and two.shape == (2, N, S, S)
    assert torch.equal(one, crop_cuda.crop_windows_reference(a, ox, oy, S))
    assert torch.equal(two, crop_cuda.crop_windows_pair_reference(
        a, b, ox, oy, S))


def _conv_taps(k):
    return (-0.5, 0.0, 0.5) if k == 3 else tuple(gaussian_kernel_1d(k, k / 6.0))


@pytest.mark.parametrize(
    "shape,k",
    [((3, 181, 333), 3), ((7056, 640), 3), ((1, 640), 3), ((2, 333), 3),
     ((4, 3, 128), 3), ((3, 181, 333), 7), ((2, 100, 256), 9),
     ((6, 20), 25), ((1, 5), 129)],
)
def test_rowconv_kernel_matches_plain(cuda, shape, k):
    """Both axes, bit for bit: the kernels sum in the plain version's
    order. W = 333 is no multiple of 4 (scalar loads); planes of 1-3 rows
    and the radii past the axis reflect periodically; 25 and 129 taps take
    the wide kernel."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    x = torch.rand(shape, generator=g, device=cuda) * 255.0
    taps = _conv_taps(k)
    for along_cols in (False, True):
        before = rowconv_cuda.launches
        fn = rowconv_cuda.conv_cols if along_cols else rowconv_cuda.conv_rows
        out = fn(x, taps)
        torch.cuda.synchronize()
        assert rowconv_cuda.launches == before + 1
        ref = rowconv_cuda.conv_reference(x, taps, along_cols)
        assert torch.equal(out, ref), (along_cols,
                                       (out - ref).abs().max().item())


@pytest.mark.parametrize(
    "shape,k",
    [((7056, 2560), 3), ((3, 181, 333), 3), ((7056, 640), 3), ((1, 640), 3),
     ((2, 333), 3), ((4, 3, 128), 3), ((6, 20), 3), ((2, 100, 256), 9),
     ((5, 64), 5)],
)
def test_rowconv_pair_kernel_matches_plain(cuda, shape, k):
    """Both passes from one read, bit for bit the plain pair and the
    single-axis kernels: the path's canvas, W no multiple of 4, planes of
    1-3 rows, SIFT's 6x20 octave and the widest radius it takes."""
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    x = torch.rand(shape, generator=g, device=cuda) * 255.0
    taps = _conv_taps(k)
    before = rowconv_cuda.launches
    rows, cols = rowconv_cuda.conv_rows_cols(x, taps)
    torch.cuda.synchronize()
    assert rowconv_cuda.launches == before + 1
    ref_r, ref_c = rowconv_cuda.conv_rows_cols_reference(x, taps)
    assert torch.equal(rows, ref_r) and torch.equal(cols, ref_c)
    assert torch.equal(rows, rowconv_cuda.conv_rows(x, taps))
    assert torch.equal(cols, rowconv_cuda.conv_cols(x, taps))


def test_rowconv_pair_kernel_rejects_wide_radius(cuda):
    x = torch.zeros((20, 20), device=cuda)
    before = rowconv_cuda.launches
    with pytest.raises(ValueError):
        rowconv_cuda.conv_rows_cols(x, gaussian_kernel_1d(11, 2.0))
    assert rowconv_cuda.launches == before


def test_blur_kernel_past_the_edge(cuda):
    """SIFT's 6x20 octave under a 25-tap blur: periodic reflect-101."""
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    x = torch.rand((2, 6, 20), generator=g, device=cuda) * 255.0
    k = gaussian_kernel_1d(25, 3.09)
    out = blur_cuda.separable_blur(x, k, k)
    ref = blur_cuda.separable_blur_reference(x, k, k)
    assert (out - ref).abs().max().item() <= 2e-3


def test_sift_pipeline_runs_through_the_kernels(cuda):
    seq = SyntheticSequence.generate(n_frames=8, shape=(240, 320),
                                     dropouts=((4, 5),), dropout_keep=0.0)
    preset = get_preset("tracking_sift")
    vo = preset.build(seq.K)
    mods = (lk_cuda, blur_cuda, crop_cuda, rowconv_cuda)
    before = [m.launches for m in mods]
    est, _, _, stats = preset.run(seq, vo)
    assert all(m.launches > b for m, b in zip(mods, before))
    assert np.isfinite(est).all()
    assert any(s["fallback"] for s in stats[1:])


def _ba_window(L=64, seed=0):
    """A 5-camera window (tests/test_ba.py's make_ba_problem, with numpy
    and the port's exp_so3): cameras moving along +z, points 15-60 m
    ahead, 1 px of observation noise, poses and points perturbed."""
    from vo_tpu_torch.geometry.se3 import exp_so3

    rng = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
    X = np.stack([rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
                  rng.uniform(15, 60, L)], 1)
    poses = np.zeros((5, 6))
    for i in range(5):
        poses[i, :3] = [0, 0.01 * i, 0]
        poses[i, 3:] = [0.1 * i, 0, float(i)]
    obs = []
    for p in poses:
        R = exp_so3(torch.tensor(p[:3], dtype=torch.float32)).numpy()
        pc = X @ R.T + p[3:]
        obs.append(pc[:, :2] / pc[:, 2:3] * [300.0, 300.0] + [160.0, 120.0])
    obs = np.stack(obs) + rng.normal(0, 1.0, (5, L, 2))
    poses0 = poses.copy()
    poses0[1:] += rng.normal(0, 0.02, (4, 6))
    X0 = X + rng.normal(0, 0.5, X.shape)
    return [torch.tensor(a, dtype=torch.float32) for a in (poses0, X0, obs, K)]


def test_bundle_adjust_on_card(cuda):
    """One BA solve on the card and on the CPU from the same inputs, held
    as tests/test_torch_ba.py holds the port to vo_tpu: identical accept
    trace, cost rtol 1e-4, poses atol 1e-4, points 1e-3 of their depth."""
    from vo_tpu_torch.ba.schur import bundle_adjust

    p0, X0, obs, K = _ba_window()
    W, L = obs.shape[:2]
    args = (p0, X0, obs, torch.ones((W, L), dtype=torch.bool),
            torch.ones(L, dtype=torch.bool), K)
    ref, rtr = bundle_adjust(*args, return_trace=True)
    got, gtr = bundle_adjust(*(a.to(cuda) for a in args), return_trace=True)
    assert torch.equal(gtr[0].cpu(), rtr[0])
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-4 * float(ref.cost)
    assert float(got.cost) < 0.1 * float(got.cost0)
    assert (got.poses.cpu() - ref.poses).abs().max() <= 1e-4
    gap = (got.points.cpu() - ref.points).abs().amax(1)
    assert (gap <= 1e-3 * ref.points[:, 2].abs()).all()


@pytest.mark.parametrize("detector", ["orb", "sift"])
def test_matching_step_on_card(cuda, detector):
    """One _matching_core step on the card and on the CPU from the same
    features (tests/torch_parity.py's scene) and RANSAC draws: the same
    matches and counts, and the pose within 3x the CPU step's own response
    to a 1e-4 px jitter of the points (plus 1e-4), as
    tests/test_torch_matching.py holds the port to vo_tpu."""
    from torch_parity import K_SCENE, scene_features
    from vo_tpu_torch.models import vo as tvo

    frames, _ = scene_features(detector, n_frames=2)
    cfg = tvo.VOConfig(detector=detector, scale_mode="unmatched",
                       ransac_iters=64)
    K = torch.tensor(K_SCENE, dtype=torch.float32)
    slot = torch.from_numpy(np.random.default_rng(3).integers(
        0, 200, (64, 5)))

    def step(dev, first=frames[0], second=frames[1]):
        f0 = tuple(torch.from_numpy(np.array(a)).to(dev) for a in first)
        f1 = tuple(torch.from_numpy(np.array(a)).to(dev) for a in second)
        st = tvo._matching_init(f0, torch.Generator(device=dev), cfg)
        m = tvo.match_features(st.desc, f1[1], st.valid, f1[2], cfg)
        _, out = tvo._matching_core(st, f1, K.to(dev), cfg, slot=slot)
        return m, out

    rng = np.random.default_rng(1)
    mc, oc = step("cpu")
    mg, og = step(cuda)
    assert torch.equal(mg.valid.cpu(), mc.valid)
    assert torch.equal(mg.idx.cpu()[mc.valid], mc.idx[mc.valid])
    assert int(og.n_assoc) == int(oc.n_assoc) > 200
    spread = 0.0
    for _ in range(3):
        moved = [(f[0] + rng.normal(0, 1e-4, f[0].shape).astype(np.float32),)
                 + f[1:] for f in frames]
        spread = max(spread, (step("cpu", *moved)[1].pose - oc.pose)
                     .abs().max().item())
    gap = (og.pose.cpu() - oc.pose).abs().max().item()
    assert gap <= 3.0 * spread + 1e-4, (gap, spread)


@pytest.mark.parametrize("name", ["tracking_sift_ba", "tracking_orb_ba"])
def test_tracking_ba_pipeline_runs_through_the_kernels(cuda, name):
    """The BA presets on the card, as tests/test_torch_presets.py runs
    tracking_sift_ba on the CPU (its small configuration: 500 features,
    sync gate): 24 frames, a 4-frame window solved every 8 frames; the
    path's kernels launch and each solve lowers its cost. tracking_sift_ba
    solves at frames 8 and 16 and accepts poses (4 and 0 over RANSAC seeds
    0-5 on the CPU). tracking_orb_ba at this size is at the mercy of its
    RANSAC draws: over seeds 0-5 on the CPU it solved 1-2 windows and
    accepted 0-4 poses each, and one run on the card accepted none, so
    only the solves are held there."""
    import dataclasses

    from vo_tpu_torch.ba.window import WindowConfig

    seq = SyntheticSequence.generate(n_frames=24, shape=(240, 320),
                                     n_points=3000)
    from vo_tpu_torch.frontend.orb import OrbConfig
    from vo_tpu_torch.frontend.sift import SiftConfig

    preset = get_preset(name)
    sift = preset.config.detector == "sift"
    preset = dataclasses.replace(  # tests/test_torch_presets.py's small preset
        preset, window=WindowConfig(window_size=4, ba_every=8),
        config=preset.config._replace(
            orb=OrbConfig(nfeatures=500, n_levels=4),
            sift=SiftConfig(nfeatures=500), fallback_gate="sync",
            min_tracked=60 if sift else 150))
    vo = preset.build(seq.K)
    mods = ((lk_cuda, blur_cuda, crop_cuda, rowconv_cuda)
            if name == "tracking_sift_ba" else (lk_cuda, blur_cuda))
    before = [m.launches for m in mods]
    est, _, _, stats = preset.run(seq, vo)
    assert all(m.launches > b for m, b in zip(mods, before))
    assert np.isfinite(est).all()
    ran = [s for s in stats if s.get("ba_ran")]
    assert ran and all(s["ba_cost"] < s["ba_cost0"] for s in ran)
    if name == "tracking_sift_ba":
        assert len(ran) == 2 and sum(s["ba_accepted"] for s in ran) > 0


def test_on_frame_hook_on_card(cuda):
    """The hook sees, in order and from step 1, the steps whose pinned pose
    copy has arrived (CUDA events), each pose equal to the returned path's;
    the path equals the run without a hook."""
    from vo_tpu_torch.models.vo import run_vo

    seq = SyntheticSequence.generate(n_frames=10, shape=(240, 320))
    preset = get_preset("tracking_orb")
    cfg = preset.config._replace(fallback_gate="sync")
    est0, *_ = run_vo(seq, preset.make(seq.K, cfg))
    seen = []
    est, *_ = run_vo(seq, preset.make(seq.K, cfg),
                     on_frame=lambda i, f: seen.append((i, f.pose)))
    np.testing.assert_array_equal(est, est0)
    assert [i for i, _ in seen] == list(range(1, len(seen) + 1))
    assert seen
    for i, pose in seen:
        assert not pose.is_cuda
        np.testing.assert_array_equal(pose.numpy()[[0, 2], 3], est[i])


def test_checkpoint_resume_on_card(cuda, tmp_path):
    """A run on the card stopped after frame 6 and resumed from its
    checkpoint (CUDA generator state included) equals the uninterrupted
    checkpointed run, with the sync gate."""
    from vo_tpu_torch.runtime.checkpoint import CheckpointingRunner

    class First:
        def __init__(self, seq, n):
            self.poses, self.K, self._seq, self._n = seq.poses[:n], seq.K, \
                seq, n

        def __len__(self):
            return self._n

        def frame(self, i):
            return self._seq.frame(i)

    seq = SyntheticSequence.generate(n_frames=12, shape=(240, 320))
    preset = get_preset("tracking_orb")
    cfg = preset.config._replace(fallback_gate="sync")
    full = CheckpointingRunner(preset.make(seq.K, cfg),
                               str(tmp_path / "full.npz"), every=3).run(seq)
    ckpt = str(tmp_path / "cut.npz")
    CheckpointingRunner(preset.make(seq.K, cfg), ckpt, every=3).run(
        First(seq, 7))
    resumed = CheckpointingRunner(preset.make(seq.K, cfg), ckpt,
                                  every=3).run(seq)
    for a, b in zip(full[:3], resumed[:3]):
        np.testing.assert_array_equal(b, a)


def test_parallel_dryrun_one_nccl_rank(cuda):
    """Every sharded path in one spawned NCCL rank on the card (B1 and B2
    on the shards), each case against the dense call on the card."""
    import torch.distributed as dist

    from vo_tpu_torch.parallel.dryrun import check_case, dryrun_multichip

    if not dist.is_nccl_available():
        pytest.fail("this PyTorch has no NCCL")
    cases = dryrun_multichip(1, device="cuda", check=False, timeout_s=240)
    for name, result in cases.items():
        check_case(name, result)
    assert cases["parity"]["sharded"]["exact"]


def test_sharded_tracking_on_one_nccl_rank(cuda, tmp_path):
    """ShardedTrackingVO in this process on a 1-rank NCCL group: B1 four
    times a step, and the run bit-equal to the dense tracking_orb."""
    import torch.distributed as dist

    from vo_tpu_torch.models.vo import FrameOutput, _dispatch, _read_back
    from vo_tpu_torch.parallel import make_mesh
    from vo_tpu_torch.parallel.mesh import init_process_group
    from vo_tpu_torch.parallel.vo_step import ShardedTrackingVO

    seq = SyntheticSequence.generate(n_frames=6, shape=(240, 320))
    cfg = get_preset("tracking_orb").config._replace(fallback_gate="sync")
    dense = _read_back(_dispatch(seq, get_preset("tracking_orb").make(
        seq.K, cfg)), FrameOutput._fields)
    init_process_group(0, 1, f"file://{tmp_path}/store", "cuda")
    try:
        assert dist.get_backend() == "nccl"
        before = lk_cuda.launches
        vo = ShardedTrackingVO(make_mesh(), seq.K, cfg)
        sharded = _read_back(_dispatch(seq, vo), FrameOutput._fields)
        assert lk_cuda.launches - before == 4 * (len(seq) - 1)
    finally:
        dist.destroy_process_group()
    for k in ("pose", "n_assoc", "n_inliers"):
        np.testing.assert_array_equal(sharded[k], dense[k])


@pytest.mark.parametrize("name", ["tracking_orb", "matching_orb"])
def test_scan_equals_step_loop_on_card(cuda, name):
    """Scan mode from the preset's own pipeline against the step loop with
    the sync gate on the card: bit-equal (chip_smoke's scan_vs_loop raises
    otherwise); tracking re-detects after its blank frames."""
    from chip_smoke import scan_vs_loop

    seq = SyntheticSequence.generate(n_frames=12, shape=(240, 320),
                                     dropouts=((5, 6),), dropout_keep=0.0)
    stats, _, _, counts = scan_vs_loop(name, seq)
    assert counts["separable_blur"] > 0
    if name == "tracking_orb":
        assert counts["lk_refine"] > 0
        assert any(s.get("fallback") for s in stats)
