"""One step of every sharded path at tiny shapes, in spawned ranks, each
held against the port's dense counterpart (the counterpart of
`__graft_entry__.py:dryrun_multichip`, which only runs them).

    python -c "from vo_tpu_torch.parallel.dryrun import dryrun_multichip; \
               dryrun_multichip(4, device='cpu')"

runs four gloo ranks on the CPU; by default (``device="cuda"``) it runs
NCCL ranks, one per card. Every rank makes the same global inputs from
fixed seeds with numpy, cuts its block, runs the sharded function and
gathers the result back; rank 0 also runs the dense function. The sharded paths are exact,
except the BA solves, whose landmark sums are associated in another order
and are held to vo_tpu's bounds (`tests/test_parallel.py`).
"""

from __future__ import annotations

import numpy as np
import torch

# relative and absolute bounds of the BA cases (tests/test_parallel.py)
BA_CLOSE = {"poses": (2e-3, 2e-3), "cost0": (2e-2, 0.0),
            "cost": (2e-2, 0.0), "ba_cost0": (2e-2, 0.0),
            "ba_cost": (2e-2, 0.0), "ba_holdout_cost": (2e-2, 1e-3)}

LK_SHAPE = (64, 96)
STEP_SHAPE = (240, 320)
STEP_FRAMES = 5


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def lk_inputs(n: int, seed: int = 5):
    """A 64x96 noise image pair shifted 2 px and brightened by 0.5, and n
    points (f32) with a validity mask, the scene of test_parallel.py."""
    rng = np.random.default_rng(seed)
    H, W = LK_SHAPE
    img1 = rng.uniform(0, 255, (H, W)).astype(np.float32)
    img2 = np.roll(img1, 2, axis=1) + np.float32(0.5)
    pts = np.stack([rng.uniform(15, W - 15, n), rng.uniform(15, H - 15, n)],
                   1).astype(np.float32)
    return img1, img2, pts, rng.random(n) > 0.2


def lk_config():
    from ..ops.lk import LKConfig

    return LKConfig(win=9, max_level=1, iters=10, window_margin=4,
                    coarse_margin=6)


def step_config():
    """tracking_orb cut to 240x320: capacity 498, two more than a multiple
    of 4, so four ranks pad it."""
    from ..frontend.orb import OrbConfig
    from ..models.vo import VOConfig

    return VOConfig(orb=OrbConfig(nfeatures=500, n_levels=3),
                    ransac_iters=128, fallback_gate="sync")


def redetect_config(n_ranks: int):
    """step_config with capacity 500 (no pad up to four ranks, so the run
    is held to the dense pipeline itself) and the presets' async gate,
    which ShardedTrackingVO overrides on more than one rank. One rank
    keeps it, and a card's re-detect step then depends on timing, so on
    one rank the case runs sync."""
    from ..frontend.orb import OrbConfig

    return step_config()._replace(
        orb=OrbConfig(nfeatures=501, n_levels=3),
        fallback_gate="async" if n_ranks > 1 else "sync")


def ba_window(L: int, device):
    """A 5-frame window over L landmarks with exact observations and
    poses 2-4 pushed off (tests/test_parallel.py's window)."""
    from ..ba.window import window_init, window_push
    from ..geometry.se3 import exp_so3, inv_se3, make_se3

    rng = np.random.default_rng(0)
    W = 5
    K = torch.tensor([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]],
                     device=device)
    X = torch.tensor(np.stack([rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
                               rng.uniform(15, 60, L)], 1),
                     dtype=torch.float32, device=device)
    p6 = torch.tensor([[0, 0.01 * i, 0, 0.1 * i, 0, float(i)]
                       for i in range(W)], device=device)
    T_wc = make_se3(exp_so3(p6[:, :3]), p6[:, 3:])
    pc = torch.einsum("wij,lj->wli", T_wc[:, :3, :3], X) + T_wc[:, None, :3, 3]
    obs = pc[..., :2] / pc[..., 2:] * K[0, 0] + K[:2, 2]
    T_cw = inv_se3(T_wc)
    T_cw[2:, :3, 3] += torch.tensor([0.2, -0.1, 0.3], device=device)
    st = window_init(W, L, device=device)
    for i in range(W):
        st = window_push(st, T_cw[i], obs[i],
                         torch.ones(L, dtype=torch.bool, device=device))
    return st, K, p6, X


def rank_cases(rank: int, world: int, mesh_shape=None):
    """Every case on this rank; rank 0 returns {case: {"sharded": {...},
    "dense": {...}, "close": {key: (rtol, atol)}}} (numpy arrays), the
    others None. `mesh_shape` (frames, kp) runs on a 2-D mesh, the row
    axis then on "kp"."""
    from ..ba.schur import BAConfig, bundle_adjust
    from ..ba.window import WindowConfig, run_window_ba
    from ..data.synthetic import SyntheticSequence
    from ..frontend.orb import OrbConfig, OrbFeatures, orb_detect_and_compute
    from ..models.vo import TrackingVO, _track_step
    from ..ops.conv import binomial_blur5
    from ..ops.fast import fast_score
    from ..ops.hamming import knn2_ratio_match, l2_table, match_descriptors
    from ..ops.lk import (lk_build_pyramid, lk_make_cache,
                          lk_pyramid_track_cached)
    from . import (batched_orb, batched_pair_match, make_mesh, make_mesh_2d,
                   replicated, shard_leading, sharded_bundle_adjust,
                   sharded_fast_score, sharded_gaussian_blur,
                   sharded_lk_make_cache, sharded_lk_track,
                   sharded_match_descriptors)
    from .ba import shard_window, sharded_window_ba
    from .mesh import axis_size, max_rank_deviation, rank_device
    from .vo_step import (ShardedTrackingVO, gather_state, pad_capacity,
                          parity_vs_single_device)

    dev = rank_device()
    if mesh_shape is not None:
        mesh = make_mesh_2d(mesh_shape, ("frame", "kp"), device=dev.type)
        meshes = {"kp": (mesh, "kp"), "row": (mesh, "kp"),
                  "frame": (mesh, "frame")}
    else:
        meshes = {a: (make_mesh(world, a, device=dev.type), a)
                  for a in ("kp", "row", "frame")}
    kp_mesh, kp = meshes["kp"]
    d_kp = axis_size(kp_mesh, kp)
    lead = rank == 0
    cases = {}

    def t(a):
        return torch.as_tensor(a, device=dev)

    def case(name, sharded, dense=None, close=None):
        if lead:
            cases[name] = {"sharded": {k: _np(v) for k, v in sharded.items()},
                           "dense": {k: _np(v) for k, v in dense().items()},
                           "close": close or {}}

    def gather(x, where="kp"):
        mesh, axis = meshes[where]
        return replicated(mesh, axis, x)

    def cut(x, where="kp"):
        mesh, axis = meshes[where]
        return shard_leading(mesh, axis, x)

    # keypoint-sharded LK: B1 on each rank's block, no collective
    cfg = lk_config()
    img1, img2, pts, valid = (t(a) for a in lk_inputs(8 * d_kp))
    pyr1, pyr2 = lk_build_pyramid(img1, cfg), lk_build_pyramid(img2, cfg)
    cache = sharded_lk_make_cache(kp_mesh, pyr1, cut(pts), cfg, kp)
    out, st, cache2 = sharded_lk_track(kp_mesh, cache, pyr1, pyr2, cut(pts),
                                       cut(valid), cfg, kp)

    def lk_dense():
        c2 = lk_pyramid_track_cached(lk_make_cache(pyr1, pts, cfg), pyr1,
                                     pyr2, pts, valid, cfg)
        return {"pts": c2[0], "status": c2[1],
                **{f"origins{L}": o for L, o in enumerate(c2[2].origins)}}

    case("lk", {"pts": gather(out), "status": gather(st),
                **{f"origins{L}": gather(o)
                   for L, o in enumerate(cache2.origins)}}, lk_dense)

    # matching: queries sharded, the train set gathered
    rng = np.random.default_rng(1)
    n1, n2 = 16 * d_kp, 32 * d_kp
    b1 = rng.integers(0, 2, (n1, 256)).astype(np.uint8)
    base = rng.integers(0, 2, (n2, 256)).astype(np.uint8)
    base[:n1] = np.where(rng.random((n1, 256)) < 0.1, 1 - b1, b1)
    b1, base = t(b1), t(base)
    v1, v2 = t(rng.random(n1) > 0.1), t(rng.random(n2) > 0.1)
    m = sharded_match_descriptors(kp_mesh, cut(b1), cut(base), cut(v1),
                                  cut(v2), axis=kp)
    case("match_hamming", {k: gather(x) for k, x in m._asdict().items()},
         lambda: match_descriptors(b1, base, v1, v2)._asdict())
    d1 = rng.normal(size=(8 * d_kp, 128)).astype(np.float32)
    d2 = rng.normal(size=(16 * d_kp, 128)).astype(np.float32)
    d2[::2] = d1 + 0.2 * rng.normal(size=d1.shape)  # true matches
    d1, d2 = t(d1), t(d2)
    o1, o2 = (torch.ones(len(x), dtype=torch.bool, device=dev)
              for x in (d1, d2))
    m = sharded_match_descriptors(kp_mesh, cut(d1), cut(d2), cut(o1), cut(o2),
                                  ratio=0.9, axis=kp, binary=False)
    case("match_l2", {k: gather(x) for k, x in m._asdict().items()},
         lambda: knn2_ratio_match(l2_table(d1, d2), o1, o2, 0.9,
                                  squared=True)._asdict())

    # row-sharded stencils; "fast_thin" has shards of halo + 1 rows, the
    # first and last mostly inside FAST's zeroed border
    row_mesh, row = meshes["row"]
    d_row = axis_size(row_mesh, row)
    for name, rows in (("blur", 8), ("fast", 8), ("fast_thin", 4)):
        img = t(np.random.default_rng(2).uniform(0, 255, (rows * d_row, 48))
                .astype(np.float32))
        if name == "blur":
            fn, dense_fn = sharded_gaussian_blur(row_mesh, row), binomial_blur5
        else:
            fn, dense_fn = sharded_fast_score(row_mesh, axis=row), fast_score
        case(name, {"out": gather(fn(cut(img, "row")), "row")},
             lambda: {"out": dense_fn(img)})

    # frame-parallel ORB and pair matching
    f_mesh, frame = meshes["frame"]
    ocfg = OrbConfig(nfeatures=64, n_levels=2, patch_size=15)
    frames = t(np.random.default_rng(3).uniform(
        0, 255, (2 * axis_size(f_mesh, frame), 64, 96)).astype(np.float32))
    feats = batched_orb(f_mesh, ocfg, frame)(cut(frames, "frame"))

    def orb_dense():
        fs = [orb_detect_and_compute(f, ocfg) for f in frames]
        return {k: torch.stack([getattr(f, k) for f in fs])
                for k in OrbFeatures._fields}

    case("batched_orb", {k: gather(getattr(feats, k), "frame")
                         for k in OrbFeatures._fields}, orb_dense)
    m = batched_pair_match(f_mesh, axis=frame)(
        feats.bits, feats.bits.roll(-1, 0), feats.valid,
        feats.valid.roll(-1, 0))

    def pairs_dense():
        f = orb_dense()
        # the pairs of each rank's block: frame j with j + 1 in the block
        nxt = [g - g % 2 + (g + 1) % 2 for g in range(len(frames))]
        ms = [match_descriptors(f["bits"][g], f["bits"][h], f["valid"][g],
                                f["valid"][h]) for g, h in enumerate(nxt)]
        return {k: torch.stack([getattr(x, k) for x in ms])
                for k in m._fields}

    case("batched_pair_match", {k: gather(x, "frame")
                                for k, x in m._asdict().items()},
         pairs_dense)

    # landmark-sharded BA: the plain LM solve and the whole window step
    st, K, p6, X = ba_window(64 if 64 % d_kp == 0 else 16 * d_kp, dev)
    g = torch.Generator().manual_seed(4)
    p0 = p6.clone()
    p0[1:] += (0.02 * torch.randn(4, 6, generator=g)).to(dev)
    X0 = X + (0.5 * torch.randn(X.shape, generator=g)).to(dev)
    obs = st.obs + (torch.randn(st.obs.shape, generator=g)).to(dev)
    om, pm = st.valid, st.valid[0]
    bcfg = BAConfig(max_iters=8)
    r = sharded_bundle_adjust(kp_mesh, p0, cut(X0), cut(obs.transpose(0, 1))
                              .transpose(0, 1), cut(om.T).T, cut(pm), K, bcfg,
                              kp)
    ba_keys = ("poses", "cost0", "cost", "n_obs")
    case("bundle_adjust", {k: getattr(r, k) for k in ba_keys},
         lambda: {k: getattr(bundle_adjust(p0, X0, obs, om, pm, K, bcfg), k)
                  for k in ba_keys}, BA_CLOSE)
    wcfg = WindowConfig(window_size=5, min_landmarks=10)
    info_keys = ("ba_ran", "ba_landmarks", "ba_holdout_n", "ba_cost0",
                 "ba_cost", "ba_holdout_cost")
    poses, _, info = sharded_window_ba(kp_mesh, shard_window(kp_mesh, st, kp),
                                       K, wcfg, axis=kp)

    def window_dense(lmap=None):
        res = run_window_ba(st, K, wcfg, lmap=lmap)
        out = {"poses": res[0], **{k: res[2][k] for k in info_keys}}
        if lmap is not None:
            out.update(ba_reused=res[2]["ba_reused"], map_ok=res[3][1])
        return out

    case("window_ba", {"poses": poses, **{k: info[k] for k in info_keys}},
         window_dense, BA_CLOSE)
    Lw = st.obs.shape[1]
    lmap = (torch.zeros((Lw, 3), device=dev),
            torch.zeros(Lw, dtype=torch.bool, device=dev))
    poses, _, info, (_, map_ok) = sharded_window_ba(
        kp_mesh, shard_window(kp_mesh, st, kp), K, wcfg,
        lmap=tuple(cut(x) for x in lmap), axis=kp)
    case("window_ba_map", {"poses": poses, "ba_reused": info["ba_reused"],
                           "map_ok": gather(map_ok),
                           **{k: info[k] for k in info_keys}},
         lambda: window_dense(lmap), BA_CLOSE)

    # the tracking step: ShardedTrackingVO over STEP_FRAMES frames against
    # the dense step on the same capacity-padded state
    seq = SyntheticSequence.generate(n_frames=STEP_FRAMES + 1,
                                     shape=STEP_SHAPE)
    vcfg = step_config()
    vo = ShardedTrackingVO(kp_mesh, seq.K, vcfg, kp)
    state = vo.init(seq.frame(0))
    outs, devs = [], []
    for i in range(1, STEP_FRAMES):
        state, o = vo.step(state, seq.frame(i))
        outs.append(o)
        devs.append(max_rank_deviation(o.pose, kp_mesh.get_group(kp)))
    full = gather_state(kp_mesh, vcfg, state, kp)
    fields = ("pose", "scale", "n_assoc", "n_inliers", "fallback")
    sharded = {k: torch.stack([getattr(o, k) for o in outs]) for k in fields}
    sharded.update(pts=full.pts, pts_valid=full.pts_valid, prev3d=full.prev3d,
                   prev3d_valid=full.prev3d_valid,
                   rank_dev=torch.tensor(max(devs)))

    def step_dense():
        dvo = TrackingVO(seq.K, vcfg, device=dev)
        s = pad_capacity(vcfg, dvo.init(seq.frame(0)), d_kp)
        douts = []
        for i in range(1, STEP_FRAMES):
            s, o = _track_step(s, dvo._image(seq.frame(i)), dvo.K, vcfg)
            douts.append(o)
        out = {k: torch.stack([getattr(o, k) for o in douts])
               for k in fields}
        out.update(pts=s.pts, pts_valid=s.pts_valid, prev3d=s.prev3d,
                   prev3d_valid=s.prev3d_valid, rank_dev=torch.tensor(0.0))
        return out

    case("tracking_step", sharded, step_dense)
    # vo_tpu's check of one step, from the gathered state of the run
    res = parity_vs_single_device(
        kp_mesh, vcfg, full._replace(gen=vo._generator(7)),
        vo._image(seq.frame(STEP_FRAMES)), vo.K, axis=kp)
    exact = ("exact", "rank_dev", "n_assoc_delta", "n_inlier_delta")
    case("parity", {k: torch.tensor(res[k]) for k in exact},
         lambda: {"exact": torch.tensor(True), "rank_dev": torch.tensor(0.0),
                  "n_assoc_delta": torch.tensor(0),
                  "n_inlier_delta": torch.tensor(0)})

    # a dip: frame 1 is blank, step 2 finds no texture, and every rank
    # must re-detect on step 3, as the dense pipeline does
    frames = [seq.frame(i) for i in range(4)]
    frames[1] = np.full_like(frames[0], 128.0)
    rcfg = redetect_config(d_kp)
    vo = ShardedTrackingVO(kp_mesh, seq.K, rcfg, kp)
    state, outs = vo.init(frames[0]), []
    for f in frames[1:]:
        state, o = vo.step(state, f)
        outs.append(o)
    full = gather_state(kp_mesh, rcfg, state, kp)
    fields = ("pose", "n_assoc", "n_inliers", "fallback")
    sharded = {k: torch.stack([getattr(o, k) for o in outs]) for k in fields}
    sharded.update(pts=full.pts, pts_valid=full.pts_valid,
                   fallback_by_rank=gather(sharded["fallback"]),
                   gate_sync=torch.tensor(vo._gate.mode == "sync"))

    def redetect_dense():
        dvo = TrackingVO(seq.K, rcfg, device=dev)
        s, douts = dvo.init(frames[0]), []
        for f in frames[1:]:
            s, o = dvo.step(s, f)
            douts.append(o)
        out = {k: torch.stack([getattr(o, k) for o in douts])
               for k in fields}
        out.update(pts=s.pts, pts_valid=s.pts_valid,
                   fallback_by_rank=out["fallback"].repeat(d_kp),
                   # sync: by the override on more than one rank, by
                   # redetect_config on one
                   gate_sync=torch.tensor(True))
        return out

    case("redetect", sharded, redetect_dense)
    return cases if lead else None


def check_case(name: str, result: dict) -> None:
    """Raise AssertionError where a case's sharded result leaves its dense
    one: keys in "close" by their (rtol, atol), every other key exactly."""
    sharded, dense, close = result["sharded"], result["dense"], result["close"]
    assert sorted(sharded) == sorted(dense), (name, sorted(sharded))
    for k, want in dense.items():
        if k in close:
            rtol, atol = close[k]
            np.testing.assert_allclose(sharded[k], want, rtol=rtol, atol=atol,
                                       err_msg=f"{name}.{k}")
        else:
            np.testing.assert_array_equal(sharded[k], want,
                                          err_msg=f"{name}.{k}")


def dryrun_multichip(world: int, mesh_shape=None, device="cuda",
                     check: bool = True, timeout_s: float = 300.0) -> dict:
    """Every sharded path once in `world` spawned ranks (`device` "cuda":
    NCCL, one rank per card, raising without a card; "cpu": gloo); returns
    rank 0's cases, each checked with `check_case` unless `check` is
    False."""
    from .launch import spawn

    cases = spawn(rank_cases, world, (mesh_shape,), device=device,
                  timeout_s=timeout_s)[0]
    if check:
        for name, result in cases.items():
            check_case(name, result)
    return cases
