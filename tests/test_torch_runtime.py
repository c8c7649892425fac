"""Parity of the port's runtime, data and utils layers with vo_tpu's: the
result bundle, KITTI IO, the native PNG decoder and prefetcher, checkpoint
round trips of the four pipeline states, the re-detect gate snapshot,
vo_tpu checkpoints loaded into the port, the CLI, the `on_frame` hook,
profiling and `compare`. Everything runs on CPU tensors at small sizes;
vo_tpu is called only for numpy-level functions, its decoder, its gate
and one ORB detect (no JAX pipeline is compiled). The resumed runs are in
tests/test_torch_resume.py."""

import json
import os

import numpy as np
import pytest
import torch

from vo_tpu.runtime import loader as jloader
from vo_tpu.utils import io as jio
from vo_tpu.data import kitti as jkitti
from vo_tpu_torch.data import kitti as tkitti
from vo_tpu_torch.data.synthetic import SyntheticSequence
from vo_tpu_torch.frontend.orb import OrbConfig
from vo_tpu_torch.models.vo import MatchingVO, TrackingVO, VOConfig, run_vo
from vo_tpu_torch.models.vo_3frame import ThreeFrameVO
from vo_tpu_torch.models.vo_ba import TrackingBAVO, run_vo_ba
from vo_tpu_torch.ba.window import WindowConfig
from vo_tpu_torch.runtime import checkpoint as tckpt
from vo_tpu_torch.runtime import loader as tloader
from vo_tpu_torch.utils import io as tio
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

SMALL = VOConfig(orb=OrbConfig(nfeatures=300, n_levels=3), ransac_iters=64,
                 fallback_gate="sync")


def _gray(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


# ------------------------------------------------------------------ io


def test_save_results_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    gt, est = rng.normal(size=(9, 2)) * 100, rng.normal(size=(9, 2))
    scales = np.abs(rng.normal(size=(9, 2)))
    est[3] = [1e-17, -0.0]  # repr edge cases
    for name, mod in (("j", jio), ("t", tio)):
        mod.save_results(str(tmp_path / name), gt, est, scales)
        mod.save_results(str(tmp_path / f"{name}_noscale"), gt, est)
    for sub in ("", "_noscale"):
        files = sorted(os.listdir(tmp_path / f"j{sub}"))
        assert files == sorted(os.listdir(tmp_path / f"t{sub}"))
        for f in files:
            assert (tmp_path / f"t{sub}" / f).read_bytes() == \
                (tmp_path / f"j{sub}" / f).read_bytes(), f
    np.testing.assert_array_equal(
        tio.load_path(str(tmp_path / "t" / "est_path.txt")), est)


# ------------------------------------------------------------------ kitti


def test_kitti_readers_match(tmp_path):
    rng = np.random.default_rng(1)
    seq = SyntheticSequence.generate(n_frames=4, shape=(40, 60), n_points=50)
    frames = [_gray(rng, (40, 60)) for _ in range(4)]
    tkitti.write_sequence(str(tmp_path), "05", frames, seq.poses, seq.K)
    # a second calib in the published files' layout: several cameras
    calib = tmp_path / "calib_multi.txt"
    calib.write_text(
        "P0: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 "
        "0.000000000000e+00 0.000000000000e+00 7.188560000000e+02 "
        "1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 "
        "0.000000000000e+00 1.000000000000e+00 0.000000000000e+00\n"
        "P1: 1 0 0 -386.1448 0 1 0 0 0 0 1 0\n")
    seq_dir = tmp_path / "sequences" / "05"
    for f, cam in ((seq_dir / "calib.txt", "P0"), (calib, "P0"),
                   (calib, "P1")):
        for a, b in zip(tkitti.read_calib(str(f), cam),
                        jkitti.read_calib(str(f), cam)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        tkitti.read_calib(str(calib), "P2")
    np.testing.assert_array_equal(
        tkitti.read_calib(str(seq_dir / "calib.txt"))[1], seq.K)
    pose_file = str(tmp_path / "poses" / "05.txt")
    for n in (None, 2):
        np.testing.assert_array_equal(tkitti.read_poses(pose_file, n),
                                      jkitti.read_poses(pose_file, n))
    np.testing.assert_array_equal(tkitti.read_poses(pose_file), seq.poses)
    (seq_dir / "image_0" / "notes.txt").write_text("not an image")
    for n in (None, 3):
        assert tkitti.list_images(str(seq_dir / "image_0"), n) == \
            jkitti.list_images(str(seq_dir / "image_0"), n)
    ks = tkitti.KittiSequence.open(str(tmp_path), "05", max_frames=3)
    assert len(ks) == 3
    np.testing.assert_array_equal(ks.gt_path_xz(), seq.poses[:3][:, [0, 2], 3])
    np.testing.assert_array_equal(ks.frame(2), frames[2].astype(np.float32))


def test_load_gray_without_pil_names_both(tmp_path, monkeypatch):
    """With no decoder to fall back on, loading raises and says why."""
    import sys

    p = str(tmp_path / "x.png")
    with open(p, "wb") as f:
        f.write(tkitti.encode_png(np.zeros((4, 4), np.uint8)))
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "_build_error", "g++ failed: no zlib.h")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL.*zlib.h"):
        tkitti.load_gray(p)
    assert tkitti.KittiSequence([p], np.eye(4)[None], np.eye(3),
                                np.eye(3, 4)).prefetched().__class__ \
        is tkitti.KittiSequence


# ------------------------------------------------------------------ decoder


def _pil_gray(path):
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.float32)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """8-bit PNGs of several kinds, each with its expected float frame."""
    from PIL import Image

    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(2)
    arrays = [
        _gray(rng, (37, 53)),  # noise
        np.tile(np.arange(64, dtype=np.uint8), (48, 1)),  # gradient
        np.zeros((16, 16), np.uint8),
        np.clip(np.rint(SyntheticSequence.generate(
            n_frames=1, shape=(60, 80), n_points=80).frame(0)),
            0, 255).astype(np.uint8),  # a scene
    ]
    out = []
    for i, arr in enumerate(arrays):
        p = str(d / f"pil{i}.png")  # PIL picks its filters per row
        Image.fromarray(arr, mode="L").save(p, optimize=True)
        out.append((p, arr.astype(np.float32)))
        q = str(d / f"std{i}.png")  # the stdlib encoder (filter 0)
        with open(q, "wb") as f:
            f.write(tkitti.encode_png(arr))
        out.append((q, arr.astype(np.float32)))
    return out


def test_decoder_bit_exact_vs_vo_tpu_and_pil(pngs):
    assert tloader.native_available(), tloader.build_error()
    for path, want in pngs:
        got = tloader.decode_png(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jloader.decode_png(path))
        np.testing.assert_array_equal(got, _pil_gray(path))
        np.testing.assert_array_equal(tkitti.load_gray(path), want)


def test_decoder_rgb_to_luma(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    p = str(tmp_path / "rgb.png")
    Image.fromarray(rgb, mode="RGB").save(p)
    got = tloader.decode_png(p)
    np.testing.assert_array_equal(got, jloader.decode_png(p))
    want = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
            + 0.114 * rgb[..., 2]).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=0.51)


def test_decoder_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        tloader.decode_png(str(tmp_path / "nonexistent.png"))


def test_build_goes_to_the_build_dir_by_rename(tmp_path, monkeypatch):
    """A build writes a name of its own and renames it into place, under
    vo_tpu_torch/_build/, not beside the source."""
    assert os.path.dirname(tloader._LIB).endswith(os.path.join(
        "vo_tpu_torch", "_build"))
    lib = str(tmp_path / "libvopng.so")
    monkeypatch.setattr(tloader, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tloader, "_LIB", lib)
    assert tloader._build() is None
    assert os.listdir(tmp_path) == ["libvopng.so"]


def test_prefetcher_in_order_and_replay(pngs):
    paths = [p for p, _ in pngs]
    with tloader.NativePrefetcher(paths, n_threads=3, ring=4) as pf:
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(pf.get(i), tloader.decode_png(p))
        # replay after consumption (inline decode), then a skip ahead
        np.testing.assert_array_equal(pf.get(2), tloader.decode_png(paths[2]))
        np.testing.assert_array_equal(pf.get(len(paths) - 1), pngs[-1][1])
        assert pf.served == len(paths) + 2


def test_prefetched_kitti_sequence(tmp_path):
    rng = np.random.default_rng(3)
    seq = SyntheticSequence.generate(n_frames=6, shape=(30, 40), n_points=40)
    frames = [_gray(rng, (30, 40)) for _ in range(6)]
    tkitti.write_sequence(str(tmp_path), "00", frames, seq.poses, seq.K)
    pf = tkitti.KittiSequence.open(str(tmp_path), "00").prefetched(2, 2)
    assert isinstance(pf, tkitti.PrefetchedSequence)
    for i in range(6):
        np.testing.assert_array_equal(pf.frame(i), frames[i].astype(np.float32))
    assert pf.served == 6
    np.testing.assert_array_equal(pf.K, seq.K)
    pf.close()


# ------------------------------------------------------------------ checkpoint


def _seq(n=3, shape=(120, 160)):
    return SyntheticSequence.generate(n_frames=n, shape=shape, n_points=400)


def _pipelines(K):
    return {
        "tracking": TrackingVO(K, SMALL, device="cpu"),
        "matching": MatchingVO(K, SMALL._replace(scale_mode="unmatched"),
                               device="cpu"),
        "three_frame": ThreeFrameVO(K, SMALL, device="cpu"),
        "tracking_ba": TrackingBAVO(K, SMALL, WindowConfig(window_size=3,
                                                           ba_every=4),
                                    device="cpu"),
    }


def _leaves_equal(a, b):
    la, lb = tckpt._leaves(a), tckpt._leaves(b)
    assert list(la) == list(lb)
    for name in la:
        if isinstance(la[name], torch.Generator):
            continue
        assert la[name].dtype == lb[name].dtype, name
        assert la[name].device == lb[name].device, name
        assert torch.equal(la[name], lb[name]), name


@pytest.mark.parametrize("kind", ["tracking", "matching", "three_frame",
                                  "tracking_ba"])
def test_checkpoint_round_trip(kind, tmp_path):
    seq = _seq()
    vo = _pipelines(seq.K)[kind]
    state = vo.init(seq.frame(0))
    state, _ = vo.step(state, seq.frame(1))
    torch.rand(3, generator=state.gen)  # move the generator off its seed
    f = str(tmp_path / "s.npz")
    tckpt.save_state(state, f, frame_idx=17, extra_meta={"host": {"a": 1}})
    restored, idx = tckpt.load_state(vo.init(seq.frame(0)), f)
    assert idx == 17 and tckpt.load_meta(f)["host"] == {"a": 1}
    assert type(restored) is type(state)
    _leaves_equal(restored, state)
    if hasattr(state, "pyramid"):
        assert any(p.dtype == torch.bfloat16 for p in restored.pyramid)
    # the restored generator continues the original's stream
    assert torch.equal(torch.rand(8, generator=restored.gen),
                       torch.rand(8, generator=state.gen))


def test_checkpoint_rejects_mismatch_and_stale_schema(tmp_path):
    seq = _seq()
    vo = TrackingVO(seq.K, SMALL, device="cpu")
    state = vo.init(seq.frame(0))
    f = str(tmp_path / "s.npz")
    tckpt.save_state(state, f, frame_idx=1)
    bigger = TrackingVO(seq.K, SMALL._replace(
        orb=OrbConfig(nfeatures=400, n_levels=3)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state(bigger.init(seq.frame(0)), f)
    matching = MatchingVO(seq.K, SMALL, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_state(matching.init(seq.frame(0)), f)
    # a stale layout: rewrite the file with another schema tag
    with np.load(f) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("__meta__")))
    meta["state_schema"] = 3
    np.savez(f, __meta__=json.dumps(meta), **arrays)
    with pytest.raises(ValueError, match="state_schema"):
        tckpt.load_state(state, f)


# ------------------------------------------------------------------ gate


def _gate_runners():
    from vo_tpu.models.vo import _AsyncScalarGate as JGate
    from vo_tpu.runtime.checkpoint import CheckpointingRunner as JRunner
    from vo_tpu_torch.models.vo import _AsyncScalarGate as TGate

    class Pipe:
        pass

    jp, tp = Pipe(), Pipe()
    jp._gate = JGate(threshold=150, mode="sync")
    tp._gate = TGate("sync")
    return (JRunner(jp, os.devnull), jp._gate), \
        (tckpt.CheckpointingRunner(tp, os.devnull), tp._gate)


# [dip latch, count] pushes, with an update() after the marked ones
GATE_SEQUENCES = {
    "pending": [([0, 500], False), ([1, 400], False)],
    "fired_then_pending": [([0, 500], True), ([1, 90], True),
                           ([0, 480], False), ([1, 120], False)],
    "quiet": [([0, 500], True), ([0, 450], True), ([0, 430], False)],
}


@pytest.mark.parametrize("case", sorted(GATE_SEQUENCES))
def test_gate_snapshot_matches_vo_tpu(case):
    (jr, jg), (tr, tg) = _gate_runners()
    for value, update in GATE_SEQUENCES[case]:
        jg.push(np.asarray(value, np.int32))
        tg.push(torch.tensor(value, dtype=torch.int32))
        if update:
            assert jg.update() == tg.update()
    snap_j, snap_t = jr._capture_host(), tr._capture_host()
    assert snap_t == snap_j
    assert len(tg._inbox) == len(jg._inbox)  # the live gate is unchanged
    # restore each package's snapshot (and vo_tpu's into the port)
    (jr2, jg2), (tr2, tg2) = _gate_runners()
    (_, _), (tr3, tg3) = _gate_runners()
    jr2._restore_host(snap_j)
    tr2._restore_host(snap_t)
    tr3._restore_host(json.loads(json.dumps(snap_j)))
    for value in ([0, 300], [1, 20], [0, 400]):
        want = jg2.update()
        assert tg2.update() == want and tg3.update() == want
        jg2.push(np.asarray(value, np.int32))
        tg2.push(torch.tensor(value, dtype=torch.int32))
        tg3.push(torch.tensor(value, dtype=torch.int32))
    assert tg2.update() == jg2.update()


def test_gate_stale_schema_fails_loudly():
    (_, _), (tr, _) = _gate_runners()
    snap = tr._capture_host()
    snap["gate"]["schema"] = 1
    with pytest.raises(ValueError, match="gate schema"):
        tr._restore_host(snap)


# ------------------------------------------------------------------ vo_tpu checkpoints


def _vo_tpu_state(kind, rng, n_lev=4, cap=40):
    """A vo_tpu state of numpy leaves (bf16 pyramid levels 1+), no JAX."""
    import ml_dtypes

    from vo_tpu.ba.window import WindowState as JWin
    from vo_tpu.models.vo import MatchingState, TrackingState
    from vo_tpu.models.vo_3frame import ThreeFrameState
    from vo_tpu.models.vo_ba import TrackingBAState
    from vo_tpu.ops.lk import LKCache as JCache

    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    b = lambda *s: rng.random(s) < 0.5  # noqa: E731
    key = np.asarray([0, 7], np.uint32)
    if kind in ("tracking", "tracking_ba"):
        pyr = tuple(f32(32 >> i, 48 >> i) if i == 0 else
                    f32(32 >> i, 48 >> i).astype(ml_dtypes.bfloat16)
                    for i in range(n_lev))
        cache = JCache(wins=tuple(f32(cap, 9, 9) for _ in range(n_lev)),
                       origins=tuple(f32(cap, 2) for _ in range(n_lev)))
        common = dict(pyramid=pyr, lk_cache=cache, pts=f32(cap, 2),
                      pts_valid=b(cap), prev3d=f32(cap, 3),
                      prev3d_valid=b(cap), pose=f32(4, 4), key=key,
                      dipped=np.int32(1))
        if kind == "tracking":
            return TrackingState(**common, health=np.int32(123))
        return TrackingBAState(
            **common,
            window=JWin(poses=f32(3, 4, 4), obs=f32(3, cap, 2),
                        valid=b(3, cap), count=np.int32(3)),
            map_X=f32(cap, 3), map_ok=b(cap), frame_idx=np.int32(9))
    desc = rng.integers(0, 2, (cap, 256)).astype(np.uint8)
    if kind == "matching":
        return MatchingState(pts=f32(cap, 2), desc=desc, valid=b(cap),
                             prev3d=f32(cap, 3), prev3d_valid=b(cap),
                             pose=f32(4, 4), key=key)
    return ThreeFrameState(
        pts_a=f32(cap, 2), pts_b=f32(cap, 2), desc_b=desc, valid_b=b(cap),
        m_ab_idx=rng.integers(0, cap, cap).astype(np.int32),
        m_ab_valid=b(cap), R_ab=f32(3, 3), t_ab=f32(3), pose=f32(4, 4),
        key=key, n_frames=np.int32(5))


@pytest.mark.parametrize("kind", ["tracking", "matching", "three_frame",
                                  "tracking_ba"])
def test_load_vo_tpu_checkpoint(kind, tmp_path):
    from vo_tpu.runtime.checkpoint import save_state as j_save
    from vo_tpu_torch.models import convert

    rng = np.random.default_rng(4)
    jstate = _vo_tpu_state(kind, rng)
    f = str(tmp_path / "tpu.npz")
    j_save(jstate, f, frame_idx=33, extra_meta={"host": {"_frame_idx": 32}})
    K = np.array([[100.0, 0, 24], [0, 100.0, 16], [0, 0, 1]])
    vo = _pipelines(K)[kind]
    state, idx = tckpt.load_vo_tpu_checkpoint(f, vo)
    assert idx == 33
    from_numpy = {"tracking": convert.state_from_numpy,
                  "matching": convert.matching_state_from_numpy,
                  "three_frame": convert.three_frame_state_from_numpy,
                  "tracking_ba": convert.tracking_ba_state_from_numpy}[kind]
    _leaves_equal(state, from_numpy(jstate, device="cpu"))
    with pytest.raises(ValueError):  # another pipeline's state
        tckpt.load_vo_tpu_checkpoint(
            f, _pipelines(K)["matching" if kind != "matching" else "tracking"])
    with pytest.raises(ValueError, match="vo_tpu"):  # a vo_tpu file
        tckpt.load_state(state, f)


# ------------------------------------------------------------------ CLI


def test_cli_writes_the_bundle_with_vo_tpu_keys(tmp_path, monkeypatch):
    from vo_tpu.utils.metrics import evaluate_paths as j_evaluate
    from vo_tpu_torch.runtime import cli
    from vo_tpu_torch.runtime.presets import PRESETS, Preset

    small = Preset("tracking_orb", "small test variant", TrackingVO,
                   SMALL._replace(fallback_gate="async"))
    monkeypatch.setitem(PRESETS, "tracking_orb", small)
    report = cli.main(["--preset", "tracking_orb", "--synthetic", "8",
                       "--device", "cpu", "--out", str(tmp_path)])
    assert report["n_frames"] == 8
    assert np.isfinite(report["ate_rmse"])
    out = tmp_path / "tracking_orb"
    for f in ["gt_path.txt", "est_path.txt", "scale.txt", "metrics.json",
              "metrics.png", "path_visualization.png"]:
        assert (out / f).exists(), f
    est = np.loadtxt(out / "est_path.txt")
    gt = np.loadtxt(out / "gt_path.txt")
    assert est.shape == (8, 2)
    rep = json.loads((out / "metrics.json").read_text())
    want = ["preset", "n_frames", "runtime_s", "fps", "compile_s",
            *j_evaluate(gt, est, np.loadtxt(out / "scale.txt"))]
    assert list(rep) == want
    assert rep["preset"] == "tracking_orb"


# ------------------------------------------------------------------ on_frame


@pytest.mark.parametrize("kind", ["tracking", "tracking_ba"])
def test_on_frame_hook(kind):
    seq = _seq(n=6)
    runner = run_vo if kind == "tracking" else run_vo_ba
    est0, *_ = runner(seq, _pipelines(seq.K)[kind])
    seen = []
    est1, _, _, stats = runner(
        seq, _pipelines(seq.K)[kind],
        on_frame=lambda i, f: seen.append((i, f.pose.numpy())))
    assert [i for i, _ in seen] == list(range(1, len(seq)))
    np.testing.assert_array_equal(est1, est0)
    # the hook shows the online pose; a BA solve rewrites its window's
    # frames in the returned path only
    rewritten = {k - 2 + j for k, s in enumerate(stats) if s.get("ba_ran")
                 for j in range(3)}
    assert rewritten or kind == "tracking"
    for i, pose in seen:
        if i not in rewritten:
            np.testing.assert_array_equal(pose[[0, 2], 3], est1[i])


# ------------------------------------------------------------------ profiling


def test_chained_timeit_threads_data():
    from vo_tpu_torch.utils.profiling import chained_timeit

    calls = []

    def chain(out, x):
        calls.append(1)
        return (out,)

    dt = chained_timeit(lambda x: x * 1.5 + 1.0, (torch.ones(8, 8),), chain,
                        n=5, warmup=2)
    assert dt > 0
    assert len(calls) >= 5  # data dependency threaded every iteration


def test_frame_rate_meter_and_trace():
    from vo_tpu_torch.utils.profiling import FrameRateMeter, summarize, trace

    m = FrameRateMeter()
    x = torch.zeros(4)
    with trace() as prof:
        for _ in range(10):
            x = x + 1.0
            m.mark(x)
    rep = m.report()
    assert rep["frames"] == 10
    assert rep["fps"] > 0
    assert torch.equal(x, torch.full((4,), 10.0))
    rows = summarize(prof, top=5, min_us=0.0)
    assert 0 < len(rows) <= 5
    assert any(name == "aten::add" and count == 10
               for _, name, count in rows)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)


# ------------------------------------------------------------------ compare


def test_compare_matches_vo_tpu(tmp_path):
    from vo_tpu.runtime.compare import run_compare as j_compare
    from vo_tpu_torch.runtime.compare import run_compare as t_compare

    frame = SyntheticSequence.generate(n_frames=1, shape=(240, 320),
                                       n_points=1500).frame(0)
    p = str(tmp_path / "frame.png")
    with open(p, "wb") as f:
        f.write(tkitti.encode_png(np.clip(np.rint(frame), 0, 255)
                                  .astype(np.uint8)))
    rj = j_compare(p, None, False)
    rt = t_compare(p, str(tmp_path / "kp.png"), False, device="cpu")
    assert list(rt) == list(rj) + ["visualization"]
    assert os.path.exists(rt["visualization"])
    # test_torch_orb.py's tolerances: >= 99 % identical keypoints, angles
    # to 1e-4, >= 99.99 % identical bits
    assert rj["n_keypoints"] > 200
    assert abs(rt["n_keypoints"] - rj["n_keypoints"]) <= 0.01 * rj["n_keypoints"]
    assert rt["fast_score_positive_at_kp"] == rt["n_keypoints"]
    assert rt["orientation_max_err_rad"] <= rj["orientation_max_err_rad"] + 1e-4
    assert rt["descriptor_bit_error_rate"] <= \
        rj["descriptor_bit_error_rate"] + 1e-4
