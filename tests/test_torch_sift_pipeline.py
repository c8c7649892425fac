"""The port's TrackingVO with the SIFT frontend (the tracking_sift path)
against vo_tpu's, frame by frame, on the CPU at 240x320.

As in tests/test_torch_pipeline.py: vo_tpu runs LKConfig(layout="lanes",
exit_mult=N + 1) (per-point LK termination, the port's definition), both
run the sync re-detect gate, and the port gets each step's RANSAC draws
from vo_tpu's key chain. SIFT finds ~140 keypoints per frame at this
shape, so `min_tracked` is lowered to 60: the sequence then tracks
without a re-detect until its blank frame, which forces re-detects; these
run SIFT on both frames and match by L2 knn.

Held: the same re-detect steps, equal gate feeds, n_assoc within 2, and
the tracked points where both keep them (the LK sums differ only in f32
rounding order; SIFT keypoints agree to ~1e-4 px, tests/test_torch_sift.py).
Measured (`pytest -s`): n_assoc equal at every step (142, 118, 112 while
tracking; 96 into the blank frame, 6 after it; re-detects at steps 6 and 7
with 18 and 20 L2 matches).
"""

import jax
import numpy as np
import pytest
import torch

from vo_tpu.data.synthetic import SyntheticSequence
from vo_tpu.frontend.sift import SiftConfig as JSift
from vo_tpu.models import vo as jvo
from vo_tpu.ops.lk import LKConfig as JLK
from vo_tpu.runtime.presets import get_preset as jpreset
from vo_tpu_torch.frontend.sift import SiftConfig as TSift
from vo_tpu_torch.models import vo as tvo
from vo_tpu_torch.models.convert import state_from_numpy
from vo_tpu_torch.runtime.presets import get_preset as tpreset
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

N_CAP = 500  # SIFT nfeatures: the tracked-point capacity
N_ITERS = 256
MIN_TRACKED = 60


def _configs():
    common = dict(detector="sift", fallback_gate="sync",
                  ransac_iters=N_ITERS, min_tracked=MIN_TRACKED)
    jcfg = jvo.VOConfig(sift=JSift(nfeatures=N_CAP),
                        lk=JLK(layout="lanes", exit_mult=N_CAP + 1), **common)
    tcfg = tvo.VOConfig(sift=TSift(nfeatures=N_CAP), **common)
    return jcfg, tcfg


def _slot(sub_key, n_assoc):
    """The draws vo_tpu's ransac_essential makes from `sub_key`."""
    n_valid = max(int(n_assoc), 5)
    return torch.from_numpy(np.array(
        jax.random.randint(sub_key, (N_ITERS, 5), 0, n_valid)))


def _sequence(drop=()):
    return SyntheticSequence.generate(
        n_frames=8, shape=(240, 320), n_points=1500, seed=0, speed=8.0,
        yaw_amplitude=0.05, dropouts=drop, dropout_keep=0.0,
    )


@pytest.fixture(scope="module")
def ref_vo():
    """One vo_tpu pipeline for the module: its jitted programs compile
    once and serve every sequence (all share shape and intrinsics)."""
    return jvo.TrackingVO(_sequence().K, _configs()[0])


@pytest.fixture(scope="module")
def runs(ref_vo):
    # steps 1-3 track; frame 4 renders no landmarks, the survivors fall
    # below min_tracked at step 5 and the following steps re-detect
    seq = _sequence(((4, 5),))
    state = ref_vo.init(seq.frame(0))
    ref = []
    for i in range(1, len(seq)):
        _, sub = jax.random.split(state.key)
        state, out = ref_vo.step(state, seq.frame(i))
        ref.append((sub, jax.tree.map(np.asarray, out),
                    jax.tree.map(np.asarray, state)))
    vo = tvo.TrackingVO(seq.K, _configs()[1], device="cpu")
    state = vo.init(seq.frame(0))
    port = []
    for i, (sub, out, _) in enumerate(ref, start=1):
        state, o = vo.step(state, seq.frame(i), slot=_slot(sub, out.n_assoc))
        port.append((o, state))
    return ref, port


def test_frame_by_frame(runs):
    ref, port = runs
    fallbacks = []
    for step, ((_, jo, js), (to, ts)) in enumerate(zip(ref, port), start=1):
        assert bool(to.fallback) == bool(jo.fallback), step
        fallbacks.append(bool(jo.fallback))
        assert abs(int(to.n_assoc) - int(jo.n_assoc)) <= 2, (
            step, int(to.n_assoc), int(jo.n_assoc))
        np.testing.assert_array_equal(to.gate.numpy(), jo.gate)
        vj, vt = js.pts_valid, ts.pts_valid.numpy()
        assert (vj == vt).mean() >= 0.99
        both = vj & vt
        if both.any():
            d = np.abs(js.pts[both] - ts.pts.numpy()[both]).max(axis=1)
            assert np.percentile(d, 99) < 1e-2 and d.max() < 0.1, d.max()
        assert (int(to.health) > 0) == (int(jo.health) > 0)
        assert np.isfinite(to.pose.numpy()).all()
    pairs = [(int(jo.n_assoc), int(to.n_assoc))
             for (_, jo, _), (to, _) in zip(ref, port)]
    print(f"n_assoc vo_tpu/port per step {pairs}, re-detects at steps "
          f"{[i for i, f in enumerate(fallbacks, start=1) if f]}")
    # it tracks before the blank frame, and re-detects after it
    assert not any(fallbacks[:4])
    assert min(int(o.n_assoc) for _, o, _ in ref[:3]) >= MIN_TRACKED
    assert any(fallbacks[4:])


def test_sift_state_converts_unchanged(ref_vo):
    """models/convert.state_from_numpy carries a SIFT-initialised vo_tpu
    state across as it is (no SIFT-specific code), and one step from it
    associates the same points as vo_tpu's step."""
    seq = _sequence()
    jstate = ref_vo.init(seq.frame(0))
    _, sub = jax.random.split(jstate.key)
    before = jax.tree.map(np.asarray, jstate)
    _, jo = ref_vo.step(jstate, seq.frame(1))
    state = state_from_numpy(before, "cpu")
    assert int(before.pts_valid.sum()) > MIN_TRACKED
    np.testing.assert_array_equal(state.pts.numpy(), before.pts)
    np.testing.assert_array_equal(state.pts_valid.numpy(), before.pts_valid)
    for a, b in zip(state.pyramid, before.pyramid):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    for a, b in zip(state.lk_cache.origins, before.lk_cache.origins):
        np.testing.assert_array_equal(a.numpy(), b)
    vo = tvo.TrackingVO(seq.K, _configs()[1], device="cpu")
    _, to = vo.step(state, seq.frame(1), slot=_slot(sub, jo.n_assoc))
    assert int(to.n_assoc) == int(jo.n_assoc)


def test_tracking_sift_preset_matches():
    jp, tp = jpreset("tracking_sift"), tpreset("tracking_sift")
    assert tp.config.detector == jp.config.detector == "sift"
    assert tp.config.sift.nfeatures == jp.config.sift.nfeatures == 3000
    assert tp.config.min_tracked == jp.config.min_tracked
    assert tp.config.match_ratio == jp.config.match_ratio
    K = np.array([[700.0, 0, 620], [0, 700.0, 188], [0, 0, 1]])
    assert tp.build(K, device="cpu").capacity == 3000
