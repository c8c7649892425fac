"""The card's renderer (vobench/frames.py) against the plain NumPy copy of
the port's renderer, frame for frame, and the ping-pong replay."""

import numpy as np
import pytest
import torch

from vobench import frames
from vobench.reference.render_np import render_frame

# The NumPy copy sums each pixel's splats landmark by landmark in float64;
# the torch renderer sorts the splats by pixel and takes differences of a
# float64 running sum. The two sums differ in their last float64 bits,
# which the cast to float32 hides (a float32 step is 1.5e-5 at 255) except
# where a sum lies on a float32 rounding boundary: there the frames differ
# by one float32 step. 1e-4 allows that step and nothing larger.
TOL = 1e-4

TRAFFIC = {"landmarks": 200, "corridor": True, "speed": 1.0,
           "yaw_amplitude": 0.3, "n_turns": 2.0,
           "dropouts": [[4, 6]], "dropout_keep": 0.03}


def _camera(H, W):
    s = W / 1226
    return frames.intrinsics({"fx": 707.0912 * s, "fy": 707.0912 * s,
                              "cx": 601.8873 * s, "cy": 183.1104 * H / 370})


@pytest.mark.parametrize("seed", [0, 2**33 + 7])
def test_frames_match_the_numpy_renderer(seed):
    H, W = 60, 80
    K = _camera(H, W)
    drive = frames.Drive(TRAFFIC, 10, frames.stream_seed(seed, 2))
    bank = frames.render_bank(drive, K, (H, W), torch.device("cpu"))
    for i in range(10):
        want = render_frame(*drive.landmarks(i), drive.poses[i], K, (H, W))
        assert np.abs(bank[i].numpy() - want).max() <= TOL, i
    # the dim frames show the same 3 % of the landmarks, the others all
    assert drive.dim(4) and drive.dim(5) and not drive.dim(6)
    assert len(drive.landmarks(4)[0]) < 0.1 * len(drive.points_w)
    assert np.array_equal(drive.landmarks(4)[0], drive.landmarks(5)[0])


def test_one_seed_gives_the_same_bits():
    K = _camera(60, 80)
    a = frames.Drive(TRAFFIC, 6, frames.stream_seed(12345678901, 0))
    b = frames.Drive(TRAFFIC, 6, frames.stream_seed(12345678901, 0))
    fa = frames.render_bank(a, K, (60, 80), torch.device("cpu"))
    fb = frames.render_bank(b, K, (60, 80), torch.device("cpu"))
    assert torch.equal(fa, fb)
    c = frames.Drive(TRAFFIC, 6, frames.stream_seed(12345678901, 1))
    assert not np.array_equal(a.points_w, c.points_w)


def test_ping_pong_replay_and_offsets():
    n = 240
    seq = [frames.bank_index(k, n) for k in range(2 * frames.cycle_length(n))]
    assert seq[:3] == [0, 1, 2] and seq[239:242] == [239, 238, 237]
    assert seq[477:480] == [1, 0, 1]
    assert all(abs(a - b) == 1 for a, b in zip(seq, seq[1:]))
    offs = [frames.stream_offset(s, 6, n) for s in range(6)]
    assert offs == [0, 79, 159, 239, 318, 398]
