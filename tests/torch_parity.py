"""Shared support for the port's parity tests (tests/test_torch_*.py)."""

import os

import numpy as np
import pytest
import torch

CAP = 480  # feature slots per frame of scene_features
K_SCENE = np.array([[288.0, 0, 160.0], [0, 288.0, 120.0], [0, 0, 1.0]])


def _threads():
    try:
        return [int(t) for t in os.listdir("/proc/self/task")]
    except FileNotFoundError:  # no procfs: the calling thread only
        return [0]


@pytest.fixture(scope="module")
def low_cpu_priority():
    """Run the module's tests at the lowest CPU priority (nice 19), with
    one PyTorch CPU thread.

    The parity tests compile vo_tpu's JAX references, minutes of CPU in
    all. Under pytest-xdist they share the cores with the suite's longest
    file, whose pace sets the suite's wall time; at nice 19 they take the
    cores the rest of the suite leaves idle. Linux keeps a priority per
    thread, so every thread of the process is lowered (threads started
    later inherit it), and the old priorities are restored afterwards
    where the process may raise them again. The port's small CPU tensors
    gain little from PyTorch's intra-op threads, which would only add to
    the cores' oversubscription."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = {}
    for t in _threads():
        try:
            old[t] = os.getpriority(os.PRIO_PROCESS, t)
            os.setpriority(os.PRIO_PROCESS, t, 19)
        except ProcessLookupError:  # the thread has ended
            pass
    yield
    torch.set_num_threads(torch_threads)
    for t, prio in old.items():
        try:
            os.setpriority(os.PRIO_PROCESS, t, prio)
        except (PermissionError, ProcessLookupError):
            pass


def scene_features(detector: str, n_frames: int = 4, seed: int = 0):
    """Features made with numpy from a seed, for feeding both packages'
    matching cores: per frame (pts (CAP, 2) f32, desc, valid (CAP,) bool)
    of a scene of 3-D points seen from a camera that moves forward and
    turns (K_SCENE, 320x240), each point with its own descriptor (ORB bit
    planes, or SIFT-like unit vectors) perturbed per view, in a random
    slot order with distractors and empty slots; and the cam->world
    poses."""
    rng = np.random.default_rng(seed)
    n = 420
    X = np.stack([rng.uniform(-12, 12, n), rng.uniform(-5, 5, n),
                  rng.uniform(8, 40, n)], 1)
    if detector == "orb":
        base = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    else:
        base = rng.random((n, 128)).astype(np.float32)
    frames, poses = [], []
    for f in range(n_frames):
        yaw = 0.02 * f
        c, s = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([0.1 * f, 0.0, 1.0 * f])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = Rwc, pos
        poses.append(T)
        pc = (X - pos) @ Rwc  # world -> camera
        uv = pc[:, :2] / pc[:, 2:] * 288.0 + [160.0, 120.0]
        uv += rng.normal(0, 0.3, uv.shape)
        vis = np.flatnonzero((pc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 320)
                             & (uv[:, 1] > 0) & (uv[:, 1] < 240))
        n_dis = 25  # distractors: features of nothing in the scene
        order = rng.permutation(len(vis) + n_dis)
        pts = np.zeros((CAP, 2), np.float32)
        valid = np.zeros(CAP, bool)
        if detector == "orb":
            d = base[vis] ^ (rng.random((len(vis), 256)) < 0.04)
            dis = rng.integers(0, 2, (n_dis, 256))
            desc = np.zeros((CAP, 256), np.uint8)
        else:
            d = base[vis] + rng.normal(0, 0.03, (len(vis), 128))
            dis = rng.random((n_dis, 128))
            desc = np.zeros((CAP, 128), np.float32)
        allp = np.concatenate([uv[vis], rng.uniform(0, 240, (n_dis, 2))])
        alld = np.concatenate([d, dis]).astype(desc.dtype)
        if detector == "sift":
            alld /= np.linalg.norm(alld, axis=1, keepdims=True)
        m = len(order)
        pts[:m], desc[:m], valid[:m] = allp[order], alld[order], True
        frames.append((pts, desc, valid))
    return frames, poses
