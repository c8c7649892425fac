"""Frames of the benchmark's drives, made from the seed on the card.

A drive is a random 3D blob world seen by a pinhole camera moving along a
smooth trajectory, as the port's synthetic sequences make it: the world,
the trajectory, the corridor of landmarks along it and the texture-poor
stretches are copied here from `data/synthetic.py` (NumPy, a few thousand
numbers). The frames themselves are rendered in PyTorch on the device:
each visible landmark adds a 9x9 Gaussian splat, summed in float64 in a
fixed order (sorted by pixel, then a running sum), so that one seed gives
the same bits on every run. The renderer uses the intrinsics that the
pipeline is given.

A stream's bank of frames is replayed ping-pong (0..n-1, n-2..1, 0, ...):
any number of steps has continuous motion, and stream s of S starts at
offset floor(s * cycle / S) of the cycle of 2n - 2 frames.
"""

from __future__ import annotations

import numpy as np
import torch

SPLAT_RADIUS = 4
BACKGROUND = 128.0
BLOB_SIGMA = 1.4
MIN_DEPTH = 1.0
DROPOUT_SUBSET_SEED = 12345  # one subset of landmarks for every dim frame


def make_world(n_points: int, seed: int,
               x_range=(-60.0, 60.0), y_range=(-8.0, 4.0),
               z_range=(2.0, 220.0)) -> tuple[np.ndarray, np.ndarray]:
    """Random 3D landmarks (world frame) with per-point contrast in
    +-[40, 90]."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(*x_range, n_points),
                    rng.uniform(*y_range, n_points),
                    rng.uniform(*z_range, n_points)], axis=1)
    contrast = rng.uniform(40.0, 90.0, n_points) * rng.choice([-1.0, 1.0],
                                                              n_points)
    return pts, contrast


def make_trajectory(n_frames: int, speed: float, yaw_amplitude: float,
                    n_turns: float, seed: int) -> np.ndarray:
    """(N, 4, 4) smooth cam->world poses: forward motion with gentle yaw
    (camera looks down +z, x right, y down)."""
    rng = np.random.default_rng(seed)
    yaw_rate = yaw_amplitude * np.sin(
        np.linspace(0, n_turns * np.pi, n_frames) + rng.uniform(0, np.pi)
    ) / max(n_frames, 1)
    yaw = np.cumsum(yaw_rate)
    speeds = speed * (1.0 + 0.3 * np.sin(np.linspace(0, 4 * np.pi, n_frames)))
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    pos = np.zeros(3)
    for i in range(n_frames):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        pos = pos + R @ np.array([0.0, 0.0, speeds[i]])
    return poses


def corridor(poses: np.ndarray, n_points: int, seed: int):
    """Landmarks scattered along the trajectory so that every frame of a
    long drive sees structure: max(n_points, 8 per frame) of them."""
    n_frames = len(poses)
    rng = np.random.default_rng(seed)
    n_extra = max(n_points, 8 * n_frames)
    t = rng.integers(0, n_frames, n_extra)
    anchor = poses[t, :3, 3]
    offs = (poses[t, :3, 2] * rng.uniform(2.0, 220.0, n_extra)[:, None]
            + poses[t, :3, 0] * rng.uniform(-60.0, 60.0, n_extra)[:, None]
            + poses[t, :3, 1] * rng.uniform(-8.0, 4.0, n_extra)[:, None])
    con = rng.uniform(40.0, 90.0, n_extra) * rng.choice([-1.0, 1.0], n_extra)
    return anchor + offs, con


def stream_seed(seed: int, stream: int) -> int:
    """The world seed of one stream of a run: any whole `seed` (also above
    32 bits) and the stream's index give one 32-bit number."""
    ss = np.random.SeedSequence([int(seed) % (2**64), int(stream)])
    return int(ss.generate_state(1, np.uint32)[0])


def intrinsics(cam: dict) -> np.ndarray:
    return np.array([[cam["fx"], 0.0, cam["cx"]],
                     [0.0, cam["fy"], cam["cy"]],
                     [0.0, 0.0, 1.0]])


class Drive:
    """One stream's world, trajectory and dim stretches (NumPy)."""

    def __init__(self, traffic: dict, n_frames: int, world_seed: int):
        self.n_frames = n_frames
        self.poses = make_trajectory(
            n_frames, traffic["speed"], traffic["yaw_amplitude"],
            traffic["n_turns"], (world_seed + 1) % 2**32)
        pts, con = make_world(traffic["landmarks"], world_seed)
        if traffic.get("corridor", True):
            ext, ext_con = corridor(self.poses, traffic["landmarks"],
                                    (world_seed + 2) % 2**32)
            pts = np.concatenate([pts, ext])
            con = np.concatenate([con, ext_con])
        self.points_w, self.contrast = pts, con
        self.dropouts = [tuple(d) for d in traffic.get("dropouts", ())]
        self.dropout_keep = float(traffic.get("dropout_keep", 1.0))

    def dim(self, i: int) -> bool:
        return any(a <= i < b for a, b in self.dropouts)

    def kept(self) -> np.ndarray:
        """The landmarks every dim frame shows: one `dropout_keep` share."""
        rng = np.random.default_rng(DROPOUT_SUBSET_SEED)
        return rng.random(len(self.points_w)) < self.dropout_keep

    def landmarks(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """The landmarks frame i shows: all, or those `kept` on a dim frame."""
        if not self.dim(i):
            return self.points_w, self.contrast
        keep = self.kept()
        return self.points_w[keep], self.contrast[keep]


def render_frames(drive: Drive, ids, K: np.ndarray, shape: tuple[int, int],
                  device: torch.device) -> torch.Tensor:
    """(len(ids), H, W) float32 frames in [0, 255] on `device`: a Gaussian
    splat of radius 4 at each projected landmark in front of the camera, its
    sigma 1.4 * clip(30 / depth, 0.6, 2.0), on a background of 128."""
    H, W = shape
    f64 = torch.float64
    ids = list(ids)
    P = torch.as_tensor(drive.points_w, dtype=f64, device=device)
    con = torch.as_tensor(drive.contrast, dtype=f64, device=device)
    w2c = torch.as_tensor(np.linalg.inv(drive.poses[ids]), dtype=f64,
                          device=device)
    pc = torch.einsum("fij,nj->fni", w2c[:, :3, :3], P) + w2c[:, None, :3, 3]
    shown = torch.ones((len(ids), P.shape[0]), dtype=torch.bool,
                       device=device)
    for r, i in enumerate(ids):
        if drive.dim(i):
            shown[r] = torch.as_tensor(drive.kept(), device=device)
    z = pc[..., 2]
    px = pc[..., 0] / z * float(K[0, 0]) + float(K[0, 2])
    py = pc[..., 1] / z * float(K[1, 1]) + float(K[1, 2])
    sel = (shown & (z > MIN_DEPTH) & (px > -6) & (px < W + 6) & (py > -6)
           & (py < H + 6))
    f, n = sel.nonzero(as_tuple=True)  # frame-major, landmarks in order
    px, py, z, c = px[f, n], py[f, n], z[f, n], con[n]
    cx, cy = torch.round(px), torch.round(py)  # half to even, as np.round
    fx, fy = px - cx, py - cy
    sigma = BLOB_SIGMA * torch.clamp(30.0 / z, 0.6, 2.0)
    r = SPLAT_RADIUS
    d = torch.arange(-r, r + 1, dtype=f64, device=device)
    gx = (d[None, :] - fx[:, None]) ** 2  # (n, 9)
    gy = (d[None, :] - fy[:, None]) ** 2
    g = torch.exp(-((gy[:, :, None] + gx[:, None, :])
                    / (2 * sigma[:, None, None] ** 2)))  # (n, 9 rows, 9 cols)
    val = c[:, None, None] * g
    rows = cy.long()[:, None, None] + d.long()[None, :, None]
    cols = cx.long()[:, None, None] + d.long()[None, None, :]
    ok = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    flat = (f[:, None, None] * (H * W) + rows * W + cols)[ok]
    val = val[ok]
    # a fixed order of summation: by pixel, then by landmark and offset
    flat, order = torch.sort(flat, stable=True)
    run = torch.cumsum(val[order], 0)
    pix, counts = torch.unique_consecutive(flat, return_counts=True)
    ends = torch.cumsum(counts, 0) - 1
    sums = run[ends] - torch.cat([run.new_zeros(1), run[ends[:-1]]])
    img = torch.full((len(ids) * H * W,), BACKGROUND, dtype=f64, device=device)
    img[pix] += sums
    return img.clamp(0.0, 255.0).to(torch.float32).reshape(len(ids), H, W)


def render_bank(drive: Drive, K: np.ndarray, shape: tuple[int, int],
                device: torch.device, chunk: int = 48) -> torch.Tensor:
    """(n_frames, H, W) float32: every frame of the drive, on `device`,
    rendered `chunk` frames at a time."""
    bank = torch.empty((drive.n_frames, *shape), dtype=torch.float32,
                       device=device)
    for i in range(0, drive.n_frames, chunk):
        ids = range(i, min(drive.n_frames, i + chunk))
        bank[i:i + len(ids)] = render_frames(drive, ids, K, shape, device)
    return bank


def cycle_length(n_frames: int) -> int:
    return 2 * n_frames - 2


def bank_index(k: int, n_frames: int) -> int:
    """The bank frame of step k of a ping-pong replay (0..n-1, n-2..1, 0..)."""
    c = k % cycle_length(n_frames)
    return c if c < n_frames else cycle_length(n_frames) - c


def stream_offset(stream: int, n_streams: int, n_frames: int) -> int:
    """Where stream `stream` of `n_streams` starts in the ping-pong cycle."""
    return stream * cycle_length(n_frames) // n_streams
