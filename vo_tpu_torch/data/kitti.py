"""KITTI odometry dataset IO (port of vo_tpu/data/kitti.py).

Same on-disk semantics as the reference's per-driver loaders
(feature_matching.cpp:127-153): poses are 12 whitespace-separated floats per
line forming the top 3 rows of a 4x4 cam->world matrix; calib's first line is
`P0: <12 floats>` giving the 3x4 projection P, with K = P[:, :3]; images are
the sorted listing of `sequences/<seq>/image_0/*.png` (grayscale left cam).

Frames are host float32 numpy arrays, as in vo_tpu; a pipeline moves each
to its device. `write_sequence` writes frames in the same layout with the
standard library's PNG encoding, for runs on data made from a seed.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np


def read_poses(pose_file: str, max_frames: int | None = None) -> np.ndarray:
    """Load (N, 4, 4) cam->world poses from a KITTI poses txt file."""
    rows = np.loadtxt(pose_file, dtype=np.float64)
    if max_frames is not None:
        rows = rows[:max_frames]
    n = rows.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, :3, :] = rows.reshape(n, 3, 4)
    return poses


def read_calib(calib_file: str, camera: str = "P0") -> tuple[np.ndarray, np.ndarray]:
    """Return (P 3x4, K 3x3) for the requested camera entry."""
    with open(calib_file) as f:
        for line in f:
            tag, _, rest = line.partition(":")
            if tag.strip() == camera:
                P = np.fromstring(rest, sep=" ", dtype=np.float64).reshape(3, 4)
                return P, P[:, :3].copy()
    raise KeyError(f"{camera} not found in {calib_file}")


def list_images(image_dir: str, max_frames: int | None = None) -> list[str]:
    names = sorted(
        n for n in os.listdir(image_dir) if n.lower().endswith((".png", ".pgm", ".jpg"))
    )
    if max_frames is not None:
        names = names[:max_frames]
    return [os.path.join(image_dir, n) for n in names]


def load_gray(path: str) -> np.ndarray:
    """Load a grayscale image as float32 (H, W) in [0, 255].

    Prefers the native C++ PNG decoder (runtime/native; bit-exact vs PIL
    for 8-bit PNGs); falls back to PIL for other formats or when the
    decoder cannot be built. Raises, naming both, when neither is there."""
    native_error = None
    if path.lower().endswith(".png"):
        from ..runtime.loader import build_error, decode_png, native_available

        if native_available():
            return decode_png(path)
        native_error = build_error()
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"cannot load {path}: PIL is not installed"
            + (f" and the native PNG decoder is unavailable ({native_error})"
               if native_error else "")
        ) from e

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.float32)


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of a (H, W) uint8 array: no filter, one
    IDAT chunk (the standard library's zlib and struct only)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"need a 2-D uint8 array, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_sequence(kitti_dir: str, sequence: str, frames, poses: np.ndarray,
                   K: np.ndarray) -> None:
    """Write a sequence in KITTI odometry layout under `kitti_dir`:
    `sequences/<seq>/image_0/%06d.png` (uint8 frames), `calib.txt` with a
    `P0:` line of [K | 0] and `poses/<seq>.txt` with the top 3 rows of
    each (4, 4) pose. Numbers are written to round-trip exactly."""
    seq_dir = os.path.join(kitti_dir, "sequences", sequence)
    img_dir = os.path.join(seq_dir, "image_0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(kitti_dir, "poses"), exist_ok=True)
    for i, img in enumerate(frames):
        with open(os.path.join(img_dir, f"{i:06d}.png"), "wb") as f:
            f.write(encode_png(img))
    P = np.zeros((3, 4))
    P[:, :3] = K
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(repr(float(v)) for v in P.ravel()) + "\n")
    with open(os.path.join(kitti_dir, "poses", f"{sequence}.txt"), "w") as f:
        for pose in np.asarray(poses, np.float64):
            f.write(" ".join(repr(float(v)) for v in pose[:3].ravel()) + "\n")


@dataclass
class KittiSequence:
    """A KITTI odometry sequence: image paths, GT poses, intrinsics."""

    image_paths: list[str]
    poses: np.ndarray  # (N, 4, 4) cam->world
    K: np.ndarray  # (3, 3)
    P: np.ndarray  # (3, 4)

    @classmethod
    def open(
        cls, kitti_dir: str, sequence: str = "05", max_frames: int | None = 1000
    ) -> "KittiSequence":
        seq_dir = os.path.join(kitti_dir, "sequences", sequence)
        image_paths = list_images(os.path.join(seq_dir, "image_0"), max_frames)
        poses = read_poses(
            os.path.join(kitti_dir, "poses", f"{sequence}.txt"), max_frames
        )
        P, K = read_calib(os.path.join(seq_dir, "calib.txt"))
        n = min(len(image_paths), len(poses))
        return cls(image_paths=image_paths[:n], poses=poses[:n], K=K, P=P)

    def __len__(self) -> int:
        return len(self.image_paths)

    def frame(self, i: int) -> np.ndarray:
        return load_gray(self.image_paths[i])

    def gt_path_xz(self) -> np.ndarray:
        """(N, 2) ground-truth x/z path, the reference's dump format."""
        return self.poses[:, [0, 2], 3]

    def prefetched(self, n_threads: int = 4, ring: int = 16):
        """Same sequence with background native decode (the synchronous
        loader when the native library is unavailable)."""
        from ..runtime.loader import NativePrefetcher, native_available

        if native_available():
            return PrefetchedSequence(
                self, NativePrefetcher(self.image_paths, n_threads, ring)
            )
        return self


@dataclass
class PrefetchedSequence:
    """KittiSequence view whose frame() is served by the native
    multi-threaded decoder (decode overlaps device compute)."""

    base: KittiSequence
    _prefetcher: object

    @property
    def poses(self) -> np.ndarray:
        return self.base.poses

    @property
    def K(self) -> np.ndarray:
        return self.base.K

    @property
    def served(self) -> int:
        """Frames the native decoder has returned so far."""
        return self._prefetcher.served

    def __len__(self) -> int:
        return len(self.base)

    def frame(self, i: int) -> np.ndarray:
        return self._prefetcher.get(i)

    def gt_path_xz(self) -> np.ndarray:
        return self.base.gt_path_xz()

    def close(self):
        self._prefetcher.close()
