"""The plain NumPy renderer of one synthetic frame (a copy of the port's
`data/synthetic.py:render_frame`): the yardstick of `vobench/frames.py`'s
renderer on the card. Splats are summed in float64, landmark by landmark."""

from __future__ import annotations

import numpy as np


def render_frame(
    points_w: np.ndarray,
    contrast: np.ndarray,
    pose_c2w: np.ndarray,
    K: np.ndarray,
    shape: tuple[int, int],
    background: float = 128.0,
    blob_sigma: float = 1.4,
    min_depth: float = 1.0,
) -> np.ndarray:
    """Render one grayscale frame: Gaussian blobs at projected landmarks.

    Blob size is mildly depth-dependent so LK sees consistent appearance
    across small baselines. Output float32 (H, W) in [0, 255].
    """
    H, W = shape
    w2c = np.linalg.inv(pose_c2w)
    pc = points_w @ w2c[:3, :3].T + w2c[:3, 3]
    vis = pc[:, 2] > min_depth
    pc, con = pc[vis], contrast[vis]
    uv = pc[:, :2] / pc[:, 2:3]
    px = uv[:, 0] * K[0, 0] + K[0, 2]
    py = uv[:, 1] * K[1, 1] + K[1, 2]
    inb = (px > -6) & (px < W + 6) & (py > -6) & (py < H + 6)
    px, py, con, z = px[inb], py[inb], con[inb], pc[inb, 2]

    img = np.full((H, W), background, dtype=np.float64)
    r = 4  # splat radius in pixels
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    for x, y, c, depth in zip(px, py, con, z):
        cx, cy = int(round(x)), int(round(y))
        fx, fy = x - cx, y - cy  # subpixel offset for smooth motion
        sigma = blob_sigma * np.clip(30.0 / depth, 0.6, 2.0)
        g = np.exp(-(((dx - fx) ** 2 + (dy - fy) ** 2) / (2 * sigma**2)))
        x0, x1 = max(0, cx - r), min(W, cx + r + 1)
        y0, y1 = max(0, cy - r), min(H, cy + r + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        img[y0:y1, x0:x1] += c * g[y0 - (cy - r) : y1 - (cy - r), x0 - (cx - r) : x1 - (cx - r)]
    return np.clip(img, 0.0, 255.0).astype(np.float32)
