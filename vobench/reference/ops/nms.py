"""Non-max suppression and deterministic top-k (port of vo_tpu/ops/nms.py).

Keypoint order is canonical: descending score, ties by ascending raster
index (lax.top_k's rule), which a stable descending sort reproduces.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values in ascending index order (as lax.top_k)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def nms_mask(score: torch.Tensor, radius: int = 1, threshold: float = 0.0):
    """Pixels above `threshold` and >= every neighbour in the (2r+1)^2
    window (ties survive, NMS.cu:108-118), excluding an r-pixel border."""
    H, W = score.shape[-2:]
    pooled = F.max_pool2d(score.reshape(1, 1, H, W), 2 * radius + 1,
                          stride=1, padding=radius).reshape(score.shape)
    ys = torch.arange(H, device=score.device)[:, None]
    xs = torch.arange(W, device=score.device)[None, :]
    interior = (ys >= radius) & (ys < H - radius) & (xs >= radius) \
        & (xs < W - radius)
    return (score > threshold) & (score >= pooled) & interior


def blocked_topk_2d(resp: torch.Tensor, k: int):
    """Top-k of an NMS-masked response (..., H, W) by 2x2 block maxima
    (exact for strict survivors; a block's equal-score pair keeps its
    first in raster order). Returns (vals, ys, xs, batch_idx) of size k."""
    H, W = resp.shape[-2:]
    B = int(np.prod(resp.shape[:-2], dtype=np.int64)) if resp.dim() > 2 else 1
    Hp, Wp = H - (H % 2), W - (W % 2)
    r = resp.reshape(B, H, W)[:, :Hp, :Wp]
    blk = r.reshape(B, Hp // 2, 2, Wp // 2, 2)
    bmax = blk.amax(dim=(2, 4))
    top, bidx = topk_stable(bmax.reshape(-1), k)
    nb = (Hp // 2) * (Wp // 2)
    b = bidx // nb
    rem = bidx % nb
    by = rem // (Wp // 2)
    bx = rem % (Wp // 2)
    quad = blk[b, by, :, bx, :].reshape(-1, 4)
    sub = torch.argmax(quad, dim=1)
    return top, by * 2 + sub // 2, bx * 2 + sub % 2, b
