"""Harris corner response (port of vo_tpu/ops/harris.py; HarrisScore.cu
with its three bugs fixed)."""

from __future__ import annotations

import torch

from .conv import gaussian_blur, sobel


def harris_response(img: torch.Tensor, block_size: int = 7, k: float = 0.04
                    ) -> torch.Tensor:
    """Dense (H, W) Harris response det(M) - k trace(M)^2. The three
    structure-tensor maps are blurred in one batched call (one B2 launch
    on the card)."""
    ix, iy = sobel(img)
    s = gaussian_blur(torch.stack([ix * ix, iy * iy, ix * iy]), block_size)
    sxx, syy, sxy = s[0], s[1], s[2]
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace
