"""Box sums (port of vo_tpu/ops/integral.py: box_filter5)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .conv import conv2d_valid


def box_filter5(img: torch.Tensor) -> torch.Tensor:
    """Dense 5x5 box SUM with zero borders (Brief.cu's sum5x5 at every
    pixel), as two passes of shifted adds."""
    out = conv2d_valid(F.pad(img, (2, 2, 2, 2)), np.ones((1, 5)))
    return conv2d_valid(out, np.ones((5, 1)))
