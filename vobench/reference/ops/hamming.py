"""Exact knn(2) + ratio matching (port of vo_tpu/ops/hamming.py): Hamming
for ORB's bits, squared L2 for SIFT's float descriptors.

With descriptors as (N, 256) {0, 1} bit planes, H(a, b) = |a| + |b| -
2 a.b, so the whole (N1, N2) table is one product. The product runs in
f32 with TF32 off: every partial sum is an integer <= 256, exact in f32.
The squared-L2 table is the same form over float rows (a plain product,
left to torch.matmul).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e9


class Matches(NamedTuple):
    """Fixed-capacity match set: query i -> train idx[i] where valid."""

    idx: torch.Tensor  # (N1,) int64 index into the train set
    dist: torch.Tensor  # (N1,) float32 best distance
    valid: torch.Tensor  # (N1,) bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)


def hamming_table(bits1: torch.Tensor, bits2: torch.Tensor) -> torch.Tensor:
    """(N1, N2) int32 Hamming distances from (N, 256) {0,1} bit planes."""
    a = bits1.float()
    b = bits2.float()
    dot = a @ b.T
    d = a.sum(1)[:, None] + b.sum(1)[None, :] - 2.0 * dot
    return d.round().to(torch.int32)


def l2_table(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(N1, N2) squared-L2 distances between float descriptor rows."""
    d1 = (desc1 * desc1).sum(1)
    d2 = (desc2 * desc2).sum(1)
    return d1[:, None] + d2[None, :] - 2.0 * (desc1 @ desc2.T)


def knn2_ratio_match(table: torch.Tensor, valid1: torch.Tensor,
                     valid2: torch.Tensor, ratio: float = 0.8,
                     squared: bool = False) -> Matches:
    """knn(k=2) + ratio test over a distance table with validity masks.
    `squared` marks a table of squared distances (`l2_table`): the ratio
    is then applied squared, as OpenCV ratio-tests true distances."""
    d = torch.where(valid2[None, :], table.float(), BIG)
    idx1 = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx1[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)[None, :]
    second = torch.where(cols == idx1[:, None], BIG, d).amin(dim=1)
    r = ratio * ratio if squared else ratio
    ok = valid1 & (best < r * second) & (best < BIG)
    return Matches(idx=idx1, dist=best, valid=ok)


def match_descriptors(bits1, bits2, valid1, valid2, ratio: float = 0.8
                      ) -> Matches:
    """Exact knn2 + ratio matching of query bits1 against train bits2."""
    return knn2_ratio_match(hamming_table(bits1, bits2), valid1, valid2, ratio)
