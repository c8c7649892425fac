"""Keypoint-sharded descriptor matching (port of
vo_tpu/parallel/matching.py): shard the queries, all-gather the train set.

Each rank holds a block of the query keypoints and a block of the train
keypoints, all-gathers the train descriptors and their validity (a 2996 x
256 bit-plane set is 767 KB as uint8), builds its (n1/d, N2) distance
block and finishes knn2 + ratio on its rows. Each query row is complete on
its rank, so nothing is reduced, and the result is exact: with Hamming the
table holds integers, so the rows equal the dense table's bit for bit.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.hamming import Matches, hamming_table, knn2_ratio_match, l2_table
from .mesh import all_gather_leading


def sharded_match_descriptors(
    mesh: DeviceMesh,
    bits1: torch.Tensor,
    bits2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    ratio: float = 0.8,
    axis: str = "kp",
    binary: bool = True,
) -> Matches:
    """Exact knn2 + ratio matching of this rank's query block `bits1`
    against the train set whose block on this rank is `bits2` (every rank
    holds an equal block, in rank order along `axis`). Returns this
    rank's query rows, `idx` into the *global* train set."""
    group = mesh.get_group(axis)
    bits2_full = all_gather_leading(bits2, group)
    valid2_full = all_gather_leading(valid2, group)
    table = (hamming_table(bits1, bits2_full) if binary
             else l2_table(bits1, bits2_full))
    # l2_table holds squared distances; squared=True keeps the ratio in
    # true-Euclidean units (OpenCV FlannBasedMatcher semantics)
    return knn2_ratio_match(table, valid1, valid2_full, ratio,
                            squared=not binary)


def pad_to_multiple(arr: torch.Tensor, mult: int, axis: int = 0):
    """Pad `axis` with zeros to a multiple of `mult`; returns (arr, n_pad)."""
    n = arr.shape[axis]
    n_pad = (-n) % mult
    if n_pad == 0:
        return arr, 0
    shape = list(arr.shape)
    shape[axis] = n_pad
    return torch.cat([arr, arr.new_zeros(shape)], axis), n_pad
