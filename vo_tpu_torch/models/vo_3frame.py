"""Three-frame correspondence VO (port of vo_tpu/models/vo_3frame.py; the
matching_orb_3d_correspond preset).

Reference: feature_tracking_scale.py. It knn-matches the frame pairs
(t-2, t-1) and (t-1, t), intersects them on the middle frame's keypoints
to build triplets (:38-74), recovers the (t-1, t) pose under the RANSAC
inlier mask (:110-125), triangulates both pairs, moves the (1, 2) cloud
into frame 2 (:158-159) and takes the matched-pair median ratio scale
(:140-151).

As in vo_tpu, the features of frame t-1 and the (t-2, t-1) match are
carried in the state, so a step costs one detect and one knn table, and
the triplets are two gathers (a -> b -> c) instead of a dict intersection.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.epipolar import normalize_pixels, ransac_essential, recover_pose
from ..geometry.scale import relative_scale_matched
from ..geometry.se3 import inv_se3, make_se3
from ..geometry.triangulate import triangulate_fast
from .vo import VOConfig, _Pipeline, _untracked_output, match_features


class ThreeFrameState(NamedTuple):
    pts_a: torch.Tensor  # (K, 2) frame t-2 keypoints
    pts_b: torch.Tensor  # (K, 2) frame t-1 keypoints
    desc_b: torch.Tensor
    valid_b: torch.Tensor  # (K,) bool
    m_ab_idx: torch.Tensor  # (K,) a-slot -> b-slot
    m_ab_valid: torch.Tensor  # (K,) bool
    R_ab: torch.Tensor  # (3, 3) relative pose a -> b (x_b = R x_a + t)
    t_ab: torch.Tensor  # (3,) unit translation
    pose: torch.Tensor  # (4, 4) chained cam -> world
    gen: torch.Generator  # RANSAC draws
    n_frames: torch.Tensor  # () int32 frames seen so far


def _tf_init(feats, gen, cfg: VOConfig) -> ThreeFrameState:
    pts, desc, valid = feats
    dev = pts.device
    # identity self-match (a = b = frame 0): step 1 estimates a plain
    # two-frame pose through the same triplet path
    return ThreeFrameState(
        pts_a=pts, pts_b=pts, desc_b=desc, valid_b=valid,
        m_ab_idx=torch.arange(pts.shape[0], device=dev),
        m_ab_valid=valid,
        R_ab=torch.eye(3, dtype=torch.float32, device=dev),
        t_ab=torch.tensor([0.0, 0.0, 1.0], device=dev),
        pose=torch.eye(4, dtype=torch.float32, device=dev),
        gen=gen,
        n_frames=torch.ones((), dtype=torch.int32, device=dev),
    )


def _tf_core(state: ThreeFrameState, feats, K, cfg: VOConfig, slot=None):
    pts_c, desc_c, valid_c = feats
    m_bc = match_features(state.desc_b, desc_c, state.valid_b, valid_c, cfg)

    # triplets over a-slots: a -> b (carried) -> c (fresh)
    j = state.m_ab_idx
    k = m_bc.idx[j]
    trip_valid = state.m_ab_valid & m_bc.valid[j]
    p1n = normalize_pixels(state.pts_a, K)
    p2n = normalize_pixels(state.pts_b[j], K)
    p3n = normalize_pixels(pts_c[k], K)

    res = ransac_essential(
        p2n, p3n, trip_valid, threshold=cfg.ransac_px_threshold / K[0, 0],
        n_iters=cfg.ransac_iters, generator=state.gen, slot=slot,
    )
    # the RANSAC inlier mask applies to the pose (reference :113-115)
    pr = recover_pose(res.E, p2n, p3n, res.inliers)
    R23, t23 = pr.R, pr.t

    # cloud (1, 2) triangulated in frame 1 and moved into frame 2; cloud
    # (2, 3) in frame 2; matched median ratio
    X12_b = triangulate_fast(state.R_ab, state.t_ab, p1n, p2n) \
        @ state.R_ab.T + state.t_ab
    X23 = triangulate_fast(R23, t23, p2n, p3n)
    cloud_valid = (trip_valid & torch.isfinite(X12_b).all(1)
                   & torch.isfinite(X23).all(1))
    s = relative_scale_matched(X12_b, X23, cloud_valid)

    # below three frames there is no earlier cloud: unit scale
    have3 = state.n_frames >= 2
    enough = trip_valid.sum() >= cfg.min_pose_points
    s = torch.where(have3 & enough, s, torch.ones_like(s))
    new_pose = torch.where(enough, state.pose @ inv_se3(make_se3(R23, s * t23)),
                           state.pose)

    new_state = ThreeFrameState(
        pts_a=state.pts_b, pts_b=pts_c, desc_b=desc_c, valid_b=valid_c,
        m_ab_idx=m_bc.idx, m_ab_valid=m_bc.valid, R_ab=R23, t_ab=t23,
        pose=new_pose, gen=state.gen, n_frames=state.n_frames + 1,
    )
    return new_state, _untracked_output(new_pose, s, trip_valid.sum(),
                                        res.inliers.sum(), enough, cfg)


class ThreeFrameVO(_Pipeline):
    """feature_tracking_scale.py-equivalent pipeline. The scale is always
    the matched-pair one."""

    def __init__(self, K, config: VOConfig = VOConfig(), device=None):
        super().__init__(K, config._replace(scale_mode="matched"), device)

    def init(self, img0, seed: int = 0) -> ThreeFrameState:
        return _tf_init(self.detect(self._image(img0)), self._generator(seed),
                        self.cfg)

    def step(self, state: ThreeFrameState, img, slot=None):
        """One frame. `slot` (ransac_iters, 5) replaces this step's RANSAC
        draws (tests feed the reference's)."""
        return _tf_core(state, self.detect(self._image(img)), self.K,
                        self.cfg, slot)
