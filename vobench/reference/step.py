"""The plain reference's steps, from the raw frames and a start state, and
the control in lower precision.

The reference works out every input of a step again from the frames that
both sides were handed: both frames' pyramids (a tracking step), the
frames' keypoints and descriptors and their knn matches (a re-detect or a
matching step), then the pose chain. A checked chain of steps starts from
the state that the program's first step started from, which the
reference cannot work out without following the program over the whole
window: the tracked points and their slots, the previous step's
search-window origins, the previous cloud, the pose and the RANSAC
generator's state, so that both draw the same hypotheses. A matching
pipeline's previous keypoints and descriptors are not taken: the
reference detects the previous frame itself. From there the reference
carries its own state from step to step, so a fault that the program
carries in its state shows in the chain's later steps.

The control is this reference with what it stores one precision below the
configuration's: the frames and every filtered or resampled map in
bfloat16 (the configuration states float32), LK's windows in float8 e4m3
(it states bfloat16), and the normalized coordinates of the pose chain in
bfloat16.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .geometry.epipolar import sampson_sq
from .geometry.scale import relative_scale_matched, relative_scale_unmatched
from .geometry.triangulate import triangulate_depths
from .models import vo
from .ops import conv, integral, orientation, pyramid, scalespace


def override(nt, values: dict):
    """A copy of the NamedTuple `nt` (nested ones too) with `values` set;
    a key that `nt` lacks raises KeyError."""
    for k, v in values.items():
        if k not in nt._fields:
            raise KeyError(f"{type(nt).__name__} has no field {k!r}")
        cur = getattr(nt, k)
        if hasattr(cur, "_fields"):
            v = override(cur, v)
        nt = nt._replace(**{k: v})
    return nt


def _bf16(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _rounded(fn):
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, (tuple, list)):
            return type(out)(_bf16(o) for o in out)
        return _bf16(out)

    return wrapper


def _increment(before, after):
    """(R, s t) of the step that took the pose `before` to `after` (4x4
    cam->world; the pipelines chain after = before @ inv([R | s t]))."""
    before, after = (np.asarray(torch.as_tensor(p).cpu(), np.float64)
                     for p in (before, after))
    M = np.linalg.inv(np.linalg.inv(before) @ after)
    return M[:3, :3], M[:3, 3]


class Reference:
    """The plain pipeline of one configuration file, on `device`."""

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.cfg = override(vo.VOConfig(), config["vo"])
        cam = config["camera"]
        K = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                      [0.0, 0.0, 1.0]])
        self.K = torch.as_tensor(K, dtype=torch.float32, device=self.device)
        self._low = False

    def _frame(self, img: torch.Tensor) -> torch.Tensor:
        img = img.to(self.device, torch.float32)
        return _bf16(img) if self._low else img

    def _config(self):
        if self._low:
            return self.cfg._replace(lk=self.cfg.lk._replace(precision="fp8"))
        return self.cfg

    def detect(self, img):
        """(pts, descriptors, valid) of one frame."""
        return vo.detect_and_describe(self._frame(img), self._config())

    def _generator(self, gen_state) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.set_state(gen_state)
        return gen

    def tracking_state(self, prev_img, pre: dict) -> vo.TrackingState:
        """A tracking pipeline's state after frame `prev_img`: its pyramid
        worked out again, the rest taken from the dict `pre`."""
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return vo.TrackingState(
            pyramid=vo.lk_build_pyramid(self._frame(prev_img),
                                        self._config().lk),
            lk_cache=vo.LKCache(origins=tuple(pre["origins"])),
            pts=pre["pts"], pts_valid=pre["valid"], prev3d=pre["prev3d"],
            prev3d_valid=pre["prev3d_valid"], pose=pre["pose"],
            gen=self._generator(pre["gen"]), health=zero, dipped=zero)

    def matching_state(self, feats, pre: dict) -> vo.MatchingState:
        """A matching pipeline's state with the previous frame's features
        `feats` (pts, desc, valid) and the rest taken from the dict `pre`."""
        pts, desc, valid = feats
        return vo.MatchingState(
            pts=pts, desc=desc, valid=valid, prev3d=pre["prev3d"],
            prev3d_valid=pre["prev3d_valid"], pose=pre["pose"],
            gen=self._generator(pre["gen"]))

    def track(self, state: vo.TrackingState, img):
        """(state, output, correspondences) of an LK step; the
        correspondences (pts1, pts2, valid) are what its pose chain was
        given."""
        new, out = vo._track_step(state, self._frame(img), self.K,
                                  self._config())
        return new, out, (state.pts, new.pts, new.pts_valid)

    def refresh(self, state: vo.TrackingState, img):
        """(state, output, correspondences) of a re-detect step: both
        frames detected and matched."""
        cfg = self._config()
        img = self._frame(img)
        f1 = vo.detect_and_describe(state.pyramid[0], cfg)
        f2 = vo.detect_and_describe(img, cfg)
        new, out = vo._refresh_core(state, img, f1, f2, self.K, cfg)
        return new, out, (f1[0], new.pts, new.pts_valid)

    def match(self, state: vo.MatchingState, feats):
        """(state, output, correspondences) of a matching step against
        this frame's features `feats` (pts, desc, valid)."""
        cfg = self._config()
        m = vo.match_features(state.desc, feats[1], state.valid, feats[2], cfg)
        new, out = vo._matching_core(state, feats, self.K, cfg)
        return new, out, (state.pts, feats[0][m.idx], m.valid)

    def judge_pose(self, corr, cloud_before, cloud, motion, ref_motion) -> dict:
        """What this reference's geometry says of a step's pose, on its own
        correspondences `corr` (pts1, pts2, valid). `motion` and
        `ref_motion` are (before, after) poses (4x4 cam->world) of the side
        judged and of this reference; `cloud_before` and `cloud` are the
        side's (prev3d, prev3d_valid) before and after the step.

        - `gap`: the MSAC cost (the pipeline's RANSAC score: Sampson
          errors capped at the threshold, over the valid correspondences)
          of the side's epipolar geometry, above the cost of this
          reference's own, in % of the latter. Two near-tied RANSAC
          hypotheses cost alike, whichever of them either side picks.
        - `scale`: the side's scale against the one that the side's cloud
          before the step and this reference's triangulation under the
          side's rotation and direction give, in %.
        - `cloud`: the median distance of the side's cloud after the step
          from that triangulation, in % of its norm.

        A side that held its pose where this reference did not, or the
        other way round, reads 100 on each."""
        (R, st), (Rr, srt) = (_increment(*motion), _increment(*ref_motion))
        # a held pose leaves its increment the identity, to rounding
        moved, ref_moved = np.linalg.norm(st) > 1e-6, np.linalg.norm(srt) > 1e-6
        if not moved and not ref_moved:
            return {"gap": 0.0, "scale": 0.0, "cloud": 0.0}
        if moved != ref_moved:
            return {"gap": 100.0, "scale": 100.0, "cloud": 100.0}
        cfg = self.cfg
        pts1, pts2, valid = corr
        p1n = vo.normalize_pixels(pts1, self.K)
        p2n = vo.normalize_pixels(pts2, self.K)
        thr2 = (cfg.ransac_px_threshold / float(self.K[0, 0])) ** 2

        def cost(R, t):
            t = t / np.linalg.norm(t)
            E = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                          [-t[1], t[0], 0.0]]) @ R
            e = sampson_sq(torch.as_tensor(E, dtype=torch.float64,
                                           device=self.device),
                           p1n.double(), p2n.double())
            return float(torch.where(valid, e.clamp(max=thr2), 0.0).sum())

        ref_cost = cost(Rr, srt)
        gap = 100.0 * max(0.0, cost(R, st) - ref_cost) / max(ref_cost, 1e-30)
        s = float(np.linalg.norm(st))
        f32 = dict(dtype=torch.float32, device=self.device)
        z1, z2 = triangulate_depths(torch.as_tensor(R, **f32),
                                    torch.as_tensor(st / s, **f32), p1n, p2n)
        X = z1[:, None] * torch.cat([p1n, torch.ones_like(p1n[:, :1])], 1)
        ok = (valid & torch.isfinite(z1) & torch.isfinite(z2) & (z1 > 0)
              & (z2 > 0) & (z1 < 1e4))
        prev3d, prev_valid = cloud_before
        if cfg.scale_mode == "matched":
            s_given = relative_scale_matched(prev3d, X, prev_valid & ok)
        else:
            s_given = relative_scale_unmatched(prev3d, prev_valid, X, ok)
        s_given = float(s_given)
        if cfg.scale_chain == "rescaled":
            X = s * X
        c3d, c_valid = cloud
        both = c_valid & ok
        rel = ((c3d[both].double() - X[both].double()).norm(dim=1)
               / X[both].double().norm(dim=1).clamp(min=1e-12))
        return {"gap": gap, "scale": 100.0 * abs(s - s_given) / s_given,
                "cloud": 100.0 * float(rel.median()) if rel.numel()
                else (0.0 if not (c_valid | ok).any() else 100.0)}

    @contextlib.contextmanager
    def lowered(self):
        """The control: while open, this reference stores its frames and
        maps in bfloat16, its LK windows in float8 e4m3, and its normalized
        coordinates in bfloat16."""
        patches = [(m, "conv2d_valid") for m in (conv, integral, orientation)]
        patches += [(pyramid, "resize_bilinear"), (scalespace, "resize_bilinear"),
                    (pyramid, "_binomial_down2"), (vo, "normalize_pixels")]
        saved = [(m, n, getattr(m, n)) for m, n in patches]
        try:
            for m, n, fn in saved:
                setattr(m, n, _rounded(fn))
            self._low = True
            yield self
        finally:
            self._low = False
            for m, n, fn in saved:
                setattr(m, n, fn)
