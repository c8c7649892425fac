"""The comparison that decides `correct`: what a step produced against what
the plain reference produces from the same frames and the same start.

Five numbers, each over all checked steps of all streams of a run:

- `points_off_pct`: the points a checked stage produced that the reference
  does not, as a share of all it compared. LK's tracked points are compared
  slot by slot (a slot is off when its status differs, or both track it and
  the positions differ by more than `POINT_TOL_PX` in x or y). Detected
  points are paired one to one with the reference's (`align`): a point is
  off when the other side has none within `POINT_TOL_PX`, and a pair is off
  when it breaks the reference's order of the points (the pipelines draw
  RANSAC samples and pair clouds by that order). A re-detect's matched
  points compare as sets.
- `points_err_px`: the mean distance (the larger of |dx| and |dy|) between
  the points that both sides have: a slot both track, or a paired point.
- `assoc_off_pct`: the associations the pose chain was given (tracked
  points, or knn matches that pass the ratio test), |n - n_ref| summed over
  the checked steps, as a share of the reference's sum.
- `pose_gap_pct`, `scale_off_pct`, `cloud_off_pct`: the medians over
  checked steps of what the reference's geometry says of the step's pose
  and cloud, on the reference's own correspondences
  (`Reference.judge_pose`): the MSAC cost of the step's epipolar geometry
  above that of the reference's own, the step's scale against the one its
  previous cloud gives with the reference's triangulation under the step's
  rotation and direction, and its new cloud against that triangulation.

The pose is judged by what it says and not compared with the reference's
pose: with hundreds to thousands of correspondences, several RANSAC
hypotheses cost nearly alike, and a rounding picks another of them on
either side, which moves the pose (`rot_off_deg`, `trans_off_pct`, kept as
readings) by far more than the rounding but its cost by almost nothing.
The medians, because a step that picks a hypothesis on a nearly
degenerate set of correspondences reads far off on either side. The limits
are set from readings of sound runs and of a control in lower precision
(PERF.md).
"""

from __future__ import annotations

import bisect
import math

import numpy as np
import torch

POINT_TOL_PX = 0.05


def slot_off(pts, valid, ref_pts, ref_valid, tol=POINT_TOL_PX) -> dict:
    """The comparison of two slot-aligned point sets: `off` of `compared`
    slots, and the summed distance `err` over the `both` slots both track."""
    both = valid & ref_valid
    dist = (pts.double() - ref_pts.double()).abs().amax(dim=1)
    off = (valid != ref_valid) | ((dist > tol) & both)
    return {"off": int(off.sum()), "compared": int((valid | ref_valid).sum()),
            "err": float(dist[both].sum()), "both": int(both.sum())}


def _nearest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """For each row of a, the distance (max norm) to the nearest row of b."""
    best = torch.full((a.shape[0],), float("inf"), dtype=a.dtype,
                      device=a.device)
    for i in range(0, b.shape[0], 1024):
        d = (a[:, None, :] - b[None, i:i + 1024, :]).abs().amax(dim=2)
        best = torch.minimum(best, d.amin(dim=1))
    return best


def set_off(pts, ref_pts, tol=POINT_TOL_PX) -> dict:
    """The comparison of two unordered point sets (n, 2) and (m, 2): a
    point is off when the other side has none within `tol`; `err` sums the
    nearest distances of the program's points that are not off."""
    pts, ref_pts = pts.double(), ref_pts.double()
    d_got = _nearest(pts, ref_pts)
    d_ref = _nearest(ref_pts, pts)
    hit = d_got <= tol
    off = int((~hit).sum()) + int((d_ref > tol).sum())
    return {"off": off, "compared": int(pts.shape[0] + ref_pts.shape[0]),
            "err": float(d_got[hit].sum()), "both": int(hit.sum())}


def pose_off(start, pose, ref_start, ref_pose):
    """(rotation angle in degrees, relative translation error in %) of the
    step start -> pose against ref_start -> ref_pose (4x4 cam->world)."""
    rel, ref = (np.linalg.inv(np.asarray(a, np.float64))
                @ np.asarray(b, np.float64)
                for a, b in ((start, pose), (ref_start, ref_pose)))
    # the angle from the chord |R - R_ref|_F = 2 sqrt(2) sin(angle / 2):
    # exact 0 for equal float32 matrices, which are not quite orthonormal
    chord = np.linalg.norm(rel[:3, :3] - ref[:3, :3]) / (2.0 * math.sqrt(2.0))
    rot = math.degrees(2.0 * math.asin(min(1.0, chord)))
    t, t_ref = rel[:3, 3], ref[:3, 3]
    gap, norm = np.linalg.norm(t - t_ref), np.linalg.norm(t_ref)
    if norm < 1e-9:
        trans = 0.0 if gap < 1e-9 else 100.0
    else:
        trans = 100.0 * gap / norm
    return rot, float(trans)


def _longest_increasing(seq) -> int:
    """The length of the longest strictly increasing subsequence."""
    tails: list = []
    for x in seq:
        i = bisect.bisect_left(tails, x)
        if i == len(tails):
            tails.append(x)
        else:
            tails[i] = x
    return len(tails)


def align(ref_feats, feats, tol=POINT_TOL_PX):
    """(the reference's features in the program's slot order, the item of
    their comparison). `feats` and `ref_feats` are (pts (K, 2), desc or
    None, valid (K,)).

    Each valid point of the program is paired with one valid point of the
    reference within `tol`; where several are (a keypoint emitted twice,
    with two orientations), the pairs with the nearest descriptors come
    first. A paired reference point goes to its partner's slot; the
    reference's unpaired points go, in their order, to the slots that the
    program leaves invalid. Off: the unpaired points of both sides, and the
    pairs outside the longest run in which both sides' orders agree."""
    r_pts, r_desc, r_valid = ref_feats
    pts, desc, valid = feats
    ip = valid.nonzero().flatten()
    iq = r_valid.nonzero().flatten()
    P, Q = pts[ip].double(), r_pts[iq].double()
    a_l, b_l, d_l = [], [], []
    for i in range(0, P.shape[0], 1024):
        d = (P[i:i + 1024, None, :] - Q[None, :, :]).abs().amax(dim=2)
        a, b = (d <= tol).nonzero(as_tuple=True)
        a_l.append(a + i)
        b_l.append(b)
        d_l.append(d[a, b])
    a = torch.cat(a_l) if a_l else ip.new_zeros(0)
    b = torch.cat(b_l) if b_l else ip.new_zeros(0)
    dist = torch.cat(d_l) if d_l else P.new_zeros(0)
    if desc is not None and r_desc is not None and a.numel():
        cost = ((desc[ip[a]].double() - r_desc[iq[b]].double()) ** 2).sum(1)
    else:
        cost = dist
    a, b, dist, cost = (x.cpu().numpy() for x in (a, b, dist, cost))
    partner = np.full(P.shape[0], -1)
    taken = np.zeros(Q.shape[0], bool)
    err = 0.0
    for o in np.lexsort((dist, cost)):
        if partner[a[o]] < 0 and not taken[b[o]]:
            partner[a[o]], taken[b[o]] = b[o], True
            err += float(dist[o])
    paired = partner >= 0
    n_pair = int(paired.sum())
    order_off = n_pair - _longest_increasing(partner[paired])
    off = (P.shape[0] - n_pair) + (Q.shape[0] - n_pair) + order_off
    item = {"off": int(off), "compared": int(P.shape[0] + Q.shape[0]),
            "err": err, "both": n_pair}
    # the reference's slots in the program's order
    src = np.full(pts.shape[0], -1)
    ipn, iqn = ip.cpu().numpy(), iq.cpu().numpy()
    src[ipn[paired]] = iqn[partner[paired]]
    free = np.flatnonzero(~valid.cpu().numpy())
    rest = iqn[~taken][:free.size]
    src[free[:rest.size]] = rest
    has = torch.as_tensor(src >= 0, device=r_valid.device)
    idx = torch.as_tensor(np.maximum(src, 0), device=r_valid.device)

    def put(x):
        return torch.where(has.reshape(-1, *[1] * (x.dim() - 1)), x[idx],
                           torch.zeros_like(x[idx]))

    out = (put(r_pts), None if r_desc is None else put(r_desc), has.clone())
    return out, item


NUMBERS = ("points_off_pct", "points_err_px", "assoc_off_pct", "pose_gap_pct",
           "scale_off_pct", "cloud_off_pct", "rot_off_deg", "trans_off_pct")


def _median(steps: list, key: str, missing: float) -> float:
    vals = [s[key] for s in steps if key in s]
    return float(np.median(vals)) if vals else missing


def summarize(steps: list[dict]) -> dict:
    """The run's numbers from its checked items: each item has the fields
    of `slot_off`/`set_off`/`align`, and a step's those of
    `Reference.judge_pose` and `rot`, `trans`, `assoc` and `ref_assoc`."""
    off = sum(s["off"] for s in steps)
    compared = sum(s["compared"] for s in steps)
    both = sum(s["both"] for s in steps)
    assoc = [s for s in steps if "assoc" in s]
    return {
        "points_off_pct": 100.0 * off / compared if compared else 100.0,
        "points_err_px": sum(s["err"] for s in steps) / both if both
        else float("inf"),
        "assoc_off_pct": 100.0 * sum(abs(s["assoc"] - s["ref_assoc"])
                                     for s in assoc)
        / max(1, sum(s["ref_assoc"] for s in assoc)),
        "pose_gap_pct": _median(steps, "gap", 100.0),
        "scale_off_pct": _median(steps, "scale", 100.0),
        "cloud_off_pct": _median(steps, "cloud", 100.0),
        "rot_off_deg": _median(steps, "rot", 180.0),
        "trans_off_pct": _median(steps, "trans", 100.0),
        "checked_steps": len(assoc),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, list[tuple]]:
    """(correct, [(name, value, limit)]): each number that the
    configuration gives a limit at or under it. A configuration compares
    at least one number, and a limit without a number fails."""
    rows = [(k, numbers.get(k, float("nan")), limits[k]) for k in sorted(limits)]
    if not rows:
        return False, [("limits", float("nan"), float("nan"))]
    ok = all(v <= lim for _, v, lim in rows)  # NaN compares false
    return ok, rows
