"""The check of a run: the start and chains of the window's steps redone by
the plain reference (`vobench/reference/`), and the control in lower
precision put in the program's place.

A side's chain is a list of step dicts, one per consecutive step:
`kind` ("track", "refresh" or "match"), `k` (the step's frame), `pre` (the
state the step started from: pts, valid, origins, prev3d, prev3d_valid,
pose, gen), `pts`, `valid` and `desc` (the points the step left in its
state; `desc` a matching pipeline's descriptors, else None), `before` and
`pose` (the pose before and after the step), `cloud_before` and `cloud`
(the side's (prev3d, prev3d_valid) before and after the step) and `assoc`
(the associations the pose chain was given). A matching chain's first step
also has `prev_feats`, the side's features of the frame before it.

The reference starts a chain from the first step's `pre` and carries its
own state from there. It takes each step's kind from the side it checks
(the re-detect gate answers a step or more late, whenever the device's
count arrives); a re-detect ends a chain, since after it the two sides'
slots hold their own orders of their own detections.
"""

from __future__ import annotations

from vobench import compare
from vobench.reference.step import Reference


def _start(ref, frame, step):
    if step["kind"] != "match":
        return ref.tracking_state(frame(step["k"] - 1), step["pre"])
    feats, _ = compare.align(ref.detect(frame(step["k"] - 1)),
                             step["prev_feats"])
    return ref.matching_state(feats, step["pre"])


def reference_items(ref: Reference, frame, steps: list) -> list[dict]:
    """The compared items of one chain: each step of `steps` against the
    reference's step from the same frames, the reference's detections put
    in the side's slot order (`compare.align`)."""
    state = _start(ref, frame, steps[0])
    items = []
    for step in steps:
        img, before = frame(step["k"]), state.pose
        if step["kind"] == "track":
            state, out, corr = ref.track(state, img)
            item = compare.slot_off(step["pts"], step["valid"], state.pts,
                                    state.pts_valid)
        elif step["kind"] == "refresh":
            state, out, corr = ref.refresh(state, img)
            item = compare.set_off(step["pts"][step["valid"]],
                                   state.pts[state.pts_valid])
        else:
            feats, item = compare.align(
                ref.detect(img), (step["pts"], step["desc"], step["valid"]))
            state, out, corr = ref.match(state, feats)
        item.update(kind=step["kind"], k=step["k"])
        item.update(ref.judge_pose(corr, step["cloud_before"], step["cloud"],
                                   (step["before"], step["pose"]),
                                   (before, out.pose)))
        item["rot"], item["trans"] = compare.pose_off(
            step["before"].cpu(), step["pose"].cpu(), before.cpu(),
            out.pose.cpu())
        item["assoc"], item["ref_assoc"] = int(step["assoc"]), int(out.n_assoc)
        items.append(item)
        if step["kind"] == "refresh":
            break
    return items


def control_steps(ref: Reference, frame, steps: list) -> list[dict]:
    """The control's chain in the program's place: the lowered reference's
    own steps from the same start and frames, in its own slot orders."""
    first = dict(steps[0])
    out_steps = []
    with ref.lowered():
        if first["kind"] == "match":
            first["prev_feats"] = ref.detect(frame(first["k"] - 1))
            state = ref.matching_state(first["prev_feats"], first["pre"])
        else:
            state = ref.tracking_state(frame(first["k"] - 1), first["pre"])
        for i, step in enumerate(steps):
            img, before, desc = frame(step["k"]), state.pose, None
            cloud_before = (state.prev3d, state.prev3d_valid)
            if step["kind"] == "track":
                state, out, _ = ref.track(state, img)
            elif step["kind"] == "refresh":
                state, out, _ = ref.refresh(state, img)
            else:
                pts, desc, valid = ref.detect(img)
                state, out, _ = ref.match(state, (pts, desc, valid))
            pts, valid = ((pts, valid) if step["kind"] == "match"
                          else (state.pts, state.pts_valid))
            out_steps.append({**(first if i == 0 else {}),
                              "kind": step["kind"], "k": step["k"],
                              "pts": pts, "valid": valid, "desc": desc,
                              "before": before, "pose": out.pose,
                              "cloud_before": cloud_before,
                              "cloud": (state.prev3d, state.prev3d_valid),
                              "assoc": out.n_assoc})
            if step["kind"] == "refresh":
                break
    return out_steps


def run_check(config: dict, device, frame, start: dict, chains: list,
              control: bool = False) -> dict:
    """{"program": items[, "control": items]}: init's detect of frame 0
    (`start`: the program's pts, valid and desc) and every chain, against
    the reference."""
    ref = Reference(config, device)
    want0 = ref.detect(frame(0))
    got0 = (start["pts"], start.get("desc"), start["valid"])
    out = {"program": [_start_item(want0, got0)]
           + [i for ch in chains for i in reference_items(ref, frame, ch)]}
    if control:
        with ref.lowered():
            low0 = ref.detect(frame(0))
        out["control"] = [_start_item(want0, low0)] + [
            i for ch in chains
            for i in reference_items(ref, frame, control_steps(ref, frame, ch))]
    return out


def _start_item(want, got) -> dict:
    _, item = compare.align(want, got)
    item.update(kind="start", k=0)
    return item
