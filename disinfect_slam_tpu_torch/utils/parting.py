"""Where two devices' arithmetic parts: DenseSLAM run in lockstep on two
devices over the same frames, every stage of every frame compared bit for
bit, and the first stage whose bits differ reported.

Each DenseSLAM runs eagerly (capture=False) with its tracked step's
`probe` set, so each frame yields, in order: the previous pose's inverse
and the ICP seed, the model depth, both pyramids (per level: vertices,
normals, valid), every ICP iteration's pose, rmse and inliers (coarse
level first), the gate (ok, the kept pose, its inverse), the volume after
fusion, and at a keyframe the loop closure's descriptors, the query's
match scores and the keyframe poses the pose graph leaves.  Up to the
first parting both runs see the same inputs, so that stage is where the
devices' arithmetic differs; after it the runs are no longer comparable
and the walk stops.  Used by chip_smoke.py (phase 8), a `gpu` test and
scripts/port_slam_parting.py.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

# the stages of one frame, in the order the step computes them
STAGES = ("inputs", "seed", "model_depth", "pyramid_ref", "pyramid_cur", "icp", "gate", "volume",
          "descriptor", "match", "pose_graph")
_VOLUME = ("entry_key", "entry_block", "block_table", "heap", "num_free", "oob_count", "tsdf",
           "rgbw", "prob")


def _leaves(label: str, value) -> list:
    """(label, host array) for every tensor or array in a nested value."""
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        out = []
        for i, v in enumerate(value):
            out += _leaves(f"{label}[{i}]", v)
        return out
    if isinstance(value, torch.Tensor):
        return [(label, value.detach().cpu().numpy())]
    return [(label, np.asarray(value))]


def _bits(a: np.ndarray) -> np.ndarray:
    """The array's bytes as unsigned integers of its width (NaNs and signed
    zeros compare by their bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        return a.view(np.uint8)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def compare(a: dict, b: dict) -> Optional[dict]:
    """The first leaf of the first stage (STAGES order) whose bits differ
    between two frames' records, or None: {stage, leaf, differing, of,
    max_abs}."""
    for stage in STAGES:
        if stage not in a and stage not in b:
            continue
        la, lb = _leaves(stage, a.get(stage)), _leaves(stage, b.get(stage))
        if [n for n, _ in la] != [n for n, _ in lb]:
            return {"stage": stage, "leaf": "structure", "differing": None, "of": None,
                    "max_abs": None}
        for (name, x), (_, y) in zip(la, lb):
            if x.shape != y.shape or x.dtype != y.dtype:
                return {"stage": stage, "leaf": name, "differing": None, "of": int(x.size),
                        "max_abs": None}
            diff = _bits(x) != _bits(y)
            if diff.any():
                d = (np.abs(x.astype(np.float64) - y.astype(np.float64))
                     if x.dtype.kind in "fiu" else diff.astype(np.float64))
                return {"stage": stage, "leaf": name, "differing": int(diff.sum()),
                        "of": int(x.size), "max_abs": float(np.nanmax(d))}
    return None


def _record(slam, feed: Callable, i: int) -> dict:
    """Run frame i through `feed(i, slam)` with the step's probe and the
    loop closure's query watched -> the frame's stages."""
    rec = {}
    slam._step.probe = rec.__setitem__
    lc = slam.lc
    if lc is not None:
        query = type(lc).query

        def watched(depth, intensity=None):
            q = query(lc, depth, intensity)
            rec["match"] = q.scores
            return q

        lc.query = watched
    try:
        feed(i, slam)
    finally:
        slam._step.probe = None
        if lc is not None:
            del lc.query
    vol = slam.volume
    rec["volume"] = [getattr(vol, f) for f in _VOLUME]
    if lc is not None:
        rec["descriptor"] = lc.db_desc[:lc.count]
        rec["pose_graph"] = (np.stack(lc.kf_pose_opt) if lc.kf_pose_opt
                             else np.zeros((0, 4, 4), np.float32))
    return rec


def isolated(slam, rec: dict) -> dict:
    """The tracker's stages recomputed by `slam` on its device from another
    device's recorded inputs (`rec`, one tracked frame's record): the
    previous pose's inverse, both pyramids and the multi-level ICP, each
    compared bit for bit with what the other device computed from them
    -> {stage: None or the first differing leaf}."""
    from ..core.geometry import inverse4

    if "icp" not in rec:
        return {}
    dev = slam.device

    def to(x):
        if isinstance(x, (list, tuple)):
            return type(x)(to(v) for v in x)
        return x.to(dev)

    tracker = slam.tracker
    prev, prev_inv, seed, _ = to(rec["seed"])
    trace = []
    tracker._track(seed, to(rec["pyramid_cur"]), to(rec["pyramid_ref"]), prev_inv, trace)
    mine = {"seed": (prev, inverse4(prev), seed, rec["seed"][3]),
            "pyramid_ref": tracker._prep(to(rec["model_depth"])),
            "pyramid_cur": tracker._prep(to(rec["inputs"])), "icp": trace}
    out = {}
    for stage, value in mine.items():
        out[stage] = compare({stage: value}, {stage: rec[stage]})
    return out


# the stages whose parting changes what the next frame sees: the walk
# stops after one of them parts
_STATE = ("gate", "volume", "pose_graph")


def lockstep(slams: Sequence, feed: Callable, frames: int,
             until: Optional[Callable] = None) -> dict:
    """Feed frames 0..frames-1 to each DenseSLAM in `slams` (two, each
    made with capture=False, on the devices to compare) through
    feed(i, slam), comparing every stage after each frame.  A stage that
    parts without changing the state the next frame sees (a descriptor,
    the match scores, an ICP iteration the gate then rejects) is noted
    and the walk goes on; it stops when the gate's pose, the volume or
    the pose graph's keyframe poses part, or after the frame for which
    until(slam) (of the first SLAM) holds.  Each tracked frame up to there
    also runs `isolated` on the first SLAM with the second's inputs.
    Returns {frames_run, parted: None or the first {frame, stage, leaf,
    differing, of, max_abs}, stages: {stage: its first parting},
    isolated: {stage: the first frame whose isolated stage differed and
    how}, closures, keyframes}."""
    a, b = slams
    first, iso = {}, {}
    n = 0
    for i in range(frames):
        ra, rb = _record(a, feed, i), _record(b, feed, i)
        n = i + 1
        for stage, diff in isolated(a, rb).items():
            if diff is not None and stage not in iso:
                iso[stage] = {"frame": i, **diff}
        for stage in STAGES:
            if stage in first:
                continue
            diff = compare({stage: ra.get(stage)}, {stage: rb.get(stage)})
            if diff is not None:
                first[stage] = {"frame": i, **diff}
        if any(s in first for s in _STATE) or (until is not None and until(a)):
            break
    parted = min(first.values(), key=lambda d: (d["frame"], STAGES.index(d["stage"])),
                 default=None)
    lc = a.lc
    return {"frames_run": n, "parted": parted, "stages": first, "isolated": iso,
            "closures": lc.closures if lc is not None else None,
            "keyframes": lc.count if lc is not None else None}


def describe(res: dict) -> str:
    """One line for a lockstep result."""
    p = res["parted"]
    each = lambda d: ", ".join(f"{k} (frame {v['frame']}, {v['leaf']}, max |d| "  # noqa: E731
                               f"{v['max_abs']})" for k, v in d.items()) or "none"
    tail = (f"; each stage's first parting: {each(res['stages'])}; isolated stages that "
            f"differ: {each(res['isolated'])}")
    if p is None:
        return (f"no parting over {res['frames_run']} frames (closures {res['closures']})"
                + tail)
    return (f"first parting at frame {p['frame']}, stage {p['stage']} ({p['leaf']}: "
            f"{p['differing']} of {p['of']} values, max |d| {p['max_abs']}) of "
            f"{res['frames_run']} frames" + tail)
