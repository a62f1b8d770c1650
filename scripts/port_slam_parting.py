#!/usr/bin/env python
"""Where the port's DenseSLAM on one device parts from the same on another
(utils/parting.py): both run in lockstep over the same frames, every
stage of every frame compared bit for bit, and the first stage and frame
whose bits differ are printed.

  orbit   datasets/orbit_vga's first --frames frames at each --scale, as
          chip_smoke.py phase 8 runs them (loop closure every 10 frames);
  soak    with --soak, tests/test_torch_soak.py's corridor (1000 frames)
          up to its first loop closure.

Needs a CUDA device for the default pair (cuda, cpu); --devices cpu cpu
runs it on the CPU alone.  ~2 s a frame on the CPU at 640x480:

  python scripts/port_slam_parting.py [--frames 11] [--scale 1 2] [--soak]
      [--devices cuda cpu] [--out parting.json]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import new_slam, slam_frames  # noqa: E402
from disinfect_slam_tpu_torch.utils import parting  # noqa: E402


def orbit(devices, scale: int, n: int) -> dict:
    """The orbit's first n frames at track_res_scale `scale` on both devices."""
    frames = slam_frames()[:n]
    slams = [new_slam(d, scale, capture=False) for d in devices]
    t0 = time.perf_counter()
    res = parting.lockstep(slams, lambda i, slam: slam.process_frame(*frames[i]), n)
    res["seconds"] = time.perf_counter() - t0
    return res


def soak(devices, n_frames: int = 1000) -> dict:
    """The soak's corridor on both devices, up to its first loop closure."""
    from tests.torch_cases import make_soak_slam, soak_feed

    slams = [make_soak_slam(d, capture=False) for d in devices]
    t0 = time.perf_counter()
    res = parting.lockstep(slams, soak_feed(n_frames), n_frames,
                           until=lambda slam: slam.lc.closures >= 1)
    res["seconds"] = time.perf_counter() - t0
    return res


def soak_pose_graph(devices, n_frames: int = 1000) -> dict:
    """The soak's first pose-graph solve and its keyframe match, isolated:
    the second device runs the corridor alone up to its first loop closure,
    and the inputs of that closure's optimize_pose_graph and of the
    keyframe's _match_scores go through both devices' functions, compared
    bit for bit."""
    from disinfect_slam_tpu_torch.systems import loop_closure
    from tests.torch_cases import make_soak_slam, soak_feed

    seen = {}
    graph, match = loop_closure.optimize_pose_graph, loop_closure._match_scores

    def graph_watch(*args, **kw):
        seen.setdefault("graph", (args, kw))
        return graph(*args, **kw)

    def match_watch(*args):
        seen["match"] = args
        return match(*args)

    loop_closure.optimize_pose_graph, loop_closure._match_scores = graph_watch, match_watch
    try:
        slam = make_soak_slam(devices[1], capture=False)
        feed = soak_feed(n_frames)
        for i in range(n_frames):
            feed(i, slam)
            if slam.lc.closures:
                break
    finally:
        loop_closure.optimize_pose_graph, loop_closure._match_scores = graph, match
    out = {"frame": i}
    if "graph" in seen:
        args, kw = seen["graph"]
        res = [graph(*[a.to(d) for a in args], **kw) for d in devices]
        out["pose_graph"] = parting.compare({"pose_graph": res[0]}, {"pose_graph": res[1]})
    desc = loop_closure.depth_descriptor
    d_half = slam.lc.kf_depth_half[-1].astype("float32")
    res = [desc(torch.from_numpy(d_half).to(d)) for d in devices]
    out["descriptor"] = parting.compare({"descriptor": res[0]}, {"descriptor": res[1]})
    if "match" in seen:
        args = seen["match"]
        res = [match(*[a.to(d) if hasattr(a, "to") else a for a in args]) for d in devices]
        out["match"] = parting.compare({"match": res[0]}, {"match": res[1]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", nargs=2, default=["cuda", "cpu"])
    ap.add_argument("--frames", type=int, default=11)
    ap.add_argument("--scale", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--soak", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    out = {}
    for scale in args.scale:
        out[f"orbit_scale{scale}"] = r = orbit(args.devices, scale, args.frames)
        print(f"[parting] orbit track_res_scale={scale}: {parting.describe(r)} "
              f"({r['seconds']:.1f} s)", flush=True)
    if args.soak:
        out["soak"] = r = soak(args.devices)
        print(f"[parting] soak corridor to its first closure: {parting.describe(r)} "
              f"({r['seconds']:.1f} s)", flush=True)
        out["soak_isolated"] = r = soak_pose_graph(args.devices)
        print(f"[parting] soak's first closure (frame {r['frame']}) isolated, first "
              f"differing leaf: {r}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
