#!/usr/bin/env python3
"""The feature probe (P7), for the PyTorch port of any checkout: two trees
timed by one code on one card.

Runs the tree's ops/cuda/feature_probe.py `run` on the card (it raises
unless every check passes), then times what `timed_pair` returns: the
probe's kernels (a trace, median of 10, chip_smoke.kernel_ms, summed over
the kernels a call launches) beside the bound of the bytes and float32
operations the tree counts, the plain torch version (CUDA events), and
a one-element fill (a launch that does no work, read by the same trace).
Where the tree's launch records each CTA's start and end on the device's
clock (`launch(..., clocks=)`), it also gives each role's first start,
last end and median CTA span over --launches launches, from the launch's
first CTA start (medians over the launches), and the launch's span.  It
runs against the disinfect_slam_tpu_torch package under --root (default:
this checkout); the timing code is always this checkout's.  Needs a CUDA device; prints
the result as one JSON line.

  python3 scripts/port_feature_probe_stage.py [--root DIR] [--launches N] [--out FILE.json]

To compare a commit with its parent, unpack the parent's package into a
git-ignored directory and run parent, change, change, parent on one card:

  mkdir -p .verify_tmp/parent
  git archive PARENT disinfect_slam_tpu_torch | tar -x -C .verify_tmp/parent
  python3 scripts/port_feature_probe_stage.py --root .verify_tmp/parent --out parent1.json
"""

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def role_spans(fp, dev, launches: int) -> dict:
    """{role: {"start", "end", "cta"}} in ms over `launches` launches with
    clocks, each the median over launches: the role's first CTA start and
    last CTA end from the launch's first CTA start, and the median of its
    CTAs' own spans; "launch": the last end from the first start."""
    import numpy as np
    import torch

    inp = torch.from_numpy(fp.pack(fp.pallas_inputs(), fp.own_inputs())).to(dev)
    clocks = torch.zeros(2, fp.GRID, dtype=torch.int64, device=dev)
    fp.launch(inp, clocks=clocks)  # warm-up
    spans = {name: [] for name, _ in fp.ROLES}
    spans["launch"] = []
    for _ in range(launches):
        fp.launch(inp, clocks=clocks)
        start, end = clocks.cpu().numpy() - clocks.min().item()
        first = 0
        for name, ctas in fp.ROLES:
            s, e = start[first:first + ctas], end[first:first + ctas]
            spans[name].append((s.min(), e.max(), np.median(e - s)))
            first += ctas
        spans["launch"].append((0, end.max(), end.max()))
    return {k: dict(zip(("start", "end", "cta"),
                        (float(x) / 1e6 for x in np.median(np.array(v), axis=0))))
            for k, v in spans.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose disinfect_slam_tpu_torch is timed")
    ap.add_argument("--launches", type=int, default=50,
                    help="launches whose CTA clocks give the role spans")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, REPO]

    import torch

    if not torch.cuda.is_available():
        print("port_feature_probe_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    import disinfect_slam_tpu_torch
    from disinfect_slam_tpu_torch.ops.cuda import feature_probe as fp
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power, cuda_time_ms

    pkg = os.path.dirname(os.path.abspath(disinfect_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"disinfect_slam_tpu_torch came from {pkg}, not from {root}")
    dev = torch.device("cuda", 0)
    checks = fp.run(dev)
    # (kernel, plain, nbytes, ops); a tree before the one-launch design
    # returns no ops (its bound counted bytes only)
    kernel_fn, plain_fn, nbytes, *ops = fp.timed_pair(dev)
    yard = chip_smoke.bound(nbytes, ops[0] if ops else 0)
    before = fp.launch.launches
    kernel_fn()
    res = {"root": root, "card": card_name_and_power(),
           "launches_a_call": fp.launch.launches - before, **yard,
           "ms": chip_smoke.kernel_ms(kernel_fn, "feature_", floor_ms=yard["bound_ms"]),
           "plain_ms": cuda_time_ms(plain_fn),
           # a launch that does no work, as the same trace reads it
           "fill_ms": chip_smoke.kernel_ms(torch.zeros(1, device=dev).zero_, "elementwise"),
           "max_abs_err": max(r["max_abs_err"] for r in checks.values())}
    if hasattr(fp, "GRID"):
        res["role_ms"] = role_spans(fp, dev, args.launches)
    chip_smoke.log(f"[port_feature_probe_stage] {res}")
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
