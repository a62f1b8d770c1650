"""Score an estimated trajectory against ground truth, ATE + RPE
(counterpart of apps/evaluate.py).

The reference exports matched trajectories (SaveMatchedTrajectory,
slam_module.cc:20-66) and defers scoring to the TUM RGB-D benchmark
scripts; this closes the loop in-framework.  Accepts either trajectory
format (13-field id+3x4 cam_T_world rows or 8-field TUM rows, mixed
freely between the two files), associates by stamp/id, Umeyama-aligns,
and prints one JSON report.  Host numpy only: no device is used.

    python -m disinfect_slam_tpu_torch.apps.evaluate gt.txt est.txt \\
        [--max-dt 0.02] [--rpe-delta 1] [--scale] [--no-align]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils import trajectory_eval as te


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("groundtruth", help="ground-truth trajectory file")
    ap.add_argument("estimate", help="estimated trajectory file")
    ap.add_argument("--max-dt", type=float, default=0.02,
                    help="association window in stamp units (frame ids or seconds)")
    ap.add_argument("--rpe-delta", type=int, default=1, help="RPE frame delta (0 disables)")
    ap.add_argument("--scale", action="store_true",
                    help="estimate a similarity scale in the ATE alignment")
    ap.add_argument("--no-align", action="store_true", help="score without alignment")
    args = ap.parse_args(argv)

    ts_gt, gt = te.load_trajectory(args.groundtruth)
    ts_est, est = te.load_trajectory(args.estimate)
    pairs = te.associate(ts_gt, ts_est, max_dt=args.max_dt)
    if len(pairs) < 3:
        print(f"only {len(pairs)} associations within max_dt={args.max_dt}; need >= 3",
              file=sys.stderr)
        return 1
    ig = [i for i, _ in pairs]
    ie = [j for _, j in pairs]
    a = te.ate(gt[ig], est[ie], align=not args.no_align, with_scale=args.scale)
    report = {
        "pairs": len(pairs),
        "gt_rows": int(ts_gt.size),
        "est_rows": int(ts_est.size),
        "ate": {k: a[k] for k in ("rmse", "mean", "median", "max", "n", "scale")},
    }
    if args.rpe_delta > 0 and len(pairs) > args.rpe_delta:
        r = te.rpe(gt[ig], est[ie], delta=args.rpe_delta)
        report["rpe"] = {
            "delta": r["delta"],
            "trans": r["trans"],
            "rot_deg": {k: (v * 57.29577951308232 if k != "n" else v)
                        for k, v in r["rot_rad"].items()},
        }
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
