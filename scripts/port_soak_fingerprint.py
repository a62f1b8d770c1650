#!/usr/bin/env python
"""Fingerprint of the JAX reference's soak (tests/test_soak.py).

Runs the JAX package's soak on the CPU (the corridor of
tests/torch_cases.py:soak_corridor_depth, which tests/test_torch_soak.py
pins to the JAX test's, through DenseSLAM with loop closure, host spill,
maybe_recenter every 25 frames and the keyframe cap, as the JAX test
wires it) at each --frames count, prints the counts the soak asserts on
and whether the JAX test's assertions hold, and writes the 1000-frame
run's counts to disinfect_slam_tpu_torch/data/soak_fingerprint.json:
lost, recenters, spill_high, keyframes, evictions, closures, start_hist,
end_hist and end_t.  tests/test_torch_soak.py and chip_smoke.py phase 12
hold the port to it (tests/torch_cases.py:check_soak_fingerprint).

With --port it also runs the port's soak on the CPU at the same counts
(tests/torch_cases.py:run_soak) and prints each beside the JAX run.  The
JAX soak takes ~75 s at 1000 frames, the port's ~95 s on one thread:

  python scripts/port_soak_fingerprint.py [--frames 1000 700 900] [--port] [--no-write]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from disinfect_slam_tpu.config import TSDFConfig  # noqa: E402
from disinfect_slam_tpu.ops.gather import BoundingCube, gather_voxels  # noqa: E402
from disinfect_slam_tpu.systems.dense_slam import DenseSLAM  # noqa: E402
from tests import torch_cases as tc  # noqa: E402
from tests.scenes import checker_rgb  # noqa: E402

OUT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data", "soak_fingerprint.json")
FP_FRAMES = 1000


def run_jax_soak(n_frames: int) -> dict:
    """tests/test_soak.py's loop on the JAX package: run_soak's counts."""
    half = n_frames // 2
    cfg = TSDFConfig(voxel_size=0.04, truncation=0.12, num_blocks_log2=10,
                     max_candidates=4096, max_visible=1024, max_new_per_round=512,
                     backend="dense", grid_log2=5)
    slam = DenseSLAM(tc.SOAK_K, tc.SOAK_H, tc.SOAK_W, voxel_size=0.04, truncation=0.12,
                     max_depth=4.0, cfg=cfg, host_spill=True, loop_closure=True,
                     kf_every=10, lc_kwargs=dict(max_keyframes=tc.SOAK_KF_CAP,
                                                 min_gap_frames=200,
                                                 verify_min_inliers=400))
    rgb = checker_rgb(tc.SOAK_W, tc.SOAK_H)
    bbox = BoundingCube(*tc.SOAK_START_BBOX)

    def observed():
        st = gather_voxels(slam.volume, bbox)
        return int(np.sum(np.asarray(st.weight)[np.asarray(st.mask)] > 0))

    recenters = spill_high = 0
    start_hist = None
    t0 = time.perf_counter()
    for i in range(n_frames):
        x = (i if i < half else (n_frames - 1 - i)) * (tc.SOAK_CORRIDOR_M / half)
        depth, _ = tc.soak_corridor_depth(x)
        slam.process_frame(rgb, depth)
        if i % 25 == 24:
            if slam.maybe_recenter():
                recenters += 1
            spill_high = max(spill_high, len(slam.spill_store))
        if i == 100:
            start_hist = observed()
    wall_s = time.perf_counter() - t0
    return {"frames": n_frames, "wall_s": wall_s, "ms_per_frame": 1e3 * wall_s / n_frames,
            "lost": slam.lost_count, "recenters": recenters, "spill_high": spill_high,
            "keyframes": slam.lc.count, "evictions": slam.lc.evictions,
            "closures": slam.lc.closures, "start_hist": start_hist, "end_hist": observed(),
            "end_t": np.asarray(slam.world_T_cam, np.float64)[:3, 3].tolist()}


def verdict(res: dict) -> str:
    try:
        tc.check_soak(res)
        return "passes"
    except AssertionError as e:
        return f"fails ({e})"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[FP_FRAMES])
    ap.add_argument("--port", action="store_true",
                    help="also run the port's soak on the CPU at each count")
    ap.add_argument("--no-write", action="store_true",
                    help=f"print only; do not write {os.path.relpath(OUT, ROOT)}")
    args = ap.parse_args()
    for n in args.frames:
        res = run_jax_soak(n)
        print(f"[jax soak] {json.dumps(res)}; assertions {verdict(res)}", flush=True)
        if n == FP_FRAMES and not args.no_write:
            fp = {k: res[k] for k in tc.SOAK_FP_KEYS}
            fp["frames"] = n
            with open(OUT, "w") as f:
                json.dump(fp, f, indent=1)
            print(f"wrote {OUT}", flush=True)
        if args.port:
            import torch

            torch.set_num_threads(1)
            port, _ = tc.run_soak(n, "cpu")
            print(f"[port soak] {json.dumps(port)}; assertions {verdict(port)}", flush=True)
            if n == FP_FRAMES:
                try:
                    tc.check_soak_fingerprint(port, res)
                    print("[port soak] within the fingerprint's limits", flush=True)
                except AssertionError as e:
                    print(f"[port soak] outside the fingerprint's limits: {e}", flush=True)


if __name__ == "__main__":
    main()
