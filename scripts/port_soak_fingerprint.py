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
(tests/torch_cases.py:run_soak) and prints each beside the JAX run.  With
--poses DIR it records both packages' world_T_cam after every frame and
every add_keyframe call (frame id, the pose given, the correction
returned), writes them to DIR/soak_poses_N.npz (keys jax and port,
float64 [N, 4, 4]; {jax,port}_kf_{frame,pose,corr}; implies --port) and
prints the first frame where the two camera positions part by more than
1 mm and how the gap grows from there.  --test-state NPZ writes the JAX
run's keyframe calls, its pose after every 25th frame and its keyframe
map before keyframes 20 and 35 (tests/data/soak_700_jax_state.npz comes
from --frames 700).  --depth-ulp up|down runs the JAX soak with every
valid depth one float32 ulp that way instead (the reference against its
own twin) and prints its counts, its assertions and whether it keeps the
fingerprint's; it writes nothing.  The JAX
soak takes ~75 s at 1000 frames, the port's ~95 s on one thread:

  python scripts/port_soak_fingerprint.py [--frames 1000 700 900] [--port] [--no-write]
      [--poses DIR] [--test-state NPZ] [--depth-ulp up|down]
"""

import argparse
import contextlib
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


def run_jax_soak(n_frames: int, on_frame=None) -> dict:
    """tests/test_soak.py's loop on the JAX package: run_soak's counts.
    on_frame(i, slam), when given, runs after each frame's step and
    recenter."""
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
        depth, _ = tc.soak_corridor_depth(tc.soak_x(i, n_frames))
        slam.process_frame(rgb, depth)
        if i % 25 == 24:
            if slam.maybe_recenter():
                recenters += 1
            spill_high = max(spill_high, len(slam.spill_store))
        if i == 100:
            start_hist = observed()
        if on_frame is not None:
            on_frame(i, slam)
    wall_s = time.perf_counter() - t0
    return {"frames": n_frames, "wall_s": wall_s, "ms_per_frame": 1e3 * wall_s / n_frames,
            "lost": slam.lost_count, "recenters": recenters, "spill_high": spill_high,
            "keyframes": slam.lc.count, "evictions": slam.lc.evictions,
            "closures": slam.lc.closures, "start_hist": start_hist, "end_hist": observed(),
            "end_t": np.asarray(slam.world_T_cam, np.float64)[:3, 3].tolist()}


# keyframe calls of the 700-frame soak whose manager state --test-state
# keeps: 20 (frame 200, the first closure) and 35 (frame 350, the turn)
STATE_KEYFRAMES = (20, 35)


def lc_snapshots(n_frames: int, kf_frame, kf_pose) -> dict:
    """The JAX soak's keyframe calls replayed through a JAX
    LoopClosureManager; its map (save()'s arrays, prefixed kfK_) before
    each call of STATE_KEYFRAMES."""
    import io

    from disinfect_slam_tpu.systems.loop_closure import LoopClosureManager

    lc = LoopClosureManager(tc.SOAK_K, tc.SOAK_H, tc.SOAK_W, kf_every=10,
                            max_keyframes=tc.SOAK_KF_CAP, min_gap_frames=200,
                            verify_min_inliers=400)
    inten = checker_rgb(tc.SOAK_W, tc.SOAK_H).astype(np.float32).mean(-1)
    out = {}
    for k, (f, pose) in enumerate(zip(kf_frame, kf_pose)):
        if k in STATE_KEYFRAMES:
            buf = io.BytesIO()
            lc.save(buf)
            with np.load(io.BytesIO(buf.getvalue())) as z:
                out.update({f"kf{k}_{name}": z[name] for name in z.files})
            if k == max(STATE_KEYFRAMES):
                break
        depth, _ = tc.soak_corridor_depth(tc.soak_x(int(f), n_frames))
        lc.add_keyframe(depth, pose, int(f), intensity=inten)
    return out


def verdict(res: dict) -> str:
    try:
        tc.check_soak(res)
        return "passes"
    except AssertionError as e:
        return f"fails ({e})"


def pose_gap_report(jax_poses: np.ndarray, port_poses: np.ndarray) -> dict:
    """The first frame whose camera positions part by more than 1 mm (and
    the first where they part at all), the largest and the last gap (m),
    and the gap around the first frame and 5, 20, 50 and 100 frames
    later."""
    gap = np.linalg.norm(jax_poses[:, :3, 3] - port_poses[:, :3, 3], axis=1)
    over = np.nonzero(gap > 1e-3)[0]
    first = int(over[0]) if over.size else None
    rep = {"first_gap_frame": first, "max_gap_m": float(gap.max()),
           "end_gap_m": float(gap[-1])}
    if first is not None:
        rep["gap_m_at"] = {str(i): float(gap[i])
                           for i in sorted({first - 1, first, first + 1, first + 5,
                                            first + 20, first + 50, first + 100,
                                            len(gap) - 1})
                           if 0 <= i < len(gap)}
        prev = np.nonzero(gap[:first] > 0)[0]
        rep["first_nonzero_frame"] = int(prev[0]) if prev.size else first
    return rep


class Recorder:
    """Per-frame world_T_cam (run_soak's on_frame hook) and every
    add_keyframe call of one package's LoopClosureManager: its frame id,
    the pose it was given and the correction it returned (NaN when
    none)."""

    def __init__(self, lc_cls):
        self.lc_cls, self.poses, self.kf = lc_cls, [], []

    def __call__(self, i, slam):
        self.poses.append(np.asarray(slam.world_T_cam, np.float64))

    @contextlib.contextmanager
    def keyframes(self):
        add = self.lc_cls.add_keyframe

        def recorded(lc, depth, world_T_cam_est, frame_id, intensity=None):
            corr = add(lc, depth, world_T_cam_est, frame_id, intensity=intensity)
            self.kf.append((int(frame_id), np.asarray(world_T_cam_est, np.float32),
                            np.full((4, 4), np.nan, np.float32) if corr is None
                            else np.asarray(corr, np.float32)))
            return corr

        self.lc_cls.add_keyframe = recorded
        try:
            yield self
        finally:
            self.lc_cls.add_keyframe = add

    def arrays(self, prefix: str) -> dict:
        ids, est, corr = zip(*self.kf)
        return {prefix: np.stack(self.poses), f"{prefix}_kf_frame": np.asarray(ids),
                f"{prefix}_kf_pose": np.stack(est), f"{prefix}_kf_corr": np.stack(corr)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[FP_FRAMES])
    ap.add_argument("--port", action="store_true",
                    help="also run the port's soak on the CPU at each count")
    ap.add_argument("--poses", metavar="DIR",
                    help="record both packages' per-frame poses and keyframe calls into "
                         "DIR/soak_poses_N.npz and report where they part (implies --port)")
    ap.add_argument("--test-state", metavar="NPZ",
                    help="write the JAX run's keyframe calls, its pose after every 25th "
                         "frame and its keyframe map before keyframe calls "
                         f"{STATE_KEYFRAMES}, for tests/test_torch_soak_divergence.py")
    ap.add_argument("--no-write", action="store_true",
                    help=f"print only; do not write {os.path.relpath(OUT, ROOT)}")
    ap.add_argument("--depth-ulp", choices=("up", "down"),
                    help="run the JAX soak with every valid depth one float32 ulp up or down "
                         "and hold it to the fingerprint (writes nothing)")
    args = ap.parse_args()
    if args.depth_ulp:
        corridor = tc.soak_corridor_depth
        towards = np.float32(np.inf if args.depth_ulp == "up" else -np.inf)

        def perturbed(x):
            d, pose = corridor(x)
            return np.where(d > 0, np.nextafter(d, towards), d).astype(np.float32), pose

        tc.soak_corridor_depth = perturbed
        for n in args.frames:
            res = run_jax_soak(n)
            print(f"[jax soak, depth one ulp {args.depth_ulp}] {json.dumps(res)}; assertions "
                  f"{verdict(res)}", flush=True)
            if n == FP_FRAMES:
                try:
                    tc.check_soak_fingerprint(res, tc.soak_fingerprint())
                    print("[jax soak] within the fingerprint's limits", flush=True)
                except AssertionError as e:
                    print(f"[jax soak] outside the fingerprint's limits: {e}", flush=True)
        return
    if args.poses:
        args.port = True
        os.makedirs(args.poses, exist_ok=True)
    for n in args.frames:
        from disinfect_slam_tpu.systems.loop_closure import LoopClosureManager

        jax_rec = Recorder(LoopClosureManager)
        with jax_rec.keyframes():
            res = run_jax_soak(n, jax_rec if args.poses or args.test_state else None)
        print(f"[jax soak] {json.dumps(res)}; assertions {verdict(res)}", flush=True)
        if args.test_state:
            kf = jax_rec.arrays("jax")
            np.savez_compressed(args.test_state, frames=n,
                                kf_frame=kf["jax_kf_frame"].astype(np.int32),
                                kf_pose=kf["jax_kf_pose"],
                                recenter_pose=np.stack(jax_rec.poses)[24::25].astype(np.float32),
                                **lc_snapshots(n, kf["jax_kf_frame"], kf["jax_kf_pose"]))
            print(f"wrote {args.test_state}", flush=True)
        if n == FP_FRAMES and not args.no_write:
            fp = {k: res[k] for k in tc.SOAK_FP_KEYS}
            fp["frames"] = n
            with open(OUT, "w") as f:
                json.dump(fp, f, indent=1)
            print(f"wrote {OUT}", flush=True)
        if args.port:
            import torch

            from disinfect_slam_tpu_torch.systems import loop_closure as port_lc

            torch.set_num_threads(1)
            port_rec = Recorder(port_lc.LoopClosureManager)
            with port_rec.keyframes():
                port, _ = tc.run_soak(n, "cpu", port_rec if args.poses else None)
            print(f"[port soak] {json.dumps(port)}; assertions {verdict(port)}", flush=True)
            if args.poses:
                out = os.path.join(args.poses, f"soak_poses_{n}.npz")
                np.savez(out, **jax_rec.arrays("jax"), **port_rec.arrays("port"))
                rep = pose_gap_report(np.stack(jax_rec.poses), np.stack(port_rec.poses))
                print(f"[poses {n}] {json.dumps(rep)}; wrote {out}", flush=True)
            if n == FP_FRAMES:
                try:
                    tc.check_soak_fingerprint(port, res)
                    print("[port soak] within the fingerprint's limits", flush=True)
                except AssertionError as e:
                    print(f"[port soak] outside the fingerprint's limits: {e}", flush=True)


if __name__ == "__main__":
    main()
