#!/usr/bin/env python
"""How far the pose-free SLAM trajectory moves under the perturbations a
port cannot avoid, measured on the CPU against the JAX reference's
fingerprint (disinfect_slam_tpu_torch/data/orbit_vga_slam_fingerprint.json,
scripts/port_fingerprint.py --slam).  chip_smoke.py's phase 8 holds the
card to limits derived from these gaps.

Over all 60 frames of datasets/orbit_vga at apps/dense_slam.py's defaults
with loop closure (the fingerprint's configuration):
  jax_ulp       the JAX DenseSLAM with every valid depth moved one float32
                ulp up;
  jax_ulp_down  the same, one ulp down;
  port_cpu      the port's DenseSLAM on the CPU (plain kernel versions);
each against the fingerprint: the largest per-frame camera-centre and
rotation gaps, the ATE rmse gap, and the volume's counts and sums
relative to the reference's.  --track-scale 2 runs them at
track_res_scale=2 against orbit_vga_slam_s2_fingerprint.json
(scripts/port_fingerprint.py --slam --track-scale 2).

--steps K ... measures single tracked frames instead, from the JAX
DenseSLAM's own state after frame K - 1 (its volume and pose): the
port's pose for frame K against JAX's, and beside it how far the JAX
tracker itself moves with its model depth one ulp up and one ulp down,
and run without jit (camera centre and rotation gaps).

--port-poses writes disinfect_slam_tpu_torch/data/orbit_vga_slam_port_poses.json
instead: the port's own DenseSLAM on the CPU over the 60 frames at
track_res_scale 1 and 2 (chip_smoke.py phase 8's configuration, loop
closure on), every frame's cam_T_world and ok flag, and the soak's counts
and end position on the CPU (tests/torch_cases.py:run_soak, 1000 frames).
The tracker gives the same bits on every device, so chip_smoke.py holds
the card to this file bit for bit (phases 8 and 12); ~8 min.

Takes ~4 min (--steps: ~1 min) and ~3 GB of host memory:

  python scripts/port_slam_gap.py [--track-scale 2] [--steps K ...] [--out gap.json]
  python scripts/port_slam_gap.py --port-poses
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import pose_gaps  # noqa: E402
from disinfect_slam_tpu.config import TSDFConfig as JConfig  # noqa: E402
from disinfect_slam_tpu.systems.dense_slam import DenseSLAM as JSLAM  # noqa: E402
from disinfect_slam_tpu_torch.io.checkpoint import volume_from_numpy, volume_to_numpy  # noqa: E402
from disinfect_slam_tpu_torch.io.png_io import read_image  # noqa: E402
from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint  # noqa: E402
from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM  # noqa: E402
from disinfect_slam_tpu_torch.utils import trajectory_eval as te  # noqa: E402

DATASET = os.path.join(ROOT, "datasets", "orbit_vga")
FINGERPRINTS = {1: os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                "orbit_vga_slam_fingerprint.json"),
                2: os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                "orbit_vga_slam_s2_fingerprint.json")}
FIELDS = ("entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")
STATE_FIELDS = ("entry_key", "entry_block", "block_table", "heap", "num_free", "oob_count",
                "tsdf", "rgbw", "prob")


def ulp(depth, towards):
    """Every valid depth one float32 ulp towards +inf or -inf."""
    return np.where(depth > 0, np.nextafter(depth, np.float32(towards)), depth).astype(np.float32)


def frames(ref, towards=None):
    for fid in ref["frame_ids"]:
        base = os.path.join(DATASET, str(fid))
        depth = read_image(base + "_depth.png", unchanged=True).astype(np.float32) / 5000.0
        if towards is not None:
            depth = ulp(depth, towards)
        yield read_image(base + "_rgb.png").astype(np.float32), depth.astype(np.float32)


def run(slam, ref, towards=None):
    poses = []
    for rgb, depth in frames(ref, towards):
        p, _ok = slam.process_frame(rgb, depth)
        poses.append(np.asarray(p.cpu().numpy() if hasattr(p, "cpu") else p, np.float32))
    return np.stack(poses)


def ate_rmse(poses):
    _, gt = te.load_trajectory(os.path.join(DATASET, "trajectory.txt"))
    return float(te.ate(gt, np.linalg.inv(poses.astype(np.float64)))["rmse"])


def gaps(poses, vol_fp, ref):
    dt, dr = pose_gaps(poses, np.asarray(ref["cam_T_world"], np.float32))
    return {"max_translation_gap_m": float(dt.max()), "max_rotation_gap_rad": float(dr.max()),
            "ate_rmse_gap_m": abs(ate_rmse(poses) - ref["ate"]["rmse"]),
            "volume_rel": {k: vol_fp[k] / ref["volume"][k] - 1.0
                           for k in ("active_blocks", "sum_abs_tsdf", "sum_weight",
                                     "sum_prob")}}


def pose_gap(a, b) -> list:
    """[camera-centre gap m, rotation gap rad] of two cam_T_world."""
    dt, dr = pose_gaps(np.asarray(a, np.float32)[None], np.asarray(b, np.float32)[None])
    return [float(dt[0]), float(dr[0])]


def steps(ref, intr, kw, jcfg, ks) -> dict:
    """--steps: single tracked frames from the JAX DenseSLAM's state."""
    js = JSLAM(intr, 480, 640, cfg=jcfg, splat_impl="xla", **kw)
    ps = DenseSLAM(intr, 480, 640, device="cpu", **kw)
    tr, ts = js.tracker, kw["track_res_scale"]
    out = {}
    for k, (rgb, depth) in enumerate(frames(ref)):
        if k in ks:
            wtc = np.asarray(js.world_T_cam, np.float32)
            prev = jnp.linalg.inv(jnp.asarray(wtc))
            md = np.asarray(js._model_depth(js.volume, prev))
            cur = tr._prep(jnp.asarray(depth[::ts, ::ts]))

            def track(model_depth):
                return np.asarray(tr._track(jnp.asarray(wtc), cur,
                                            tr._prep(jnp.asarray(model_depth)), prev)[0])

            t_jax = track(md)
            with jax.disable_jit():
                t_eager = np.asarray(tr._track(jnp.asarray(wtc), tr._prep(
                    jnp.asarray(depth[::ts, ::ts])), tr._prep(jnp.asarray(md)), prev)[0])
            ps.volume = volume_from_numpy({f: np.asarray(getattr(js.volume, f))
                                           for f in STATE_FIELDS}, ps.volume.cfg, device="cpu")
            ps.world_T_cam = wtc
            ps.frame_count = k
            t_port = ps.process_frame(rgb, depth)[0].numpy()
            jpose = np.asarray(js.process_frame(rgb, depth)[0])
            out[k] = {"port": pose_gap(t_port, jpose),
                      "jax_model_depth_ulp_up": pose_gap(track(ulp(md, np.inf)), t_jax),
                      "jax_model_depth_ulp_down": pose_gap(track(ulp(md, -np.inf)), t_jax),
                      "jax_eager": pose_gap(t_eager, t_jax)}
            print(f"[gap] step {k}: " + ", ".join(
                f"{n} {v[0] * 1e3:.4f} mm {v[1] * 1e3:.4f} mrad" for n, v in out[k].items()),
                flush=True)
        else:
            js.process_frame(rgb, depth)
        if k >= max(ks):
            return out
    return out


PORT_POSES = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                          "orbit_vga_slam_port_poses.json")


def port_poses() -> dict:
    """--port-poses: the port's CPU poses and ok flags at both scales, and
    its CPU soak."""
    import torch

    from chip_smoke import new_slam, slam_frames
    from tests.torch_cases import SOAK_FP_KEYS, run_soak

    torch.set_num_threads(1)
    out = {"frames": 60}
    for scale in (1, 2):
        slam = new_slam("cpu", scale)
        poses, oks = [], []
        for rgb, depth in slam_frames():
            p, ok = slam.process_frame(rgb, depth)
            poses.append(p.numpy().astype(np.float32).tolist())
            oks.append(bool(ok))
        out[f"scale{scale}"] = {"cam_T_world": poses, "ok": oks, "lost": slam.lost_count,
                                "keyframes": slam.lc.count, "closures": slam.lc.closures}
        print(f"[gap] port poses at track_res_scale={scale}: lost {slam.lost_count}, "
              f"keyframes {slam.lc.count}", flush=True)
    res, _ = run_soak(1000, "cpu")
    out["soak"] = {k: res[k] for k in ("frames", *SOAK_FP_KEYS)}
    print(f"[gap] port soak on the CPU: {out['soak']}", flush=True)
    with open(PORT_POSES, "w") as f:
        json.dump(out, f)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--track-scale", type=int, choices=(1, 2), default=1,
                    help="DenseSLAM's track_res_scale, and the fingerprint of that scale")
    ap.add_argument("--steps", type=int, nargs="+", metavar="K",
                    help="single tracked frames K from the JAX state instead of the run")
    ap.add_argument("--out", help="write the report here as JSON")
    ap.add_argument("--port-poses", action="store_true",
                    help="write data/orbit_vga_slam_port_poses.json (the port on the CPU)")
    args = ap.parse_args()
    if args.port_poses:
        port_poses()
        return
    with open(FINGERPRINTS[args.track_scale]) as f:
        ref = json.load(f)
    intr = (525.1, 525.3, 319.6, 239.7)  # datasets/orbit_vga/cam.yaml
    jcfg = JConfig(voxel_size=ref["voxel"], truncation=ref["trunc"], sampler="gather")
    if args.steps:
        kw = dict(voxel_size=ref["voxel"], truncation=ref["trunc"], max_depth=ref["max_depth"],
                  track_res_scale=args.track_scale)
        out = steps(ref, intr, kw, jcfg, sorted(set(args.steps)))
    else:
        common = dict(voxel_size=ref["voxel"], truncation=ref["trunc"],
                      max_depth=ref["max_depth"], loop_closure=True, kf_every=ref["kf_every"],
                      lc_kwargs=dict(min_gap_frames=ref["lc_min_gap"]),
                      track_res_scale=args.track_scale)
        out = {}
        t0 = time.perf_counter()
        for name, towards in (("jax_ulp", np.inf), ("jax_ulp_down", -np.inf)):
            slam = JSLAM(intr, 480, 640, cfg=jcfg, splat_impl="xla", **common)
            poses = run(slam, ref, towards)
            fp = volume_fingerprint({f: np.asarray(getattr(slam.volume, f)) for f in FIELDS})
            out[name] = gaps(poses, fp, ref)
            print(f"[gap] {name} {out[name]} ({time.perf_counter() - t0:.0f} s)", flush=True)
        slam = DenseSLAM(intr, 480, 640, device="cpu", **common)
        poses = run(slam, ref)
        out["port_cpu"] = gaps(poses, volume_fingerprint(volume_to_numpy(slam.volume)), ref)
        print(f"[gap] port_cpu {out['port_cpu']} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
