#!/usr/bin/env python
"""How far the pose-free SLAM trajectory moves under the perturbations a
port cannot avoid, measured on the CPU against the JAX reference's
fingerprint (disinfect_slam_tpu_torch/data/orbit_vga_slam_fingerprint.json,
scripts/port_fingerprint.py --slam).  chip_smoke.py's phase 8 holds the
card to limits derived from these gaps.

Over all 60 frames of datasets/orbit_vga at apps/dense_slam.py's defaults
with loop closure (the fingerprint's configuration):
  jax_ulp    the JAX DenseSLAM with every valid depth moved one float32
             ulp up;
  port_cpu   the port's DenseSLAM on the CPU (plain kernel versions);
each against the fingerprint: the largest per-frame camera-centre and
rotation gaps, the ATE rmse gap, and the volume's counts and sums
relative to the reference's; and
  jax_track_res_scale_2
             the JAX DenseSLAM at track_res_scale=2: ATE rmse against
             trajectory.txt and lost frames.

Takes ~5 min and ~3 GB of host memory:

  python scripts/port_slam_gap.py [--out gap.json]
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

from chip_smoke import pose_gaps  # noqa: E402
from disinfect_slam_tpu.config import TSDFConfig as JConfig  # noqa: E402
from disinfect_slam_tpu.systems.dense_slam import DenseSLAM as JSLAM  # noqa: E402
from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy  # noqa: E402
from disinfect_slam_tpu_torch.io.png_io import read_image  # noqa: E402
from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint  # noqa: E402
from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM  # noqa: E402
from disinfect_slam_tpu_torch.utils import trajectory_eval as te  # noqa: E402

DATASET = os.path.join(ROOT, "datasets", "orbit_vga")
FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                           "orbit_vga_slam_fingerprint.json")
FIELDS = ("entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")


def frames(ref, ulp=False):
    for fid in ref["frame_ids"]:
        base = os.path.join(DATASET, str(fid))
        depth = read_image(base + "_depth.png", unchanged=True).astype(np.float32) / 5000.0
        if ulp:
            depth = np.where(depth > 0, np.nextafter(depth, np.float32(np.inf)), depth)
        yield read_image(base + "_rgb.png").astype(np.float32), depth.astype(np.float32)


def run(slam, ref, ulp=False):
    poses = []
    for rgb, depth in frames(ref, ulp):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the report here as JSON")
    args = ap.parse_args()
    with open(FINGERPRINT) as f:
        ref = json.load(f)
    intr = (525.1, 525.3, 319.6, 239.7)  # datasets/orbit_vga/cam.yaml
    common = dict(voxel_size=ref["voxel"], truncation=ref["trunc"], max_depth=ref["max_depth"],
                  loop_closure=True, kf_every=ref["kf_every"],
                  lc_kwargs=dict(min_gap_frames=ref["lc_min_gap"]))
    jcfg = JConfig(voxel_size=ref["voxel"], truncation=ref["trunc"], sampler="gather")
    out = {}
    t0 = time.perf_counter()
    slam = JSLAM(intr, 480, 640, cfg=jcfg, splat_impl="xla", **common)
    poses = run(slam, ref, ulp=True)
    fp = volume_fingerprint({f: np.asarray(getattr(slam.volume, f)) for f in FIELDS})
    out["jax_ulp"] = gaps(poses, fp, ref)
    print(f"[gap] jax_ulp {out['jax_ulp']} ({time.perf_counter() - t0:.0f} s)", flush=True)
    slam = DenseSLAM(intr, 480, 640, device="cpu", **common)
    poses = run(slam, ref)
    out["port_cpu"] = gaps(poses, volume_fingerprint(volume_to_numpy(slam.volume)), ref)
    print(f"[gap] port_cpu {out['port_cpu']} ({time.perf_counter() - t0:.0f} s)", flush=True)
    slam = JSLAM(intr, 480, 640, cfg=jcfg, splat_impl="xla", track_res_scale=2, **common)
    poses = run(slam, ref)
    out["jax_track_res_scale_2"] = {"ate_rmse_m": ate_rmse(poses), "lost": slam.lost_count}
    print(f"[gap] jax_track_res_scale_2 {out['jax_track_res_scale_2']} "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
