#!/usr/bin/env python
"""Fingerprint of the JAX reference on the stereo orbit scene.

Writes the scene's 60 VGA pairs (tests/torch_cases.py:write_stereo_logdir:
datasets/orbit_vga's poses and intrinsics, a 0.12 m baseline, a
world-anchored value-noise texture) into a stereo logdir, runs the JAX
package on the CPU over it and writes
disinfect_slam_tpu_torch/data/orbit_vga_stereo_fingerprint.json:

  - per frame, the crc32 and byte sums of the generated u8 pair;
  - per frame, for the flat and the pyramid matcher at 64 disparities
    (stereo_depth at the rectified fx, 0.12 m, max depth 4 m, the online
    app's settings), the valid count and float64 sums of disparity and
    depth over the valid pixels;
  - the volume of apps/online.py --stereo --fused --segment over the 60
    frames (FusedOnlineStep at the app's default config with the exact
    gather sampler, the shipped UNet, depth from StereoDepthEstimator,
    rgb the left view): gather.volume_fingerprint and its record count;
  - the rectifier of tests/test_io.py's ZED factory calibration (cv2's
    stereoRectify branch): rectified intrinsics and float64 sums of each
    map.

chip_smoke.py phase 11 holds the card against it (the GPU host has no
JAX and no cv2).  With --port it also runs the PyTorch port on the CPU
over the same logdir and prints its gaps to the reference (the limits of
phase 11 come from them).  ~5 min and ~4 GB of host memory:

  python scripts/port_stereo_fingerprint.py [--port]
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from disinfect_slam_tpu.config import TSDFConfig  # noqa: E402
from disinfect_slam_tpu.io.dataset import LoggedStereoReplay  # noqa: E402
from disinfect_slam_tpu.io.zed_calib import rectifier_from_factory_conf  # noqa: E402
from disinfect_slam_tpu.models import segmentation as seg  # noqa: E402
from disinfect_slam_tpu.ops.gather import to_numpy_records  # noqa: E402
from disinfect_slam_tpu.ops.stereo import StereoDepthEstimator, stereo_depth  # noqa: E402
from disinfect_slam_tpu.systems.online_step import FusedOnlineStep  # noqa: E402
from disinfect_slam_tpu.systems.tsdf_grid import TSDFGrid  # noqa: E402
from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint  # noqa: E402
from tests import torch_cases as tc  # noqa: E402

DATASET = os.path.join(ROOT, "datasets", "orbit_vga")
OUT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data", "orbit_vga_stereo_fingerprint.json")
# the online app's stereo settings: --max-disp, --max-depth, --voxel, --trunc
MAX_DISP, MAX_DEPTH, VOXEL, TRUNC = 64, 4.0, 0.05, 0.2
METHODS = ("flat", "pyramid")
FIELDS = ("entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")


def depth_summaries(replay, fx, matcher):
    out = {m: [] for m in METHODS}
    for fr in replay:
        for m in METHODS:
            out[m].append(tc.stereo_depth_summary(matcher(fr.left, fr.right, m)))
    return out


def jax_matcher(fx):
    fns = {m: jax.jit(lambda l, r, m=m: stereo_depth(
        l, r, fx=fx, baseline_m=tc.STEREO_BASELINE, max_disp=MAX_DISP, max_depth=MAX_DEPTH,
        method=m)) for m in METHODS}
    return lambda left, right, m: fns[m](left, right)


def jax_online(replay, fx):
    cfg = TSDFConfig(voxel_size=VOXEL, truncation=TRUNC, sampler="gather")
    est = StereoDepthEstimator(fx=fx, baseline_m=tc.STEREO_BASELINE, max_disp=MAX_DISP,
                               max_depth=MAX_DEPTH)
    step = FusedOnlineStep(cfg, tc.ORBIT_VGA_K, 480, 640, MAX_DEPTH, seg_model=seg.create_model(),
                           seg_params=seg.load_default_params("unet"))
    for fr in replay:
        step.step(fr.left, est(fr.left, fr.right), fr.cam_T_world)
    vol = step.volume
    fp = volume_fingerprint({f: np.asarray(getattr(vol, f)) for f in FIELDS})
    grid = TSDFGrid(cfg.voxel_size, cfg.truncation, cfg=cfg)
    grid.volume = vol
    fp["records"] = int(to_numpy_records(grid.gather_valid()).shape[0])
    return fp


def rectifier(conf_path, make):
    rect = make(conf_path, "VGA")
    return {"rectified_intrinsics": list(rect.rectified_intrinsics()),
            "map_sums": [float(np.asarray(m, np.float64).sum()) for m in rect.maps[:4]],
            "size": list(rect.maps.left_x.shape)}


def port_gaps(logdir, ref):
    """The PyTorch port on the CPU over the same logdir: depth summaries,
    the online app's volume and the factory rectifier, against `ref`."""
    import torch

    from disinfect_slam_tpu_torch.apps import online
    from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
    from disinfect_slam_tpu_torch.io.dataset import LoggedStereoReplay as TReplay
    from disinfect_slam_tpu_torch.io.zed_calib import rectifier_from_factory_conf as trect
    from disinfect_slam_tpu_torch.ops import stereo as tst

    fx = tc.ORBIT_VGA_K[0]

    def matcher(left, right, m):
        return tst.stereo_depth(torch.from_numpy(left), torch.from_numpy(right), fx=fx,
                                baseline_m=tc.STEREO_BASELINE, max_disp=MAX_DISP,
                                max_depth=MAX_DEPTH, method=m)

    depth = depth_summaries(TReplay(logdir), fx, matcher)
    for m in METHODS:
        same = sum(a == b for a, b in zip(depth[m], ref["depth"][m]))
        print(f"[port] {m}: {same} of {len(depth[m])} frames with equal summaries", flush=True)
    r = online.main(["--logdir", logdir, "--config", os.path.join(logdir, "cam.yaml"),
                     "--stereo", "--fused", "--segment", "--device", "cpu"])
    fp = volume_fingerprint(volume_to_numpy(r["step"].volume))
    for k in ("active_blocks", "sum_abs_tsdf", "sum_weight", "sum_prob"):
        print(f"[port] online {k}: {fp[k]} reference {ref['online'][k]} rel "
              f"{abs(fp[k] - ref['online'][k]) / abs(ref['online'][k]):.3e}", flush=True)
    print(f"[port] online keys equal: {fp['keys_sha256'] == ref['online']['keys_sha256']}")
    rect = rectifier(ref["_conf"], lambda p, res: trect(p, res, device="cpu"))
    print(f"[port] rectifier {rect} reference {ref['rectifier']}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU and print its gaps")
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="stereo_fp_")
    logdir = os.path.join(tmp, "stereo")
    t0 = time.perf_counter()
    sums = tc.write_stereo_logdir(logdir, DATASET)
    print(f"[fingerprint] {len(sums)} pairs written in {time.perf_counter() - t0:.0f} s",
          flush=True)
    fx = tc.ORBIT_VGA_K[0]
    replay = LoggedStereoReplay(logdir)
    depth = depth_summaries(replay, fx, jax_matcher(fx))
    print(f"[fingerprint] depth frame 0: { {m: depth[m][0] for m in METHODS} } "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)
    fp = jax_online(replay, fx)
    print(f"[fingerprint] online: {fp} ({time.perf_counter() - t0:.0f} s)", flush=True)
    conf = os.path.join(tmp, "SN12345.conf")
    with open(conf, "w") as f:
        f.write(tc.ZED_FACTORY_CONF)
    out = {
        "reference": "disinfect_slam_tpu on CPU: stereo_depth (jitted), FusedOnlineStep "
                     "sampler='gather' with the shipped UNet (bfloat16), "
                     "rectifier_from_factory_conf through cv2.stereoRectify",
        "scene": "tests/torch_cases.py:write_stereo_logdir (datasets/orbit_vga poses and "
                 f"intrinsics, baseline {tc.STEREO_BASELINE} m, seed {tc.STEREO_SEED})",
        "frames": len(sums),
        "max_disp": MAX_DISP,
        "max_depth": MAX_DEPTH,
        "fx": fx,
        "baseline_m": tc.STEREO_BASELINE,
        "online_voxel": VOXEL,
        "online_truncation": TRUNC,
        "pairs": sums,
        "depth": depth,
        "online": fp,
        "rectifier": rectifier(conf, rectifier_from_factory_conf),
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"[fingerprint] wrote {os.path.relpath(OUT, ROOT)} ({time.perf_counter() - t0:.0f} s)")
    if args.port:
        port_gaps(logdir, {**out, "_conf": conf})


if __name__ == "__main__":
    main()
