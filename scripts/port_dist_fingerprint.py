#!/usr/bin/env python
"""Fingerprint of the JAX package's sharded volume on the offline
benchmark replay.

Replays the first --frames frames (default: all 60) of datasets/orbit_vga
through the JAX DistributedTSDF (block-ownership sharding, the exact
gather sampler) over 4 virtual CPU devices and over 1, at the port's
`bench` preset (4 mm voxels, 24 mm truncation, a 2^18-block pool, split
into four 2^16-block shards on 4 devices; 32768 candidates and visible
rows a shard; max depth 4 m; allocation every frame, as the sharded step
does), and writes disinfect_slam_tpu_torch/data/
orbit_vga_dist_fingerprint.json: for each shard count, the shards' union
summarised as parallel/sharding.py:shards_fingerprint does it (active
blocks, each shard's, oob count, a sha256 of the sorted live keys,
float64 sums of |tsdf|, weight and prob) and the gather_all_tsdf record
count.  The two differ where the one shard's max_candidates cut binds and
the four shards' does not.  chip_smoke.py phase 10c holds the card's
4-shard and 1-shard replays each against its count's entry, at the same
frame count.  Takes a few minutes and several GB of host memory:

  python scripts/port_dist_fingerprint.py [--frames N] [--out PATH]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from disinfect_slam_tpu.config import TSDFConfig  # noqa: E402
from disinfect_slam_tpu.io.config_reader import (  # noqa: E402
    get_depth_factor, get_intrinsics, load_yaml,
)
from disinfect_slam_tpu.io.dataset import LoggedReplay  # noqa: E402
from disinfect_slam_tpu.ops.integrate import FrameInput  # noqa: E402
from disinfect_slam_tpu.parallel.sharding import DistributedTSDF, make_mesh  # noqa: E402
from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH  # noqa: E402
from disinfect_slam_tpu_torch.parallel.sharding import (  # noqa: E402
    FINGERPRINT_FIELDS, shards_fingerprint,
)

DATASET = os.path.join(ROOT, "datasets", "orbit_vga")
OUT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data", "orbit_vga_dist_fingerprint.json")
SHARDS = (4, 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    cam = load_yaml(os.path.join(DATASET, "cam.yaml"))
    intrinsics = get_intrinsics(cam)
    cfg = TSDFConfig(**dataclasses.replace(BENCH, sampler="gather").__dict__)
    out = {"reference": "disinfect_slam_tpu DistributedTSDF on CPU (virtual devices), "
                        "sampler='gather'",
           "dataset": "datasets/orbit_vga", "preset": "bench", "max_depth": BENCH_MAX_DEPTH}
    for shards in SHARDS:
        dist = DistributedTSDF(cfg, make_mesh(shards))
        t0 = time.perf_counter()
        n = 0
        for fr in LoggedReplay(DATASET, get_depth_factor(cam)):
            frame = FrameInput(*(jnp.asarray(a, jnp.float32)
                                 for a in (fr.rgb, fr.depth, fr.ht, fr.lt)))
            dist.integrate(frame, intrinsics, fr.cam_T_world, BENCH_MAX_DEPTH)
            n += 1
            print(f"{shards} shard(s), frame {n}: {time.perf_counter() - t0:.1f} s", flush=True)
            if n == args.frames:
                break
        fp = shards_fingerprint([{f: np.asarray(getattr(dist.volume, f)[d])
                                  for f in FINGERPRINT_FIELDS} for d in range(shards)])
        fp["records"] = int(dist.gather_all_tsdf().shape[0])
        out["frames"] = n
        out[f"shards_{shards}"] = fp
        del dist
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
