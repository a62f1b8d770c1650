#!/usr/bin/env python3
"""Where the PyTorch port's mesh extraction spends its time on the card,
and what its compaction costs written two ways.

Fuses the 60-frame bench replay of datasets/orbit_vga on a fresh volume
(chip_smoke.py's fresh_bench_grid), then times ops/mesh.py's
extract_mesh_chunked (f32) with the compaction the port ships
(mesh._compact, the JAX package's form: every dropped row sent to one
scratch slot) and with a stable partition (every scatter index distinct,
no two stores to one address), alternating partition, scratch, scratch,
partition, three times: wall ms of each call (synchronised), then one
call of each under the profiler: device time by kernel name.  Both forms
give the same triangles (checked).  Needs a CUDA device; prints one JSON
line.

  python3 scripts/port_mesh_stage.py [--out FILE.json]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compact_partition(mask, rows, cap, fill):
    """mesh._compact written as a stable partition: the True rows first,
    in order, then the others, so that the scatter's indices are all
    distinct."""
    import torch

    from disinfect_slam_tpu_torch.ops import hash as h

    n = mask.shape[0]
    rank = h.cumsum_i32(mask) - 1
    total = mask.sum(dtype=torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    slot = torch.where(mask, rank, total + (idx - rank - 1)).long()
    buf = rows.new_empty((max(cap, n),) + tuple(rows.shape[1:]))
    buf[slot] = rows
    kept = torch.arange(cap, device=mask.device) < total
    out = torch.where(kept.view(-1, *([1] * (rows.dim() - 1))), buf[:cap], fill)
    return out, kept, total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_mesh_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power
    from disinfect_slam_tpu_torch.apps import offline
    from disinfect_slam_tpu_torch.ops import mesh

    card = card_name_and_power()
    dev = torch.device("cuda", 0)
    grid, _, frames, intr, max_depth = chip_smoke.fresh_bench_grid(offline, dev, 60)
    for fr in frames:
        grid.integrate(fr.rgb, fr.depth, fr.ht, fr.lt, max_depth, intr, fr.cam_T_world)
    vol = grid.volume
    shipped = mesh._compact
    forms = {"partition": compact_partition, "scratch": shipped}

    def run(form):
        mesh._compact = forms[form]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tris = mesh.extract_mesh_chunked(vol)
            return tris, 1e3 * (time.perf_counter() - t0)
        finally:
            mesh._compact = shipped

    ref, _ = run("scratch")  # warm-up
    walls = {f: [] for f in forms}
    for _ in range(3):
        for form in ("partition", "scratch", "scratch", "partition"):
            tris, ms = run(form)
            if not np.array_equal(tris, ref):
                raise AssertionError(f"the {form} compaction changed the mesh")
            walls[form].append(ms)
    device = {}
    for form in forms:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(form)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        device[form] = {"device_ms": sum(by_name.values()),
                        "top_kernels_ms": [[k[:80], v] for k, v in top]}
    res = {"card": card, "triangles": int(ref.shape[0]), "wall_ms": walls,
           "median_wall_ms": {f: float(np.median(v)) for f, v in walls.items()},
           "device": device}
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
