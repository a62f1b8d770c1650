"""Mesh a VoxelSpatialTSDF dump (data.bin) on the PyTorch port
(counterpart of apps/tsdf2mesh.py).

The reference dumps (x, y, z, tsdf) float32 records (offline.cc:184-190)
and meshes them with the external TSDF2Mesh tool (README.md:69, 91).
This rebuilds a hash-backend volume from the dump
(ops/gather.py volume_from_spatial_records) and runs the port's marching
tetrahedra; a .ply output carries each vertex's rgb and high-touch
probability, an .obj the geometry.

Usage:
  python -m disinfect_slam_tpu_torch.apps.tsdf2mesh data.bin out.ply \\
      [--voxel 0.004] [--max-tris N] [--q16] [--device cuda]

The voxel size is inferred from the records' spacing when not given.  It
runs on the CUDA device unless asked for another (--device cpu).
"""

from __future__ import annotations

import argparse
import time

from ..ops.gather import load_spatial_tsdf, volume_from_spatial_records
from ..ops.mesh import extract_mesh_chunked, merge_vertices, save_obj, save_ply, vertex_attributes
from ..utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", help="VoxelSpatialTSDF binary (the offline app's --save)")
    ap.add_argument("out", help="output mesh (.obj or .ply)")
    ap.add_argument("--voxel", type=float, help="voxel size in metres (default: inferred)")
    ap.add_argument("--max-tris", type=int, default=1 << 18,
                    help="triangle capacity of an extraction chunk")
    ap.add_argument("--q16", action="store_true",
                    help="16-bit fixed-point mesh transfer (half the bytes, at most "
                         "1/32 voxel of error)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the volume; without CUDA the run stops "
                         "unless this is cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Returns the record, block, vertex and face counts, the volume and
    the seconds of the load (records to volume) and of the mesh."""
    device = resolve_device(args.device)
    rec = load_spatial_tsdf(args.dump)
    print(f"[tsdf2mesh] {rec.shape[0]} records from {args.dump}")
    t0 = time.perf_counter()
    vol = volume_from_spatial_records(rec, voxel_size=args.voxel, device=device)
    blocks = int(vol.num_active_blocks)
    t1 = time.perf_counter()
    print(f"[tsdf2mesh] volume: {blocks} blocks, voxel {vol.cfg.voxel_size * 1000:.2f} mm "
          f"({t1 - t0:.2f} s)")
    tris = extract_mesh_chunked(vol, max_tris_per_chunk=args.max_tris,
                                transfer="q16" if args.q16 else "f32")
    verts, faces = merge_vertices(tris)
    if args.out.lower().endswith(".ply"):
        rgb, prob = vertex_attributes(vol, verts)
        save_ply(args.out, verts, faces, rgb=rgb, prob=prob)
    else:
        save_obj(args.out, verts, faces)
    t2 = time.perf_counter()
    print(f"[tsdf2mesh] {len(verts)} verts / {len(faces)} faces -> {args.out} "
          f"({t2 - t1:.2f} s)")
    return {"records": int(rec.shape[0]), "blocks": blocks, "vertices": len(verts),
            "faces": len(faces), "volume": vol, "load_s": t1 - t0, "mesh_s": t2 - t1}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
