#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (disinfect_slam_tpu_torch).

Phases, each printed as it ends; any failure raises and the process
exits non-zero:

  0. the card (nvidia-smi name and power limit) and torch / CUDA versions;
  1. builds the CUDA kernels from csrc/ (nvcc, sm_90a; one library per
     source, all compiled at once);
  2. holds each kernel against its plain torch version on the card at the
     slice's shapes (32768 visible blocks, 640x480 frame, a 2^18-row pool):
     fuse_rows on synthetic block rows placed in the frustum at 640x480
     and 1920x1080 (tests/torch_cases.py's block_case: rows behind the
     camera, off the image and, at 1080p, voxels at camera z = 0);
  3. the slice: apps.offline over all 60 frames of datasets/orbit_vga at
     the bench preset through the fused kernel, three times; fuse_rows
     must launch once per frame, and the fused volume must agree with
     the JAX reference's fingerprint (disinfect_slam_tpu_torch/data/);
     the last of the three also renders the app's final view
     (--render-dir), which must launch splat_zbuf_blocks and
     splat_payload_blocks once each and write two 640x360 RGBA PNGs; then
     where the fusion's time goes on a fresh volume (frames 45-59, its
     stages by CUDA events);
  4. the same replay through the two-stage path (sample_rows + torch
     fusion math), once, with the same checks;
  5. the render slice on the last fused volume: TSDFGrid.ray_cast
     (renderer="auto", the two splat kernels) at the poses of frames 0-4,
     640x480, one warm-up and three timed passes of five renders; one
     launch of each kernel per render; the frame-0 render bit-equal, in
     both buffers and all four images, to the plain torch splat on the
     same volume, each kernel's branches counted there; the render split
     into the surface set, the plain projection (off the card path: the
     kernels project), each kernel and the image assembly by CUDA events,
     and profiled (render_split, which scripts/port_render_stage.py also
     runs on another tree); the frame-0 and the app's view held against
     the JAX reference's render fingerprint; the parity raycaster on the
     frame-0
     view, timed, with its divergence from the splat; then fuse_rows
     against its plain version on frame 30's visible set of the fused
     volume, with its yardsticks (below);
  6. the online slice (segmentation feeding fusion): InferenceEngine on
     frame 0 for both shipped nets against the JAX reference's seg
     fingerprint, timed end to end (seg_ms) and on a staged input
     (seg_dev_ms); FusedOnlineStep at the bench preset over the first 30
     frames (u8 rgb, raw u16 depth) with the shipped UNet, three times on
     fresh volumes (online_fps, timed after alloc_every warm-up frames),
     each volume against the JAX online fingerprint, then once with
     FastSeg (online_fps_fast); fuse_rows launches once per frame and
     sample_rows never; one profiled pass (device time, launches, idle
     share) and one pass split into upload, seg and fusion by CUDA
     events; then apps.online over all 60 frames, --fused with
     --render-dir (fuse_rows once per frame, two 640x360 RGBA PNGs) and
     the asynchronous DISINFSystem path at --fps 120;
  6b. the export slice, on phase 3's last volume and dump: the mesh
     (extract_mesh_chunked, f32 then q16, each transfer's wall ms) against
     the JAX reference's export fingerprint (triangles, merged vertices
     and faces within 0.1%, clipped chunks equal, vertex sums within 1e-4
     of their largest possible size), its first 4 chunks against the
     port's own CPU run of the same blocks (equal counts, vertices within
     1e-6 m, no triangle wound the other way); the bridge's 2 m bbox query
     (median of 5 calls); apps.tsdf2mesh on phase 3's data.bin, .ply as a
     user runs it and .obj in process (the rebuilt volume's gather_valid
     gives the dump's records back exactly, as a set; the mesh against the
     fingerprint); the hash-backend replay (apps.offline --backend hash,
     fused sampler: fuse_rows once per frame, the volume against the
     fingerprint, a frame-0 render launching each splat kernel once,
     bit-equal in both buffers to the plain splat); and apps.offline
     --preset small --grid-log2 6 --auto-recenter, whose window moves
     (every live entry's table cell points back at it, no live block
     outside the window);
  8. the tracking slice (pose-free dense SLAM): (a) apps.dense_slam over
     all 60 frames with --loop-closure --evaluate auto --out-traj --save
     --mesh at its defaults (2 cm voxels, 6 cm truncation, 4 m, the
     default TSDFConfig: 2^16-block pool, 16384 visible rows): fuse_rows
     once per frame, splat_zbuf_blocks once per tracked frame,
     splat_payload_blocks never, one pose read per tracked frame (plus one
     per loop verification); the trajectory, ok flags, ATE and volume
     against the JAX DenseSLAM's fingerprint
     (data/orbit_vga_slam_fingerprint.json) within TOL_SLAM_*; (b)
     DenseSLAM in process at track_res_scale 1 and 2, ms/frame over
     frames 3-59 with one sync at the end, three fresh runs each, lost
     frames and ATE, then one pass split by CUDA events (upload, model
     depth, pyramids, ICP, the pose read, fusion, keyframe work); (c) K4
     on the app's SLAM volume at 640x480 and 320x240, bit-equal to its
     plain version, its branches counted; (d) LoopClosureManager on the
     card over tests/test_loop_closure.py's drifted out-and-back keyframes
     (tests/torch_cases.py): the loop closes and the error falls;
  7. device times, after every end-to-end measurement (a profiler trace
     leaves the host slower for the rest of the process): the fusion
     profile (frames 45-59 of a fresh volume: device time, kernels per
     frame, idle share; then the fuse stage, fuse_visible, on frame 59's
     visible set); phase 2's checks again, now with each kernel's
     yardsticks: its device time (and one call's, CUDA events) beside its
     bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s), its
     plain version's time and, where one torch call computes the same
     function, that call's device time; and the probes: of the splat
     tile (P8's A/B of the per-voxel atomics against the tile kernel,
     P9's tile-shape sweep), the feature probe (P7: every primitive's
     check must pass) and the probes of the sampler and of fuse_rows'
     stages (P1-P6: K1's direct modes, the patch and one-hot mma
     selections, fuse_rows stripped stage by stage), each mode against
     its plain version; K4 at 320x240 on phase 8's SLAM volume (its
     bound, its plain version, scatter_reduce "amin"); and the SLAM frame
     profiled (frames 45-59: device time, kernels, idle share; ICP alone:
     kernels, device time and the host time of its ops).

  9. the served map, on phase 3's volume: (a) ReconstructionService
     over a DISINFSystem at the bench preset on 127.0.0.1 (make_server in a
     thread): all 60 frames POSTed as npz (rgb, depth, the logged ht/lt
     and pose), fuse_rows once a frame, the served volume bit-equal to
     phase 3's and within its fingerprint limits; /render at frame 0's
     pose, 640x480, five times (median HTTP round trip), each splat kernel
     once a request, bit-equal to ray_cast(renderer="auto") and the plain
     splat; /query on the bridge's 2 m cube equal to gather_voxels; /stats
     and /mesh timed; (d) the bench replay in process with the occlusion
     cull off and on: both volumes bit-equal to phase 3's, fewer visible
     rows with it, fusion ms/frame of each; (e) apps.view_volume on a
     checkpoint of phase 3's volume, each splat kernel once a view; (c)
     the dense window recentred away from phase 3's volume so that every
     block spills to the host store and back (spill and restore ms, host
     bytes; rows bit-equal, store empty, validate_volume clean), then
     apps.offline --preset small --grid-log2 6 --auto-recenter --spill
     --page-radius 1.0 --debug --save (the window moves) and the same
     without --grid-log2 and --auto-recenter (the scene outgrows the
     4096-block pool and paging evicts to the store): fuse_rows once a
     frame, the volume validated after every frame, the dump plus the
     appended store records covering every block the card and the store
     hold; (b)
     apps.serve --synthetic 30 as its own process on the card: the viewer
     page, the replay started and run to its end, /stats with 30 frames,
     a PNG from /render, the process stopped with no traceback on stderr.

  10. training the seg net, the sharded volume and the host library:
     (a) UNetSeg and FastSeg at their shipped widths, 10 steps each of
     models/train.py's make_train_step at 352x640, batch 8, on make_batch
     scenes: the loss finite and falling, step ms (CUDA events, median of
     the last 8), peak memory, and (at the end of the phase) the kernels of
     one profiled step; a narrow net's first step on the card against the
     CPU from the same parameters, float32 and bfloat16 (TRAIN_TOL); (b)
     apps.train_seg as its own process (no --device) for 600 steps at its
     defaults: its npz beats IoU 0.7 on both channels of
     tests/test_seg_training.py's held-out set (printed beside the shipped
     checkpoint's), and its msgpack save_checkpoint drives apps.online
     --seg-ckpt --fused over 5 logged frames; (c) DistributedTSDF at the
     bench preset (2^18 blocks in four 2^16-block shards) over [cuda:0] * 4
     and [cuda:0], all 60 frames: fuse_rows 4 x 60 and 60 times, each
     within the JAX sharded volume's fingerprint
     (data/orbit_vga_dist_fingerprint.json), the two bit-equal block by
     block unless a printed capacity cut explains it; query_bbox of phase
     6b's cube equal to the 1-shard volume's; a 640x480 render at frame 0's
     pose launching K4 and K5 four times, hit and depth within
     tests/test_parallel.py's limits of the 1-shard render; the elastic
     checkpoint restored onto 1 and 2 shards bit-equal; apps.offline
     --preset bench --devices 1 --save-dist as its own process, its
     checkpoint equal to the 1-shard volume; ms/frame of both replays; (d)
     FrameLogger writes 30 frames that LoggedReplay reads back bit-equal,
     and the native runtime builds and answers as PoseManager.

  11. stereo-only depth: (a) tests/torch_cases.py's stereo orbit (60
     pairs at 640x480: datasets/orbit_vga's poses and intrinsics, the
     right camera 0.12 m along the left one's +x, a world-anchored
     texture) written through StereoFrameLogger, each pair's checksum
     against data/orbit_vga_stereo_fingerprint.json (a difference is
     generator drift); (b) flat and pyramid depth of frame 0 on the card
     bit-equal to the port's CPU run, then all 60 frames on the card
     against the JAX reference's per-frame valid counts and sums; (c)
     stereo_ms of both matchers as bench.py times it (64 disparities,
     chained, one sync, CUDA events, median of 3); (d) the ZED factory
     calibration's rectifier without cv2 against cv2's numbers in the
     fingerprint, its remap on the card bit-equal to the CPU's; (e)
     apps.online --stereo --segment as its own process (no --device):
     --fused --render-dir (fuse_rows once a frame, the volume within the
     JAX stereo app's fingerprint, two 640x360 PNGs) and the asynchronous
     path at --fps 120 (fuse_rows once a frame, no frame dropped);
  12. the soak: tests/test_soak.py's corridor out and back, 1000 frames
     of DenseSLAM with loop closure, host spill, recentering and the
     keyframe cap on the card, with the JAX soak's assertions and within
     the JAX soak's counts (data/soak_fingerprint.json; fuse_rows once a
     frame, splat_zbuf_blocks once a tracked frame); wall time, ms/frame
     and closures; then K4 on the final volume at the soak's 96x72
     (partial tiles) bit-equal to its plain version, and K2 on the last
     frame's visible rows against its plain version.
  13. the segmentation net over a (data, model) mesh
     (parallel/seg_parallel.py), the shipped UNet's architecture at its
     full width, 352x640, batch 8 (phase 10a's shape): over [cuda:0]
     (1x1) the sharded step bit-equal to make_train_step over 3 steps,
     loss and every parameter; over [cuda:0] * 4 (2x2) the first step's
     loss within 1e-5 relative, and in float32 its gradients within 1e-4
     of each parameter's largest with AdamW held on them bit-equal; ms a
     step of make_train_step and the sharded step over 1x1 and 2x2
     (median of the last 8 of 10, CUDA events) and the kernels of one
     profiled step each; make_sharded_infer of the shipped weights over
     [cuda:0] * 4 against sigmoid(model), bfloat16 and float32
     (SEG_PAR_INFER_TOL); no fusion or splat kernel launched;
  14. the kernels' self-check: utils/kernel_verify.verify_all() on the
     card (K1 at 640x480, 1080p and with an early count, the two-stage
     and the fused integrate of a small scene, K4/K5's render of it),
     every check PASS in under 60 s; its launches are reported apart
     from the main paths' (verify_launches).
  15. the port's benchmark as a user runs it: `python bench_torch.py` in
     its own process (no arguments, so on the card), under a time limit:
     exit 0, its self-check PASS before anything is timed, the timed
     fusion volume within the JAX reference's fingerprint, and a last
     line with bench.py's twelve keys (platform "cuda", fallback false,
     vs_baseline null, every other number positive); fuse_rows launched
     2 + 60 times by the fusion stage and 30 a net by the online stage,
     each splat kernel 6 times, sample_rows only in the self-check
     (bench_launches in the kernels line).  Its line and its summary are
     printed.

Phases run 0-6b, then 9, then 8, then 10, then 11, then 12, then 13,
then 14, then 15, then 7 (which
also profiles the two matchers: kernels and device time a call).  Phase
2 also holds splat_zbuf_blocks and splat_payload_blocks (K4, K5:
they project block rows in registers) against their plain versions at
the render's capacity (16384 block rows, 14000 live, 640x480 and
1920x1080; tests/torch_cases.py's splat_block_case: rows behind the
camera and off the image, 5% of the live rows near the camera, and a
second pair of runs with voxels at camera z = 0), bit for bit, with both
branches of each kernel taken and counted; phase 5 counts them on the
frame-0 render too.

The line before the last is a JSON object describing each kernel; the
last line is the JSON result.  The full report, the data.bin of phase 3's
last replay (and data_two_stage.bin, data_hash.bin of the others) and the
meshes go to disinfect_slam_tpu_torch/_build/.  Run from the
repository root, with no arguments:  python3 chip_smoke.py
"""

import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from disinfect_slam_tpu_torch.ops.gather import TOL_WP, fingerprint_gaps
from disinfect_slam_tpu_torch.utils.timing import card_name_and_power, cuda_time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
DATASET = os.path.join(ROOT, "datasets", "orbit_vga")
FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                           "orbit_vga_bench_fingerprint.json")
V, H, W = 32768, 480, 640
POOL = 1 << 18
COUNT = 32207  # visible rows below the capacity, as in the slice's last frames
CONSTS = dict(truncation=0.024, max_depth=4.0, max_weight=40.0, prob_eps=0.0)
# splat renders of the fused volume against the JAX reference's: hit
# count and every sum within 1e-3 relative; dropped surface blocks within
# 0.1% of the surface-block count
TOL_RENDER = 1e-3
SPLAT_ROWS, SPLAT_COUNT = 16384, 14000  # the render's surf_cap; live rows
SPLAT_VOXEL, SPLAT_TRUNC = 0.004, 0.024  # the bench preset's voxel size and truncation
RENDER_MAX_DEPTH = 4.0
ONLINE_FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                  "orbit_vga_online_fingerprint.json")
EXPORT_FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                  "orbit_vga_export_fingerprint.json")
# meshes against the JAX reference's (its volume agrees within the limits
# above, not bit for bit): counts within 0.1%; each axis's vertex sum
# within 1e-4 of the largest it could be (points x the bbox's reach)
TOL_MESH_COUNT, TOL_MESH_SUM = 1e-3, 1e-4
MESH_CPU_CHUNKS = 4  # chunks held against the port's CPU run
RECENTER_GRID_LOG2 = 6  # a 64-block window of 8 cm blocks: the camera starts near its edge
ONLINE_FRAMES = 30
SPLIT_FIRST, SPLIT_LAST = 45, 59  # the replay frames fusion_split and fusion_profile measure
# seg of frame 0 against the JAX reference, from the limits of
# tests/test_torch_seg.py (mean |dp| per arch, thresholded labels on at
# most 0.5% of pixels): each map's sum within mean-limit x pixels, each
# count above 0.5 within 0.5% of the pixels
SEG_MEAN_TOL = {"unet": 5e-3, "fast": 2e-3}
SEG_LABEL_TOL = 5e-3
# the 30-frame online volume: the seg reaches fusion only through prob,
# so counts, sum|tsdf| and sum weight hold the offline limits; sum prob
# within 5e-3 relative (the port on the CPU: 9.0e-4 from the reference)
TOL_ONLINE_PROB = 5e-3
# the least time for a kernel's work on an H100 SXM (NVIDIA's data sheet,
# 700 W): its bytes (each input read once, each output written once, the
# frame counted once) over the 3.35 TB/s of HBM3, or its operations over
# the 67 TFLOP/s of float32 outside the tensor cores, whichever is larger
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations per voxel, counted from the sources (a division, exp, log or
# square root counted as 8): sample_rows clips, bounds-checks and indexes
# (12); fuse_rows projects (48 and 2 divisions) and fuses (60 and 9
# divisions, 2 exp, 2 log): 228; the splat kernels test every live voxel's
# tsdf against the band (2), project those inside it (48 and 2 divisions,
# then the range, its root, the depth correction with a division and the
# floor pixel: 94) and merge the surface-band voxels' 4 footprint pixels
# (16)
OPS_PER_VOXEL = {"sample_rows": 12, "fuse_rows": 228, "splat_project": 94, "splat": 16}
SLAM_FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                "orbit_vga_slam_fingerprint.json")
# the SLAM app run against the JAX DenseSLAM's fingerprint (PERF.md §2):
# ICP on this orbit amplifies ulps along its weakly constrained direction,
# so these are 3x the larger of two gaps measured on the CPU over the 60
# frames: the port against JAX (6.6 mm, 1.32 mrad, ATE 0.22 mm, blocks
# 0.97%, sums 1.19%) and JAX against itself with every depth one float32
# ulp up (5.4 mm, blocks 0, sums 0.19%); ATE keeps the looser 1 mm set
# before those measurements
TOL_SLAM_T, TOL_SLAM_R, TOL_SLAM_ATE = 0.020, 0.004, 0.001
TOL_SLAM_COUNT, TOL_SLAM_SUM = 0.03, 0.04
SLAM_WARM = 3  # frames before the SLAM timing window (frames 3-59)


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_ms(fn, name=None, reps: int = 10, floor_ms: float = 0.0) -> float:
    """Device time per call of fn() from a profiler trace of reps calls
    after one warm-up: the median launch of the kernel whose name holds
    `name`, or (name None) the sum over the kernels a call launches of
    each one's median.  No launch overhead or host time, which
    cuda_time_ms includes.  A trace can drop a device event or two, so
    medians stand in for the launches; a trace that lost most of them, or
    that reads less than floor_ms (the kernel's bound: no run can be
    faster, so such a reading is a fault of the trace), is taken again,
    five times at most; when none gave a reading at or above the bound,
    the calls are timed by CUDA events (cuda_time_ms, launch overhead
    included) and the log says so, and a time below the bound raises.
    The profiler leaves the
    host slower for the rest of the process, so these run after the
    end-to-end measurements they could slow."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type.name == "CUDA" and (name is None or name in e.name):
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if by_name and all(len(v) >= reps // 2 for v in by_name.values()):
            # launches per call of each kernel, from the counts traced
            ms = sum(statistics.median(v) * max(1, round(len(v) / reps))
                     for v in by_name.values()) / 1e3
            if ms >= floor_ms:
                return ms
            readings.append(ms)
            log(f"[chip_smoke] {name or 'fn'}: a trace read {ms:.4f} ms, below the bound "
                f"{floor_ms:.4f} ms; taken again")
    # no trace read at or above the bound (the rest lost their device
    # events): time the calls with CUDA events, which include each call's
    # launch overhead (an upper bound of the device time), and say so
    ms = cuda_time_ms(fn, reps)
    log(f"[chip_smoke] {name or 'fn'}: no trace read at or above the bound (readings "
        f"{[round(r, 4) for r in readings]}, the rest lost their device events); CUDA events "
        f"instead: {ms:.4f} ms a call")
    if ms >= floor_ms:
        return ms
    raise AssertionError(f"{name or 'fn'}: CUDA events read {ms:.4f} ms, below the bound "
                         f"{floor_ms:.4f} ms; the traces read {readings}")


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms and what sets it, for a kernel moving nbytes and doing ops
    float32 operations (see PEAK_BYTES_PER_S)."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_F32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "ops": ops}


def time_kernel(res: dict, fn, name: str) -> None:
    """res["ms"]: the kernel's device time (kernel_ms); res["call_ms"]: one
    call of its wrapper bracketed by CUDA events (cuda_time_ms, this
    script's earlier measure), launch overhead and output allocation
    included."""
    res["ms"] = kernel_ms(fn, name, floor_ms=res["bound_ms"])
    res["call_ms"] = cuda_time_ms(fn)


def print_yardsticks(label: str, res: dict) -> None:
    lib = res.get("library_ms")
    log(f"[chip_smoke] {label}: kernel {res['ms']:.4f} ms (one call {res['call_ms']:.4f} "
        f"ms), bound {res['bound_ms']:.4f} ms by {res['bound_by']} "
        f"({res['bytes'] / 1e6:.1f} MB, {res['ops'] / 1e9:.2f} GOP): "
        f"{res['bound_ms'] / res['ms']:.1%} of the bound; plain torch {res['plain_ms']:.4f} "
        f"ms; library call " + (f"{lib:.4f} ms" if lib is not None else "none")
        + (f" (the scatter as render_fast calls it, every footprint entry and a dump "
           f"slot: {res['library_dump_ms']:.4f} ms)" if "library_dump_ms" in res else "")
        + (f"; the per-voxel-atomic body the tile replaced, on the same rows "
           f"{res['atomic_body_ms']:.4f} ms" if "atomic_body_ms" in res else ""))


def make_frame(rng, img_h, img_w, dev):
    """sample_rows inputs: a random 8-channel frame and V rows of pixels."""
    img = np.zeros((img_h, img_w, 8), np.float32)
    img[..., 0] = rng.uniform(0.3, 4.4, (img_h, img_w))
    img[..., 0][rng.uniform(size=(img_h, img_w)) < 0.05] = 0.0
    img[..., 0][rng.uniform(size=(img_h, img_w)) < 0.02] = 4.0
    img[..., 1] = rng.uniform(1.0, 1.3, (img_h, img_w))
    img[..., 2:5] = rng.integers(0, 256, (img_h, img_w, 3))
    img[..., 5:7] = rng.uniform(0, 1, (img_h, img_w, 2))
    img[..., 5][rng.uniform(size=(img_h, img_w)) < 0.02] = 0.0
    img[..., 6][rng.uniform(size=(img_h, img_w)) < 0.02] = 1.0
    # every block's voxels fall in a 14x14 footprint; 1% land off-image
    u = rng.integers(0, img_w - 14, (V, 1)) + rng.integers(0, 14, (V, 512))
    v = rng.integers(0, img_h - 14, (V, 1)) + rng.integers(0, 14, (V, 512))
    off = rng.uniform(size=(V, 512)) < 0.01
    u[off] = np.where(rng.uniform(size=off.sum()) < 0.5, -3, img_w + 2)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)  # noqa: E731
    return t(img, np.float32), t(u, np.int32), t(v, np.int32)


def make_pool(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    tsdf = torch.rand((POOL, 512), generator=g, device=dev) * 2 - 1
    w = torch.randint(0, 41, (POOL, 512), generator=g, device=dev, dtype=torch.int32)
    w = torch.where(torch.rand((POOL, 512), generator=g, device=dev) < 0.2, 0, w)
    rgb = torch.randint(0, 1 << 24, (POOL, 512), generator=g, device=dev,
                        dtype=torch.int32)
    prob = torch.rand((POOL, 512), generator=g, device=dev)
    prob = torch.where(torch.rand((POOL, 512), generator=g, device=dev) < 0.02, 0.0, prob)
    prob = torch.where(torch.rand((POOL, 512), generator=g, device=dev) < 0.02, 1.0, prob)
    return tsdf, rgb | (w << 24), prob


def block_rows(seed, img_h, img_w, about_z, dev):
    """fuse_rows inputs at the slice's shapes (tests/torch_cases.py's
    block_case at the bench preset's 4 mm voxels, V rows, COUNT live):
    (frame, block_pos, pool_idx, geometry kwargs) on the card."""
    from tests.torch_cases import block_case

    c = block_case(seed, img_h, img_w, V, COUNT, POOL, voxel_size=0.004, about_z=about_z,
                   with_pool=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(c["img"]), t(c["block_pos"]), t(c["pool_idx"]),
            dict(cam_T_world=c["pose"], intrinsics=c["intrinsics"],
                 voxel_size=c["voxel_size"]))


def updated_voxels(fuse_kernel, img, block_pos, count, consts) -> int:
    """Voxels of the live rows that take the update (in the image, with a
    valid depth, not far behind the surface), from the plain projection:
    the ones whose rgbw and prob words fuse_rows must read."""
    n = int(count)
    img_h, img_w, _ = img.shape
    u, v, z = fuse_kernel.project_rows(block_pos[:n], consts["cam_T_world"],
                                       consts["intrinsics"], consts["voxel_size"])
    in_img = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    pix = (v.clamp_(0, img_h - 1) * img_w + u.clamp_(0, img_w - 1)).long()
    del u, v
    flat = img.view(-1, 8)
    depth, d2r = flat[:, 0][pix], flat[:, 1][pix]
    sdf = d2r * (depth - z)
    upd = (in_img & (depth > 0) & (depth <= consts["max_depth"])
           & (sdf > -consts["truncation"]))
    return int(upd.sum().item())


def compare_fuse(fuse_kernel, img, block_pos, pool_idx, count, pool, consts, label):
    """fuse_rows against its plain version on copies of the pool arrays
    (each clone of a bench pool is 0.5 GB): tsdf, rgbw and min |tsdf| of
    the live rows bit-equal, prob within 1e-6 (expf/logf of the kernel vs
    torch's exp/log).  Returns (max_abs_err, pool words written, voxels
    updated)."""
    n = int(count)
    live = pool_idx[:n].long()
    ours = [a.clone() for a in pool]
    ref = [a.clone() for a in pool]
    minabs = fuse_kernel.fuse_rows(img, block_pos, pool_idx, count, *ours, **consts)
    minabs_ref = fuse_kernel.fuse_rows_reference(img, block_pos, pool_idx, count, *ref,
                                                 **consts)
    torch.cuda.synchronize()
    err = {
        "tsdf": (ours[0] - ref[0]).abs().max().item(),
        "rgbw": int((ours[1] != ref[1]).sum().item()),
        "prob": (ours[2] - ref[2]).abs().max().item(),
        "minabs": (minabs[:n] - minabs_ref[:n]).abs().max().item(),
    }
    # pool words this call must write: those it changed
    written = sum(int((a[live] != a0[live]).sum().item()) for a, a0 in zip(ours, pool))
    updated = updated_voxels(fuse_kernel, img, block_pos, count, consts)
    log(f"[chip_smoke] fuse_rows {label}, V={block_pos.shape[0]}, count={n}: "
        f"max|dtsdf|={err['tsdf']:.3g} rgbw words differing={err['rgbw']} "
        f"max|dprob|={err['prob']:.3g} max|dminabs|={err['minabs']:.3g} "
        f"(pool words of the live rows changed {written / (3 * 512 * max(n, 1)):.4f}, "
        f"voxels updated {updated / (512 * max(n, 1)):.4f})")
    if err["tsdf"] != 0 or err["rgbw"] != 0 or err["minabs"] != 0 or err["prob"] > 1e-6:
        raise AssertionError(f"fuse_rows disagrees with its plain version ({label}): {err}")
    if written == 0:
        raise AssertionError(f"fuse_rows {label}: nothing fused")
    # rgbw enters as the largest difference of its r, g, b and weight bytes
    rgbw_err = (ours[1].view(torch.uint8).int() - ref[1].view(torch.uint8).int()).abs().max()
    del ours, ref
    return max(err["tsdf"], err["prob"], err["minabs"], rgbw_err.item()), written, updated


def fuse_rows_yardsticks(fuse_kernel, img, block_pos, pool_idx, count, pool, consts,
                         written, updated, label):
    """Kernel and plain times (the plain one on a copy of the pool) and
    the bound: the live rows' block coordinates and pool indices, count,
    the tsdf word of every live voxel (min |tsdf| and the update test
    need it) and the rgbw and prob words of the updated voxels, the
    changed words written, min |tsdf| per live row, the frame."""
    n = int(count)
    voxels = n * 512
    res = bound(16 * n + 4 + 4 * voxels + 8 * updated + 4 * written + 4 * n
                + img.numel() * 4, OPS_PER_VOXEL["fuse_rows"] * voxels)
    res["library_ms"] = None  # no single torch call computes it
    time_kernel(res, lambda: fuse_kernel.fuse_rows(
        img, block_pos, pool_idx, count, *pool, **consts), "fuse_rows_kernel")
    ref = [a.clone() for a in pool]
    res["plain_ms"] = cuda_time_ms(lambda: fuse_kernel.fuse_rows_reference(
        img, block_pos, pool_idx, count, *ref, **consts))
    del ref
    print_yardsticks(f"fuse_rows {label}", res)
    return res


def check_fuse_rows(fuse_kernel, img_h, img_w, seed, dev, about_z, timed):
    """fuse_rows against its plain version on synthetic rows placed in the
    frustum (phase 2); with `timed`, then its yardsticks (phase 7)."""
    img, block_pos, pool_idx, geometry = block_rows(seed, img_h, img_w, about_z, dev)
    count = torch.tensor(COUNT, dtype=torch.int32, device=dev)
    pool = make_pool(dev, seed)
    consts = dict(CONSTS, **geometry)
    # the corners the case claims, from the plain projection
    u, v, z = fuse_kernel.project_rows(block_pos[:COUNT], geometry["cam_T_world"],
                                       geometry["intrinsics"], geometry["voxel_size"])
    in_img = ((u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)).float().mean().item()
    corners = {"in_image": in_img, "behind": (z < 0).float().mean().item(),
               "z0": int((z == 0).sum().item())}
    del u, v, z
    log(f"[chip_smoke] fuse_rows {img_w}x{img_h} rows: voxels in the image {in_img:.4f}, "
        f"behind the camera {corners['behind']:.4f}, at z = 0 {corners['z0']}")
    if not (corners["behind"] > 0 and in_img < 1 and (corners["z0"] > 0) == about_z):
        raise AssertionError(f"fuse_rows rows miss a corner: {corners}")
    err, written, updated = compare_fuse(fuse_kernel, img, block_pos, pool_idx, count, pool,
                                         consts, f"{img_w}x{img_h}")
    res = {"max_abs_err": err, **corners}
    if timed:
        res.update(fuse_rows_yardsticks(fuse_kernel, img, block_pos, pool_idx, count, pool,
                                        consts, written, updated, f"{img_w}x{img_h}"))
    return res


def check_sample_rows(sample_kernel, dev, timed):
    rng = np.random.default_rng(7)
    img, u, v = make_frame(rng, H, W, dev)
    count = torch.tensor(COUNT, dtype=torch.int32, device=dev)
    chans, valid = sample_kernel.sample_rows(img, u, v, count)
    chans_ref, valid_ref = sample_kernel.sample_rows_reference(img, u, v, count)
    torch.cuda.synchronize()
    err = (chans[:, :COUNT] - chans_ref[:, :COUNT]).abs().max().item()
    bad_valid = int((valid[:COUNT] != valid_ref[:COUNT]).sum().item())
    log(f"[chip_smoke] sample_rows {W}x{H}, V={V}, count={COUNT}: "
        f"max|dchan|={err} validity differing={bad_valid} "
        f"(in-image share {valid[:COUNT].float().mean().item():.4f})")
    if err != 0 or bad_valid:
        raise AssertionError("sample_rows disagrees with its plain version")
    res = {"max_abs_err": err}
    if not timed:
        return res
    # u, v of the live voxels and count; 8 channels and validity out; the frame
    voxels = COUNT * 512
    res.update(bound(8 * voxels + 4 + 33 * voxels + img.numel() * 4,
                     OPS_PER_VOXEL["sample_rows"] * voxels))
    time_kernel(res, lambda: sample_kernel.sample_rows(img, u, v, count), "sample_rows_kernel")
    res["plain_ms"] = cuda_time_ms(
        lambda: sample_kernel.sample_rows_reference(img, u, v, count))
    # the library yardstick: one index_select of the live voxels' 32-byte
    # pixel rows (indices built outside the timed window)
    flat = (v[:COUNT].clamp(0, H - 1) * W + u[:COUNT].clamp(0, W - 1)).reshape(-1).long()
    rows8 = img.view(-1, 8)
    res["library_ms"] = kernel_ms(lambda: rows8.index_select(0, flat))
    print_yardsticks("sample_rows 640x480", res)
    return res


def make_splat_pool(dev, seed, voxel_size, truncation):
    """The pool of make_pool, its tsdf redrawn for the splat kernels
    (tests/torch_cases.py's splat_pool, on the card): 60% of voxels
    inside the surface band, from 8 levels so that neighbouring voxels tie
    at a pixel, the rest outside it."""
    _, rgbw, prob = make_pool(dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    band = 1.25 * voxel_size / truncation
    shape = (POOL, 512)
    levels = torch.arange(-3.5, 4.0, device=dev) / 4.0 * band
    inside = levels[torch.randint(0, 8, shape, generator=g, device=dev)]
    sign = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5, -1.0, 1.0)
    outside = sign * (1.01 * band + torch.rand(shape, generator=g, device=dev)
                      * (1.0 - 1.01 * band))
    tsdf = torch.where(torch.rand(shape, generator=g, device=dev) < 0.6, inside, outside)
    return tsdf.float().contiguous(), rgbw, prob


def make_splat_blocks(seed, img_h, img_w, dev, about_z=False):
    """Splat kernel inputs at the render's capacity: tests/torch_cases.py's
    splat_block_case at the bench preset's 4 mm voxels and 24 mm
    truncation, SPLAT_ROWS rows of which SPLAT_COUNT live, placed about a
    surface in front of the camera, with rows behind the camera and off
    the image, 5% of the live rows near the camera (footprints wider than
    the kernels' 32x32 tile) and, with about_z, voxels at camera z = 0 and
    each block layer at one depth; the pool of make_splat_pool.  -> (rows
    (block_pos, pool_idx, count), pool (tsdf, rgbw, prob), geometry
    keywords) on the card."""
    from disinfect_slam_tpu_torch.core.geometry import CameraParams
    from tests.torch_cases import splat_block_case

    c = splat_block_case(seed, img_h, img_w, SPLAT_ROWS, SPLAT_COUNT, POOL,
                         voxel_size=SPLAT_VOXEL, truncation=SPLAT_TRUNC, about_z=about_z,
                         with_pool=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rows = (t(c["block_pos"]), t(c["pool_idx"]),
            torch.tensor(SPLAT_COUNT, dtype=torch.int32, device=dev))
    geometry = dict(cam_T_world=c["pose"], cam=CameraParams.create(c["intrinsics"], img_h, img_w),
                    voxel_size=c["voxel_size"], truncation=c["truncation"],
                    max_depth=c["max_depth"], band=c["band"])
    return rows, make_splat_pool(dev, seed, SPLAT_VOXEL, SPLAT_TRUNC), geometry


def u32_err(a, b) -> int:
    """Largest difference of two buffers of u32 bits held as i32."""
    return int(((a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)).abs().max().item())


def splat_corners(splat_kernel, fuse_kernel, rows, geometry, planes) -> dict:
    """The corners the synthetic splat rows claim, from the plain
    projection of the live rows: the share of voxels behind the camera,
    the voxels at camera z = 0, the share in the surface band."""
    n = int(rows[2])
    _, _, z = fuse_kernel.project_rows(rows[0][:n], geometry["cam_T_world"],
                                       geometry["cam"].intrinsics, geometry["voxel_size"])
    return {"behind": (z < 0).float().mean().item(), "z0": int((z == 0).sum().item()),
            "surface_band": (planes[2][:n] < splat_kernel.BIG).float().mean().item()}


def check_splat(splat_kernel, fuse_kernel, img_h, img_w, seed, dev, timed, about_z=False):
    """The two splat kernels against their plain versions on block rows,
    bit for bit; each kernel's rows on its tile and atomic branches
    counted (both must be taken); with `timed`, the yardsticks."""
    from disinfect_slam_tpu_torch.ops.cuda import splat_probe

    rows, pool, geometry = make_splat_blocks(seed, img_h, img_w, dev, about_z)
    tsdf = pool[0]
    branches = [torch.zeros(2, dtype=torch.int32, device=dev) for _ in range(2)]
    zbuf = splat_kernel.splat_zbuf_blocks(*rows, tsdf, **geometry, branch_counts=branches[0])
    pbuf = splat_kernel.splat_payload_blocks(*rows, *pool, zbuf, **geometry,
                                             branch_counts=branches[1])
    zref = splat_kernel.splat_zbuf_blocks_reference(*rows, tsdf, **geometry)
    pref = splat_kernel.splat_payload_blocks_reference(*rows, *pool, zref, **geometry)
    torch.cuda.synchronize()
    z_err, p_err = u32_err(zbuf, zref), u32_err(pbuf, pref)
    covered = (zbuf < splat_kernel.BIG).float().mean().item()
    top = (pbuf < 0).float().mean().item()
    planes = splat_kernel.splat_planes(*rows, tsdf, **geometry)
    corners = splat_corners(splat_kernel, fuse_kernel, rows, geometry, planes)
    label = f"{img_w}x{img_h}" + (" about z" if about_z else "")
    zb, pb = (b.tolist() for b in branches)
    log(f"[chip_smoke] splat {label}, S={SPLAT_ROWS}, count={SPLAT_COUNT}: "
        f"zbuf max|d|={z_err}, pbuf max|d|={p_err} (pixels covered {covered:.4f}, "
        f"payload words with the top bit set {top:.4f}; live voxels in the surface band "
        f"{corners['surface_band']:.4f}, behind the camera {corners['behind']:.4f}, at z = 0 "
        f"{corners['z0']}); rows on the tile / atomic branch: splat_zbuf_blocks {zb}, "
        f"splat_payload_blocks {pb}")
    if not (torch.equal(zbuf, zref) and torch.equal(pbuf, pref)):
        raise AssertionError(f"splat kernels disagree with their plain versions at {label}")
    if top == 0 or covered == 0:
        raise AssertionError("splat inputs exercised no top-bit payload")
    if not (corners["behind"] > 0 and (corners["z0"] > 0) == about_z):
        raise AssertionError(f"splat rows miss a corner: {corners}")
    if not all(zb + pb):
        raise AssertionError(f"splat {label}: a branch of a splat kernel was not taken")
    res = {"zbuf": {"max_abs_err": z_err, "branches": zb},
           "payload": {"max_abs_err": p_err, "branches": pb}, "corners": corners}
    if not timed:
        return res
    zres, pres = splat_bound_and_library(splat_kernel, rows, pool, geometry, planes, zbuf, pbuf)
    res["zbuf"].update(zres)
    res["payload"].update(pres)
    time_kernel(res["zbuf"], lambda: splat_kernel.splat_zbuf_blocks(*rows, tsdf, **geometry),
                "splat_zbuf_tile_kernel")
    res["zbuf"]["plain_ms"] = cuda_time_ms(
        lambda: splat_kernel.splat_zbuf_blocks_reference(*rows, tsdf, **geometry))
    time_kernel(res["payload"], lambda: splat_kernel.splat_payload_blocks(
        *rows, *pool, zbuf, **geometry), "splat_payload_tile_kernel")
    res["payload"]["plain_ms"] = cuda_time_ms(
        lambda: splat_kernel.splat_payload_blocks_reference(*rows, *pool, zbuf, **geometry))
    # the z-buffer body the tile replaced (one global atomic per footprint
    # pixel, kept in the probe's source, projecting as K4 does) on the same
    # rows
    res["zbuf"]["atomic_body_ms"] = kernel_ms(lambda: splat_probe.zbuf_atomic(
        *rows, tsdf, **geometry), "probe_zbuf_atomic_kernel", floor_ms=res["zbuf"]["bound_ms"])
    for name, key in (("splat_zbuf_blocks", "zbuf"), ("splat_payload_blocks", "payload")):
        print_yardsticks(f"{name} {img_w}x{img_h}", res[key])
    return res


def splat_bound_and_library(splat_kernel, rows, pool, geometry, planes, zbuf, pbuf):
    """The splat merges' bounds from these inputs, and their library
    yardsticks: one scatter_reduce_ ("amin" into the z-buffer, "amax" of
    the winners' words into the payload buffer) over the in-image
    footprint pixels, with the indices built outside the timed window;
    each must give the kernel's buffer.  Returns the z-buffer's and the
    payload's entries.

    Bytes: 16 per live row (block position, pool index), the tsdf word of
    every live voxel, then for K4 the z-buffer written once; for K5 the
    z-buffer read once, 8 per winning voxel (its RGBW word and
    probability) and the payload buffer written once.  Operations: the
    band test of every live voxel, the projection of the voxels inside
    the tsdf band, the footprint merges of the surface-band voxels."""
    rf = splat_kernel.rf
    u0, v0, dq = planes
    block_pos, pool_idx, count_t = rows
    tsdf, rgbw, prob = pool
    img_h, img_w = geometry["cam"].img_h, geometry["cam"].img_w
    n_pix = img_h * img_w
    count = int(count_t)
    band = torch.zeros_like(dq, dtype=torch.bool)
    band[:count] = dq[:count] < splat_kernel.BIG
    n_band = int(band.sum().item())
    band_tsdf = geometry["band"] * geometry["voxel_size"] / geometry["truncation"]
    projected = int((tsdf[pool_idx[:count].long()].abs() < band_tsdf).sum().item())
    pix = rf.footprint(u0, v0, band, img_h, img_w)
    keep = pix < n_pix
    dq4 = dq.expand(pix.shape)
    won = keep & (dq4 == zbuf[pix.clamp(max=n_pix - 1)])
    winners = int(won.any(0).sum().item())
    live = count * 512
    rows_bytes = 16 * count + 4 + 4 * live
    ops = 2 * live + OPS_PER_VOXEL["splat_project"] * projected + OPS_PER_VOXEL["splat"] * n_band
    zres = bound(rows_bytes + 4 * n_pix, ops)
    pres = bound(rows_bytes + 4 * n_pix + 8 * winners + 4 * n_pix, ops)
    z_idx, z_val = pix[keep], dq4[keep]
    p_idx = pix[won]
    pool_rows = pool_idx.clamp(0, rgbw.shape[0] - 1).long()
    packed = rf.pack_payload_rgbw(rgbw[pool_rows], prob[pool_rows])
    p_val = packed.expand(pix.shape)[won]
    pix_all, dq4_all = pix.reshape(-1), dq4.reshape(-1)
    won_all = torch.where(won, pix, n_pix).reshape(-1)
    packed_all = packed.expand(pix.shape).reshape(-1)
    del pix, keep, dq4, won, band, packed
    z_base = torch.full((n_pix,), splat_kernel.BIG, dtype=torch.int32, device=dq.device)
    p_base = torch.zeros((n_pix,), dtype=torch.int64, device=dq.device)
    lib_z = z_base.scatter_reduce(0, z_idx, z_val, "amin")
    lib_p = p_base.scatter_reduce(0, p_idx, p_val, "amax")
    lib_p = torch.where(lib_p >= 1 << 31, lib_p - (1 << 32), lib_p).to(torch.int32)
    if not (torch.equal(lib_z, zbuf) and torch.equal(lib_p, pbuf)):
        raise AssertionError("the splat library yardsticks compute another function")
    zres["library_ms"] = kernel_ms(lambda: z_base.scatter_reduce(0, z_idx, z_val, "amin"))
    pres["library_ms"] = kernel_ms(lambda: p_base.scatter_reduce(0, p_idx, p_val, "amax"))
    # beside them, the same calls as render_fast makes them: every
    # footprint entry, those that merge nothing sent to a dump slot
    dump_z = torch.full((n_pix + 1,), splat_kernel.BIG, dtype=torch.int32, device=dq.device)
    dump_p = torch.zeros((n_pix + 1,), dtype=torch.int64, device=dq.device)
    zres["library_dump_ms"] = kernel_ms(lambda: dump_z.scatter_reduce(
        0, pix_all, dq4_all, "amin"))
    pres["library_dump_ms"] = kernel_ms(lambda: dump_p.scatter_reduce(
        0, won_all, packed_all, "amax"))
    log(f"[chip_smoke] splat {img_w}x{img_h}: {count} live rows, {projected} voxels in the "
        f"tsdf band (projected), {n_band} in the surface band, {winners} winners, "
        f"{z_idx.numel()} footprint pixels")
    return zres, pres


def reset_launches(*fns) -> None:
    for fn in fns:
        fn.launches = 0


def replay(offline, sampler: str, save: str, render_dir=None, extra=()):
    argv = ["--logdir", DATASET, "--config", os.path.join(DATASET, "cam.yaml"),
            "--preset", "bench", "--device", "cuda", "--sampler", sampler,
            "--prefetch", "0", "--save", save, *extra]
    if render_dir:
        argv += ["--render-dir", render_dir, "--renderer", "auto"]
    return offline.main(argv)


def check_fingerprint(grid, records, ref, label, prob_tol=TOL_WP):
    from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
    from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint

    fp = volume_fingerprint(volume_to_numpy(grid.volume))
    fp["records"] = records
    return check_fingerprint_dict(fp, ref, label, prob_tol)


def check_fingerprint_dict(fp, ref, label, prob_tol=TOL_WP):
    """A volume_fingerprint (with its record count) against the
    reference's, within ops/gather.py's limits (prob: prob_tol)."""
    checks = fingerprint_gaps(fp, ref, prob_tol)
    for k, (dev_, tol) in checks.items():
        log(f"[chip_smoke] {label} {k}: port {fp[k]} reference {ref[k]} "
            f"rel dev {dev_:.3e} (limit {tol:g})")
    log(f"[chip_smoke] {label} oob_count: port {fp['oob_count']} reference "
        f"{ref['oob_count']}; live-block key hash matches exactly: "
        f"{fp['keys_sha256'] == ref['keys_sha256']}")
    failed = {k: v for k, v in checks.items() if not v[0] <= v[1]}
    if failed:
        raise AssertionError(f"{label}: fingerprint outside tolerance: {failed}")
    return fp


def check_dump(path: str, records: int) -> None:
    from disinfect_slam_tpu_torch.ops.gather import load_spatial_tsdf

    rec = load_spatial_tsdf(path)
    if rec.shape != (records, 4) or not np.isfinite(rec).all():
        raise AssertionError(f"{path}: bad dump {rec.shape}")
    if not (np.abs(rec[:, 3]) <= 1.0).all():
        raise AssertionError(f"{path}: tsdf outside [-1, 1]")


def check_render_fingerprint(fp, ref, label):
    """A splat render's fingerprint (render_fast.render_fingerprint)
    against the JAX reference's for the same view."""
    checks = {"hits": (fp["hits"], ref["hits"]),
              "sum_depth": (fp["sum_depth"], ref["sum_depth"]),
              "surf_blocks": (fp["surf_blocks"], ref["surf_blocks"])}
    for c in range(4):
        checks[f"sum_rgba[{c}]"] = (fp["sum_rgba"][c], ref["sum_rgba"][c])
        checks[f"sum_normal[{c}]"] = (fp["sum_normal"][c], ref["sum_normal"][c])
    failed = {}
    for k, (ours, theirs) in checks.items():
        dev_ = abs(ours - theirs) / max(abs(theirs), 1.0)
        log(f"[chip_smoke] {label} {k}: port {ours} reference {theirs} rel dev "
            f"{dev_:.3e} (limit {TOL_RENDER:g})")
        if not dev_ <= TOL_RENDER:
            failed[k] = dev_
    ov_dev = abs(fp["surf_overflow"] - ref["surf_overflow"]) / max(ref["surf_blocks"], 1)
    log(f"[chip_smoke] {label} surf_overflow: port {fp['surf_overflow']} reference "
        f"{ref['surf_overflow']} ({ov_dev:.3e} of the surface blocks, limit 1e-3)")
    if not ov_dev <= 1e-3:
        failed["surf_overflow"] = ov_dev
    if failed:
        raise AssertionError(f"{label}: render fingerprint outside tolerance: {failed}")


def render_split(grid, intrinsics, poses) -> dict:
    """Where a render's time goes, in any tree of the port (it uses only
    what every tree has; scripts/port_render_stage.py runs it against
    another checkout's package): on the frame-0 view of `grid` at 640x480,
    CUDA-event ms (median of 10) of the surface set
    (render_fast._surf_visible), the plain projection of the surface rows
    (render_fast._project_for_splat, surface set included: the card path's
    projection while the kernels read [S, 512] planes, the plain path's
    alone once they project in registers), the card path's buffers
    (splat_kernel.splat_buffers_cuda), the image assembly and the whole
    render (TSDFGrid.ray_cast, renderer "auto"), and the two kernels'
    device times within the card path's buffers (profiler, by name); then
    five renders (the poses of frames 0-4) under the profiler: wall and
    device kernel ms, kernels per render, idle share."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.ops import render_fast as rf
    from disinfect_slam_tpu_torch.ops.cuda import splat_kernel as sk

    vol, view = grid.volume, (intrinsics, H, W)
    cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), H, W)
    pose0, cap = SE3.from_matrix(poses[0]), rf.DEFAULT_SURF_CAP
    bufs = sk.splat_buffers_cuda(vol, cam, pose0, RENDER_MAX_DEPTH)
    stages = {
        "surface set": cuda_time_ms(lambda: rf._surf_visible(vol, cam, pose0, 1.25, cap)),
        "plain projection, with the surface set": cuda_time_ms(
            lambda: rf._project_for_splat(vol, cam, pose0, RENDER_MAX_DEPTH, 1.25, cap)),
        "card path buffers": cuda_time_ms(
            lambda: sk.splat_buffers_cuda(vol, cam, pose0, RENDER_MAX_DEPTH)),
        "images_from_buffers": cuda_time_ms(
            lambda: rf.images_from_buffers(bufs[0], bufs[1], cam)),
        "render": cuda_time_ms(
            lambda: grid.ray_cast(RENDER_MAX_DEPTH, view, poses[0], renderer="auto")),
    }
    log("[chip_smoke] render frame 0 split, CUDA-event ms (median of 10): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    frames = poses[:5]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pose in frames:
            grid.ray_cast(RENDER_MAX_DEPTH, view, pose, renderer="auto")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    n = len(frames)
    prof_res = {"renders": n, "wall_ms": wall_ms, "device_ms": device_ms,
                "kernels": len(events), "wall_ms_per_render": wall_ms / n,
                "device_ms_per_render": device_ms / n, "kernels_per_render": len(events) / n,
                "idle_share": 1 - device_ms / wall_ms if device_ms else None}
    log(f"[chip_smoke] render profile ({n} renders): wall {wall_ms / n:.3f} ms/render, device "
        f"kernel time {device_ms / n:.3f} ms/render in {len(events) / n:.1f} kernels/render, "
        f"idle share " + (f"{prof_res['idle_share']:.3f}" if device_ms else "not measured"))
    card = lambda: sk.splat_buffers_cuda(vol, cam, pose0, RENDER_MAX_DEPTH)  # noqa: E731
    kernels = {k: kernel_ms(card, k) for k in ("splat_zbuf", "splat_payload")}
    log(f"[chip_smoke] render frame 0 kernels, device ms: {kernels}")
    return {"stages_ms": stages, "profile": prof_res, "kernel_ms": kernels}


def render_views(grid, render_fast, splat_kernel, intrinsics, poses, ref):
    """Phase 5: the render slice on the fused volume (see the docstring).
    Returns the report entries and the main path's launch counts."""
    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams

    kernels = (splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks)
    view = (intrinsics, H, W)
    cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), H, W)
    frames = poses[:5]
    reset_launches(*kernels)
    grid.ray_cast(RENDER_MAX_DEPTH, view, frames[0], renderer="auto")  # warm-up
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pose in frames:
            grid.ray_cast(RENDER_MAX_DEPTH, view, pose, renderer="auto")
        torch.cuda.synchronize()
        passes.append(1e3 * (time.perf_counter() - t0) / len(frames))
    launches = [fn.launches for fn in kernels]
    n_renders = 1 + 3 * len(frames)
    splat_ms = statistics.median(passes)
    log(f"[chip_smoke] render: splat ms/render {passes} -> median {splat_ms:.3f} "
        f"(640x480, frames 0-4); launches {launches} for {n_renders} renders")
    if launches != [n_renders, n_renders]:
        raise AssertionError(f"splat kernels launched {launches} times for "
                             f"{n_renders} renders")

    # frame 0: kernels against the plain torch splat on the same volume
    vol, pose0, cfg = grid.volume, SE3.from_matrix(frames[0]), grid.cfg
    res = grid.ray_cast(RENDER_MAX_DEPTH, view, frames[0], renderer="auto")
    bufs = splat_kernel.splat_buffers_cuda(vol, cam, pose0, RENDER_MAX_DEPTH)
    plain_bufs = render_fast.splat_buffers(vol, cam, pose0, RENDER_MAX_DEPTH)
    plain = render_fast.images_from_buffers(plain_bufs[0], plain_bufs[1], cam)
    torch.cuda.synchronize()
    equal = {"zbuf": torch.equal(bufs[0], plain_bufs[0]),
             "pbuf": torch.equal(bufs[1], plain_bufs[1]),
             **{f: torch.equal(getattr(res, f), getattr(plain, f))
                for f in ("rgba", "normal", "depth", "hit")}}
    kept, overflow = int(bufs[3]), int(bufs[2])
    log(f"[chip_smoke] render frame 0: bit-equal to the plain splat {equal}; "
        f"surface blocks {kept + overflow}, kept {kept}, surf_overflow {overflow}; "
        f"hit share {res.hit.float().mean().item():.4f}")
    if not all(equal.values()):
        raise AssertionError(f"the splat kernels' render differs from the plain one: {equal}")
    err = {"zbuf": u32_err(bufs[0], plain_bufs[0]), "pbuf": u32_err(bufs[1], plain_bufs[1])}

    # the two kernels on the frame-0 surface rows, their branches counted
    vis, _ = render_fast.splat_visible(vol, cam, pose0, 1.25, render_fast.DEFAULT_SURF_CAP)
    rows = (vis.block_pos, vis.pool_idx, vis.count)
    geometry = dict(cam_T_world=pose0, cam=cam, voxel_size=cfg.voxel_size,
                    truncation=cfg.truncation, max_depth=RENDER_MAX_DEPTH, band=1.25)
    branches = [torch.zeros(2, dtype=torch.int32, device=vol.device) for _ in range(2)]
    zbuf = splat_kernel.splat_zbuf_blocks(*rows, vol.tsdf, **geometry,
                                          branch_counts=branches[0])
    pbuf = splat_kernel.splat_payload_blocks(*rows, vol.tsdf, vol.rgbw, vol.prob, zbuf,
                                             **geometry, branch_counts=branches[1])
    if not (torch.equal(zbuf, plain_bufs[0]) and torch.equal(pbuf, plain_bufs[1])):
        raise AssertionError("the splat kernels differ from the plain buffers on frame 0")
    zbuf_branches, payload_branches = (b.tolist() for b in branches)
    log(f"[chip_smoke] render frame 0: both kernels bit-equal to the plain buffers; "
        f"surface blocks on the tile / atomic branch: splat_zbuf_blocks {zbuf_branches}, "
        f"splat_payload_blocks {payload_branches}")
    # the render's own stages, device time by CUDA events (median of 10):
    # the projection runs in the kernels on the card path; the plain one is
    # timed beside them
    pool = (vol.tsdf, vol.rgbw, vol.prob)
    stages = {
        "surface set (splat_visible)": cuda_time_ms(lambda: render_fast.splat_visible(
            vol, cam, pose0, 1.25, render_fast.DEFAULT_SURF_CAP)),
        "plain projection (not on the card path)": cuda_time_ms(
            lambda: render_fast.project_splat_rows(
                *rows, vol.tsdf, pose0, cam, cfg.voxel_size, cfg.truncation, RENDER_MAX_DEPTH,
                1.25)),
        "splat_zbuf_blocks": cuda_time_ms(lambda: splat_kernel.splat_zbuf_blocks(
            *rows, vol.tsdf, **geometry)),
        "splat_payload_blocks": cuda_time_ms(lambda: splat_kernel.splat_payload_blocks(
            *rows, *pool, zbuf, **geometry)),
        "plain zbuf": cuda_time_ms(lambda: splat_kernel.splat_zbuf_blocks_reference(
            *rows, vol.tsdf, **geometry)),
        "plain payload": cuda_time_ms(lambda: splat_kernel.splat_payload_blocks_reference(
            *rows, *pool, zbuf, **geometry)),
        "images_from_buffers": cuda_time_ms(
            lambda: render_fast.images_from_buffers(bufs[0], bufs[1], cam)),
        "plain splat_render": cuda_time_ms(
            lambda: render_fast.splat_render(vol, cam, pose0, RENDER_MAX_DEPTH)),
    }
    log("[chip_smoke] render frame 0 stages, CUDA-event ms (median of 10): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    del plain_bufs, plain, zbuf, pbuf
    # the split every tree of the port shares, with the render's profile
    split = render_split(grid, intrinsics, poses)
    reset_launches(*kernels)  # the profiled renders are not the main path's

    # the JAX reference's fingerprints of the frame-0 view and the app's view
    fps = {}
    for name, (i, hgt, wid) in {"frame0": (0, H, W), "app": (-1, 360, 640)}.items():
        vcam = CameraParams.create(CameraIntrinsics.create(*intrinsics), hgt, wid)
        pose = SE3.from_matrix(poses[i])
        zb, pb, ov, kept_i = splat_kernel.splat_buffers_cuda(vol, vcam, pose, RENDER_MAX_DEPTH)
        r = render_fast.images_from_buffers(zb, pb, vcam)
        fps[name] = render_fast.render_fingerprint(
            r.hit.cpu(), r.depth.cpu(), r.rgba.cpu(), r.normal.cpu(), ov.cpu(),
            (kept_i + ov).cpu())
        check_render_fingerprint(fps[name], ref["render"][name], f"render {name}")

    # the parity raycaster on the frame-0 view, and the splat's divergence from it
    grid.ray_cast(RENDER_MAX_DEPTH, view, frames[0], renderer="raycast")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ray = grid.ray_cast(RENDER_MAX_DEPTH, view, frames[0], renderer="raycast")
    torch.cuda.synchronize()
    raycast_ms = 1e3 * (time.perf_counter() - t0)
    d = render_fast.render_divergence(ray, res, intrinsics, grid.cfg.voxel_size)
    p95 = float(np.percentile(d["depth_err"], 95)) if d["depth_err"].size else 0.0
    divergence = {"holes": d["holes"], "p95_depth_err_voxels": p95 / grid.cfg.voxel_size,
                  "bad": d["bad"], "on_edge": d["on_edge"],
                  "rgba_median": [float(v) for v in d["rgba_median"]],
                  "raycast_hit_share": ray.hit.float().mean().item()}
    log(f"[chip_smoke] raycast frame 0: {raycast_ms:.3f} ms (640x480); splat "
        f"divergence from it {divergence}")
    if not ray.hit.any():
        raise AssertionError("the parity raycaster hit nothing")
    report = {"splat_ms_per_render": passes, "splat_ms": splat_ms,
              "zbuf_branches": zbuf_branches, "payload_branches": payload_branches,
              "kernel_ms_frame0": split["kernel_ms"], "surface_blocks": kept + overflow,
              "surf_overflow": overflow, "stages_ms": stages, "split": split["stages_ms"],
              "profile": split["profile"], "fingerprints": fps, "raycast_ms": raycast_ms,
              "divergence": divergence}
    return report, launches, err


def check_seg(seg, dev, rgb0, ref):
    """Phase 6, seg: both shipped nets on frame 0 against the JAX seg
    fingerprint; seg_ms end to end (host u8 in, numpy out) and seg_dev_ms
    on a staged input, medians of 10."""
    out, models = {}, {}
    for arch in ("unet", "fast"):
        model = seg.load_model(arch, device=dev)
        eng = seg.InferenceEngine(model)
        ht, lt = eng.infer_one(rgb0)
        pixels = ht.size
        fp = {"shape": list(ht.shape), "sum_ht": float(ht.astype(np.float64).sum()),
              "sum_lt": float(lt.astype(np.float64).sum()),
              "ht_above_half": int((ht > 0.5).sum()), "lt_above_half": int((lt > 0.5).sum())}
        want = ref[arch]
        failed = [] if fp["shape"] == want["shape"] else ["shape"]
        for k in ("sum_ht", "sum_lt", "ht_above_half", "lt_above_half"):
            tol = (SEG_MEAN_TOL[arch] if k.startswith("sum") else SEG_LABEL_TOL) * pixels
            log(f"[chip_smoke] seg {arch} {k}: port {fp[k]} reference {want[k]} "
                f"|d| {abs(fp[k] - want[k]):.4g} (limit {tol:g})")
            if not abs(fp[k] - want[k]) <= tol:
                failed.append(k)
        if failed:
            raise AssertionError(f"seg {arch} differs from the reference in {failed}")
        ms = []
        for _ in range(11):
            t0 = time.perf_counter()
            eng.infer_one(rgb0)
            ms.append(1e3 * (time.perf_counter() - t0))
        staged = torch.from_numpy(rgb0).to(dev).float()  # as bench.py stages it
        dev_ms = cuda_time_ms(lambda: seg.segment(model, staged, seg.OUTPUT_H, seg.OUTPUT_W))
        out[arch] = {**fp, "seg_ms": statistics.median(ms[1:]), "seg_dev_ms": dev_ms}
        log(f"[chip_smoke] seg {arch}: {out[arch]['seg_ms']:.3f} ms end to end "
            f"(u8 in, numpy out), {dev_ms:.3f} ms on a staged input (medians of 10)")
        models[arch] = model
    return out, models


def online_split(make_step, frames, warm, model, dev):
    """Phase 6, where the time goes: six frames after warm-up split by CUDA
    events into upload + conversion, seg and fusion, as
    FusedOnlineStep.step_device runs them, then one profiled pass over six
    more (device kernel time, kernel launches, idle share).  The split
    comes first, so that no profiler state is left to slow it."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.core.geometry import SE3
    from disinfect_slam_tpu_torch.models.segmentation import segment
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput, integrate

    step = make_step(model)
    for f in frames[:warm]:
        step.step(*f)
    n = 6  # two alloc_every cycles at the bench preset
    names = ("upload + conversion", "seg", "fusion", "frame")
    stages = {k: [] for k in names}
    df = torch.full((), 5000.0, device=dev)
    for i, (rgb, depth, pose) in enumerate(frames[warm:warm + n], start=warm):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        rgb_t = torch.from_numpy(rgb).to(dev).float()
        depth_t = torch.from_numpy(depth).to(dev).float() / df
        ev[1].record()
        ht, lt = segment(model, rgb_t, H, W)
        ev[2].record()
        step.volume = integrate(step.volume, FrameInput(rgb_t, depth_t, ht, lt), step.cam,
                                SE3.from_matrix(pose), step.max_depth,
                                allocate=i % step.cfg.alloc_every == 0)
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(names, ((0, 1), (1, 2), (2, 3), (0, 3))):
            stages[k].append(ev[a].elapsed_time(ev[b]))
    split = {k: statistics.mean(v) for k, v in stages.items()}
    log(f"[chip_smoke] online split, CUDA-event ms/frame (mean of {n}, frames "
        f"{warm}-{warm + n - 1}): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    # the step's own allocation tick did not advance over the split, which
    # is a whole number of alloc_every cycles: the cadence stays the same
    timed = frames[warm + n:warm + 2 * n]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in timed:
            step.step(*f)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    prof_res = {"frames": n, "wall_ms_per_frame": wall_ms / n,
                "device_ms_per_frame": device_ms / n, "kernels_per_frame": len(events) / n,
                "idle_share": 1 - device_ms / wall_ms if device_ms else None}
    log(f"[chip_smoke] online profile (frames {warm + n}-{warm + 2 * n - 1}): wall "
        f"{wall_ms / n:.3f} ms/frame, device kernel time {device_ms / n:.3f} ms/frame in "
        f"{len(events) / n:.1f} kernels/frame, idle share "
        + (f"{prof_res['idle_share']:.3f}" if device_ms else "not measured"))

    # the net alone on a staged frame: its device kernel time and launches
    rgb_t = torch.from_numpy(frames[0][0]).to(dev).float()
    segment(model, rgb_t, H, W)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            segment(model, rgb_t, H, W)
        torch.cuda.synchronize()
        seg_wall = 1e3 * (time.perf_counter() - t0) / 5
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    seg_prof = {"wall_ms": seg_wall,
                "device_ms": sum(e.time_range.elapsed_us() for e in events) / 5e3,
                "kernels": len(events) / 5}
    log(f"[chip_smoke] seg profile (UNet, 5 forwards at {W}x{H}): wall "
        f"{seg_prof['wall_ms']:.3f} ms, device kernel time {seg_prof['device_ms']:.3f} ms "
        f"in {seg_prof['kernels']:.1f} kernels per forward")
    return {"profile": prof_res, "seg_profile": seg_prof, "split_ms_per_frame": split,
            "split_frames": stages}


def online_app(online, fuse_kernel, read_png, render_dir):
    """Phase 6, the app: both paths over all 60 frames through main(argv),
    beside the replay's PNG decode alone (host ms/frame), which the apps'
    frame loops include."""
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay

    t0 = time.perf_counter()
    n = sum(1 for _ in LoggedReplay(DATASET, 5000.0))
    decode_ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"[chip_smoke] app replay decode alone: {decode_ms:.3f} ms/frame over {n} frames")
    base = ["--logdir", DATASET, "--config", os.path.join(DATASET, "cam.yaml"),
            "--segment", "--device", "cuda"]
    res = {"decode_ms_per_frame": decode_ms}
    for name, extra in (("fused", ["--fused", "--render-dir", render_dir]),
                        ("async", ["--fps", "120"])):
        fuse_kernel.fuse_rows.launches = 0
        r = online.main(base + extra)
        launches = fuse_kernel.fuse_rows.launches
        log(f"[chip_smoke] app {name}: {r['frames']} frames, {r['fps']:.3f} FPS, "
            f"{r['active_blocks']} active blocks, fuse_rows launches {launches}")
        if r["frames"] != 60 or r["active_blocks"] <= 0 or launches != 60:
            raise AssertionError(f"app {name}: {r['frames']} frames, {r['active_blocks']} "
                                 f"blocks, fuse_rows launched {launches} times")
        res[name] = {k: r[k] for k in ("frames", "fps", "wall_s", "active_blocks")}
        res[name]["fuse_rows_launches"] = launches
        if name == "fused":
            for path in r["render_paths"]:
                img = read_png(path)
                if img.shape != (360, 640, 4) or img.dtype != np.uint8:
                    raise AssertionError(f"{path}: {img.dtype} {img.shape}")
            res[name]["render_paths"] = [os.path.relpath(p, ROOT) for p in r["render_paths"]]
        del r
        torch.cuda.empty_cache()
    return res


def online_slice(fuse_kernel, sample_kernel, dev, smi, render_dir):
    """Phase 6 (see the docstring); returns the report entry."""
    from disinfect_slam_tpu_torch.apps import online
    from disinfect_slam_tpu_torch.apps.bench import time_online
    from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH
    from disinfect_slam_tpu_torch.io.config_reader import get_intrinsics, load_yaml
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
    from disinfect_slam_tpu_torch.io.png_io import read_image, read_png
    from disinfect_slam_tpu_torch.models import segmentation as seg
    from disinfect_slam_tpu_torch.ops.gather import gather_valid
    from disinfect_slam_tpu_torch.systems.online_step import FusedOnlineStep

    with open(ONLINE_FINGERPRINT) as f:
        ref = json.load(f)
    intrinsics = get_intrinsics(load_yaml(os.path.join(DATASET, "cam.yaml")))
    frames = []
    for fid, pose in LoggedReplay(DATASET, 5000.0).entries[:ONLINE_FRAMES]:
        base = os.path.join(DATASET, str(fid))
        frames.append((read_image(base + "_rgb.png"),
                       read_image(base + "_depth.png", unchanged=True), pose))
    if frames[0][0].dtype != np.uint8 or frames[0][1].dtype != np.uint16:
        raise AssertionError("orbit_vga frames are not u8 rgb / u16 depth")

    seg_res, models = check_seg(seg, dev, frames[0][0], ref["seg_frame0"])
    warm = BENCH.alloc_every

    def make_step(model):
        return FusedOnlineStep(BENCH, intrinsics, H, W, BENCH_MAX_DEPTH, seg_model=model,
                               depth_factor=5000.0, device=dev)

    def run(arch, label):
        reset_launches(fuse_kernel.fuse_rows, sample_kernel.sample_rows)
        step = make_step(models[arch])
        fps = time_online(step, frames, warm)
        launches = (fuse_kernel.fuse_rows.launches, sample_kernel.sample_rows.launches)
        if launches != (len(frames), 0):
            raise AssertionError(f"{label}: fuse_rows / sample_rows launched {launches} "
                                 f"times for {len(frames)} frames")
        # FastSeg is not the reference's net: its volume holds the
        # geometry limits, and prob is not compared
        fp = check_fingerprint(step, int(gather_valid(step.volume).count), ref, label,
                               prob_tol=TOL_ONLINE_PROB if arch == "unet" else float("inf"))
        del step
        torch.cuda.empty_cache()
        log(f"[chip_smoke] {label}: {fps:.3f} FPS over frames {warm}-{len(frames) - 1}; "
            f"fuse_rows launches {launches[0]}, sample_rows {launches[1]}")
        return fps, launches[0], fp

    runs = [run("unet", f"online run {i}") for i in range(3)]
    online_fps = statistics.median(r[0] for r in runs)
    fast_fps, fast_launches, fp_fast = run("fast", "online fastseg")
    log(f"[chip_smoke] online_fps {[r[0] for r in runs]} -> median {online_fps:.3f}; "
        f"online_fps_fast {fast_fps:.3f} ({smi})")
    split = online_split(make_step, frames, warm, models["unet"], dev)
    del models
    torch.cuda.empty_cache()
    app = online_app(online, fuse_kernel, read_png, render_dir)
    return {"seg": seg_res, "online_fps_runs": [r[0] for r in runs], "online_fps": online_fps,
            "online_fps_fast": fast_fps, "online_launches": runs[-1][1],
            "online_fast_launches": fast_launches, "fingerprint_online": runs[-1][2],
            "fingerprint_online_fast": fp_fast, **split, "app": app}


def bench_frames(first: int, n: int):
    """Frames first..first+n-1 of the bench replay as the offline app
    reads them, with the camera and the depth factor of its cam.yaml."""
    from disinfect_slam_tpu_torch.core.geometry import CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.io.config_reader import (
        get_depth_factor, get_intrinsics, load_yaml,
    )
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay

    cam_yaml = load_yaml(os.path.join(DATASET, "cam.yaml"))
    replay = LoggedReplay(DATASET, get_depth_factor(cam_yaml))
    cam = CameraParams.create(CameraIntrinsics.create(*get_intrinsics(cam_yaml)), H, W)
    return cam, [replay.load_frame(*e) for e in replay.entries[first:first + n]]


def upload_frame(fr, dev):
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput

    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return FrameInput(up(fr.rgb), up(fr.depth), up(fr.ht), up(fr.lt))


def check_fuse_real_frame(fuse_kernel, grid, index, dev):
    """Phase 5: fuse_rows against its plain version on the visible set of
    frame `index` of the bench replay over the fused volume (copies of its
    pool arrays: the volume stays as it is), and its yardsticks there."""
    from disinfect_slam_tpu_torch.config import BENCH_MAX_DEPTH
    from disinfect_slam_tpu_torch.core.geometry import SE3
    from disinfect_slam_tpu_torch.ops.integrate import depth_to_range, gather_visible, stack_frame

    cam, (fr,) = bench_frames(index, 1)
    pose = SE3.from_matrix(fr.cam_T_world)
    vol, cfg = grid.volume, grid.cfg
    img = stack_frame(upload_frame(fr, dev), depth_to_range(cam, dev))
    vis = gather_visible(vol, cam, pose)
    consts = dict(truncation=cfg.truncation, max_depth=BENCH_MAX_DEPTH,
                  max_weight=cfg.max_weight, prob_eps=cfg.prob_eps, cam_T_world=pose,
                  intrinsics=cam.intrinsics, voxel_size=cfg.voxel_size)
    label = f"real frame {index}"
    err, written, updated = compare_fuse(fuse_kernel, img, vis.block_pos, vis.pool_idx,
                                         vis.count, (vol.tsdf, vol.rgbw, vol.prob), consts,
                                         label)
    pool = [a.clone() for a in (vol.tsdf, vol.rgbw, vol.prob)]
    res = {"max_abs_err": err, "count": int(vis.count)}
    res.update(fuse_rows_yardsticks(fuse_kernel, img, vis.block_pos, vis.pool_idx,
                                    vis.count, pool, consts, written, updated, label))
    del pool
    torch.cuda.empty_cache()
    return res


def fresh_bench_grid(offline, dev, n_frames: int):
    """A fresh volume at the offline app's bench preset (fused sampler),
    with the camera, the first n_frames frames of the replay, the
    intrinsics tuple and the max depth."""
    from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

    cfg, voxel, trunc, max_depth = offline.make_config(offline.parse_args(
        ["--logdir", DATASET, "--preset", "bench", "--sampler", "pallas_fused"]))
    cam, frames = bench_frames(0, n_frames)
    k = cam.intrinsics
    return (TSDFGrid(voxel, trunc, cfg=cfg, device=dev), cam, frames,
            (k.fx, k.fy, k.cx, k.cy), max_depth)


def fusion_split(offline, fuse_kernel, dev):
    """Phase 3, where the offline fusion's time goes at the bench preset,
    on a fresh volume: frames 0-44 through TSDFGrid.integrate, then frames
    45-59 through integrate's own stages split by CUDA events (the frame
    upload, depth_to_range, allocation on every alloc_every-th frame, the
    visibility sweep and compaction, fuse_visible, the carve).  It uses
    only what every tree of the port has, so scripts/port_fuse_stage.py
    runs it on another checkout's package too."""
    from disinfect_slam_tpu_torch.core.geometry import SE3
    from disinfect_slam_tpu_torch.ops import integrate as itg

    grid, cam, frames, intr, max_depth = fresh_bench_grid(offline, dev, SPLIT_LAST + 1)
    for fr in frames[:SPLIT_FIRST]:
        grid.integrate(fr.rgb, fr.depth, fr.ht, fr.lt, max_depth, intr, fr.cam_T_world)
    names = ("upload", "depth_to_range", "allocate", "visible", "fuse", "carve", "frame")
    stages = {n: [] for n in names}
    launches0 = fuse_kernel.fuse_rows.launches
    vol = grid.volume
    for i, fr in enumerate(frames[SPLIT_FIRST:], start=SPLIT_FIRST):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        pose = SE3.from_matrix(fr.cam_T_world)
        torch.cuda.synchronize()
        ev[0].record()
        frame = upload_frame(fr, dev)
        ev[1].record()
        d2r = itg.depth_to_range(cam, dev)
        ev[2].record()
        if i % grid.cfg.alloc_every == 0:
            vol = itg.allocate_blocks(vol, frame.depth, d2r, cam, pose, max_depth)
        ev[3].record()
        vis = itg.gather_visible(vol, cam, pose)
        ev[4].record()
        vol, min_abs = itg.fuse_visible(vol, vis, frame, d2r, cam, pose, max_depth)
        ev[5].record()
        vol = itg.space_carve(vol, vis, min_abs)
        ev[6].record()
        torch.cuda.synchronize()
        for n, (a, b) in zip(names, ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (0, 6))):
            stages[n].append(ev[a].elapsed_time(ev[b]))
    n_split = SPLIT_LAST + 1 - SPLIT_FIRST
    if fuse_kernel.fuse_rows.launches - launches0 != n_split:
        raise AssertionError("the split frames did not launch fuse_rows once each")
    split = {n: statistics.mean(v) for n, v in stages.items()}
    log(f"[chip_smoke] fusion split, CUDA-event ms/frame (mean of frames {SPLIT_FIRST}-"
        f"{SPLIT_LAST}, {len(range(SPLIT_FIRST, SPLIT_LAST + 1, grid.cfg.alloc_every))} "
        f"allocating): " + ", ".join(f"{n} {v:.3f}" for n, v in split.items()))
    return {"split_ms_per_frame": split, "split_frames": stages}


def fusion_profile(offline, dev):
    """Phase 7: a fresh volume at the bench preset over frames 0-44
    through TSDFGrid.integrate, then frames 45-59 under the profiler
    (device kernel time, kernels per frame, idle share), then the fuse
    stage alone on frame 59's visible set: fuse_visible's device time
    (every kernel it launches), the fuse_rows kernel's within it, and one
    call by CUDA events.  Like fusion_split, it runs on any tree of the
    port."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.core.geometry import SE3
    from disinfect_slam_tpu_torch.ops import integrate as itg

    grid, cam, frames, intr, max_depth = fresh_bench_grid(offline, dev, SPLIT_LAST + 1)
    for fr in frames[:SPLIT_FIRST]:
        grid.integrate(fr.rgb, fr.depth, fr.ht, fr.lt, max_depth, intr, fr.cam_T_world)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in frames[SPLIT_FIRST:]:
            grid.integrate(fr.rgb, fr.depth, fr.ht, fr.lt, max_depth, intr, fr.cam_T_world)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    n = len(frames[SPLIT_FIRST:])
    res = {"frames": [SPLIT_FIRST, SPLIT_LAST], "wall_ms_per_frame": wall_ms / n,
           "device_ms_per_frame": device_ms / n, "kernels_per_frame": len(events) / n,
           "idle_share": 1 - device_ms / wall_ms if device_ms else None}
    log(f"[chip_smoke] fusion profile (frames {SPLIT_FIRST}-{SPLIT_LAST}): wall "
        f"{wall_ms / n:.3f} ms/frame, device kernel time {device_ms / n:.3f} ms/frame in "
        f"{len(events) / n:.1f} kernels/frame, idle share "
        + (f"{res['idle_share']:.3f}" if device_ms else "not measured"))

    fr = frames[-1]
    pose = SE3.from_matrix(fr.cam_T_world)
    frame = upload_frame(fr, dev)
    d2r = itg.depth_to_range(cam, dev)
    vis = itg.gather_visible(grid.volume, cam, pose)
    stage = lambda: itg.fuse_visible(grid.volume, vis, frame, d2r, cam, pose,  # noqa: E731
                                     max_depth)
    res["fuse_stage"] = {"rows": int(vis.count), "device_ms": kernel_ms(stage),
                         "fuse_rows_ms": kernel_ms(stage, "fuse_rows_kernel"),
                         "call_ms": cuda_time_ms(stage)}
    log(f"[chip_smoke] fuse stage on frame {SPLIT_LAST}'s {res['fuse_stage']['rows']} "
        f"visible rows: fuse_visible {res['fuse_stage']['device_ms']:.4f} ms of device "
        f"time (one call {res['fuse_stage']['call_ms']:.4f} ms), of which the fuse_rows "
        f"kernel {res['fuse_stage']['fuse_rows_ms']:.4f} ms")
    return res


def check_mesh_fingerprint(fp, ref, label) -> None:
    """A mesh fingerprint (ops/mesh.py mesh_fingerprint or
    indexed_mesh_fingerprint) against the JAX reference's: counts within
    TOL_MESH_COUNT, clipped chunks equal, each axis's vertex sum within
    TOL_MESH_SUM of the largest it could be (its points times the bbox's
    reach on that axis; a sum of coordinates of both signs can sit near
    0, where a relative limit would mean nothing)."""
    failed = {}
    for k in ("triangles", "merged_vertices", "merged_faces"):
        if k in ref:
            dev_ = abs(fp[k] - ref[k]) / max(ref[k], 1)
            log(f"[chip_smoke] {label} {k}: port {fp[k]} reference {ref[k]} rel dev "
                f"{dev_:.3e} (limit {TOL_MESH_COUNT:g})")
            if not dev_ <= TOL_MESH_COUNT:
                failed[k] = dev_
    if "clipped_chunks" in ref:
        log(f"[chip_smoke] {label} clipped chunks: port {fp['clipped_chunks']} reference "
            f"{ref['clipped_chunks']}")
        if fp["clipped_chunks"] != ref["clipped_chunks"]:
            failed["clipped_chunks"] = fp["clipped_chunks"]
    points = 3 * ref["triangles"] if "triangles" in ref else ref["merged_vertices"]
    for a in range(3):
        reach = points * max(abs(ref["bbox_min"][a]), abs(ref["bbox_max"][a]), 1e-3)
        dev_ = abs(fp["vertex_sum"][a] - ref["vertex_sum"][a]) / reach
        log(f"[chip_smoke] {label} vertex sum axis {a}: port {fp['vertex_sum'][a]:.3f} "
            f"reference {ref['vertex_sum'][a]:.3f} dev {dev_:.3e} of its reach (limit "
            f"{TOL_MESH_SUM:g})")
        if not dev_ <= TOL_MESH_SUM:
            failed[f"vertex_sum[{a}]"] = dev_
    if failed:
        raise AssertionError(f"{label}: mesh fingerprint outside tolerance: {failed}")


def timed_mesh(vol, transfer):
    """extract_mesh_chunked (device work and the one copy to the host),
    wall ms, then the fingerprint (the weld on the host, timed apart)."""
    from disinfect_slam_tpu_torch.ops import mesh as tmesh

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tmesh.counting_clips() as clipped:
        tris = tmesh.extract_mesh_chunked(vol, transfer=transfer)
    ms = 1e3 * (time.perf_counter() - t0)
    t1 = time.perf_counter()
    fp = tmesh.mesh_fingerprint(tris, clipped[0])
    return tris, {"ms": ms, "weld_ms": 1e3 * (time.perf_counter() - t1), **fp}


def mesh_chunks_against_cpu(vol) -> dict:
    """The first MESH_CPU_CHUNKS chunks of extract_mesh_chunked's
    candidate blocks on the card and on a CPU copy of the volume: equal
    triangle counts, vertices within 1e-6 m, no triangle wound the other
    way."""
    import dataclasses

    from disinfect_slam_tpu_torch.ops import mesh as tmesh

    cpu = dataclasses.replace(vol, **{f.name: getattr(vol, f.name).cpu()
                                      for f in dataclasses.fields(vol) if f.name != "cfg"})
    idx = torch.nonzero(tmesh._candidates(vol)).flatten()
    worst, tris = 0.0, 0
    for c in range(MESH_CPU_CHUNKS):
        sel = idx[c * 512:(c + 1) * 512]
        out = []
        for v in (vol, cpu):
            s = sel.to(v.device)
            m = tmesh._extract_from_blocks(v, v.entry_pos[s], v.entry_block[s],
                                           torch.ones(len(s), dtype=torch.bool, device=v.device),
                                           1 << 18)
            out.append(m.vertices[:int(m.count)].cpu().numpy())
        a, b = out
        if a.shape != b.shape:
            raise AssertionError(f"mesh chunk {c}: {a.shape[0]} triangles on the card, "
                                 f"{b.shape[0]} on the CPU")
        n_a = np.cross(a[:, 1] - a[:, 0], a[:, 2] - a[:, 0])
        n_b = np.cross(b[:, 1] - b[:, 0], b[:, 2] - b[:, 0])
        big = np.linalg.norm(n_b, axis=-1) > 1e-12
        flips = int(((n_a * n_b).sum(-1)[big] <= 0).sum())
        err = float(np.abs(a - b).max()) if a.size else 0.0
        worst, tris = max(worst, err), tris + a.shape[0]
        if err > 1e-6 or flips:
            raise AssertionError(f"mesh chunk {c}: card against CPU max |dv| {err}, "
                                 f"{flips} flipped triangles")
    del cpu
    log(f"[chip_smoke] mesh: first {MESH_CPU_CHUNKS} chunks ({tris} triangles) on the card "
        f"equal the CPU run's: max |dv| {worst:.3g} m, no flips")
    return {"chunks": MESH_CPU_CHUNKS, "triangles": tris, "max_abs_err": worst}


def tsdf2mesh_phase(dump: str, ref, smi) -> dict:
    """apps.tsdf2mesh on phase 3's dump: the .ply as a user runs it (a
    process of its own, wall seconds), the mesh against the reference's
    (c); the .obj in process with the dump's voxel size, whose rebuilt
    volume must give the dump's records back exactly, as a set."""
    from disinfect_slam_tpu_torch.apps import tsdf2mesh
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.ops.gather import (
        gather_valid, load_spatial_tsdf, to_numpy_records,
    )

    out = os.path.join(str(build.BUILD_DIR), "dump_mesh")
    ply = out + ".ply"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "disinfect_slam_tpu_torch.apps.tsdf2mesh",
                           dump, ply], cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"tsdf2mesh failed ({proc.returncode}): {proc.stderr[-3000:]}")
    for line in proc.stdout.strip().splitlines():
        log(f"[chip_smoke] {line}")
    last = proc.stdout.strip().splitlines()[-1].split()
    n_v, n_f = int(last[1]), int(last[4])
    head = open(ply, "rb").read(512).split(b"end_header")[0].decode()
    if f"element vertex {n_v}" not in head or "ht_probability" not in head:
        raise AssertionError(f"{ply}: unexpected header {head!r}")
    fp = {"merged_vertices": n_v, "merged_faces": n_f}
    for k in fp:
        dev_ = abs(fp[k] - ref["mesh"][k]) / ref["mesh"][k]
        log(f"[chip_smoke] tsdf2mesh {k}: port {fp[k]} reference {ref['mesh'][k]} rel dev "
            f"{dev_:.3e} (limit {TOL_MESH_COUNT:g})")
        if not dev_ <= TOL_MESH_COUNT:
            raise AssertionError(f"tsdf2mesh {k} outside tolerance")
    res = tsdf2mesh.main([dump, out + ".obj", "--voxel", str(SPLAT_VOXEL)])
    rec = load_spatial_tsdf(dump)
    back = to_numpy_records(gather_valid(res["volume"]))

    def by_voxel(r):
        """The records in voxel order (one int64 key a voxel)."""
        v = np.rint(r[:, :3] / SPLAT_VOXEL).astype(np.int64) + (1 << 20)
        return r[np.argsort((v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2], kind="stable")]

    same = back.shape == rec.shape and np.array_equal(by_voxel(back).view(np.int32),
                                                      by_voxel(rec).view(np.int32))
    log(f"[chip_smoke] tsdf2mesh: {res['blocks']} blocks (reference {ref['active_blocks']}); "
        f"the rebuilt volume's gather_valid gives the {rec.shape[0]} records back as a set: "
        f"{same}; wall {wall_s:.2f} s for the .ply ({smi}); in process load "
        f"{res['load_s']:.2f} s, mesh {res['mesh_s']:.2f} s")
    if not same or res["blocks"] != ref["active_blocks"]:
        raise AssertionError("tsdf2mesh: the rebuilt volume does not hold the dump")
    return {"wall_s": wall_s, **fp, "load_s": res["load_s"], "mesh_s": res["mesh_s"],
            "records": int(rec.shape[0]), "blocks": res["blocks"]}


def hash_replay(offline, splat_kernel, fuse_kernel, intrinsics, poses, ref, fused_ms) -> dict:
    """apps.offline --backend hash with the fused sampler: fuse_rows once a
    frame, the volume against the reference's hash replay, then one
    frame-0 render (renderer "auto") launching each splat kernel once,
    bit-equal in both buffers to the plain splat on the card."""
    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.ops import render_fast
    from disinfect_slam_tpu_torch.ops.cuda import build

    splat_fns = (splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks)
    reset_launches(fuse_kernel.fuse_rows, *splat_fns)
    save = os.path.join(str(build.BUILD_DIR), "data_hash.bin")
    res = replay(offline, "pallas_fused", save, extra=["--backend", "hash"])
    grid = res["grid"]
    if grid.cfg.backend != "hash" or fuse_kernel.fuse_rows.launches != res["frames"]:
        raise AssertionError(f"hash replay: {grid.cfg.backend}, fuse_rows launched "
                             f"{fuse_kernel.fuse_rows.launches} times for {res['frames']} frames")
    fuse_launches = fuse_kernel.fuse_rows.launches
    check_dump(save, res["records"])
    fp = check_fingerprint(grid, res["records"], ref, "hash replay")
    ms = 1e3 * statistics.mean(res["integrate_s"])
    grid.ray_cast(RENDER_MAX_DEPTH, (intrinsics, H, W), poses[0], renderer="auto")
    torch.cuda.synchronize()
    launches = [fn.launches for fn in splat_fns]
    if launches != [1, 1]:
        raise AssertionError(f"hash render: splat kernels launched {launches} times")
    cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), H, W)
    pose = SE3.from_matrix(poses[0])
    ours = splat_kernel.splat_buffers_cuda(grid.volume, cam, pose, RENDER_MAX_DEPTH)
    plain = render_fast.splat_buffers(grid.volume, cam, pose, RENDER_MAX_DEPTH)
    equal = all(torch.equal(a, b) for a, b in zip(ours, plain))
    log(f"[chip_smoke] hash replay: {ms:.3f} ms/frame (dense fused replay {fused_ms:.3f}); "
        f"fuse_rows launches {fuse_launches}; frame-0 render splat launches {launches}, "
        f"buffers bit-equal to the plain splat: {equal} ({int(ours[3])} surface blocks)")
    if not equal:
        raise AssertionError("hash render: the kernels' buffers differ from the plain splat")
    return {"ms_per_frame": ms, "fuse_rows_launches": fuse_launches,
            "splat_launches": launches, "fingerprint": fp, "frames": res["frames"]}


def recenter_replay(offline) -> dict:
    """apps.offline --preset small --grid-log2 RECENTER_GRID_LOG2
    --auto-recenter on orbit_vga: the window moves, every live entry's
    table cell points back at it, and no live block lies outside it."""
    from disinfect_slam_tpu_torch.ops import hash as th

    res = offline.main(["--logdir", DATASET, "--config", os.path.join(DATASET, "cam.yaml"),
                        "--preset", "small", "--grid-log2", str(RECENTER_GRID_LOG2),
                        "--auto-recenter", "--device", "cuda"])
    vol = res["grid"].volume
    live = vol.entry_block >= 0
    cell, in_window = th.table_index(vol.entry_pos, vol.cfg)
    entries = torch.arange(vol.cfg.num_entries, device=vol.device, dtype=torch.int32)
    back = vol.block_table[cell.long()] == entries
    n_live = int(live.sum())
    n_table = int((vol.block_table >= 0).sum())
    ok = bool((back | ~live).all()) and bool((in_window | ~live).all()) and n_table == n_live
    log(f"[chip_smoke] recenter replay: the window moved at frames {res['recenter_frames']} to "
        f"origin {vol.cfg.grid_origin}; {n_live} live blocks, {n_table} table cells, each live "
        f"entry's cell points back at it and lies in the window: {ok}; oob_count "
        f"{int(vol.oob_count)}")
    if not res["recenter_frames"] or not ok or n_live == 0:
        raise AssertionError("recenter replay: the window did not move or its directory is bad")
    return {"moves": res["recenter_frames"], "origin": list(vol.cfg.grid_origin),
            "live_blocks": n_live, "oob_count": int(vol.oob_count)}


def export_slice(offline, grid, dump, fuse_kernel, splat_kernel, intrinsics, poses, fused_ms,
                 smi, dev) -> dict:
    """Phase 6b (see the docstring)."""
    from types import SimpleNamespace

    from disinfect_slam_tpu_torch.ops.gather import BoundingCube
    from disinfect_slam_tpu_torch.ops.mesh import indexed_mesh_fingerprint
    from disinfect_slam_tpu_torch.systems.bridge import ReconstructionBridge

    with open(EXPORT_FINGERPRINT) as f:
        ref = json.load(f)
    vol = grid.volume
    mesh = {}
    for transfer in ("f32", "q16"):
        _, mesh[transfer] = timed_mesh(vol, transfer)
        log(f"[chip_smoke] mesh {transfer}: {mesh[transfer]['ms']:.1f} ms wall "
            f"(extract and the one copy; the weld on the host "
            f"{mesh[transfer]['weld_ms']:.1f} ms) ({smi})")
        check_mesh_fingerprint(mesh[transfer], ref["mesh"][transfer], f"mesh {transfer}")
    mesh["cpu_chunks"] = mesh_chunks_against_cpu(vol)
    torch.cuda.empty_cache()

    bridge = ReconstructionBridge(SimpleNamespace(tsdf=SimpleNamespace(tsdf=grid)),
                                  BoundingCube(*ref["bridge"]["cube"]))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        verts, faces = bridge.query_mesh()
        times.append(1e3 * (time.perf_counter() - t0))
    bfp = indexed_mesh_fingerprint(verts, faces)
    log(f"[chip_smoke] bridge query (2 m cube): median {statistics.median(times):.1f} ms of "
        f"{[round(t, 1) for t in times]} (the reference publishes every 200 ms) ({smi})")
    check_mesh_fingerprint(bfp, ref["bridge"], "bridge query")
    torch.cuda.empty_cache()

    dump_res = tsdf2mesh_phase(dump, ref["dump"], smi)
    torch.cuda.empty_cache()
    hash_res = hash_replay(offline, splat_kernel, fuse_kernel, intrinsics, poses,
                           ref["hash_replay"], fused_ms)
    torch.cuda.empty_cache()
    return {"mesh": mesh, "bridge": {"median_ms": statistics.median(times), "ms": times, **bfp},
            "tsdf2mesh": dump_res, "hash": hash_res, "recenter": recenter_replay(offline)}


# ----------------------------------------------------------------------
# phase 8: the tracking slice (pose-free dense SLAM)
# ----------------------------------------------------------------------
def slam_app_args(out_dir: str, *extra) -> list:
    """apps.dense_slam as a user runs it on orbit_vga with loop closure,
    scoring, the trajectory, the checkpoint and the mesh, at its defaults."""
    return ["--logdir", DATASET, "--config", os.path.join(DATASET, "cam.yaml"),
            "--loop-closure", "--evaluate", "auto",
            "--out-traj", os.path.join(out_dir, "traj.txt"),
            "--save", os.path.join(out_dir, "slam_volume.npz"),
            "--mesh", os.path.join(out_dir, "slam_mesh.obj"), *extra]


def pose_gaps(poses: np.ndarray, ref: np.ndarray):
    """Per-frame camera-centre distance (m) and rotation angle (rad)
    between two cam_T_world stacks [N, 4, 4].  The angle comes from the
    skew part of R_a R_b^T (atan2 of |vee| / 2 against (trace - 1) / 2):
    the tracked rotations drift from orthonormal by ~1e-6 over the frames,
    which an arccos of the trace alone reads as milliradians."""
    c_a = np.linalg.inv(poses.astype(np.float64))[:, :3, 3]
    c_b = np.linalg.inv(ref.astype(np.float64))[:, :3, 3]
    r = np.einsum("nij,nkj->nik", poses[:, :3, :3].astype(np.float64),
                  ref[:, :3, :3].astype(np.float64))
    vee = np.stack([r[:, 2, 1] - r[:, 1, 2], r[:, 0, 2] - r[:, 2, 0],
                    r[:, 1, 0] - r[:, 0, 1]], -1)
    angle = np.arctan2(0.5 * np.linalg.norm(vee, axis=1),
                       0.5 * (np.trace(r, axis1=1, axis2=2) - 1.0))
    return np.linalg.norm(c_a - c_b, axis=1), angle


def check_slam_fingerprint(res, vol_fp, ref) -> dict:
    """The app run against the JAX DenseSLAM's fingerprint, within the
    TOL_SLAM_* limits (PERF.md §2): the same ok flags, lost, keyframe and
    closure counts; each frame's pose; ATE; the volume."""
    fids = ref["frame_ids"]
    ok = [res["ok"][f] for f in fids]
    poses = np.stack([res["poses"][f] for f in fids])
    dt, dr = pose_gaps(poses, np.asarray(ref["cam_T_world"], np.float32))
    lc = res["slam"].lc
    ate = res["evaluation"]["ate"]
    out = {"frames": len(fids), "ok_equal": ok == ref["ok"], "lost": res["slam"].lost_count,
           "keyframes": lc.count, "closures": lc.closures,
           "max_translation_gap_m": float(dt.max()), "max_rotation_gap_rad": float(dr.max()),
           "ate": ate, "ate_rmse_gap_m": abs(ate["rmse"] - ref["ate"]["rmse"]),
           "rpe": res["evaluation"]["rpe"], "volume": vol_fp,
           "volume_rel": {k: vol_fp[k] / ref["volume"][k] - 1.0
                          for k in ("active_blocks", "sum_abs_tsdf", "sum_weight",
                                    "sum_prob")}}
    log(f"[chip_smoke] slam app against the JAX fingerprint: ok flags equal "
        f"{out['ok_equal']}, lost {out['lost']} (ref {ref['lost']}), keyframes "
        f"{out['keyframes']} ({ref['keyframes']}), closures {out['closures']} "
        f"({ref['closures']}); max per-frame gap {out['max_translation_gap_m'] * 1e3:.3f} mm "
        f"(limit {TOL_SLAM_T * 1e3:.0f}), {out['max_rotation_gap_rad'] * 1e3:.4f} mrad "
        f"(limit {TOL_SLAM_R * 1e3:.0f}); ATE rmse {ate['rmse']:.6f} m against "
        f"{ref['ate']['rmse']:.6f} (limit +-{TOL_SLAM_ATE * 1e3:.0f} mm); volume relative to "
        f"the reference {out['volume_rel']} (limits {TOL_SLAM_COUNT}, {TOL_SLAM_SUM})")
    bad = []
    if not out["ok_equal"] or (out["lost"], out["keyframes"], out["closures"]) != (
            ref["lost"], ref["keyframes"], ref["closures"]):
        bad.append("ok flags or lost / keyframe / closure counts")
    if out["max_translation_gap_m"] > TOL_SLAM_T or out["max_rotation_gap_rad"] > TOL_SLAM_R:
        bad.append("per-frame poses")
    if out["ate_rmse_gap_m"] > TOL_SLAM_ATE:
        bad.append("ATE")
    rel = out["volume_rel"]
    if abs(rel["active_blocks"]) > TOL_SLAM_COUNT or any(
            abs(rel[k]) > TOL_SLAM_SUM for k in ("sum_abs_tsdf", "sum_weight", "sum_prob")):
        bad.append("volume")
    if bad:
        raise AssertionError(f"slam app outside the fingerprint limits: {bad}")
    return out


def slam_app(fuse_kernel, splat_kernel, odometry) -> dict:
    """Phase 8 (a): apps.dense_slam over all 60 frames through main(argv),
    every count set to 0 just before and read just after."""
    from disinfect_slam_tpu_torch.apps import dense_slam as app
    from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
    from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint

    with open(SLAM_FINGERPRINT) as f:
        ref = json.load(f)
    from disinfect_slam_tpu_torch.ops.cuda import build

    out_dir = os.path.join(str(build.BUILD_DIR), "slam")
    os.makedirs(out_dir, exist_ok=True)
    reset_launches(fuse_kernel.fuse_rows, splat_kernel.splat_zbuf_blocks,
                   splat_kernel.splat_payload_blocks)
    odometry.read_result.reads = 0
    t0 = time.perf_counter()
    r = app.main(slam_app_args(out_dir))
    wall_s = time.perf_counter() - t0
    launches = {"fuse_rows": fuse_kernel.fuse_rows.launches,
                "splat_zbuf_blocks": splat_kernel.splat_zbuf_blocks.launches,
                "splat_payload_blocks": splat_kernel.splat_payload_blocks.launches}
    reads = odometry.read_result.reads
    lc = r["slam"].lc
    tracked = r["frames"] - 1
    log(f"[chip_smoke] slam app: {r['frames']} frames in {r['seconds']:.2f} s of frame loop "
        f"({wall_s:.2f} s with the mesh and the checkpoint), launches {launches}, pose reads "
        f"{reads} ({tracked} tracked frames + {lc.verifications} loop verifications), mesh "
        f"{r['mesh']}")
    if r["frames"] != ref["frames"] or launches != {
            "fuse_rows": r["frames"], "splat_zbuf_blocks": tracked, "splat_payload_blocks": 0}:
        raise AssertionError(f"slam app: {r['frames']} frames, launches {launches}")
    if reads != tracked + lc.verifications:
        raise AssertionError(f"slam app: {reads} pose reads for {tracked} tracked frames")
    for name in ("traj.txt", "slam_volume.npz", "slam_mesh.obj"):
        if os.path.getsize(os.path.join(out_dir, name)) == 0:
            raise AssertionError(f"slam app wrote an empty {name}")
    fp = check_slam_fingerprint(r, volume_fingerprint(volume_to_numpy(r["slam"].volume)), ref)
    res = {"frames": r["frames"], "loop_s": r["seconds"], "wall_s": wall_s,
           "launches": launches, "pose_reads": reads, "verifications": lc.verifications,
           "mesh": r["mesh"], **fp}
    return res, r["slam"]


def slam_frames():
    """The 60 orbit_vga frames as the app feeds them (float32 rgb, depth in
    metres), decoded before any timed window."""
    from disinfect_slam_tpu_torch.io.png_io import read_image

    out = []
    for i in range(60):
        base = os.path.join(DATASET, str(i))
        out.append((read_image(base + "_rgb.png").astype(np.float32),
                    read_image(base + "_depth.png", unchanged=True).astype(np.float32)
                    / 5000.0))
    return out


def new_slam(dev, scale):
    """DenseSLAM at the app's defaults (2 cm, 6 cm, 4 m, the default
    TSDFConfig, loop closure every 10 frames, a 60-frame gap)."""
    from disinfect_slam_tpu_torch.io.config_reader import get_intrinsics, load_yaml
    from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM

    intr = get_intrinsics(load_yaml(os.path.join(DATASET, "cam.yaml")))
    return DenseSLAM(intr, H, W, voxel_size=0.02, truncation=0.06, max_depth=4.0,
                     loop_closure=True, kf_every=10, lc_kwargs=dict(min_gap_frames=60),
                     track_res_scale=scale, device=dev)


SLAM_STAGES = ("upload", "model_depth", "pyramids", "icp", "pose_read", "fusion")


def slam_timing(dev, frames, smi) -> dict:
    """Phase 8 (b): ms/frame over frames 3-59 with one sync at the end,
    three fresh runs at each track_res_scale; lost frames and ATE against
    trajectory.txt; then one pass split by CUDA events at each mark of the
    tracked step (and the host clock beside them), keyframe work after."""
    from disinfect_slam_tpu_torch.utils import trajectory_eval as te

    ts_gt, gt = te.load_trajectory(os.path.join(DATASET, "trajectory.txt"))
    out = {}
    for scale in (1, 2):
        ms, lost, ates = [], [], []
        for _ in range(3):
            slam = new_slam(dev, scale)
            poses = []
            for i, (rgb, depth) in enumerate(frames):
                if i == SLAM_WARM:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                poses.append(slam.process_frame(rgb, depth))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0) / (len(frames) - SLAM_WARM))
            if not np.array_equal(ts_gt, np.arange(len(frames))):
                raise AssertionError("trajectory.txt does not list frames 0-59 in order")
            oks = torch.stack([ok for _, ok in poses]).cpu().numpy()
            est = np.linalg.inv(torch.stack([p for p, _ in poses]).cpu().numpy()[oks])
            ates.append(te.ate(gt[oks], est)["rmse"])
            lost.append(slam.lost_count)
            del slam
        # one pass split at the marks (frames SLAM_WARM-59)
        slam = new_slam(dev, scale)
        dev_ms = {n: [] for n in (*SLAM_STAGES, "keyframe", "frame")}
        host_ms = {n: [] for n in dev_ms}
        for i, (rgb, depth) in enumerate(frames):
            if i < SLAM_WARM:
                slam.process_frame(rgb, depth)
                continue
            ev, host = {}, {}

            def mark(name, ev=ev, host=host):
                ev[name] = torch.cuda.Event(enable_timing=True)
                ev[name].record()
                host[name] = time.perf_counter()

            torch.cuda.synchronize()
            mark("start")
            slam.process_frame(rgb, depth, mark=mark)
            mark("end")
            torch.cuda.synchronize()
            names = ("start", *SLAM_STAGES, "end")
            for a, b in zip(names, names[1:]):
                key = "keyframe" if b == "end" else b
                dev_ms[key].append(ev[a].elapsed_time(ev[b]))
                host_ms[key].append(1e3 * (host[b] - host[a]))
            dev_ms["frame"].append(ev["start"].elapsed_time(ev["end"]))
            host_ms["frame"].append(1e3 * (host["end"] - host["start"]))
        split = {n: statistics.mean(v) for n, v in dev_ms.items()}
        host_split = {n: statistics.mean(v) for n, v in host_ms.items()}
        del slam
        torch.cuda.empty_cache()
        out[scale] = {"ms_per_frame_runs": ms, "ms_per_frame": statistics.median(ms),
                      "lost": lost, "ate_rmse_m": ates, "split_ms": split,
                      "host_split_ms": host_split}
        log(f"[chip_smoke] slam track_res_scale={scale}: ms/frame over frames {SLAM_WARM}-59 "
            f"{ms} -> median {statistics.median(ms):.3f} ({smi}); lost {lost}, ATE rmse {ates}")
        log(f"[chip_smoke] slam split, CUDA-event ms/frame (host clock): " + ", ".join(
            f"{n} {split[n]:.3f} ({host_split[n]:.3f})" for n in split))
        if any(lost):
            raise AssertionError(f"slam timing at scale {scale}: lost frames {lost}")
    return out


def slam_volume_rows(splat_kernel, vol, scale, pose):
    """The surface rows of a SLAM volume seen from `pose` at the
    tracking camera of track_res_scale `scale`, as DenseSLAM's model
    depth gives them to K4 -> (rows, pool, geometry)."""
    from disinfect_slam_tpu_torch.core.geometry import CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.io.config_reader import get_intrinsics, load_yaml

    fx, fy, cx, cy = get_intrinsics(load_yaml(os.path.join(DATASET, "cam.yaml")))
    cam = CameraParams.create(CameraIntrinsics.create(fx / scale, fy / scale, cx / scale,
                                                      cy / scale), H // scale, W // scale)
    return volume_rows(splat_kernel, vol, cam, pose, 4.0)


def volume_rows(splat_kernel, vol, cam, pose, max_depth):
    """The surface rows of a volume seen from `pose` (cam_T_world [4, 4])
    at `cam`, as splat_kernel.splat_depth gives them to K4 -> (rows,
    pool, geometry)."""
    from disinfect_slam_tpu_torch.core.geometry import SE3

    vis, _overflow, geometry = splat_kernel._rows(vol, cam, SE3.from_matrix(pose), max_depth,
                                                  1.25, splat_kernel.rf.DEFAULT_SURF_CAP)
    return ((vis.block_pos, vis.pool_idx, vis.count), (vol.tsdf, vol.rgbw, vol.prob),
            geometry)


def check_zbuf_rows(splat_kernel, rows, pool, geometry, dev, what) -> dict:
    """K4 on a volume's surface rows, bit-equal to its plain version, with
    the rows on each of its branches counted and the covered pixels."""
    branches = torch.zeros(2, dtype=torch.int32, device=dev)
    zbuf = splat_kernel.splat_zbuf_blocks(*rows, pool[0], **geometry, branch_counts=branches)
    zref = splat_kernel.splat_zbuf_blocks_reference(*rows, pool[0], **geometry)
    cam = geometry["cam"]
    label = f"{what} K4 {cam.img_w}x{cam.img_h}"
    res = {"rows": int(rows[2]), "branches": branches.tolist(), "max_abs_err": u32_err(zbuf, zref),
           "covered": (zbuf < splat_kernel.BIG).float().mean().item()}
    log(f"[chip_smoke] {label}: {res['rows']} surface rows, zbuf max|d| {res['max_abs_err']}, "
        f"pixels covered {res['covered']:.4f}, rows on the tile / atomic branch "
        f"{res['branches']}")
    if not torch.equal(zbuf, zref) or res["covered"] == 0:
        raise AssertionError(f"{label} disagrees with its plain version")
    return res


def check_slam_zbuf(splat_kernel, vol, pose, dev) -> dict:
    """Phase 8 (c): K4 on the app's final SLAM volume from the last
    tracked pose at 640x480 and 320x240, bit-equal to its plain version,
    with the rows on each of its branches counted."""
    out = {}
    for scale in (1, 2):
        rows, pool, geometry = slam_volume_rows(splat_kernel, vol, scale, pose)
        cam = geometry["cam"]
        out[f"{cam.img_w}x{cam.img_h}"] = check_zbuf_rows(splat_kernel, rows, pool, geometry,
                                                          dev, "slam")
    return out


def slam_loop_closure(dev) -> dict:
    """Phase 8 (d): the port's LoopClosureManager on the card over the
    drifted out-and-back keyframes of tests/test_loop_closure.py (its
    JAX-free copy, tests/torch_cases.py): a loop closes, first at keyframe
    5 or later, and the optimised keyframes' error falls below 60% of the
    drifted estimates' (the CPU test's limits)."""
    from disinfect_slam_tpu_torch.systems.loop_closure import LoopClosureManager
    from tests.torch_cases import LC_ARGS, LC_H, LC_K, LC_W, out_and_back_keyframes

    true_poses, est_poses, depths = out_and_back_keyframes()
    lc = LoopClosureManager(LC_K, LC_H, LC_W, device=dev, **LC_ARGS)
    t0 = time.perf_counter()
    firsts = [k for k, (d, e) in enumerate(zip(depths, est_poses))
              if lc.add_keyframe(d, e, frame_id=10 * k) is not None]
    wall_ms = 1e3 * (time.perf_counter() - t0)
    err = lambda poses: float(np.mean([np.linalg.norm(p[:3, 3] - g[:3, 3])  # noqa: E731
                                       for p, g in zip(poses, true_poses)]))
    res = {"closures": lc.closures, "corrections_at": firsts, "verifications": lc.verifications,
           "err_est_m": err(est_poses), "err_opt_m": err(lc.kf_pose_opt),
           "wall_ms_12_keyframes": wall_ms}
    log(f"[chip_smoke] slam loop closure on the card: {res}")
    if not (lc.closures >= 1 and firsts and firsts[0] >= 5
            and res["err_opt_m"] < 0.6 * res["err_est_m"]):
        raise AssertionError(f"loop closure on the card did not close the chain: {res}")
    return res


def slam_zbuf_yardsticks(splat_kernel, vol, pose) -> dict:
    """Phase 7, K4 at the tracking resolution: on phase 8's SLAM volume
    from the last pose at 320x240 (track_res_scale=2), its device time
    beside its bound, its plain version's time and scatter_reduce "amin"
    (splat_bound_and_library's K4 entry; the payload buffer it also needs
    comes from K5's plain version)."""
    rows, pool, geometry = slam_volume_rows(splat_kernel, vol, 2, pose)
    zbuf = splat_kernel.splat_zbuf_blocks(*rows, pool[0], **geometry)
    pbuf = splat_kernel.splat_payload_blocks_reference(*rows, *pool, zbuf, **geometry)
    planes = splat_kernel.splat_planes(*rows, pool[0], **geometry)
    res, _ = splat_bound_and_library(splat_kernel, rows, pool, geometry, planes, zbuf, pbuf)
    time_kernel(res, lambda: splat_kernel.splat_zbuf_blocks(*rows, pool[0], **geometry),
                "splat_zbuf_tile_kernel")
    res["plain_ms"] = cuda_time_ms(
        lambda: splat_kernel.splat_zbuf_blocks_reference(*rows, pool[0], **geometry))
    print_yardsticks("splat_zbuf_blocks 320x240 (SLAM volume)", res)
    return res


def slam_profile(dev) -> dict:
    """Phase 7, the SLAM frame under the profiler: a fresh DenseSLAM at
    track_res_scale 1 over frames 0-44, then frames 45-59 profiled (wall
    and device kernel time a frame, kernels a frame, idle share); then
    ICP alone (ICPOdometry._track on frame 59 against the model depth,
    five calls): kernels, device and wall ms a call, and the torch ops
    that take the most host time in it."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.core.geometry import SE3
    from disinfect_slam_tpu_torch.utils.device import upload

    frames = slam_frames()
    slam = new_slam(dev, 1)
    for rgb, depth in frames[:SPLIT_FIRST]:
        slam.process_frame(rgb, depth)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rgb, depth in frames[SPLIT_FIRST:]:
            slam.process_frame(rgb, depth)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    n = len(frames) - SPLIT_FIRST
    res = {"frames": [SPLIT_FIRST, len(frames) - 1], "wall_ms_per_frame": wall_ms / n,
           "device_ms_per_frame": device_ms / n, "kernels_per_frame": len(events) / n,
           "idle_share": 1 - device_ms / wall_ms if device_ms else None}

    prev = np.linalg.inv(slam.world_T_cam)
    tracker = slam.tracker
    pyr_ref = tracker._prep(slam._model_depth(SE3.from_matrix(prev)))
    pyr_cur = tracker._prep(upload(frames[-1][1], dev))
    poses = upload(np.stack([slam.world_T_cam, prev]), dev)
    calls = 5
    tracker._track(poses[0], pyr_cur, pyr_ref, poses[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            tracker._track(poses[0], pyr_cur, pyr_ref, poses[1])
        torch.cuda.synchronize()
        icp_wall = 1e3 * (time.perf_counter() - t0) / calls
    icp_events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    top = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total, reverse=True)[:8]
    res["icp"] = {"wall_ms_per_call": icp_wall, "kernels_per_call": len(icp_events) / calls,
                  "device_ms_per_call": sum(e.time_range.elapsed_us() for e in icp_events)
                  / 1e3 / calls,
                  "top_host_ops_ms_per_call": {a.key: a.self_cpu_time_total / 1e3 / calls
                                               for a in top}}
    log(f"[chip_smoke] slam profile (frames {SPLIT_FIRST}-{len(frames) - 1}): wall "
        f"{wall_ms / n:.3f} ms/frame, device kernel time {device_ms / n:.3f} ms/frame in "
        f"{len(events) / n:.1f} kernels/frame, idle share "
        + (f"{res['idle_share']:.3f}" if device_ms else "not measured")
        + f"; ICP alone {res['icp']['wall_ms_per_call']:.3f} ms a call, "
        f"{res['icp']['kernels_per_call']:.1f} kernels, "
        f"{res['icp']['device_ms_per_call']:.3f} ms of device time; host time by op "
        f"(ms a call): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     res["icp"]["top_host_ops_ms_per_call"].items()))
    del slam
    torch.cuda.empty_cache()
    return res


def slam_slice(fuse_kernel, splat_kernel, dev, smi) -> dict:
    """Phase 8 (a)-(d); returns the report entry and the SLAM volume and
    last pose that phase 7 times K4 on."""
    from disinfect_slam_tpu_torch.systems import odometry

    app, slam = slam_app(fuse_kernel, splat_kernel, odometry)
    pose = np.linalg.inv(slam.world_T_cam)
    zbuf = check_slam_zbuf(splat_kernel, slam.volume, pose, dev)
    vol = slam.volume
    del slam
    torch.cuda.empty_cache()
    timing = slam_timing(dev, slam_frames(), smi)
    lc = slam_loop_closure(dev)
    return {"app": app, "timing": timing, "zbuf": zbuf, "loop_closure": lc}, vol, pose


# ----------------------------------------------------------------------
# phase 9: the served map (the HTTP service and its app, host block
# streaming, the occlusion cull, apps.view_volume)
# ----------------------------------------------------------------------
VOLUME_FIELDS = ("entry_key", "entry_block", "block_table", "heap", "num_free", "oob_count",
                 "tsdf", "rgbw", "prob")
SERVE_RENDERS = 5  # /render requests timed (median)
SERVE_MAX_DEPTH = 10.0  # ReconstructionService.render's default, as the JAX service's
SERVE_APP_FRAMES = 30
VIEW_FRAMES = 4


def http_get(url: str, timeout: float = 600.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read(), r.headers.get("Content-Type")


def http_npz(url: str):
    return np.load(io.BytesIO(http_get(url)[0]))


def http_json(url: str):
    return json.loads(http_get(url)[0])


def post_npz(url: str, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return np.load(io.BytesIO(r.read()))


def timed_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def volumes_equal(a, b) -> dict:
    """Which of two volumes' tensors are equal, bit for bit."""
    return {f: torch.equal(getattr(a, f), getattr(b, f)) for f in VOLUME_FIELDS}


def bench_service(offline, dev):
    """A DISINFSystem at the offline app's bench preset with orbit_vga's
    camera behind ReconstructionService, served on 127.0.0.1 at a free
    port by a thread -> (system, server, base url, replay, intrinsics)."""
    from disinfect_slam_tpu_torch.io.config_reader import (
        get_depth_factor, get_extrinsics, get_intrinsics, load_yaml,
    )
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
    from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem
    from disinfect_slam_tpu_torch.systems.server import ReconstructionService, make_server

    cfg, voxel, trunc, max_depth = offline.make_config(offline.parse_args(
        ["--logdir", DATASET, "--preset", "bench", "--sampler", "pallas_fused"]))
    cam_yaml = load_yaml(os.path.join(DATASET, "cam.yaml"))
    intrinsics = get_intrinsics(cam_yaml)
    replay = LoggedReplay(DATASET, get_depth_factor(cam_yaml), get_extrinsics(cam_yaml))
    system = DISINFSystem(intrinsics, depth_factor=1.0, voxel_size=voxel, truncation=trunc,
                          max_depth=max_depth, cfg=cfg, half_scale=False, device=dev)
    httpd = make_server(ReconstructionService(system), "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return system, httpd, f"http://127.0.0.1:{httpd.server_address[1]}", replay, intrinsics


def served_map(offline, grid, fuse_kernel, splat_kernel, ref, export_ref, smi, dev) -> dict:
    """Phase 9a: the service in process.  POST every frame of the bench
    replay (rgb, depth, ht, lt, pose as npz); fuse_rows launches once a
    frame; the served volume equals phase 3's bit for bit and meets the
    fingerprint; /render at frame 0's pose launches each splat kernel once
    a request and gives ray_cast(renderer="auto")'s and the plain splat's
    bits; /query on the bridge's 2 m cube gives gather_voxels' records;
    /stats, /query and /mesh timed."""
    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.ops import render_fast
    from disinfect_slam_tpu_torch.ops.gather import BoundingCube, to_numpy_records

    splat_fns = (splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks)
    system, httpd, base, replay, intrinsics = bench_service(offline, dev)
    try:
        reset_launches(fuse_kernel.fuse_rows, *splat_fns)
        post_ms = []
        t0 = time.perf_counter()
        for i, fr in enumerate(replay):
            out, ms = timed_ms(lambda: post_npz(
                f"{base}/frame", rgb=fr.rgb, depth=fr.depth, timestamp_ms=np.asarray(33 * i),
                ht=fr.ht, lt=fr.lt, pose=fr.cam_T_world))
            post_ms.append(ms)
            if not bool(out["ok"]) or not np.array_equal(out["pose"], fr.cam_T_world):
                raise AssertionError(f"/frame {i}: ok {out['ok']}, pose {out['pose']}")
        stats, stats_ms = timed_ms(lambda: http_json(f"{base}/stats"))  # drains the queue
        stream_s = time.perf_counter() - t0
        launches = fuse_kernel.fuse_rows.launches
        served = system.tsdf.tsdf
        if launches != len(replay) or stats["frames"] != len(replay) or any(
                fn.launches for fn in splat_fns) or system.tsdf.dropped_frames:
            raise AssertionError(f"served replay: fuse_rows {launches}, stats {stats}, splat "
                                 f"{[fn.launches for fn in splat_fns]}, dropped "
                                 f"{system.tsdf.dropped_frames}")
        equal = volumes_equal(served.volume, grid.volume)
        log(f"[chip_smoke] served replay: {len(replay)} frames POSTed in {stream_s:.2f} s "
            f"(median {statistics.median(post_ms):.1f} ms a POST, npz of rgb, depth, ht, lt, "
            f"pose), fuse_rows launches {launches}; the served volume equals phase 3's bit "
            f"for bit: {equal} ({smi})")
        if not all(equal.values()):
            raise AssertionError(f"served volume differs from phase 3's: {equal}")
        fp = check_fingerprint(served, int(served.gather_valid().count), ref, "served volume")

        pose0 = replay.entries[0][1]
        fx = float(intrinsics[0])
        csv = ",".join(repr(float(x)) for x in np.asarray(pose0, np.float32).ravel())
        url = f"{base}/render?fx={fx!r}&w={W}&h={H}&pose={csv}"
        reset_launches(*splat_fns)
        renders, render_ms = [], []
        for _ in range(SERVE_RENDERS):
            r, ms = timed_ms(lambda: http_npz(url))
            renders.append(r)
            render_ms.append(ms)
        render_launches = [fn.launches for fn in splat_fns]
        if render_launches != [SERVE_RENDERS] * 2:
            raise AssertionError(f"/render launched the splat kernels {render_launches} times "
                                 f"for {SERVE_RENDERS} requests")
        view = ((fx, fx, (W - 1) / 2, (H - 1) / 2), H, W)
        auto = served.ray_cast(SERVE_MAX_DEPTH, view, pose0, renderer="auto")
        plain = render_fast.splat_render(served.volume,
                                         CameraParams.create(CameraIntrinsics.create(*view[0]),
                                                             H, W),
                                         SE3.from_matrix(pose0), SERVE_MAX_DEPTH)
        equal = {k: all(np.array_equal(r[k], getattr(want, k).cpu().numpy())
                        for r in renders for want in (auto, plain))
                 for k in ("rgba", "normal", "depth")}
        hits = float((renders[0]["depth"] > 0).mean())
        log(f"[chip_smoke] /render 640x480 at frame 0's pose: median {statistics.median(render_ms):.1f} "
            f"ms of {[round(t, 1) for t in render_ms]} (HTTP round trip, npz); splat launches "
            f"{render_launches}; bit-equal to ray_cast(auto) and the plain splat: {equal}; hit "
            f"{hits:.3f} ({smi})")
        if not all(equal.values()) or hits < 0.1:
            raise AssertionError(f"/render differs from the in-process render: {equal}, hit {hits}")

        cube = export_ref["bridge"]["cube"]
        q = ",".join(repr(float(x)) for x in cube)
        rec, query_ms = timed_ms(lambda: http_npz(f"{base}/query?bbox={q}")["records"])
        local = to_numpy_records(served.gather_voxels(BoundingCube(*cube)))
        log(f"[chip_smoke] /query (the bridge's 2 m cube): {rec.shape[0]} records in "
            f"{query_ms:.1f} ms, equal to gather_voxels in process: {np.array_equal(rec, local)}")
        if rec.shape[0] == 0 or not np.array_equal(rec, local):
            raise AssertionError("/query differs from gather_voxels")
        mesh, mesh_ms = timed_ms(lambda: http_npz(f"{base}/mesh"))
        nv, nf = mesh["verts"].shape[0], mesh["faces"].shape[0]
        want = export_ref["mesh"]["f32"]
        dev_ = max(abs(nv - want["merged_vertices"]) / want["merged_vertices"],
                   abs(nf - want["merged_faces"]) / want["merged_faces"])
        log(f"[chip_smoke] /mesh: {nv} vertices, {nf} faces in {mesh_ms:.1f} ms (extract, weld, "
            f"npz); the reference's {want['merged_vertices']} / {want['merged_faces']}, rel dev "
            f"{dev_:.3e} (limit {TOL_MESH_COUNT:g}); /stats {stats_ms:.1f} ms ({smi})")
        if not dev_ <= TOL_MESH_COUNT:
            raise AssertionError("/mesh counts outside tolerance")
        del mesh
    finally:
        httpd.shutdown()
        httpd.server_close()
        system.terminate()
    return {"fuse_rows_launches": launches, "splat_launches": render_launches,
            "post_ms_median": statistics.median(post_ms), "stream_s": stream_s,
            "render_ms": render_ms, "render_ms_median": statistics.median(render_ms),
            "query_ms": query_ms, "query_records": int(rec.shape[0]), "stats_ms": stats_ms,
            "mesh_ms": mesh_ms, "mesh": [int(nv), int(nf)], "fingerprint": fp, "hit": hits}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_app(smi) -> dict:
    """Phase 9b: apps.serve --synthetic 30 as a user runs it (its own
    process, no --device: the card): the viewer page, the replay started
    and run to its end, /stats reporting every frame, a PNG from /render;
    then the process is stopped, and its stderr holds no traceback."""
    from disinfect_slam_tpu_torch.io.png_io import read_png
    from disinfect_slam_tpu_torch.ops.cuda import build

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    out_path = os.path.join(str(build.BUILD_DIR), "serve_app.log")
    err_path = os.path.join(str(build.BUILD_DIR), "serve_app.err")
    t0 = time.perf_counter()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "disinfect_slam_tpu_torch.apps.serve", "--synthetic",
             str(SERVE_APP_FRAMES), "--port", str(port)], cwd=ROOT, stdout=out, stderr=err)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"apps.serve exited with {proc.returncode}")
                try:
                    http_get(f"{base}/stats", timeout=5)
                    break
                except OSError:
                    if time.perf_counter() - t0 > 300:
                        raise
                    time.sleep(0.5)
            up_s = time.perf_counter() - t0
            page, ctype = http_get(f"{base}/")
            if not ctype.startswith("text/html") or b"arcball" not in page.lower():
                raise AssertionError(f"/ served {ctype}, not the viewer")
            t1 = time.perf_counter()
            http_json(f"{base}/ctrl?cmd=start")
            while not http_json(f"{base}/ctrl?cmd=status")["done"]:
                if time.perf_counter() - t1 > 300:
                    raise AssertionError("the replay did not end")
                time.sleep(0.1)
            stats = http_json(f"{base}/stats")
            replay_s = time.perf_counter() - t1
            png, ctype = http_get(f"{base}/render?fmt=png&view=rgba")
            path = os.path.join(str(build.BUILD_DIR), "serve_app_render.png")
            with open(path, "wb") as f:
                f.write(png)
            img = read_png(path)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    with open(err_path) as f:
        stderr = f.read()
    log(f"[chip_smoke] apps.serve --synthetic {SERVE_APP_FRAMES}: up in {up_s:.1f} s, replay "
        f"{replay_s:.2f} s, /stats {stats}; /render PNG {img.shape} {img.dtype}; stopped "
        f"(exit {proc.returncode}); traceback on stderr: {'Traceback' in stderr} ({smi})")
    if (stats["frames"] != SERVE_APP_FRAMES or not stats["replay"]["done"]
            or stats["active_blocks"] == 0 or img.shape != (360, 640, 4)
            or "Traceback" in stderr):
        raise AssertionError(f"apps.serve: stats {stats}, render {img.shape}, stderr "
                             f"{stderr[-2000:]}")
    return {"up_s": up_s, "replay_s": replay_s, "stats": stats}


def live_block_rows(vol):
    """(sorted live keys, their tsdf, rgbw and prob rows) on the device."""
    live = (vol.entry_block >= 0).nonzero().flatten()
    keys, order = torch.sort(vol.entry_key[live])
    rows = vol.entry_block[live][order].long()
    return keys, vol.tsdf[rows], vol.rgbw[rows], vol.prob[rows]


def spill_at_scale(grid, smi) -> dict:
    """Phase 9c: on phase 3's volume, the dense window recentred away so
    that every block spills to a host store, then back: the store empties,
    each block's rows come back bit for bit, and the volume validates."""
    from disinfect_slam_tpu_torch.ops.hash import window_origin
    from disinfect_slam_tpu_torch.systems.block_streaming import HostBlockStore
    from disinfect_slam_tpu_torch.utils.validate import validate_volume

    cfg = grid.cfg
    before = live_block_rows(grid.volume)
    n_live = before[0].numel()
    origin = window_origin(cfg)
    bs = cfg.block_len * cfg.voxel_size
    # a window one side further along x: no live block stays in it
    away = ((cfg.grid_side + 1.5) * bs, 0.0, 0.0)
    grid.spill_store = HostBlockStore()
    try:
        torch.cuda.synchronize()
        moved, spill_ms = timed_ms(lambda: grid.recenter(away))
        spilled, active = len(grid.spill_store), grid.num_active_blocks()
        nbytes = grid.spill_store.nbytes()
        moved_back, restore_ms = timed_ms(lambda: grid.recenter((0.0, 0.0, 0.0)))
        torch.cuda.synchronize()
        after = live_block_rows(grid.volume)
        equal = [torch.equal(a, b) for a, b in zip(after, before)]
        left = len(grid.spill_store)
    finally:
        grid.spill_store = None
    errors = validate_volume(grid.volume, strict=False)
    log(f"[chip_smoke] spill at scale: {n_live} live blocks; the window moved away "
        f"({moved}): {spilled} blocks spilled in {spill_ms:.1f} ms ({nbytes / 1e6:.1f} MB on "
        f"the host), {active} left on the card; back ({moved_back}, origin "
        f"{window_origin(grid.cfg)} == {origin}): restored in {restore_ms:.1f} ms, {left} "
        f"left in the store; keys and rows bit-equal {equal}; validate {errors} ({smi})")
    if (not (moved and moved_back) or spilled != n_live or active != 0 or left
            or not all(equal) or errors or window_origin(grid.cfg) != origin):
        raise AssertionError("spill at scale: the roundtrip lost or changed blocks")
    return {"blocks": n_live, "spill_ms": spill_ms, "restore_ms": restore_ms,
            "nbytes": nbytes}


def paged_app(offline, fuse_kernel, smi, label, *flags) -> dict:
    """Phase 9c, the app: apps.offline --preset small --spill --page-radius
    1.0 --debug --save over the 60 frames with `flags`: fuse_rows once a
    frame, validate_volume after every frame, and the dump with the store's
    records appended covers every block the card and the store hold."""
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.ops.gather import load_spatial_tsdf

    save = os.path.join(str(build.BUILD_DIR), f"data_{label}.bin")
    reset_launches(fuse_kernel.fuse_rows)
    res = offline.main(["--logdir", DATASET, "--config", os.path.join(DATASET, "cam.yaml"),
                        "--preset", "small", *flags, "--spill", "--page-radius", "1.0",
                        "--debug", "--save", save, "--device", "cuda"])
    launches = fuse_kernel.fuse_rows.launches
    grid, store = res["grid"], res["grid"].spill_store
    rec = load_spatial_tsdf(save)
    blocks = np.unique(np.floor(np.round(rec[:, :3] / grid.cfg.voxel_size)
                                / grid.cfg.block_len).astype(np.int64), axis=0)
    vol = grid.volume
    on_card = vol.entry_pos[vol.entry_block >= 0].cpu().numpy().astype(np.int64)
    stored = np.array(list(store._store), np.int64).reshape(-1, 3)
    held = np.unique(np.concatenate([on_card, stored]), axis=0)
    covered = (rec.shape[0] == res["records"] + res["spilled_records"]
               and np.array_equal(blocks, held))
    evicted = sum(e for _, _, e in res["pages"])
    log(f"[chip_smoke] paged app ({label}: {' '.join(flags) or 'the preset window'}): "
        f"{res['frames']} frames, "
        f"fuse_rows launches {launches}, validated {res['validated']} frames, window moved at "
        f"{res['recenter_frames']}, pages (frame, restored, evicted) {res['pages']}, "
        f"{on_card.shape[0]} blocks on the card and {stored.shape[0]} in the store; the dump "
        f"({res['records']} + {res['spilled_records']} records) covers every block either "
        f"holds: {covered}; integrate {1e3 * statistics.mean(res['integrate_s']):.3f} "
        f"ms/frame ({smi})")
    if (launches != res["frames"] or res["frames"] != 60 or res["validated"] != 60
            or not covered):
        raise AssertionError(f"paged app ({label}): launches, validation or the dump's "
                             f"coverage failed")
    return {"fuse_rows_launches": launches, "moves": res["recenter_frames"],
            "pages": res["pages"], "evicted": evicted, "stored_blocks": int(stored.shape[0]),
            "card_blocks": int(on_card.shape[0]), "spilled_records": res["spilled_records"]}


def cull_replay(offline, grid, fuse_kernel, fused_ms, smi, dev) -> dict:
    """Phase 9d: the bench replay through integrate, in process, with the
    occlusion cull off and on (each frame synchronised at both ends,
    uploads outside): both volumes equal phase 3's bit for bit, the cull
    keeps fewer visible rows a frame, and each run's fusion ms/frame."""
    import dataclasses

    from disinfect_slam_tpu_torch.core.geometry import SE3
    from disinfect_slam_tpu_torch.core.state import TSDFVolume
    from disinfect_slam_tpu_torch.ops.integrate import integrate

    cfg, voxel, trunc, max_depth = offline.make_config(offline.parse_args(
        ["--logdir", DATASET, "--preset", "bench", "--sampler", "pallas_fused"]))
    cfg = dataclasses.replace(cfg, voxel_size=voxel, truncation=trunc)
    cam, frames = bench_frames(0, 60)
    out = {}
    for cull in (False, True):
        vol = TSDFVolume.create(dataclasses.replace(cfg, cull_occluded=cull), dev)
        reset_launches(fuse_kernel.fuse_rows)
        ms, rows = [], []
        for i, fr in enumerate(frames):
            frame, pose = upload_frame(fr, dev), SE3.from_matrix(fr.cam_T_world)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vol, stats = integrate(vol, frame, cam, pose, max_depth,
                                   allocate=i % cfg.alloc_every == 0, return_stats=True)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            rows.append(int(stats.visible_count))
        equal = volumes_equal(vol, grid.volume)
        out["on" if cull else "off"] = {
            "ms_per_frame": statistics.mean(ms), "visible_rows_mean": statistics.mean(rows),
            "fuse_rows_launches": fuse_kernel.fuse_rows.launches, "equal": all(equal.values())}
        del vol
        torch.cuda.empty_cache()
    on, off = out["on"], out["off"]
    log(f"[chip_smoke] cull replay: visible rows a frame {on['visible_rows_mean']:.1f} with the "
        f"cull against {off['visible_rows_mean']:.1f} without; fusion {on['ms_per_frame']:.3f} "
        f"against {off['ms_per_frame']:.3f} ms/frame (phase 3's app replay {fused_ms:.3f}); "
        f"fuse_rows launches {on['fuse_rows_launches']} / {off['fuse_rows_launches']}; both "
        f"volumes bit-equal to phase 3's: {on['equal']} / {off['equal']} ({smi})")
    if (not (on["equal"] and off["equal"])
            or not on["visible_rows_mean"] < off["visible_rows_mean"]
            or on["fuse_rows_launches"] != 60):
        raise AssertionError("cull replay: the volume changed or nothing was culled")
    return out


def view_volume_app(grid, splat_kernel, smi) -> dict:
    """Phase 9e: apps.view_volume on a checkpoint of phase 3's volume:
    each splat kernel launches once a view, and the PNGs decode."""
    from disinfect_slam_tpu_torch.apps import view_volume
    from disinfect_slam_tpu_torch.io.checkpoint import save_volume
    from disinfect_slam_tpu_torch.io.png_io import read_png
    from disinfect_slam_tpu_torch.ops.cuda import build

    path = os.path.join(str(build.BUILD_DIR), "phase3_volume.npz")
    _, save_ms = timed_ms(lambda: save_volume(path, grid.volume))
    splat_fns = (splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks)
    reset_launches(*splat_fns)
    res, view_ms = timed_ms(lambda: view_volume.main(
        ["--volume", path, "--out", os.path.join(str(build.BUILD_DIR), "views"), "--frames",
         str(VIEW_FRAMES), "--device", "cuda"]))
    launches = [fn.launches for fn in splat_fns]
    shapes = {read_png(p).shape for p in res["paths"]}
    os.remove(path)
    log(f"[chip_smoke] apps.view_volume: checkpoint written in {save_ms:.0f} ms; {VIEW_FRAMES} "
        f"views in {view_ms:.0f} ms (load included), splat launches {launches}, hit "
        f"{[round(h, 3) for h in res['hit']]}, {len(res['paths'])} PNGs of {shapes} ({smi})")
    if (launches != [VIEW_FRAMES] * 2 or len(res["paths"]) != 2 * VIEW_FRAMES
            or shapes != {(360, 640, 4)} or min(res["hit"]) <= 0):
        raise AssertionError("apps.view_volume: launches, PNGs or hits wrong")
    return {"splat_launches": launches, "ms": view_ms, "save_ms": save_ms, "hit": res["hit"]}


def served_map_slice(offline, grid, fuse_kernel, splat_kernel, ref, fused_ms, smi, dev) -> dict:
    """Phase 9 (see the docstring), in an order that leaves phase 3's
    volume as it is until the spill roundtrip moves its pool rows."""
    with open(EXPORT_FINGERPRINT) as f:
        export_ref = json.load(f)
    out = {"service": served_map(offline, grid, fuse_kernel, splat_kernel, ref, export_ref,
                                 smi, dev)}
    torch.cuda.empty_cache()
    out["cull"] = cull_replay(offline, grid, fuse_kernel, fused_ms, smi, dev)
    out["view"] = view_volume_app(grid, splat_kernel, smi)
    out["spill"] = spill_at_scale(grid, smi)
    # the window of RECENTER_GRID_LOG2 moves (once: the orbit stays near
    # its centre after); the preset's own 2^7 window holds the whole scene,
    # whose blocks outgrow the 4096-block pool, so that paging evicts
    out["paged_app"] = paged_app(offline, fuse_kernel, smi, "recenter", "--grid-log2",
                                 str(RECENTER_GRID_LOG2), "--auto-recenter")
    out["paging_app"] = paged_app(offline, fuse_kernel, smi, "paging")
    if not out["paged_app"]["moves"] or not (out["paging_app"]["evicted"]
                                             and out["paging_app"]["stored_blocks"]):
        raise AssertionError("paged apps: the window did not move or nothing was paged out")
    torch.cuda.empty_cache()
    out["app"] = serve_app(smi)
    return out


# ----------------------------------------------------------------------
# phase 10: training the seg net, the sharded volume, the host library
# ----------------------------------------------------------------------
DIST_FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                "orbit_vga_dist_fingerprint.json")
DIST_SHARDS = 4
TRAIN_STEPS = 10  # full-width steps timed per net (median of the last 8)
TRAIN_BATCH, TRAIN_H, TRAIN_W = 8, 352, 640  # the inference contract's 352x640
TRAIN_APP_STEPS = 600
# the first step on the card against the CPU's from the same parameters
# (a narrow net, 48x64): float32 within tests/test_torch_train.py's
# limits against JAX (loss 1e-5, each gradient 1e-4 relative by norm:
# TF32 would move them by ~1e-3); bfloat16 within its bfloat16 ones (loss
# 5e-4, the gradients together 0.1), and the two updates at cosine 0.9 or
# more: Adam's first step moves each parameter by about lr times the sign
# of its gradient, so a near-zero gradient rounded to the other sign
# moves its parameter 2 lr the other way (port against JAX on the CPU:
# the updates 0.31 apart by norm)
TRAIN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (5e-4, 0.1)}
TRAIN_UPDATE_COS = 0.9
# tests/test_seg_training.py:test_shipped_weights_iou's held-out set and bar
IOU_SEED, IOU_N, IOU_H, IOU_W, IOU_BAR = 77, 6, 96, 160, 0.7
HOST_LOG_FRAMES = 30
SEG_CKPT_FRAMES = 5


def train_batches(n: int, dev):
    """n batches of make_batch scenes at the contract's size, on the card."""
    from disinfect_slam_tpu_torch.models.synth_data import make_batch

    rng = np.random.default_rng(0)
    return [tuple(torch.from_numpy(a).to(dev) for a in
                  make_batch(rng, TRAIN_BATCH, TRAIN_H, TRAIN_W)) for _ in range(n)]


def train_full_width(dev, batches, smi) -> dict:
    """Phase 10a: UNetSeg and FastSeg at their shipped widths, TRAIN_STEPS
    steps of make_train_step each (AdamW at 3e-3, the rate
    tests/test_seg_training.py's falling-loss test uses): the loss finite
    and falling, the step's ms (CUDA events, median of the last 8) and
    the peak memory."""
    from disinfect_slam_tpu_torch.models import train

    res = {}
    for arch in ("unet", "fast"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = train.create_train_state(arch=arch, lr=3e-3, device=dev,
                                         generator=torch.Generator().manual_seed(0))
        step = train.make_train_step(state.model, state.opt)
        losses, events = [], []
        for imgs, labs in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss = step(state, imgs, labs)
            end.record()
            losses.append(loss)
            events.append((start, end))
        torch.cuda.synchronize()
        losses = [float(v) for v in losses]
        ms = [a.elapsed_time(b) for a, b in events]
        r = {"params": sum(p.numel() for p in state.model.parameters()), "losses": losses,
             "step_ms": ms, "step_ms_median": statistics.median(ms[2:]),
             "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        log(f"[chip_smoke] train {arch} ({r['params'] / 1e6:.2f} M params) at {TRAIN_H}x"
            f"{TRAIN_W} batch {TRAIN_BATCH}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, step "
            f"{r['step_ms_median']:.2f} ms (median of the last {len(ms) - 2}; first "
            f"{ms[0]:.1f} ms), peak memory {r['peak_gb']:.2f} GB ({smi})")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train {arch}: the loss did not fall: {losses}")
        res[arch] = r
        del state, step
    torch.cuda.empty_cache()
    return res


def _first_step(device, dtype):
    """The first train step of a narrow UNetSeg (8, 16, 16, 16) at 48x64,
    batch 2, from seed-0 parameters: (loss, gradients, update)."""
    from disinfect_slam_tpu_torch.models import segmentation as seg
    from disinfect_slam_tpu_torch.models import synth_data, train

    net = seg.create_model((8, 16, 16, 16), dtype=dtype,
                           generator=torch.Generator().manual_seed(0))
    before = [p.detach().clone().cpu() for p in net.parameters()]
    state = train.create_train_state(net, lr=1e-3, device=device)
    imgs, labs = (torch.from_numpy(a).to(device) for a in
                  synth_data.make_batch(np.random.default_rng(0), 2, 48, 64))
    state, loss = train.make_train_step(state.model, state.opt)(state, imgs, labs)
    ps = list(state.model.parameters())
    grads = torch.cat([p.grad.detach().cpu().flatten() for p in ps])
    update = torch.cat([(p.detach().cpu() - b).flatten() for p, b in zip(ps, before)])
    per_param = [p.grad.detach().cpu() for p in ps]
    return float(loss), grads, update, per_param


def train_card_vs_cpu() -> dict:
    """Phase 10a: the first step on the card against the CPU's, float32
    and bfloat16 (TRAIN_TOL); the TF32 flags as they were after it."""
    dev = torch.device("cuda", 0)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    res = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        lc, gc, uc, pc = _first_step("cpu", dtype)
        lg, gg, ug, pg = _first_step(dev, dtype)
        rel = lambda a, b: float((a - b).norm() / b.norm().clamp(min=1e-30))  # noqa: E731
        r = {"loss_card": lg, "loss_cpu": lc, "loss_diff": abs(lg - lc),
             "grad_rel": rel(gg, gc), "grad_rel_worst": max(rel(a, b) for a, b in zip(pg, pc)),
             "update_cos": float(ug @ uc / (ug.norm() * uc.norm()))}
        loss_tol, grad_tol = TRAIN_TOL[name]
        worst = r["grad_rel_worst"] if name == "float32" else r["grad_rel"]
        log(f"[chip_smoke] first train step {name}, card against CPU: loss {lg:.6f} / "
            f"{lc:.6f} (diff {r['loss_diff']:.2e}, limit {loss_tol:g}), gradients "
            f"{r['grad_rel']:.2e} apart (worst tensor {r['grad_rel_worst']:.2e}; limit "
            f"{grad_tol:g}), updates at cosine {r['update_cos']:.4f}")
        if not (r["loss_diff"] <= loss_tol and worst <= grad_tol
                and r["update_cos"] >= TRAIN_UPDATE_COS):
            raise AssertionError(f"first train step {name}: card and CPU disagree: {r}")
        res[name] = r
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != flags:
        raise AssertionError("the train step left the TF32 flags changed")
    return res


def logged_frames(logdir: str, n: int) -> list:
    """apps/online.py's log layout: FrameLogger writes the first n frames
    of orbit_vga (u8 rgb, depth at 1/5000 m) and the camera YAML.  Returns
    what the logger was given."""
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
    from disinfect_slam_tpu_torch.io.logger import FrameLogger

    if os.path.isdir(logdir):
        shutil.rmtree(logdir)
    logger = FrameLogger(logdir, depth_factor=5000.0)
    given = []
    for fr in LoggedReplay(DATASET, 5000.0):
        item = (fr.frame_id, fr.rgb.astype(np.uint8), fr.depth, fr.cam_T_world)
        logger.log_data(item)
        given.append(item)
        if len(given) == n:
            break
    logger.close()
    shutil.copy(os.path.join(DATASET, "cam.yaml"), os.path.join(logdir, "cam.yaml"))
    return given


def train_app(fuse_kernel, smi) -> dict:
    """Phase 10b: apps.train_seg as a user runs it (its own process, no
    --device: the card) for TRAIN_APP_STEPS steps at its defaults, --out in
    a temp dir; its npz through load_model against IoU_BAR on the held-out
    set of tests/test_seg_training.py, beside the shipped checkpoint's IoU
    there; then a msgpack save_checkpoint of it through apps.online
    --seg-ckpt --fused over SEG_CKPT_FRAMES logged frames."""
    from disinfect_slam_tpu_torch.apps import online
    from disinfect_slam_tpu_torch.models import segmentation as seg
    from disinfect_slam_tpu_torch.models import synth_data, train
    from disinfect_slam_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="train_seg_", dir=str(build.BUILD_DIR))
    out = os.path.join(tmp, "seg_unet_f16.npz")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "disinfect_slam_tpu_torch.apps.train_seg",
                           "--steps", str(TRAIN_APP_STEPS), "--out", out], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"apps.train_seg failed ({proc.returncode}): {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        log(f"[chip_smoke] {line}")
    imgs, labs = (torch.from_numpy(a).to(dev) for a in synth_data.make_batch(
        np.random.default_rng(IOU_SEED), IOU_N, IOU_H, IOU_W))
    model = seg.load_model("unet", out, device=dev)
    iou = train.make_eval_step(model)(imgs, labs)["iou"].cpu().numpy()
    shipped = train.make_eval_step(seg.load_model("unet", device=dev))(imgs, labs)["iou"]
    shipped = shipped.cpu().numpy()
    res = {"steps": TRAIN_APP_STEPS, "wall_s": wall_s, "iou": iou.tolist(),
           "shipped_iou": shipped.tolist(), "last_line": lines[-1]}
    log(f"[chip_smoke] apps.train_seg {TRAIN_APP_STEPS} steps in {wall_s:.1f} s wall ({smi}); "
        f"held-out IoU (default_rng({IOU_SEED}), {IOU_N} scenes at {IOU_H}x{IOU_W}) ht "
        f"{iou[0]:.4f} lt {iou[1]:.4f} against the shipped checkpoint's ht {shipped[0]:.4f} "
        f"lt {shipped[1]:.4f} (bar {IOU_BAR})")
    if not (iou > IOU_BAR).all():
        raise AssertionError(f"the card-trained checkpoint's IoU {iou} is not above {IOU_BAR}")

    ckpt = os.path.join(tmp, "seg_unet.msgpack")
    train.save_checkpoint(ckpt, model)
    want = seg.flax_from_state_dict(model.state_dict())
    got = train.load_params(ckpt)
    if set(got) != set(want) or any(not np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError("the msgpack checkpoint does not read back its parameters")
    logdir = os.path.join(tmp, "log5")
    logged_frames(logdir, SEG_CKPT_FRAMES)
    fuse_kernel.fuse_rows.launches = 0
    r = online.main(["--logdir", logdir, "--config", os.path.join(logdir, "cam.yaml"),
                     "--segment", "--seg-ckpt", ckpt, "--fused", "--device", "cuda"])
    launches = fuse_kernel.fuse_rows.launches
    log(f"[chip_smoke] apps.online --seg-ckpt (msgpack) --fused: {r['frames']} frames, "
        f"{r['active_blocks']} active blocks, fuse_rows launches {launches}")
    if r["frames"] != SEG_CKPT_FRAMES or launches != SEG_CKPT_FRAMES or r["active_blocks"] <= 0:
        raise AssertionError(f"apps.online --seg-ckpt: {r['frames']} frames, fuse_rows "
                             f"launched {launches} times")
    res["seg_ckpt_app"] = {"frames": r["frames"], "fuse_rows_launches": launches,
                           "active_blocks": r["active_blocks"]}
    return res


def dist_rows(dist):
    """Every live block of a DistributedTSDF ordered by key, on the first
    shard's device: (keys, tsdf rows, rgbw rows, prob rows)."""
    dev = dist.mesh[0]
    parts = []
    for s in dist.shards:
        live = s.entry_block >= 0
        rows = s.entry_block[live].long()
        parts.append([t.to(dev) for t in (s.entry_key[live], s.tsdf[rows], s.rgbw[rows],
                                          s.prob[rows])])
    cat = [torch.cat(x) for x in zip(*parts)]
    order = torch.argsort(cat[0])
    return [t[order] for t in cat]


def same_rows(a, b) -> bool:
    return all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def dist_replay(frames, intrinsics, mesh, fuse_kernel):
    """The bench preset's DistributedTSDF over `mesh`, the frames one by
    one (each integrate synchronised): (volume, ms per frame, fuse_rows
    launches, the cuts (candidates, visible blocks) summed over frames
    and shards)."""
    from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput
    from disinfect_slam_tpu_torch.parallel.sharding import DistributedTSDF

    dist = DistributedTSDF(BENCH, mesh)
    fuse_kernel.fuse_rows.launches = 0
    ms, cuts = [], []
    for fr in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.integrate(FrameInput(fr.rgb, fr.depth, fr.ht, fr.lt), intrinsics, fr.cam_T_world,
                       BENCH_MAX_DEPTH, cuts=cuts)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    cut = [int(sum(int(c[i]) for c in cuts)) for i in range(2)]
    return dist, ms, fuse_kernel.fuse_rows.launches, cut


def dist_slice(fuse_kernel, splat_kernel, intrinsics, poses, fused_ms, export_ref, smi) -> dict:
    """Phase 10c: the sharded volume at the bench preset (see the
    docstring)."""
    from disinfect_slam_tpu_torch.config import BENCH_MAX_DEPTH
    from disinfect_slam_tpu_torch.core.geometry import CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.ops.gather import BoundingCube
    from disinfect_slam_tpu_torch.parallel.sharding import load_distributed, save_distributed

    with open(DIST_FINGERPRINT) as f:
        ref = json.load(f)
    dev = torch.device("cuda", 0)
    frames = [fr for _, fr in zip(range(ref["frames"]), LoggedReplay(DATASET, 5000.0))]
    n = len(frames)
    res = {"frames": n, "shards": DIST_SHARDS}
    dists = {}
    for shards in (DIST_SHARDS, 1):
        dist, ms, launches, cut = dist_replay(frames, intrinsics, [dev] * shards, fuse_kernel)
        fp = dist.fingerprint()
        r = {"ms_per_frame": statistics.mean(ms), "ms_per_frame_median": statistics.median(ms),
             "fuse_rows_launches": launches, "candidate_cut": cut[0], "visible_cut": cut[1],
             "per_shard_active_blocks": fp["per_shard_active_blocks"], "fingerprint": fp}
        log(f"[chip_smoke] sharded replay, {shards} shard(s) on one card: {n} frames, "
            f"{r['ms_per_frame']:.3f} ms/frame (median {r['ms_per_frame_median']:.3f}; phase 3's "
            f"app replay {fused_ms:.3f}) ({smi}); fuse_rows launches {launches}; active blocks "
            f"{fp['per_shard_active_blocks']}; candidates cut {cut[0]}, visible blocks cut "
            f"{cut[1]}")
        if launches != shards * n:
            raise AssertionError(f"{shards} shard(s): fuse_rows launched {launches} times for "
                                 f"{n} frames")
        fp["records"] = int(dist.gather_all_tsdf().shape[0])
        want = ref[f"shards_{shards}"]
        checks = fingerprint_gaps(fp, want)
        for k, (dev_, tol) in checks.items():
            log(f"[chip_smoke] sharded {shards}: {k} port {fp[k]} JAX ({shards} virtual CPU "
                f"device(s)) {want[k]} rel dev {dev_:.3e} (limit {tol:g})")
        log(f"[chip_smoke] sharded {shards}: live-block key hash matches the JAX one exactly: "
            f"{fp['keys_sha256'] == want['keys_sha256']}")
        failed = {k: v for k, v in checks.items() if not v[0] <= v[1]}
        if failed:
            raise AssertionError(f"sharded {shards}: fingerprint outside tolerance: {failed}")
        dists[shards] = (dist, r)
        res[f"shards_{shards}"] = r
    d4, d1 = dists[DIST_SHARDS][0], dists[1][0]
    rows1 = dist_rows(d1)
    equal = same_rows(dist_rows(d4), rows1)
    cuts = sum(res[f"shards_{s}"][k] for s in (DIST_SHARDS, 1)
               for k in ("candidate_cut", "visible_cut"))
    log(f"[chip_smoke] sharded: the {DIST_SHARDS}-shard volume equals the 1-shard one bit for "
        f"bit (keys, tsdf, rgbw, prob of every block): {equal}; capacity cuts {cuts}")
    if not equal and not cuts:
        raise AssertionError("the 4-shard volume differs from the 1-shard one with no cut")
    res["equal_to_one_shard"] = equal

    path = os.path.join(str(build.BUILD_DIR), "dist4.npz")
    t0 = time.perf_counter()
    n_blocks = save_distributed(path, d4)
    save_s = time.perf_counter() - t0
    rows4 = dist_rows(d4)
    restored = {}
    for shards in (2, 1):
        t0 = time.perf_counter()
        r = load_distributed(path, [dev] * shards)
        load_s = time.perf_counter() - t0
        restored[shards] = {"load_s": load_s, "equal": same_rows(dist_rows(r), rows4)}
    del rows4
    log(f"[chip_smoke] elastic checkpoint: {n_blocks} blocks saved in {save_s:.1f} s "
        f"({os.path.getsize(path) / 1e6:.1f} MB); restored onto 1 and 2 shards in "
        f"{restored[1]['load_s']:.1f} / {restored[2]['load_s']:.1f} s, records identical: "
        f"{restored[1]['equal']} / {restored[2]['equal']}")
    if not (restored[1]["equal"] and restored[2]["equal"]):
        raise AssertionError("an elastic restore differs from the saved volume")
    res["elastic"] = {"blocks": n_blocks, "save_s": save_s, "mb": os.path.getsize(path) / 1e6,
                      "restored": restored}

    # the query and the render against one shard holding the same map: the
    # 1-shard restore of the 4-shard volume (the 1-shard replay's map
    # differs where its max_candidates cut binds)
    one = r
    cube = BoundingCube(*export_ref["bridge"]["cube"])
    t0 = time.perf_counter()
    q4 = d4.query_bbox(cube)
    q_ms = 1e3 * (time.perf_counter() - t0)
    q1 = one.query_bbox(cube)
    srt = lambda r: r[np.lexsort((r[:, 3], r[:, 2], r[:, 1], r[:, 0]))]  # noqa: E731
    q_equal = q4.shape == q1.shape and np.array_equal(srt(q4), srt(q1))
    log(f"[chip_smoke] sharded query_bbox of the bridge cube: {q4.shape[0]} records in "
        f"{q_ms:.1f} ms, equal as a set to one shard's holding the same map: {q_equal}")
    if not q_equal or q4.shape[0] == 0:
        raise AssertionError(f"sharded query_bbox: {q4.shape} against {q1.shape}")
    res["query"] = {"records": int(q4.shape[0]), "ms": q_ms}

    cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), H, W)
    splat_fns = (splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks)
    reset_launches(*splat_fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r4 = d4.render(cam, poses[0], BENCH_MAX_DEPTH)
    torch.cuda.synchronize()
    render_ms = 1e3 * (time.perf_counter() - t0)
    render_launches = [fn.launches for fn in splat_fns]
    r1 = one.render(cam, poses[0], BENCH_MAX_DEPTH)
    hit4, hit1 = r4.hit.cpu().numpy(), r1.hit.cpu().numpy()
    both = hit4 & hit1
    hit_agree = float((hit4 == hit1).mean())
    depth_err = float(np.abs(r4.depth.cpu().numpy() - r1.depth.cpu().numpy())[both].max())
    log(f"[chip_smoke] sharded render at frame 0's pose, {W}x{H}: {render_ms:.1f} ms; splat "
        f"launches {render_launches}; {int(hit4.sum())} hits, hit agreement with one shard "
        f"holding the same map {hit_agree:.6f} (limit 0.995), depth max |diff| "
        f"{depth_err:.2e} (limit 2e-3)")
    if render_launches != [DIST_SHARDS] * 2 or hit_agree < 0.995 or depth_err > 2e-3:
        raise AssertionError(f"sharded render: launches {render_launches}, hit agreement "
                             f"{hit_agree}, depth {depth_err}")
    res["render"] = {"ms": render_ms, "launches": render_launches, "hits": int(hit4.sum()),
                     "hit_agreement": hit_agree, "depth_max_err": depth_err}
    del r4, r1, r, one
    torch.cuda.empty_cache()

    # where a sharded frame's time goes: frame 59 again on each volume,
    # profiled (after every timed replay: a trace slows the host)
    for shards, dist in ((DIST_SHARDS, d4), (1, d1)):
        res[f"shards_{shards}"]["profile"] = dist_profile(dist, frames[-1], intrinsics)

    app_npz = os.path.join(str(build.BUILD_DIR), "dist_app.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "disinfect_slam_tpu_torch.apps.offline", "--logdir", DATASET,
         "--config", os.path.join(DATASET, "cam.yaml"), "--preset", "bench", "--devices", "1",
         "--save-dist", app_npz, "--prefetch", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    app_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"apps.offline --devices 1 failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    for line in proc.stdout.strip().splitlines():
        log(f"[chip_smoke] {line}")
    if "[offline] shard | active blocks | share" not in proc.stdout:
        raise AssertionError("apps.offline --devices 1 printed no scaling table")
    app_equal = same_rows(dist_rows(load_distributed(app_npz, [dev])), rows1)
    log(f"[chip_smoke] apps.offline --preset bench --devices 1 --save-dist: {app_s:.1f} s wall; "
        f"its checkpoint restores equal to the in-process 1-shard volume: {app_equal}")
    if not app_equal:
        raise AssertionError("the app's elastic checkpoint differs from the 1-shard volume")
    res["app"] = {"wall_s": app_s, "equal": app_equal}
    del dists, d4, d1, rows1
    torch.cuda.empty_cache()
    return res


def dist_profile(dist, fr, intrinsics) -> dict:
    """One integrate of a DistributedTSDF under the profiler: wall ms,
    device kernel ms, kernels and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.config import BENCH_MAX_DEPTH
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dist.integrate(FrameInput(fr.rgb, fr.depth, fr.ht, fr.lt), intrinsics, fr.cam_T_world,
                       BENCH_MAX_DEPTH)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    res = {"wall_ms": wall_ms, "device_ms": device_ms or None, "kernels": len(events) or None,
           "idle_share": 1 - device_ms / wall_ms if device_ms else None}
    log(f"[chip_smoke] sharded frame profiled, {dist.n_devices} shard(s): wall {wall_ms:.2f} "
        "ms, " + (f"device kernel time {device_ms:.3f} ms in {len(events)} kernels, idle share "
                  f"{res['idle_share']:.3f}" if events else "no device event traced (not "
                                                            "measured)"))
    return res


def host_library(smi) -> dict:
    """Phase 10d: FrameLogger writes HOST_LOG_FRAMES orbit_vga frames and
    LoggedReplay reads them back bit-equal to what the logger was given
    (u8 rgb, depth after its u16 quantisation at 1/5000 m; poses to the
    trajectory's 9 decimals); the native runtime builds from its source
    and its pose buffer answers as PoseManager does over the orbit's
    poses."""
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
    from disinfect_slam_tpu_torch.native import runtime
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.systems.pose_manager import PoseManager

    logdir = os.path.join(str(build.BUILD_DIR), "logged30")
    t0 = time.perf_counter()
    given = logged_frames(logdir, HOST_LOG_FRAMES)
    log_s = time.perf_counter() - t0
    back = list(LoggedReplay(logdir, 5000.0))
    ok = [f.frame_id for f in back] == [g[0] for g in given]
    pose_err = 0.0
    for fr, (_, rgb, depth, pose) in zip(back, given):
        d16 = np.clip(np.asarray(depth) * 5000.0, 0, 65535).astype(np.uint16)
        ok &= np.array_equal(fr.rgb, rgb.astype(np.float32))
        ok &= np.array_equal(fr.depth, d16.astype(np.float32) / 5000.0)
        pose_err = max(pose_err, float(np.abs(fr.cam_T_world - pose).max()))
    log(f"[chip_smoke] FrameLogger: {len(back)} frames logged in {log_s:.2f} s and read back "
        f"by LoggedReplay bit-equal: {ok}; poses within {pose_err:.1e}")
    if not ok or len(back) != HOST_LOG_FRAMES or pose_err > 1e-6:
        raise AssertionError("the logged frames do not read back as written")

    t0 = time.perf_counter()
    built = runtime.available()
    build_s = time.perf_counter() - t0
    if not built:
        raise AssertionError(f"the native runtime did not build ({runtime.compiler()})")
    rng = np.random.default_rng(0)
    queries = rng.integers(-20, 33 * HOST_LOG_FRAMES + 20, 200)
    errs = {}
    # the orbit's poses by nearest neighbour (the reference's query), and
    # random rotations interpolated: the orbit's rotations lie near 180
    # degrees (|w| < 1e-3), where PoseManager's quaternion from
    # sqrt(1 + trace) loses about 1e-3 and the native branch-wise one does
    # not, so interpolating them would measure PoseManager's rounding
    for name, interpolate, poses in (
            ("orbit, nearest", False, [g[3] for g in given]),
            ("random, interpolated", True, [random_pose(rng) for _ in range(HOST_LOG_FRAMES)])):
        buf, ref = runtime.NativePoseBuffer(interpolate), PoseManager(interpolate)
        for i, pose in enumerate(poses):
            buf.register_valid_pose(33 * i, pose)
            ref.register_valid_pose(33 * i, pose)
        errs[name] = max(float(np.abs(buf.query_pose(int(t)) - ref.query_pose(int(t))).max())
                         for t in queries)
    log(f"[chip_smoke] native runtime: built with {runtime.compiler()} in {build_s:.2f} s "
        f"({os.path.relpath(str(runtime.library_path()), ROOT)}); pose buffer against "
        f"PoseManager over {len(queries)} queries, max |diff|: "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()) + f" ({smi})")
    if max(errs.values()) > 2e-6:
        raise AssertionError(f"the native pose buffer differs from PoseManager: {errs}")
    return {"logged_frames": len(back), "log_s": log_s, "pose_err": pose_err,
            "native_build_s": build_s, "native_pose_err": errs}


def random_pose(rng) -> np.ndarray:
    """A 4x4 cam_T_world of a random unit quaternion and translation."""
    q = rng.standard_normal(4)
    w, x, y, z = q / np.linalg.norm(q)
    m = np.eye(4)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    m[:3, 3] = rng.uniform(-3, 3, 3)
    return m


def train_profile(batches) -> dict:
    """Phase 10a's launches a train step: one profiled step per net (after
    phase 10's timed work: a trace slows the host for the rest of the
    process)."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.models import train

    dev = torch.device("cuda", 0)
    res = {}
    for arch in ("unet", "fast"):
        state = train.create_train_state(arch=arch, lr=3e-3, device=dev)
        step = train.make_train_step(state.model, state.opt)
        step(state, *batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, *batches[1])
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        # a trace that caught no device event measured nothing
        res[arch] = {"launches": len(events) or None, "device_ms": device_ms or None}
        log(f"[chip_smoke] train {arch} step profiled: "
            + (f"{len(events)} kernels, {device_ms:.2f} ms of device time" if events
               else "no device event traced (not measured)"))
        del state, step
    torch.cuda.empty_cache()
    return res


def train_dist_host(fuse_kernel, splat_kernel, intrinsics, poses, fused_ms, smi) -> dict:
    """Phase 10 (see the docstring): a-d, then the train step's profile."""
    dev = torch.device("cuda", 0)
    with open(EXPORT_FINGERPRINT) as f:
        export_ref = json.load(f)
    t = time.perf_counter()
    batches = train_batches(TRAIN_STEPS, dev)
    res = {"batches_s": time.perf_counter() - t}
    res["train"] = train_full_width(dev, batches, smi)
    res["train_card_vs_cpu"] = train_card_vs_cpu()
    res["train_app"] = train_app(fuse_kernel, smi)
    res["dist"] = dist_slice(fuse_kernel, splat_kernel, intrinsics, poses, fused_ms, export_ref,
                             smi)
    res["host"] = host_library(smi)
    res["train_profile"] = train_profile(batches)
    del batches
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# phase 11: stereo-only depth (the rectifier, flat and pyramid block
# matching, the online app's --stereo into K2); phase 12: the soak
# ----------------------------------------------------------------------
STEREO_FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                  "orbit_vga_stereo_fingerprint.json")
STEREO_METHODS = ("flat", "pyramid")
# stereo_ms as bench.py:572-599 times it: the bench's gray frame 0 and its
# 13-pixel roll at 64 disparities, each call fed the last one's output,
# one sync; CUDA events around STEREO_ITERS calls, median of STEREO_REPS
STEREO_REPS, STEREO_ITERS = 3, 10
# the 60 frames on the card against the JAX reference: the valid count
# equal and the float64 sums of disparity and depth within 1e-9 relative
# (the port on the CPU gives the JAX bits on every frame,
# scripts/port_stereo_fingerprint.py --port, and the card the CPU's; the
# slack is the host's float64 summation order)
TOL_STEREO_SUM = 1e-9
# the factory calibration's rectifier without cv2 against cv2's (the
# fingerprint): rectified intrinsics within 1e-6 relative, each map's
# mean within 1e-4 px
TOL_RECT_INTR, TOL_RECT_MEAN_PX = 1e-6, 1e-4
SOAK_FRAMES = 1000
# the stereo app as its own process, as a user runs it (no --device):
# both paths through main(argv), each volume's fingerprint and fuse_rows'
# launches printed as the last line
STEREO_APP_CODE = """
import json, sys
from disinfect_slam_tpu_torch.apps import online
from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
from disinfect_slam_tpu_torch.ops.cuda import fuse_kernel
from disinfect_slam_tpu_torch.ops.gather import gather_valid, volume_fingerprint
logdir, render_dir = sys.argv[1:3]
base = ["--logdir", logdir, "--config", logdir + "/cam.yaml", "--stereo", "--segment"]
out = {}
for name, extra in (("fused", ["--fused", "--render-dir", render_dir]), ("async", ["--fps", "120"])):
    fuse_kernel.fuse_rows.launches = 0
    r = online.main(base + extra)
    vol = r["step"].volume if name == "fused" else r["system"].tsdf.tsdf.volume
    fp = volume_fingerprint(volume_to_numpy(vol))
    fp["records"] = int(gather_valid(vol).count)
    out[name] = {"frames": r["frames"], "fps": r["fps"], "wall_s": r["wall_s"],
                 "active_blocks": r["active_blocks"], "fingerprint": fp,
                 "fuse_rows_launches": fuse_kernel.fuse_rows.launches,
                 "render_paths": r["render_paths"],
                 "dropped": r["system"].tsdf.dropped_frames if name == "async" else 0}
print(json.dumps(out))
"""


def stereo_logdir(ref) -> tuple:
    """The stereo scene's 60 pairs written as a user's capture
    (tests/torch_cases.py:write_stereo_logdir), each pair's checksum
    against the fingerprint's: a difference is generator drift."""
    from disinfect_slam_tpu_torch.ops.cuda import build
    from tests.torch_cases import write_stereo_logdir

    logdir = os.path.join(str(build.BUILD_DIR), "stereo")
    if os.path.isdir(logdir):
        shutil.rmtree(logdir)
    t0 = time.perf_counter()
    sums = write_stereo_logdir(logdir, DATASET)
    gen_s = time.perf_counter() - t0
    drift = [i for i, (a, b) in enumerate(zip(sums, ref["pairs"])) if a != b]
    if len(sums) != ref["frames"] or drift:
        raise AssertionError(f"stereo scene generator drift: {len(sums)} pairs, frames "
                             f"{drift[:10]} differ from the fingerprint's checksums")
    log(f"[chip_smoke] stereo logdir: {len(sums)} pairs at 640x480 written in {gen_s:.1f} s, "
        f"every checksum equal to the fingerprint's")
    return logdir, gen_s


def stereo_depth_frames(logdir, ref, dev) -> dict:
    """Frame 0, both matchers, on the card against the port's CPU run bit
    for bit; then all 60 frames on the card against the JAX reference's
    per-frame summaries."""
    from disinfect_slam_tpu_torch.io.dataset import LoggedStereoReplay
    from disinfect_slam_tpu_torch.ops.stereo import stereo_depth
    from tests.torch_cases import stereo_depth_summary

    kw = dict(fx=ref["fx"], baseline_m=ref["baseline_m"], max_disp=ref["max_disp"],
              max_depth=ref["max_depth"])
    frames = list(LoggedStereoReplay(logdir))
    cpu = torch.device("cpu")
    for m in STEREO_METHODS:
        runs = [[t.cpu() for t in stereo_depth(*(torch.from_numpy(x).to(d) for x in
                                                  (frames[0].left, frames[0].right)),
                                                method=m, **kw)] for d in (dev, cpu)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"stereo {m}: frame 0 on the card differs from the CPU")
    worst = {m: 0.0 for m in STEREO_METHODS}
    valid = {m: 0 for m in STEREO_METHODS}
    for i, fr in enumerate(frames):
        left, right = (torch.from_numpy(x).to(dev) for x in (fr.left, fr.right))
        for m in STEREO_METHODS:
            got, want = stereo_depth_summary(stereo_depth(left, right, method=m, **kw)), \
                ref["depth"][m][i]
            rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in ("sum_disp", "sum_depth"))
            worst[m] = max(worst[m], rel)
            valid[m] += got["valid"]
            if got["valid"] != want["valid"] or rel > TOL_STEREO_SUM:
                raise AssertionError(f"stereo {m} frame {i}: {got} against the reference's "
                                     f"{want}")
    n_px = len(frames) * frames[0].left.shape[0] * frames[0].left.shape[1]
    log(f"[chip_smoke] stereo depth: frame 0 on the card bit-equal to the CPU (flat and "
        f"pyramid); {len(frames)} frames: valid counts equal to the JAX reference's, sums "
        f"within {worst} relative (limit {TOL_STEREO_SUM:g}); valid share "
        f"{ {m: round(valid[m] / n_px, 4) for m in STEREO_METHODS} }")
    return {"frames": len(frames), "frame0_bit_equal": True, "max_rel_sum": worst,
            "valid_share": {m: valid[m] / n_px for m in STEREO_METHODS}}


def stereo_bench_pair(dev):
    """bench.py's stereo input: the gray of orbit_vga's frame 0 and its
    13-pixel roll, on the card."""
    from disinfect_slam_tpu_torch.io.png_io import read_image

    gray = read_image(os.path.join(DATASET, "0_rgb.png")).astype(np.float32).mean(axis=-1)
    return tuple(torch.from_numpy(np.ascontiguousarray(g)).to(dev)
                 for g in (gray, np.roll(gray, -13, axis=1)))


def stereo_timing(dev, smi) -> dict:
    """stereo_ms for both matchers (bench.py's stereo micro-bench)."""
    from disinfect_slam_tpu_torch.ops.stereo import block_match, block_match_pyramid

    left, right = stereo_bench_pair(dev)
    res = {}
    for name, fn in (("flat", block_match), ("pyramid", block_match_pyramid)):
        def step(x, fn=fn):
            disp, valid = fn(x, right, max_disp=64)
            return x + (disp.sum() + valid.sum()) * 0.0

        x = step(left)
        torch.cuda.synchronize()
        runs = []
        for _ in range(STEREO_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            x = left
            start.record()
            for _ in range(STEREO_ITERS):
                x = step(x)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / STEREO_ITERS)
        res[name] = {"ms": statistics.median(runs), "runs_ms": runs}
    log(f"[chip_smoke] stereo_ms at 640x480, 64 disparities: flat {res['flat']['ms']:.3f} "
        f"({[round(r, 3) for r in res['flat']['runs_ms']]}), pyramid "
        f"{res['pyramid']['ms']:.3f} ({[round(r, 3) for r in res['pyramid']['runs_ms']]}) "
        f"({smi})")
    return res


def stereo_rectifier(ref, dev) -> dict:
    """The ZED factory calibration's rectifier, built without cv2, against
    the fingerprint's cv2 numbers; its remap on the card against the CPU,
    bit for bit, and timed."""
    from disinfect_slam_tpu_torch.io.zed_calib import rectifier_from_factory_conf
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.ops.image_ops import bilinear_remap
    from tests.torch_cases import ZED_FACTORY_CONF

    conf = os.path.join(str(build.BUILD_DIR), "SN12345.conf")
    with open(conf, "w") as f:
        f.write(ZED_FACTORY_CONF)
    t0 = time.perf_counter()
    rect = rectifier_from_factory_conf(conf, "VGA")
    build_s = time.perf_counter() - t0
    want = ref["rectifier"]
    intr = max(abs(a - b) / abs(b) for a, b in zip(rect.rectified_intrinsics(),
                                                  want["rectified_intrinsics"]))
    n_px = want["size"][0] * want["size"][1]
    mean_px = max(abs(float(np.asarray(m, np.float64).sum()) - b) / n_px
                  for m, b in zip(rect.maps[:4], want["map_sums"]))
    if rect.maps_device[0].device.type != "cuda" or not (
            intr <= TOL_RECT_INTR and mean_px <= TOL_RECT_MEAN_PX):
        raise AssertionError(f"factory rectifier: intrinsics {rect.rectified_intrinsics()} "
                             f"(rel {intr:.3e}), map means {mean_px:.3e} px off cv2's")
    rng = np.random.default_rng(9)
    left = rng.uniform(0, 255, (*want["size"], 3)).astype(np.float32)
    right = rng.uniform(0, 255, want["size"]).astype(np.float32)
    l_card, r_card = rect.rectify(left, right)
    for img, out, maps in ((left, l_card, rect.maps[:2]), (right, r_card, rect.maps[2:4])):
        cpu = bilinear_remap(torch.from_numpy(img), *(torch.from_numpy(m) for m in maps))
        if not np.array_equal(out, cpu.numpy()):
            raise AssertionError("the remap on the card differs from the CPU's")
    l_dev, r_dev = (torch.from_numpy(x).to(dev) for x in (left, right))
    remap_ms = cuda_time_ms(lambda: rect.rectify_device(l_dev, r_dev))
    log(f"[chip_smoke] factory rectifier (no cv2): built in {build_s:.2f} s, rectified "
        f"intrinsics {[round(v, 4) for v in rect.rectified_intrinsics()]} within {intr:.2e} "
        f"relative of cv2's, map means within {mean_px:.2e} px; remap of an RGB + gray "
        f"672x376 pair on the card bit-equal to the CPU, {remap_ms:.3f} ms")
    return {"build_s": build_s, "intrinsics_rel": intr, "map_mean_px": mean_px,
            "remap_ms": remap_ms}


def stereo_app(logdir, ref, read_png) -> dict:
    """apps.online --stereo --segment, --fused with --render-dir and the
    asynchronous path at --fps 120, in a process of its own on the card."""
    from disinfect_slam_tpu_torch.ops.cuda import build

    render_dir = os.path.join(str(build.BUILD_DIR), "stereo_render")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STEREO_APP_CODE, logdir, render_dir],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"stereo app failed ({proc.returncode}): {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[chip_smoke] {line}")
    res = json.loads(lines[-1])
    n = ref["frames"]
    for name, r in res.items():
        if (r["frames"], r["fuse_rows_launches"], r["dropped"]) != (n, n, 0):
            raise AssertionError(f"stereo app {name}: {r['frames']} frames, fuse_rows "
                                 f"launched {r['fuse_rows_launches']} times, {r['dropped']} "
                                 f"dropped")
    for path in res["fused"]["render_paths"]:
        img = read_png(path)
        if img.shape != (360, 640, 4) or img.dtype != np.uint8:
            raise AssertionError(f"{path}: {img.dtype} {img.shape}")
    check_fingerprint_dict(res["fused"]["fingerprint"], ref["online"], "stereo app --fused",
                           TOL_ONLINE_PROB)
    asy = res["async"]["fingerprint"]
    log(f"[chip_smoke] stereo app: {wall_s:.1f} s as a process; fused "
        f"{res['fused']['fps']:.3f} FPS, async {res['async']['fps']:.3f} FPS at --fps 120 "
        f"(0 dropped), fuse_rows {res['fused']['fuse_rows_launches']} / "
        f"{res['async']['fuse_rows_launches']} launches; the async volume's blocks "
        f"{asy['active_blocks']} and sum|tsdf| {asy['sum_abs_tsdf']:.1f} beside the "
        f"reference's {ref['online']['active_blocks']} / {ref['online']['sum_abs_tsdf']:.1f}")
    res["process_wall_s"] = wall_s
    return res


def stereo_slice(read_png, smi, dev) -> dict:
    """Phase 11 (see the docstring)."""
    with open(STEREO_FINGERPRINT) as f:
        ref = json.load(f)
    logdir, gen_s = stereo_logdir(ref)
    res = {"generate_s": gen_s}
    res["depth"] = stereo_depth_frames(logdir, ref, dev)
    torch.cuda.empty_cache()
    res["stereo_ms"] = stereo_timing(dev, smi)
    res["rectifier"] = stereo_rectifier(ref, dev)
    res["app"] = stereo_app(logdir, ref, read_png)
    torch.cuda.empty_cache()
    return res


def soak(fuse_kernel, splat_kernel, dev, smi) -> dict:
    """Phase 12: tests/test_soak.py's corridor, all SOAK_FRAMES frames,
    through DenseSLAM on the card (tests/torch_cases.py:run_soak) with the
    JAX soak's assertions and within the JAX soak's own counts
    (data/soak_fingerprint.json); fuse_rows once a frame,
    splat_zbuf_blocks once a tracked frame, and both held against their
    plain versions on the soak's own inputs after the run."""
    from tests.torch_cases import check_soak, check_soak_fingerprint, run_soak, soak_fingerprint

    fns = (fuse_kernel.fuse_rows, splat_kernel.splat_zbuf_blocks,
           splat_kernel.splat_payload_blocks)
    reset_launches(*fns)
    res, slam = run_soak(SOAK_FRAMES, dev)
    res["launches"] = {fn.__name__: fn.launches for fn in fns}
    log(f"[chip_smoke] soak: {res['frames']} frames in {res['wall_s']:.1f} s, "
        f"{res['ms_per_frame']:.3f} ms/frame ({smi}); lost {res['lost']}, recenters "
        f"{res['recenters']}, spill high {res['spill_high']} blocks, keyframes "
        f"{res['keyframes']}, evictions {res['evictions']}, closures {res['closures']}, "
        f"start region {res['start_hist']} -> {res['end_hist']} observed voxels, end "
        f"position {res['end_t']}; launches {res['launches']}")
    check_soak(res)
    want = {"fuse_rows": SOAK_FRAMES, "splat_zbuf_blocks": SOAK_FRAMES - 1,
            "splat_payload_blocks": 0}
    if res["launches"] != want:
        raise AssertionError(f"soak launches {res['launches']}, expected {want}")
    ref = soak_fingerprint()
    log(f"[chip_smoke] soak against the JAX soak's counts {ref}")
    check_soak_fingerprint(res, ref)
    res["kernels"] = check_soak_kernels(fuse_kernel, splat_kernel, slam, dev)
    del slam
    return res


def check_soak_kernels(fuse_kernel, splat_kernel, slam, dev) -> dict:
    """Phase 12's kernels on the soak's own inputs: K4 on the final volume
    from the last pose at the soak's 96x72 tracking camera (72 rows: its
    last row of 32x32 tiles is partial), bit-equal to its plain version;
    K2 on the visible rows of the last frame (x = 0) over that volume
    (copies of its pool) against its plain version, compare_fuse's
    tolerances."""
    from disinfect_slam_tpu_torch.core.geometry import SE3
    from disinfect_slam_tpu_torch.ops.integrate import (FrameInput, depth_to_range,
                                                        gather_visible, stack_frame)
    from disinfect_slam_tpu_torch.utils.device import upload
    from tests.scenes import checker_rgb
    from tests.torch_cases import soak_corridor_depth

    pose = np.linalg.inv(slam.world_T_cam).astype(np.float32)
    vol, cam, cfg = slam.volume, slam.cam, slam.cfg
    rows, pool, geometry = volume_rows(splat_kernel, vol, slam.track_cam, pose, slam.max_depth)
    res = {"k4": check_zbuf_rows(splat_kernel, rows, pool, geometry, dev, "soak")}
    depth, _ = soak_corridor_depth(0.0)
    ones = torch.ones(depth.shape, dtype=torch.float32, device=dev)
    frame = FrameInput(upload(checker_rgb(cam.img_w, cam.img_h), dev), upload(depth, dev),
                       ones, ones)
    d2r = depth_to_range(cam, dev)
    se3 = SE3.from_matrix(pose)
    vis = gather_visible(vol, cam, se3, frame.depth, d2r)
    consts = dict(truncation=cfg.truncation, max_depth=slam.max_depth,
                  max_weight=cfg.max_weight, prob_eps=cfg.prob_eps, cam_T_world=se3,
                  intrinsics=cam.intrinsics, voxel_size=cfg.voxel_size)
    err, written, _ = compare_fuse(fuse_kernel, stack_frame(frame, d2r), vis.block_pos,
                                   vis.pool_idx, vis.count, pool, consts, "soak last frame")
    res["k2"] = {"max_abs_err": err, "count": int(vis.count), "written": written}
    return res


def stereo_profile(dev) -> dict:
    """Phase 7, the matchers under the profiler at 640x480, 64
    disparities: kernels and device ms a call."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.ops.stereo import block_match, block_match_pyramid

    left, right = stereo_bench_pair(dev)
    res = {}
    for name, fn in (("flat", block_match), ("pyramid", block_match_pyramid)):
        fn(left, right, max_disp=64)
        torch.cuda.synchronize()
        calls = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(left, right, max_disp=64)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / calls
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        dev_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls
        res[name] = {"kernels_per_call": len(events) / calls, "device_ms_per_call": dev_ms,
                     "wall_ms_per_call": wall,
                     "idle_share": 1 - dev_ms / wall if dev_ms else None}
    log(f"[chip_smoke] stereo profile: " + "; ".join(
        f"{k} {v['kernels_per_call']:.1f} kernels, {v['device_ms_per_call']:.3f} ms of device "
        f"time in {v['wall_ms_per_call']:.3f} ms a call" for k, v in res.items()))
    return res


# ----------------------------------------------------------------------
# phase 13: the segmentation net over a (data, model) mesh on the card;
# phase 14: the kernels' self-check
# ----------------------------------------------------------------------
SEG_PAR_STEPS = 3  # steps the 1x1 mesh must equal make_train_step over, bit for bit
SEG_PAR_LR = 3e-3  # phase 10a's rate
# tests/test_torch_seg_parallel.py's limits: the 2x2 step's loss within
# 1e-5 relative of the unsharded step's; its gradients (a float32 net)
# within 1e-4 of each parameter's largest.  The sharded inference of the
# shipped net at 352x640, batch 8, over [cuda:0] * 4 against the unsharded
# one (this phase, NVIDIA H100 80GB HBM3, 700 W): 1.02e-2 of a probability
# in bfloat16 (a rounding of a per-shard GroupNorm sum can flip a bf16
# activation), 1.14e-5 with the same weights in float32; limits about 5x
# and 9x those
SEG_PAR_LOSS_RTOL, SEG_PAR_GRAD_RTOL = 1e-5, 1e-4
SEG_PAR_INFER_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
VERIFY_BUDGET_S = 60.0


def _net(dev, dtype=torch.bfloat16):
    """The shipped UNetSeg's architecture at its full width, seed-0
    parameters, in training mode on dev."""
    from disinfect_slam_tpu_torch.models import segmentation as seg

    return seg.create_model(dtype=dtype, generator=torch.Generator().manual_seed(0)).to(dev).train()


def _timed_steps(step, state, batches) -> tuple:
    """One step per batch, each between CUDA events: (state, ms list)."""
    events = []
    for imgs, labs in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, imgs, labs)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return state, [a.elapsed_time(b) for a, b in events]


def _profiled(step, state, batch) -> dict:
    """The kernels and device time of one step under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, *batch)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    # a trace that caught no device event measured nothing
    return {"launches": len(events) or None, "device_ms": device_ms or None}


def seg_parallel_checks(dev, batches, mesh_sizes=(1, 4)) -> dict:
    """Phase 13's checks on any device (the card here; the CPU tests run
    the same checks at a narrow width): over [dev] (1x1) the sharded step
    equals make_train_step bit for bit, loss and every parameter, for
    SEG_PAR_STEPS steps; over [dev] * 4 (2x2) the first step's loss
    (bfloat16 net) and gradients (the same net in float32) within the CPU
    tests' limits, AdamW held on the same gradients (bit-equal).  cuDNN
    keeps to its deterministic algorithms meanwhile: a weight gradient
    summed by atomics differs between two runs of one step."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _seg_parallel_checks(dev, batches, mesh_sizes)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _seg_parallel_checks(dev, batches, mesh_sizes) -> dict:
    from disinfect_slam_tpu_torch.models import train
    from disinfect_slam_tpu_torch.parallel import seg_parallel as sp

    res = {}
    sd = _net(dev).state_dict()
    ref = train.create_train_state(_net(dev), lr=SEG_PAR_LR, device=dev)
    ref.model.load_state_dict(sd)
    ref_step = train.make_train_step(ref.model, ref.opt)
    mesh = sp.make_mesh_2d(devices=[dev] * mesh_sizes[0])
    net = _net(dev)
    net.load_state_dict(sd)
    state = sp.ShardedTrainState(sp.shard_params(net, mesh))
    step = sp.make_sharded_train_step(net, dict(lr=SEG_PAR_LR), mesh)
    for i, (imgs, labs) in enumerate(batches[:SEG_PAR_STEPS]):
        ref, ref_loss = ref_step(ref, imgs, labs)
        state, loss = step(state, imgs, labs)
        if not torch.equal(loss, ref_loss):
            raise AssertionError(f"1x1 step {i}: loss {float(loss)} != {float(ref_loss)}")
    params = state.params.full()
    unequal = [k for k, p in ref.model.named_parameters() if not torch.equal(p, params[k])]
    if unequal:
        raise AssertionError(f"1x1 mesh: {len(unequal)} parameters differ: {unequal[:4]}")
    res["1x1"] = {"steps_bit_equal": SEG_PAR_STEPS, "losses": [float(ref_loss)]}
    imgs, labs = batches[0]
    for dtype, label in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        base = _net(dev, dtype)
        base.load_state_dict(sd)
        one = train.create_train_state(_net(dev, dtype), lr=SEG_PAR_LR, device=dev)
        one.model.load_state_dict(sd)
        _, one_loss = train.make_train_step(one.model, one.opt)(one, imgs, labs)
        grads = {k: p.grad for k, p in one.model.named_parameters()}
        mesh = sp.make_mesh_2d(devices=[dev] * mesh_sizes[1])
        st = sp.ShardedTrainState(sp.shard_params(base, mesh))
        st, loss = sp.make_sharded_train_step(base, dict(lr=SEG_PAR_LR), mesh)(st, imgs, labs)
        loss_rel = abs(float(loss) - float(one_loss)) / abs(float(one_loss))
        r = {"mesh": list(mesh.shape), "loss": float(loss),
             "loss_1x1": float(one_loss), "loss_rel": loss_rel}
        if loss_rel > SEG_PAR_LOSS_RTOL:
            raise AssertionError(f"2x2 {label}: loss {r}")
        if dtype == torch.float32:
            ours = st.params.full_grads()
            r["grad_rel"] = max(float((ours[k] - g).abs().max() / g.abs().max())
                                for k, g in grads.items())
            if r["grad_rel"] > SEG_PAR_GRAD_RTOL:
                raise AssertionError(f"2x2 float32: gradients {r['grad_rel']:.3e} apart")
            held = train.create_train_state(_net(dev, dtype), lr=SEG_PAR_LR, device=dev)
            held.model.load_state_dict(sd)
            for k, p in held.model.named_parameters():
                p.grad = ours[k].clone()
            held.opt.step()
            full = st.params.full()
            r["adamw_held_bit_equal"] = all(torch.equal(p, full[k])
                                            for k, p in held.model.named_parameters())
            if not r["adamw_held_bit_equal"]:
                raise AssertionError("2x2 float32: AdamW on the shards differs from AdamW on "
                                     "the same gradients")
        res[f"2x2_{label}"] = r
    return res


def seg_parallel_infer(dev, imgs, n_devices=4) -> dict:
    """Phase 13's inference: make_sharded_infer of the shipped UNet over
    [dev] * n_devices against sigmoid(model) on the whole batch, in
    bfloat16 (as shipped) and with the same weights in float32, within
    SEG_PAR_INFER_TOL."""
    from disinfect_slam_tpu_torch.models import segmentation as seg
    from disinfect_slam_tpu_torch.parallel import seg_parallel as sp
    from disinfect_slam_tpu_torch.utils.device import exact_fp32

    mesh = sp.make_mesh_2d(devices=[dev] * n_devices)
    shipped = seg.load_model("unet", device=dev)
    res = {}
    for dtype, label in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        model = seg.create_model(dtype=dtype).to(dev)
        model.load_state_dict(shipped.state_dict())
        with torch.no_grad(), exact_fp32():
            full = torch.sigmoid(model(imgs.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        probs = sp.make_sharded_infer(model, mesh)(imgs)
        if probs.shape != full.shape or not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"sharded inference: {tuple(probs.shape)} vs "
                                 f"{tuple(full.shape)}")
        d = (probs - full).abs()
        res[label] = {"mesh": list(mesh.shape), "max_abs_err": float(d.max()),
                      "mean_abs_err": float(d.mean()),
                      "labels_flipped": float(((probs > 0.5) != (full > 0.5)).float().mean())}
        if res[label]["max_abs_err"] > SEG_PAR_INFER_TOL[label]:
            raise AssertionError(f"sharded inference off the net ({label}): {res[label]}")
        del model, full, probs
    return res


def seg_parallel_slice(fuse_kernel, sample_kernel, splat_kernel, dev, smi) -> dict:
    """Phase 13 (see the docstring)."""
    from disinfect_slam_tpu_torch.models import train
    from disinfect_slam_tpu_torch.parallel import seg_parallel as sp

    hand = (fuse_kernel.fuse_rows, sample_kernel.sample_rows, splat_kernel.splat_zbuf_blocks,
            splat_kernel.splat_payload_blocks)
    reset_launches(*hand)
    t = time.perf_counter()
    batches = train_batches(TRAIN_STEPS, dev)
    res = {"batches_s": time.perf_counter() - t}
    res["checks"] = seg_parallel_checks(dev, batches)
    log(f"[chip_smoke] seg_parallel: 1x1 over [{dev}] bit-equal to make_train_step over "
        f"{SEG_PAR_STEPS} steps (loss and every parameter); 2x2 over [{dev}] * 4: "
        + "; ".join(f"{k} loss {v['loss']:.6f} vs {v['loss_1x1']:.6f} (rel {v['loss_rel']:.2e})"
                    + (f", gradients {v['grad_rel']:.2e} of each largest, AdamW held on them "
                       f"bit-equal" if "grad_rel" in v else "")
                    for k, v in res["checks"].items() if k.startswith("2x2")))
    # ms a step: make_train_step and the sharded step over 1x1 and 2x2,
    # each from the same parameters, median of the last 8 of TRAIN_STEPS
    sd = _net(dev).state_dict()
    timing = {}
    for label, n in (("make_train_step", 0), ("sharded_1x1", 1), ("sharded_2x2", 4)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        net = _net(dev)
        net.load_state_dict(sd)
        if n == 0:
            state = train.create_train_state(net, lr=SEG_PAR_LR, device=dev)
            step = train.make_train_step(state.model, state.opt)
        else:
            mesh = sp.make_mesh_2d(devices=[dev] * n)
            state = sp.ShardedTrainState(sp.shard_params(net, mesh))
            step = sp.make_sharded_train_step(net, dict(lr=SEG_PAR_LR), mesh)
        state, ms = _timed_steps(step, state, batches)
        timing[label] = {"step_ms": ms, "step_ms_median": statistics.median(ms[2:]),
                         "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                         "profile": _profiled(step, state, batches[0])}
        del state, step, net
    res["timing"] = timing
    log(f"[chip_smoke] seg_parallel step at {TRAIN_H}x{TRAIN_W} batch {TRAIN_BATCH} (UNet "
        f"full width, median of the last {TRAIN_STEPS - 2} of {TRAIN_STEPS}, CUDA events): "
        + "; ".join(f"{k} {v['step_ms_median']:.2f} ms, peak {v['peak_gb']:.2f} GB, profiled "
                    + (f"{v['profile']['launches']} kernels, {v['profile']['device_ms']:.2f} ms "
                       f"of device time" if v["profile"]["launches"] else "no device event "
                       "traced (not measured)")
                    for k, v in timing.items()) + f" ({smi})")
    res["infer"] = seg_parallel_infer(dev, batches[0][0])
    res["hand_kernel_launches"] = {fn.__name__: fn.launches for fn in hand}
    log(f"[chip_smoke] seg_parallel inference of the shipped UNet over [{dev}] * 4 at "
        f"{TRAIN_H}x{TRAIN_W} batch {TRAIN_BATCH}: " + "; ".join(
            f"{k} max |dp| {v['max_abs_err']:.3e} (limit {SEG_PAR_INFER_TOL[k]:g}), mean "
            f"{v['mean_abs_err']:.3e}, labels flipped {v['labels_flipped']:.2e}"
            for k, v in res["infer"].items())
        + f"; hand kernel launches {res['hand_kernel_launches']} (cuDNN and torch ops only)")
    if any(res["hand_kernel_launches"].values()):
        raise AssertionError("seg_parallel launched a fusion or splat kernel")
    del batches
    torch.cuda.empty_cache()
    return res


def kernel_self_check(fuse_kernel, sample_kernel, splat_kernel, dev, smi) -> dict:
    """Phase 14: utils/kernel_verify.verify_all() on the card, every check
    PASS in under VERIFY_BUDGET_S; its comparison launches are counted
    apart from the main paths'."""
    from disinfect_slam_tpu_torch.utils import kernel_verify

    fns = (sample_kernel.sample_rows, fuse_kernel.fuse_rows, splat_kernel.splat_zbuf_blocks,
           splat_kernel.splat_payload_blocks)
    reset_launches(*fns)
    t0 = time.perf_counter()
    ok = kernel_verify.verify_all(verbose=True, device=dev)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fns}
    log(f"[chip_smoke] kernel self-check: {len(kernel_verify.CHECKS)} checks "
        f"{'PASS' if ok else 'FAIL'} in {wall:.1f} s (budget {VERIFY_BUDGET_S:g} s); "
        f"comparison launches {launches} ({smi})")
    if not ok:
        raise AssertionError("kernel_verify.verify_all failed on the card")
    if wall > VERIFY_BUDGET_S:
        raise AssertionError(f"the self-check took {wall:.1f} s")
    if not all(launches.values()):
        raise AssertionError(f"the self-check left a kernel unlaunched: {launches}")
    return {"checks": len(kernel_verify.CHECKS), "wall_s": wall, "launches": launches}


# ----------------------------------------------------------------------
# phase 15: the port's benchmark
# ----------------------------------------------------------------------
BENCH_TIMEOUT_S = 600
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "platform", "img", "voxel_m",
              "online_fps", "online_fps_fast", "stereo_ms", "fallback", "dataset"]
BENCH_FRAMES, BENCH_WARM = 60, 2  # the fusion stage's timed frames; warm-up frames
BENCH_RENDERS = 6  # a warm-up and five timed splat renders


def bench_phase(smi) -> dict:
    """Phase 15: bench_torch.py in its own process, as a user runs it; its
    JSON line, summary and launch counts held to the contract (see the
    docstring)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    err = proc.stderr.splitlines()
    for line in err:
        if line.startswith("[bench]") or line.startswith("[port_verify]"):
            log(f"[chip_smoke] bench_torch.py: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {proc.returncode}: "
                             + "\n".join(err[-30:]))
    line = proc.stdout.strip().splitlines()[-1]
    log(f"[chip_smoke] bench_torch.py's line: {line}")
    payload = json.loads(line)
    prefix = "[bench] kernel launches: "
    counts = json.loads(next(x for x in err if x.startswith(prefix))[len(prefix):])
    numbers = {k: payload[k] for k in ("value", "voxel_m", "online_fps", "online_fps_fast",
                                       "stereo_ms")}
    stages = counts["stages"]
    want = {
        ("fusion", "fuse_rows"): BENCH_WARM + BENCH_FRAMES,
        ("online unet", "fuse_rows"): ONLINE_FRAMES, ("online fast", "fuse_rows"): ONLINE_FRAMES,
        ("splat", "splat_zbuf_blocks"): BENCH_RENDERS,
        ("splat", "splat_payload_blocks"): BENCH_RENDERS,
    }
    got = {k: stages.get(k[0], {}).get(k[1]) for k in want}
    failed = []
    if list(payload) != BENCH_KEYS:
        failed.append(f"keys {list(payload)}")
    if (payload["platform"], payload["fallback"], payload["vs_baseline"]) != ("cuda", False, None):
        failed.append("platform / fallback / vs_baseline")
    if not all(isinstance(v, (int, float)) and v > 0 for v in numbers.values()):
        failed.append(f"numbers {numbers}")
    if not payload["dataset"].startswith("orbit_vga"):
        failed.append(f"dataset {payload['dataset']}")
    if got != want:
        failed.append(f"launches {got}, expected {want}")
    if (counts["total"]["sample_rows"] or not counts["self_check"]
            or not all(counts["self_check"].values())):
        failed.append(f"sample_rows on the bench's stages, or a kernel the self-check left "
                      f"unlaunched: {counts}")
    if not any("self-check PASS" in x for x in err):
        failed.append("no self-check PASS")
    if not any("within the reference's limits" in x for x in err):
        failed.append("the timed volume was not held to the reference")
    log(f"[chip_smoke] bench_torch.py: {wall:.1f} s; launches on its stages {counts['total']}, "
        f"in its self-check {counts['self_check']} ({smi})")
    if failed:
        raise AssertionError(f"bench_torch.py broke its contract: {failed}")
    return {"payload": payload, "launches": counts, "wall_s": wall,
            "summary": next(x for x in err if x.startswith("[bench] platform="))}


def probe_timer(fn, name, nbytes=0) -> float:
    """The probes' timer: kernel_ms, with the bound of nbytes as its
    floor."""
    return kernel_ms(fn, name, floor_ms=bound(nbytes, 0)["bound_ms"])


def probe_launches(splat_probe, feature_probe, sp) -> list:
    """The probe wrappers that count their launches."""
    return [splat_probe.zbuf_atomic, splat_probe.zbuf_tile, feature_probe.launch,
            sp.sample_patch, sp.sample_mma, sp.sample_direct, sp.fuse_stage]


def probes(dev, splat_probe, feature_probe, sp, fuse_kernel) -> dict:
    """Phase 7: the probes, each kernel timed by its device time: P8/P9 of
    splat_zbuf_blocks' tile (splat_probe, on phase 2's block rows at
    640x480 and 1080p), P7's primitives (feature_probe: every check must
    pass; its kernels' device time and its plain torch version's), and
    P1-P6 (sample_probe: K1's direct modes, the patch and mma selections
    and fuse_rows' stages, each against its plain version, at K1's and
    fuse_rows' phase 2 rows)."""
    t0 = time.perf_counter()
    cases = {"640x480": make_splat_blocks(3, H, W, dev),
             "1080p": make_splat_blocks(4, 1080, 1920, dev)}
    probe = splat_probe.run(dev, probe_timer, cases)
    del cases
    torch.cuda.empty_cache()
    p8 = probe["p8"]
    log(f"[chip_smoke] probe P8 (block rows, S={p8['rows']}, count {p8['count']}, "
        f"{p8['image'][1]}x{p8['image'][0]}): per-voxel atomics {p8['atomic_ms']:.4f} ms, "
        f"tile kernel {p8['tile_ms']:.4f} ms, both bit-equal to the plain scatter-min; tile "
        f"rows on the tile / atomic branch {p8['tile_branches']}")
    for r in probe["p9"]:
        log(f"[chip_smoke] probe P9 tile {r['tile'][0]}x{r['tile'][1]}: {r['registers']} "
            f"registers, {r['local_bytes']} local (spill) bytes, {r['shared_bytes']} shared "
            f"bytes; " + "; ".join(f"{k} rows {r[k]['ms']:.4f} ms (branches "
                                   f"{r[k]['branches']})" for k in ("640x480", "1080p"))
            + "; launches and agrees")

    checks = feature_probe.run(dev)
    kernels_fn, plain_fn, nbytes = feature_probe.timed_pair(dev)
    probe["p7"] = {"checks": checks, "ms": probe_timer(kernels_fn, "feature_", nbytes),
                   "plain_ms": cuda_time_ms(plain_fn), **bound(nbytes, 0),
                   "max_abs_err": max(r["max_abs_err"] for r in checks.values())}
    log(f"[chip_smoke] probe P7: every check passed {checks}; its kernels "
        f"{probe['p7']['ms']:.4f} ms of device time, the torch version "
        f"{probe['p7']['plain_ms']:.4f} ms")

    img, u, v = make_frame(np.random.default_rng(7), H, W, dev)
    count = torch.tensor(COUNT, dtype=torch.int32, device=dev)
    fimg, block_pos, pool_idx, geometry = block_rows(1, H, W, False, dev)
    pool = make_pool(dev, 1)
    consts = dict(CONSTS, **geometry)
    res = sp.run(dev, probe_timer, (img, u, v, count),
                 (fimg, block_pos, pool_idx, count, pool, consts),
                 fuse_kernel.fuse_rows)
    for group in ("p4", "patch", "p5"):
        for r in res[group]:
            if "bytes" in r:
                r.update(bound(r["bytes"], 0))
            log(f"[chip_smoke] probe {group} {r.get('mode', r.get('stage'))}: {r['ms']:.4f} ms"
                + (f", bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB), "
                   f"{r['bound_ms'] / r['ms']:.1%} of it" if "bound_ms" in r else "")
                + (f"; skipped {r['skipped_voxels']} voxels in {r['skipped_rows']} rows"
                   if "skipped_voxels" in r else "")
                + (f"; voxels let through {r['voxels_through']}"
                   if "voxels_through" in r else ""))
    u0, v0 = sp.patch_origins(u, v, H, W)
    res["plain_ms"] = {
        "direct": cuda_time_ms(lambda: sp.sample_direct_reference(img, u, v, count, 0)),
        "patch": cuda_time_ms(lambda: sp.patch_sample_reference(img, u, v, count, u0, v0,
                                                                *sp.PATCH_SHAPES[0])),
        "fuse_stage": cuda_time_ms(lambda: sp.fuse_stage_reference(
            0, fimg, block_pos, pool_idx, count, *pool, **consts)),
    }
    probe["sample"] = res
    del pool, img, fimg
    torch.cuda.empty_cache()
    log(f"[chip_smoke] probes ok ({time.perf_counter() - t0:.1f} s)")
    return probe


def probe_kernels(probe, launches: dict) -> list:
    """The probes' entries of the kernels line: one per probe kernel,
    timed at its mode named in `mode` (the others in the report), with its
    wrapper's launches on the main path (`launches`, by wrapper name) and
    the largest difference from its plain version over every mode it
    ran."""
    src = "disinfect_slam_tpu_torch/csrc/"
    sample = probe["sample"]
    pick = lambda group, key, name: next(r for r in sample[group] if r[key] == name)  # noqa: E731
    worst = lambda rows: max(r["max_abs_err"] for r in rows if "max_abs_err" in r)  # noqa: E731
    patch = pick("patch", "mode", "patch 24x32, 4 rows a CTA")
    mma = sample["patch"][-1]
    direct = pick("p4", "mode", "full")
    stage = pick("p5", "stage", "ring")
    entry = lambda name, source, replaces, r, plain, mode, n, err: {  # noqa: E731
        "name": name, "route": "cuda", "source": src + source, "replaces": replaces,
        "launches": n, "max_abs_err": err, "ms": r["ms"], "plain_ms": plain,
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "mode": mode}
    p7 = probe["p7"]
    return [
        entry("probe sample_patch_kernel (P1/P2/P6)", "sample_probe.cu",
              "scripts/probe_sample2.py:132", patch, sample["plain_ms"]["patch"], patch["mode"],
              launches["sample_patch"], worst(sample["patch"][:-1])),
        entry("probe sample_mma_kernel (P3)", "sample_probe.cu", "scripts/probe_sample4.py:132",
              mma, sample["plain_ms"]["patch"], mma["mode"], launches["sample_mma"],
              mma["max_abs_err"]),
        entry("probe sample_direct_kernel (P4)", "sample_probe.cu",
              "scripts/probe_sample_overhead.py:131", direct, sample["plain_ms"]["direct"],
              direct["mode"], launches["sample_direct"], worst(sample["p4"])),
        entry("probe fuse_rows_kernel stages (P5)", "fuse_rows.cuh",
              "scripts/probe_kernel_stages.py:187", stage, sample["plain_ms"]["fuse_stage"],
              stage["stage"], launches["fuse_stage"], worst(sample["p5"])),
        {"name": "probe feature kernels (P7)", "route": "cuda", "source": src + "feature_probe.cu",
         "replaces": "scripts/probe_mosaic_features.py:39", "launches": launches["launch"],
         "max_abs_err": p7["max_abs_err"], "ms": p7["ms"], "plain_ms": p7["plain_ms"],
         "bound_ms": p7["bound_ms"], "bound_by": p7["bound_by"], "library_ms": None},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from disinfect_slam_tpu_torch.apps import offline
    from disinfect_slam_tpu_torch.io.config_reader import get_intrinsics, load_yaml
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
    from disinfect_slam_tpu_torch.io.png_io import read_png
    from disinfect_slam_tpu_torch.ops import render_fast
    from disinfect_slam_tpu_torch.ops.cuda import (
        build, feature_probe, fuse_kernel, sample_kernel, sample_probe, splat_kernel,
        splat_probe,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    # phase 0: the card
    smi = card_name_and_power()
    log(smi)
    log(f"[chip_smoke] phase 0: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")

    # phase 1: build
    t0 = time.perf_counter()
    paths, build_log, nvcc_s = build.build()  # every source at once
    for lib in paths:
        build.library(lib)
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[chip_smoke] ptxas: {line.strip()}")
    log(f"[chip_smoke] phase 1: {len(paths)} kernel libraries built in {nvcc_s:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s) -> "
        f"{sorted(os.path.relpath(p, ROOT) for p in paths.values())}")

    # phase 2: kernels against their plain versions at the slice's shapes
    # (their times come in phase 7: a profiler trace would slow what follows)
    checks = [lambda timed: check_fuse_rows(fuse_kernel, H, W, 1, dev, False, timed),
              lambda timed: check_fuse_rows(fuse_kernel, 1080, 1920, 2, dev, True, timed),
              lambda timed: check_sample_rows(sample_kernel, dev, timed),
              lambda timed: check_splat(splat_kernel, fuse_kernel, H, W, 3, dev, timed),
              lambda timed: check_splat(splat_kernel, fuse_kernel, 1080, 1920, 4, dev,
                                        timed)]
    for check in checks:
        check(False)
        torch.cuda.empty_cache()
    splat_about_z = [check_splat(splat_kernel, fuse_kernel, h, w, 5, dev, False, about_z=True)
                     for h, w in ((H, W), (1080, 1920))]
    torch.cuda.empty_cache()
    log(f"[chip_smoke] phase 2: kernels agree with their plain versions "
        f"({time.perf_counter() - t_start:.1f} s)")

    with open(FINGERPRINT) as f:
        ref = json.load(f)
    save = os.path.join(str(build.BUILD_DIR), "data.bin")
    render_dir = os.path.join(str(build.BUILD_DIR), "render")
    splat_fns = (splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks)

    # phase 3: the slice through the fused kernel; the last replay also
    # renders the app's final view through the splat kernels.  The probes
    # count their launches from here to the end of phase 6b: the main path
    # must launch none
    probe_fns = probe_launches(splat_probe, feature_probe, sample_probe)
    reset_launches(*probe_fns)
    ms_runs = []
    for i in range(3):
        reset_launches(fuse_kernel.fuse_rows, sample_kernel.sample_rows, *splat_fns)
        last = i == 2
        res = replay(offline, "pallas_fused", save, render_dir if last else None)
        fused_launches = fuse_kernel.fuse_rows.launches
        app_launches = [fn.launches for fn in splat_fns]
        if app_launches != ([1, 1] if last else [0, 0]):
            raise AssertionError(f"replay {i}: splat kernels launched {app_launches} times")
        if last:
            for path in res["render_paths"]:
                img = read_png(path)
                if img.shape != (360, 640, 4) or img.dtype != np.uint8:
                    raise AssertionError(f"{path}: {img.dtype} {img.shape}")
            log(f"[chip_smoke] app render: {res['render_ms']:.3f} ms, "
                f"{[os.path.relpath(p, ROOT) for p in res['render_paths']]} decode to "
                f"[360, 640, 4] u8; splat launches {app_launches}")
        if fused_launches != res["frames"] or res["frames"] != ref["frames"]:
            raise AssertionError(f"fuse_rows launched {fused_launches} times "
                                 f"for {res['frames']} frames")
        if sample_kernel.sample_rows.launches:
            raise AssertionError("the fused path launched sample_rows")
        ms_runs.append(1e3 * statistics.mean(res["integrate_s"]))
        check_dump(save, res["records"])
        fp_fused = check_fingerprint(res["grid"], res["records"], ref, f"fused replay {i}")
        grid = res["grid"]
        del res
        torch.cuda.empty_cache()
    fused_ms = statistics.median(ms_runs)
    log(f"[chip_smoke] phase 3: fused replay ms/frame {ms_runs} -> median "
        f"{fused_ms:.3f} ({smi}); fuse_rows launches {fused_launches} "
        f"({time.perf_counter() - t_start:.1f} s)")
    # where the fusion's time goes
    fusion = fusion_split(offline, fuse_kernel, dev)

    # phase 4: the two-stage path
    fuse_kernel.fuse_rows.launches = 0
    sample_kernel.sample_rows.launches = 0
    save_two = os.path.join(str(build.BUILD_DIR), "data_two_stage.bin")
    res = replay(offline, "pallas", save_two)
    sample_launches = sample_kernel.sample_rows.launches
    if sample_launches != res["frames"] or fuse_kernel.fuse_rows.launches:
        raise AssertionError(f"two-stage replay: sample_rows launched "
                             f"{sample_launches} times, fuse_rows "
                             f"{fuse_kernel.fuse_rows.launches}")
    check_dump(save_two, res["records"])
    fp_two = check_fingerprint(res["grid"], res["records"], ref, "two-stage replay")
    two_ms = 1e3 * statistics.mean(res["integrate_s"])
    log(f"[chip_smoke] phase 4: two-stage replay {two_ms:.3f} ms/frame; "
        f"sample_rows launches {sample_launches} ({time.perf_counter() - t_start:.1f} s)")
    del res
    torch.cuda.empty_cache()

    # phase 5: the render slice on the last fused volume
    intrinsics = get_intrinsics(load_yaml(os.path.join(DATASET, "cam.yaml")))
    poses = [pose for _, pose in LoggedReplay(DATASET, 5000.0).entries]
    render, splat_launches, render_err = render_views(
        grid, render_fast, splat_kernel, intrinsics, poses, ref)
    log(f"[chip_smoke] phase 5: render slice ok; splat {render['splat_ms']:.3f} "
        f"ms/render, raycast {render['raycast_ms']:.3f} ms ({smi}) "
        f"({time.perf_counter() - t_start:.1f} s)")
    # fuse_rows on a real frame's visible set of the fused volume
    fuse_real = check_fuse_real_frame(fuse_kernel, grid, 30, dev)
    torch.cuda.empty_cache()

    # phase 6: the online slice, segmentation feeding fuse_rows
    t6 = time.perf_counter()
    online = online_slice(fuse_kernel, sample_kernel, dev, smi,
                          os.path.join(str(build.BUILD_DIR), "online_render"))
    log(f"[chip_smoke] phase 6: online slice ok; online_fps {online['online_fps']:.3f}, "
        f"online_fps_fast {online['online_fps_fast']:.3f}, seg_ms "
        f"{online['seg']['unet']['seg_ms']:.3f} (UNet) ({smi}) "
        f"({time.perf_counter() - t6:.1f} s added, {time.perf_counter() - t_start:.1f} s)")

    # phase 6b: the export slice on phase 3's volume and dump
    t6b = time.perf_counter()
    export = export_slice(offline, grid, save, fuse_kernel, splat_kernel, intrinsics, poses,
                          fused_ms, smi, dev)
    torch.cuda.empty_cache()
    log(f"[chip_smoke] phase 6b: export slice ok; mesh f32 {export['mesh']['f32']['ms']:.1f} "
        f"ms, q16 {export['mesh']['q16']['ms']:.1f} ms, bridge query "
        f"{export['bridge']['median_ms']:.1f} ms, tsdf2mesh {export['tsdf2mesh']['wall_s']:.2f} "
        f"s, hash replay {export['hash']['ms_per_frame']:.3f} ms/frame (dense {fused_ms:.3f}) "
        f"({smi}) ({time.perf_counter() - t6b:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")

    # phase 9: the served map on phase 3's volume
    t9 = time.perf_counter()
    served = served_map_slice(offline, grid, fuse_kernel, splat_kernel, ref, fused_ms, smi, dev)
    del grid
    torch.cuda.empty_cache()
    log(f"[chip_smoke] phase 9: served map ok; /render "
        f"{served['service']['render_ms_median']:.1f} ms, /query "
        f"{served['service']['query_ms']:.1f} ms, /mesh {served['service']['mesh_ms']:.0f} ms, "
        f"spill {served['spill']['spill_ms']:.1f} ms, restore "
        f"{served['spill']['restore_ms']:.1f} ms of {served['spill']['blocks']} blocks, cull "
        f"rows {served['cull']['on']['visible_rows_mean']:.1f} of "
        f"{served['cull']['off']['visible_rows_mean']:.1f} ({smi}) "
        f"({time.perf_counter() - t9:.1f} s added, {time.perf_counter() - t_start:.1f} s)")

    # phase 8: the tracking slice (pose-free dense SLAM)
    t8 = time.perf_counter()
    slam, slam_vol, slam_pose = slam_slice(fuse_kernel, splat_kernel, dev, smi)
    torch.cuda.empty_cache()
    log(f"[chip_smoke] phase 8: tracking slice ok; slam ms/frame "
        f"{slam['timing'][1]['ms_per_frame']:.3f} at track_res_scale 1, "
        f"{slam['timing'][2]['ms_per_frame']:.3f} at 2 ({smi}) "
        f"({time.perf_counter() - t8:.1f} s added, {time.perf_counter() - t_start:.1f} s)")

    # phase 10: training the seg net, the sharded volume, the host library
    t10 = time.perf_counter()
    p10 = train_dist_host(fuse_kernel, splat_kernel, intrinsics, poses, fused_ms, smi)
    dist = p10["dist"]
    log(f"[chip_smoke] phase 10: training, sharded volume and host library ok; UNet step "
        f"{p10['train']['unet']['step_ms_median']:.2f} ms, FastSeg "
        f"{p10['train']['fast']['step_ms_median']:.2f} ms at {TRAIN_H}x{TRAIN_W} batch "
        f"{TRAIN_BATCH}; train_seg {TRAIN_APP_STEPS} steps {p10['train_app']['wall_s']:.1f} s, "
        f"IoU {p10['train_app']['iou']}; sharded replay "
        f"{dist[f'shards_{DIST_SHARDS}']['ms_per_frame']:.3f} ms/frame on {DIST_SHARDS} shards, "
        f"{dist['shards_1']['ms_per_frame']:.3f} on 1 (phase 3 {fused_ms:.3f}) ({smi}) "
        f"({time.perf_counter() - t10:.1f} s added, {time.perf_counter() - t_start:.1f} s)")

    # phase 11: stereo-only depth
    t11 = time.perf_counter()
    stereo = stereo_slice(read_png, smi, dev)
    log(f"[chip_smoke] phase 11: stereo slice ok; stereo_ms flat "
        f"{stereo['stereo_ms']['flat']['ms']:.3f}, pyramid "
        f"{stereo['stereo_ms']['pyramid']['ms']:.3f}; stereo app --fused "
        f"{stereo['app']['fused']['fps']:.3f} FPS ({smi}) "
        f"({time.perf_counter() - t11:.1f} s added, {time.perf_counter() - t_start:.1f} s)")

    # phase 12: the soak
    t12 = time.perf_counter()
    soak_res = soak(fuse_kernel, splat_kernel, dev, smi)
    torch.cuda.empty_cache()
    log(f"[chip_smoke] phase 12: soak ok; {soak_res['frames']} frames, "
        f"{soak_res['ms_per_frame']:.3f} ms/frame, {soak_res['closures']} closures ({smi}) "
        f"({time.perf_counter() - t12:.1f} s added, {time.perf_counter() - t_start:.1f} s)")

    # phase 13: the seg net over a (data, model) mesh on the card
    t13 = time.perf_counter()
    seg_par = seg_parallel_slice(fuse_kernel, sample_kernel, splat_kernel, dev, smi)
    log(f"[chip_smoke] phase 13: seg_parallel ok; step "
        f"{seg_par['timing']['sharded_1x1']['step_ms_median']:.2f} ms (1x1), "
        f"{seg_par['timing']['sharded_2x2']['step_ms_median']:.2f} ms (2x2) against "
        f"make_train_step's {seg_par['timing']['make_train_step']['step_ms_median']:.2f} ms "
        f"({smi}) ({time.perf_counter() - t13:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")

    probe_main_launches = {fn.__name__: fn.launches for fn in probe_fns}
    log(f"[chip_smoke] probe launches on the main path (phases 3-13): {probe_main_launches}")

    # phase 14: the kernels' self-check
    t14 = time.perf_counter()
    verify = kernel_self_check(fuse_kernel, sample_kernel, splat_kernel, dev, smi)
    log(f"[chip_smoke] phase 14: kernel self-check ok ({time.perf_counter() - t14:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")

    # phase 15: the port's benchmark, as a user runs it
    t15 = time.perf_counter()
    bench = bench_phase(smi)
    log(f"[chip_smoke] phase 15: bench_torch.py ok; tsdf_fusion_fps {bench['payload']['value']}, "
        f"online_fps {bench['payload']['online_fps']}, stereo_ms "
        f"{bench['payload']['stereo_ms']} ({smi}) ({time.perf_counter() - t15:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")

    # phase 7: device times, after every end-to-end measurement
    t7 = time.perf_counter()
    fusion["profile"] = fusion_profile(offline, dev)
    torch.cuda.empty_cache()
    fuse, fuse_1080, sample, splat, splat_1080 = (check(True) for check in checks)
    probe = probes(dev, splat_probe, feature_probe, sample_probe, fuse_kernel)
    splat_slam = slam_zbuf_yardsticks(splat_kernel, slam_vol, slam_pose)
    del slam_vol
    slam["profile"] = slam_profile(dev)
    stereo["profile"] = stereo_profile(dev)
    log(f"[chip_smoke] phase 7: device times ({smi}) ({time.perf_counter() - t7:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")

    report = {
        "card": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc_s": nvcc_s,
        "fuse_rows_640x480": fuse,
        "fuse_rows_1080p": fuse_1080,
        "fuse_rows_real_frame": fuse_real,
        "fusion": fusion,
        "splat_640x480": splat,
        "splat_1080p": splat_1080,
        "splat_about_z": splat_about_z,
        "probe": probe,
        "render": render,
        "online": online,
        "export": export,
        "slam": slam,
        "served": served,
        "phase10": p10,
        "stereo": stereo,
        "soak": soak_res,
        "seg_parallel": seg_par,
        "kernel_verify": verify,
        "bench": bench,
        "splat_zbuf_slam_320x240": splat_slam,
        "fused_replay_ms_per_frame": ms_runs,
        "two_stage_replay_ms_per_frame": two_ms,
        "fingerprint_fused": fp_fused,
        "fingerprint_two_stage": fp_two,
        "fingerprint_reference": ref,
    }
    with open(os.path.join(str(build.BUILD_DIR), "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    kernels = [
        {"name": "fuse_rows", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/fuse_rows.cu",
         "also_source": ["disinfect_slam_tpu_torch/csrc/fuse_rows.cuh"],
         "replaces": "disinfect_slam_tpu/ops/pallas/fuse_kernel.py:262",
         "also_replaces": "disinfect_slam_tpu/ops/pallas/fuse_kernel.py:519",
         "launches": fused_launches, "online_launches": online["online_launches"],
         "online_app_launches": online["app"]["fused"]["fuse_rows_launches"],
         "hash_launches": export["hash"]["fuse_rows_launches"],
         "slam_launches": slam["app"]["launches"]["fuse_rows"],
         "serve_launches": served["service"]["fuse_rows_launches"],
         "paged_app_launches": [served[k]["fuse_rows_launches"]
                                for k in ("paged_app", "paging_app")],
         "cull_launches": served["cull"]["on"]["fuse_rows_launches"],
         "dist_launches": [dist[f"shards_{k}"]["fuse_rows_launches"] for k in (DIST_SHARDS, 1)],
         "stereo_app_launches": [stereo["app"][k]["fuse_rows_launches"]
                                 for k in ("fused", "async")],
         "soak_launches": soak_res["launches"]["fuse_rows"],
         "seg_parallel_launches": seg_par["hand_kernel_launches"]["fuse_rows"],
         "verify_launches": verify["launches"]["fuse_rows"],
         "bench_launches": bench["launches"]["total"]["fuse_rows"],
         "bench_verify_launches": bench["launches"]["self_check"]["fuse_rows"],
         **fuse,
         "max_abs_err": max(fuse["max_abs_err"], fuse_1080["max_abs_err"],
                            fuse_real["max_abs_err"], soak_res["kernels"]["k2"]["max_abs_err"]),
         "ms_1080p": fuse_1080["ms"], "bound_ms_1080p": fuse_1080["bound_ms"],
         "ms_real_frame": fuse_real["ms"], "bound_ms_real_frame": fuse_real["bound_ms"]},
        {"name": "sample_rows", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/sample_rows.cu",
         "replaces": "disinfect_slam_tpu/ops/pallas/sample_kernel.py:359",
         "launches": sample_launches,
         "seg_parallel_launches": seg_par["hand_kernel_launches"]["sample_rows"],
         "verify_launches": verify["launches"]["sample_rows"],
         "bench_launches": bench["launches"]["total"]["sample_rows"],
         "bench_verify_launches": bench["launches"]["self_check"]["sample_rows"], **sample},
        {"name": "splat_zbuf_blocks", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/splat_rows.cu",
         "also_source": ["disinfect_slam_tpu_torch/csrc/splat_zbuf_tile.cuh",
                         "disinfect_slam_tpu_torch/csrc/splat_project.cuh"],
         "replaces": "disinfect_slam_tpu/ops/pallas/splat_kernel.py:149",
         "launches": splat_launches[0], "hash_launches": export["hash"]["splat_launches"][0],
         "slam_launches": slam["app"]["launches"]["splat_zbuf_blocks"],
         "serve_launches": served["service"]["splat_launches"][0],
         "view_launches": served["view"]["splat_launches"][0],
         "dist_launches": dist["render"]["launches"][0],
         "soak_launches": soak_res["launches"]["splat_zbuf_blocks"],
         "seg_parallel_launches": seg_par["hand_kernel_launches"]["splat_zbuf_blocks"],
         "verify_launches": verify["launches"]["splat_zbuf_blocks"],
         "bench_launches": bench["launches"]["total"]["splat_zbuf_blocks"],
         "bench_verify_launches": bench["launches"]["self_check"]["splat_zbuf_blocks"],
         **splat["zbuf"],
         "max_abs_err": max(splat["zbuf"]["max_abs_err"], splat_1080["zbuf"]["max_abs_err"],
                            *(w["zbuf"]["max_abs_err"] for w in splat_about_z),
                            render_err["zbuf"], soak_res["kernels"]["k4"]["max_abs_err"],
                            *(v["max_abs_err"] for v in slam["zbuf"].values())),
         "ms_slam_320x240": splat_slam["ms"], "bound_ms_slam_320x240": splat_slam["bound_ms"],
         "plain_ms_slam_320x240": splat_slam["plain_ms"],
         "library_ms_slam_320x240": splat_slam["library_ms"],
         "branches_about_z": [w["zbuf"]["branches"] for w in splat_about_z],
         "branches_real_render": render["zbuf_branches"]},
        {"name": "splat_payload_blocks", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/splat_rows.cu",
         "replaces": "disinfect_slam_tpu/ops/pallas/splat_kernel.py:438",
         "launches": splat_launches[1], "hash_launches": export["hash"]["splat_launches"][1],
         "slam_launches": slam["app"]["launches"]["splat_payload_blocks"],
         "serve_launches": served["service"]["splat_launches"][1],
         "view_launches": served["view"]["splat_launches"][1],
         "dist_launches": dist["render"]["launches"][1],
         "seg_parallel_launches": seg_par["hand_kernel_launches"]["splat_payload_blocks"],
         "verify_launches": verify["launches"]["splat_payload_blocks"],
         "bench_launches": bench["launches"]["total"]["splat_payload_blocks"],
         "bench_verify_launches": bench["launches"]["self_check"]["splat_payload_blocks"],
         **splat["payload"],
         "max_abs_err": max(splat["payload"]["max_abs_err"],
                            splat_1080["payload"]["max_abs_err"],
                            *(w["payload"]["max_abs_err"] for w in splat_about_z),
                            render_err["pbuf"]),
         "branches_about_z": [w["payload"]["branches"] for w in splat_about_z],
         "branches_real_render": render["payload_branches"]},
        *probe_kernels(probe, probe_main_launches),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
