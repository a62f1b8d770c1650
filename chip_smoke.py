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
     the JAX reference's render fingerprint; the parity raycaster (the
     superblock_bits and raycast kernels, csrc/raycast_bits.cu and
     csrc/raycast.cu) through TSDFGrid.ray_cast(renderer="raycast") at
     frames 0-4: the captured RaycastStep (the main path, one launch of
     each counted a render) and the same eagerly, ms a render, the
     frame-0 render bit-equal to the eager one, to raycast_reference on
     the card (its time beside) and to the port's CPU raycast of the same
     volume, and the splat's divergence from it; then fuse_rows
     against its plain version on frame 30's visible set of the fused
     volume, with its yardsticks (below);
  6. the online slice (segmentation feeding fusion): InferenceEngine on
     frame 0 for both shipped nets against the JAX reference's seg
     fingerprint, timed end to end (seg_ms) and on a staged input
     (seg_dev_ms); FusedOnlineStep at the bench preset over the first 30
     frames (u8 rgb, raw u16 depth) with the shipped UNet, three times on
     fresh volumes (online_fps, timed after 6 warm-up frames: every key of
     the captured step),
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
     bit-equal in both buffers to the plain splat, and the raycast kernel
     on the hash volume, captured and eager, bit-equal to its plain
     version); and apps.offline
     --preset small --grid-log2 6 --auto-recenter, whose window moves
     (every live entry's table cell points back at it, no live block
     outside the window);
  8. the tracking slice (pose-free dense SLAM): (a) apps.dense_slam over
     all 60 frames with --loop-closure --evaluate auto --out-traj --save
     --mesh at its defaults (2 cm voxels, 6 cm truncation, 4 m, the
     default TSDFConfig: 2^16-block pool, 16384 visible rows), the tracked
     frame a captured step (systems/dense_slam.TrackFuseStep): fuse_rows
     once per frame, splat_zbuf_blocks once per tracked frame (graph
     replays included), splat_payload_blocks never, no pose read outside
     the loop verifications, the ICP kernel (icp_step) once an
     iteration, 19 a tracked frame and a loop verification; the
     trajectory, ok flags, ATE and volume against the JAX DenseSLAM's
     fingerprint (data/orbit_vga_slam_fingerprint.json) within TOL_SLAM_*,
     and every pose and ok flag bit-equal to the port's own run on the CPU
     (data/orbit_vga_slam_port_poses.json); (b)
     DenseSLAM in process at track_res_scale 1 and 2, ms/frame over
     frames 3-59 with one sync at the end, three fresh runs each
     (captured), lost frames and ATE, every pose bit-equal to the CPU
     port's, then one eager pass (capture=False)
     split by CUDA events (upload, model depth, pyramids, ICP, the gate,
     fusion, keyframe work); (c) K4
     on the app's SLAM volume at 640x480 and 320x240, bit-equal to its
     plain version, its branches counted; (d) LoopClosureManager on the
     card over tests/test_loop_closure.py's drifted out-and-back keyframes
     (tests/torch_cases.py): the loop closes and the error falls, the
     queries and pose graphs as captured steps, 12 pose_graph_solve
     launches a closure, the wall time beside the parent tree's; (e)
     where the card's tracker parts from the CPU's (utils/parting.py):
     the eager DenseSLAM on the card and on the CPU in lockstep over
     frames 0-10 at track_res_scale 1 and 2, every stage of every frame
     bit for bit (the inverse and seed, the model depth, the pyramids,
     each ICP iteration, the gate, the volume, the descriptors, the
     match scores, the pose graph's keyframe poses) and the tracker's
     stages recomputed on the card from the CPU's inputs: any parting
     fails;
  7. device times, after every end-to-end measurement (a profiler trace
     leaves the host slower for the rest of the process): the fusion
     profile (frames 45-59 of a fresh volume: device time, kernels per
     frame, idle share; then the fuse stage, fuse_visible, on frame 59's
     visible set); phase 2's checks again, now with each kernel's
     yardsticks: its device time (and one call's, CUDA events) beside its
     bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s), its
     plain version's time and, where one torch call computes the same
     function, that call's device time; and the probes: K4's own
     instruments (the per-voxel atomics against the tile kernel, the
     tile-shape sweep), P8 and P9 (the Pallas z-buffer from the scripts'
     own inputs, every function bit-equal to its plain version on the
     card and to probe_splat2.py main's numpy z-buffer, the shared patch
     against one atomic a footprint pixel), the feature probe (P7: one
     launch of the Pallas probe's eight functions and the port's
     primitives, every role bit-equal to its plain version and every
     check passed, its time beside its operation bound and floors), P4
     and P5 (the Pallas sampler's modes on the scripts' own inputs, every
     mode bit-equal to its plain version on the card), and the window
     selections (P1-P3, P6: each row's footprint box staged through a
     bulk-copy ring, with what each window shape stages) beside the
     port's instruments of K1 (its direct modes) and of K2 (fuse_rows
     stripped stage by stage), each mode against its plain version; each
     probe kernel beside its bound, its plain version and, where one
     torch call computes it, that call; K4 at 320x240 on phase
     8's SLAM volume (its bound, its plain version, scatter_reduce
     "amin"); the ICP kernel
     (icp_step) at each pyramid level of orbit_vga at track_res_scale 1 and
     2, bit-equal to its plain version on the card and the CPU, its device
     time beside its bound, its order floor (the chain probe: 29 register
     chains of N / 8 dependent float32 adds) and its plain version's time,
     and a tracked frame's totals; the pose graph's kernel
     (pose_graph_solve and its fused entry, the residuals and Jacobians in
     the launch) at 8, 32, 128, 256 and 512 nodes (the last with its
     columns in device memory), each entry bit-equal to its
     plain version, its device time beside its bound, its order floor
     (the chain probe: the pivot steps alone) beside the parent design's,
     torch.linalg.solve_ex of the same H, the plain versions' times and one
     call's stages from the kernel's timeline; the pose graph's pass
     layout (a panel's rows in passes) forced at 8 and 512 nodes and taken
     by itself at 2736 nodes (m = 16416, past the register layouts' 16384
     rows), each bit-equal to its plain version (core/exact.solve_lu); the
     raycast kernel on phase 3's volume at the frame-0 view and the app's
     640x360 view, bit-equal to its plain version, its device time beside
     its bound (from the launch's record of its work: the images, the
     bits, each distinct index entry and tsdf row read once), its order
     floor (the longest chain of dependent global loads the kernel counted
     for a ray, at the latency of the chase probe's dependent loads in L2;
     the two-loads-a-sample definition beside it), its plain version's
     time, its launch shape and the A/B of its bits in shared and in
     device memory; the
     superblock_bits kernel bit-equal to its plain version, its device
     time beside its bound, its plain version's and torch.amax's; a
     captured render's graph split into the two kernels and the rest, its
     wall time with the pose staged and with a DevicePose; and the SLAM frame
     profiled (frames 45-59: device time, kernels, idle share; ICP alone:
     kernels, device time and the host time of its ops).

  9. the served map, on phase 3's volume: (a) ReconstructionService
     over a DISINFSystem at the bench preset on 127.0.0.1 (make_server in a
     thread): all 60 frames POSTed as npz (rgb, depth, the logged ht/lt
     and pose), fuse_rows once a frame; the service drops the POSTed
     ht/lt in disinf mode, as the JAX service does, so the served volume
     is bit-equal to a card replay fed ht = lt = None and within that
     replay's JAX fingerprint (data/orbit_vga_bench_noseg_fingerprint.json); /render at frame 0's
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
     scenes, eager and captured (a CUDA graph a step after each staging
     slot's first call), with cuDNN deterministic (the captured losses and
     parameters bit-equal to eager) and at its defaults: the loss finite
     and falling, step ms (CUDA events, median of the last 8), graph
     replays, peak memory, and (at the end of the phase) one profiled
     eager step and one profiled replay (kernels, device ms, host launch
     calls: none in a replay, idle share); a narrow net's first step on
     the card against the CPU from the same parameters, float32 and
     bfloat16 (TRAIN_TOL); (b) apps.train_seg as its own process (no
     --device: its steps captured) for 600 steps at its defaults: its npz
     beats IoU 0.7 on both channels of
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
     frame, splat_zbuf_blocks once a tracked frame, icp_step 19 times a
     tracked frame and a verification, pose_graph_solve 12 times a
     closure), every count and the end position
     equal to the port's soak on the CPU (data/orbit_vga_slam_port_poses.json);
     wall time, ms/frame and closures; then K4 on the final volume at the soak's 96x72
     (partial tiles) bit-equal to its plain version, and K2 on the last
     frame's visible rows against its plain version.
  13. the segmentation net over a (data, model) mesh
     (parallel/seg_parallel.py), the shipped UNet's architecture at its
     full width, 352x640, batch 8 (phase 10a's shape), cuDNN
     deterministic: make_train_step and the sharded step over [cuda:0]
     (1x1) and [cuda:0] * 4 (2x2), each captured (one CUDA graph a step)
     and eager over 10 steps, the captured run bit-equal to its eager
     twin, loss and every parameter, and the 1x1 run bit-equal to
     make_train_step's; ms a step of each (median of the last 8, CUDA
     events), graph replays, one profiled eager step and one profiled
     replay each (kernels, device ms, host launch calls: none in a
     replay, idle share), and the 2x2 step's ms eager and captured again
     at cuDNN's defaults; over 2x2 the first step's loss within 1e-5
     relative, and in float32 its gradients within 1e-4 of each
     parameter's largest with AdamW held on them bit-equal;
     make_sharded_infer of the shipped weights over [cuda:0] * 4 against
     sigmoid(model), bfloat16 (captured, bit-equal to eager, ms a call of
     each) and float32 (SEG_PAR_INFER_TOL); no fusion or splat kernel
     launched;
  14. the kernels' self-check: utils/kernel_verify.verify_all() on the
     card (K1 at 640x480, 1080p and with an early count, the two-stage
     and the fused integrate of a small scene, K4/K5's render of it, the
     captured steps, icp_step, pose_graph_solve, the raycast kernel on a
     dense (both bits layouts) and a hash volume, superblock_bits: eleven
     checks), every
     check PASS in under 60 s; its launches are reported apart
     from the main paths' (verify_launches).
  15. the port's benchmark as a user runs it: `python bench_torch.py` in
     its own process (no arguments, so on the card), under a time limit:
     exit 0, its self-check PASS before anything is timed, the timed
     fusion volume within the JAX reference's fingerprint, and a last
     line with bench.py's twelve keys (platform "cuda", fallback false,
     vs_baseline null, every other number positive); fuse_rows launched
     2 + 60 times by the fusion stage and 30 a net by the online stage,
     each splat kernel 6 times, the raycast and superblock_bits kernels 6
     times by the captured raycast stage and never by its plain one,
     sample_rows only
     in the self-check
     (bench_launches in the kernels line).  Its line and its summary are
     printed.
  16. the captured steps (utils/graphs.py: each per-frame step one CUDA
     graph, the pose in device memory, the counterpart of the JAX
     package's jitted, donated steps): (a) the bench replay, all 60
     frames through TSDFGrid eager and then captured, three times in
     turns: every volume array equal, the captured volume within the
     fingerprint, ms/frame of each over frames 6-59 (CUDA events, the
     upload included, median of 3), fuse_rows launches and graph replays
     a frame, clocks.sm and power.draw; (b) FusedOnlineStep with the UNet
     and with FastSeg over 30 frames, eager and captured: the volumes
     equal, online_fps of each; (c) the splat render at frames 0-4's
     poses, eager (splat_render_cuda) and captured (TSDFGrid.ray_cast):
     every image equal, ms a render of each; (d) DISINFSystem integrating
     on its own thread against its eager twin; (e) a recenter in the
     middle of a captured replay: new captures, the volume equal to the
     eager twin's; (f) DenseSLAM (phase 8's configuration) over the 60
     frames at track_res_scale 1 and 2, eager and captured in turns, twice:
     every pose, ok flag and volume array equal, ms/frame of each over
     frames 3-59 (CUDA events), graph replays and K4 / K2 launches a
     frame, clocks.sm and power.draw; (g) the sharded step at the bench
     preset over [cuda:0] * 4 and [cuda:0], eager and captured in turns,
     twice: every block and the capacity cuts equal, ms/frame of each over
     frames 6-59, graph replays a frame; (h) the stereo estimator (flat
     and pyramid, 640x480, 64 disparities, the bench's pair from the
     host), the ZED factory rectifier's remap (VGA, host in and out),
     InferenceEngine.infer_one (the shipped UNet, frame 0 at 480x640 u8)
     and extract_mesh_chunked on (a)'s volume (f32 and q16), each eager
     (capture=False) and captured: outputs bit-equal, ms a call (CUDA
     events), graph replays a call; the mesh's first call (its own
     graphs), a repeat on kept graphs (every step replays) and its peak
     memory, both within the export fingerprint; then every replay
     profiled (frames 6-17 of the bench replay and the sharded step,
     45-59 of SLAM, three calls of each of (h)'s steps, one mesh call:
     device time, kernels, host launch calls and graph launches a frame or
     call, idle share).  The kernels line gives each kernel's launches
     made by graph replays over the run (graph_replays).

Each phase prints its wall seconds on a line of its own.  Phases run
0-6b, then 9, then 8, then 10, then 11, then 12, then 13,
then 14, then 15, then 16, then 7 (which
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

import collections
import gc
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
# the bench replay with ht = lt = 1 (scripts/port_fingerprint.py
# --no-semantics): the service drops POSTed ht / lt in disinf mode
NOSEG_FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                 "orbit_vga_bench_noseg_fingerprint.json")
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
# P7's floors beside its bound (csrc/feature_probe.cu): the dot's float32
# instructions, a multiply and an add for the plain sum (-fmad=false) and
# one fmaf, 3 x 256^3, over 132 SMs x 128 lanes at 1.98 GHz; and a sum's
# 256 dependent adds at 4 cycles
P7_FLOORS_MS = {"issue_floor_ms": 1e3 * 3 * 256**3 / (132 * 128 * 1.98e9),
                "order_floor_ms": 1e3 * 256 * 4 / 1.98e9}
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
TOL_SLAM = dict(t=TOL_SLAM_T, r=TOL_SLAM_R, ate=TOL_SLAM_ATE, count=TOL_SLAM_COUNT,
                sum=TOL_SLAM_SUM)
# the same run at track_res_scale=2 (ICP and the model depth at 320x240)
# against the JAX DenseSLAM's own fingerprint at that scale
# (scripts/port_fingerprint.py --slam --track-scale 2).  The half-resolution
# tracker amplifies an ulp far more (its model depth has hundreds of pixels
# whose normal is the rounding residue of cross(-v, -v)); these limits are
# 3x (scale 1's factor) the larger gap of JAX against itself with every
# depth one float32 ulp up and one ulp down (scripts/port_slam_gap.py
# --track-scale 2 on the CPU, 60 frames): a camera 41.36 / 55.20 mm and
# 18.04 / 22.08 mrad apart, ATE 2.354 / 2.246 mm, blocks 1 / 4 of 630, sums
# 0.377% / 0.635% (one twin alone would put the limit under the other's
# gap).  The port's own gap (46.1 mm, 40.5 mrad, ATE 2.61 mm, blocks 1.27%,
# sums 1.21%) sets none of them
SLAM_S2_FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                   "orbit_vga_slam_s2_fingerprint.json")
SLAM_S2_JAX_ULP_GAP = dict(t=0.05519853351876835, r=0.02207619453954418,
                           ate=0.002354249446624941, count=0.006349206349206327,
                           sum=0.006349206349206327)
TOL_SLAM_S2 = {k: 3 * v for k, v in SLAM_S2_JAX_ULP_GAP.items()}
SLAM_WARM = 3  # frames before the SLAM timing window (frames 3-59)
# the port's own DenseSLAM on the CPU (scripts/port_slam_gap.py --port-poses):
# every tracked pose at track_res_scale 1 and 2 and the soak's counts, which
# the card must give bit for bit (the tracker's arithmetic is the same
# sequence of IEEE operations on both devices)
SLAM_PORT_POSES = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                               "orbit_vga_slam_port_poses.json")
PARTING_FRAMES = 11  # phase 8 (e): frames 0-10, two keyframes
ICP_ITERS = (4, 5, 10)  # ICPOdometry's iterations at levels 0, 1, 2


def log(msg: str) -> None:
    print(msg, flush=True)


def free_graphs() -> None:
    """Collect the captured steps let go of (a step's graph cache is in a
    reference cycle) and release the allocator's cached memory."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_wall(name: str, t0: float) -> None:
    """The phase's wall seconds, on a line of its own."""
    log(f"[chip_smoke] phase {name} wall s: {time.perf_counter() - t0:.1f}")


def kernel_ms(fn, name=None, reps: int = 10, floor_ms: float = 0.0, events: bool = True):
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
    included) and the log says so, and a time below the bound raises;
    or (events False: where fn does more than the kernel, so that its CUDA
    events would not time the kernel) None, "not measured".
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
    if not events:
        log(f"[chip_smoke] {name or 'fn'}: no trace read at or above the bound (readings "
            f"{[round(r, 4) for r in readings]}, the rest lost their device events): not "
            f"measured")
        return None
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
    from disinfect_slam_tpu_torch.core.geometry import DevicePose
    from tests.torch_cases import block_case

    c = block_case(seed, img_h, img_w, V, COUNT, POOL, voxel_size=0.004, about_z=about_z,
                   with_pool=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    # the pose in device memory, as the captured steps hand it to the kernel
    return (t(c["img"]), t(c["block_pos"]), t(c["pool_idx"]),
            dict(cam_T_world=DevicePose.from_se3(c["pose"], dev), intrinsics=c["intrinsics"],
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
    from disinfect_slam_tpu_torch.core.geometry import CameraParams, DevicePose
    from tests.torch_cases import splat_block_case

    c = splat_block_case(seed, img_h, img_w, SPLAT_ROWS, SPLAT_COUNT, POOL,
                         voxel_size=SPLAT_VOXEL, truncation=SPLAT_TRUNC, about_z=about_z,
                         with_pool=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rows = (t(c["block_pos"]), t(c["pool_idx"]),
            torch.tensor(SPLAT_COUNT, dtype=torch.int32, device=dev))
    # the pose in device memory, as the captured render hands it to K4/K5
    geometry = dict(cam_T_world=DevicePose.from_se3(c["pose"], dev),
                    cam=CameraParams.create(c["intrinsics"], img_h, img_w),
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

    # the parity raycaster (the raycast kernel) on frames 0-4, and the
    # splat's divergence from it on frame 0
    ray, raycast = raycast_views(grid, view, frames)
    raycast_ms = raycast["captured_ms"]
    d = render_fast.render_divergence(ray, res, intrinsics, grid.cfg.voxel_size)
    p95 = float(np.percentile(d["depth_err"], 95)) if d["depth_err"].size else 0.0
    divergence = {"holes": d["holes"], "p95_depth_err_voxels": p95 / grid.cfg.voxel_size,
                  "bad": d["bad"], "on_edge": d["on_edge"],
                  "rgba_median": [float(v) for v in d["rgba_median"]],
                  "raycast_hit_share": ray.hit.float().mean().item()}
    log(f"[chip_smoke] raycast frame 0: {raycast_ms:.3f} ms a captured render (640x480); "
        f"splat divergence from it {divergence}")
    if not ray.hit.any():
        raise AssertionError("the parity raycaster hit nothing")
    report = {"splat_ms_per_render": passes, "splat_ms": splat_ms,
              "zbuf_branches": zbuf_branches, "payload_branches": payload_branches,
              "kernel_ms_frame0": split["kernel_ms"], "surface_blocks": kept + overflow,
              "surf_overflow": overflow, "stages_ms": stages, "split": split["stages_ms"],
              "profile": split["profile"], "fingerprints": fps, "raycast_ms": raycast_ms,
              "raycast": raycast, "divergence": divergence}
    return report, launches, err


RAY_FIELDS = ("hit", "depth", "rgba", "normal")


def to_cpu(vol):
    """A copy of a volume on the host."""
    import dataclasses

    return dataclasses.replace(vol, **{f.name: getattr(vol, f.name).cpu()
                                       for f in dataclasses.fields(vol) if f.name != "cfg"})


def raycast_views(grid, view, frames) -> tuple:
    """Phase 5, the parity raycaster through TSDFGrid.ray_cast(renderer=
    "raycast"): the main path first, the captured RaycastStep at frames
    0-4 (the capture, then three timed passes of five replays; one raycast
    and one superblock_bits launch counted a render), then the same passes
    eagerly (capture off:
    one launch a render); the frame-0 view captured against the eager
    render, raycast_reference on the card and the port's CPU raycast of a
    host copy of the volume, all four images bit for bit.  Returns (the
    frame-0 render, the report)."""
    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel
    from disinfect_slam_tpu_torch.ops.raycast import raycast_reference

    intr, hgt, wid = view
    cam = CameraParams.create(CameraIntrinsics.create(*intr), hgt, wid)

    def passes() -> list:
        grid.ray_cast(RENDER_MAX_DEPTH, view, frames[0], renderer="raycast")  # warm-up
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for pose in frames:
                grid.ray_cast(RENDER_MAX_DEPTH, view, pose, renderer="raycast")
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0) / len(frames))
        return out

    grid.capture = True
    reset_launches(raycast_kernel.raycast, raycast_kernel.superblock_bits)
    captured = passes()
    launches = raycast_kernel.raycast.launches
    bits_launches = raycast_kernel.superblock_bits.launches
    n_renders = 1 + 3 * len(frames)
    if launches != n_renders or bits_launches != n_renders:
        raise AssertionError(f"the raycast kernel launched {launches} times and superblock_bits "
                             f"{bits_launches} for {n_renders} captured renders")
    grid.capture = False
    eager = passes()
    got = {"eager": grid.ray_cast(RENDER_MAX_DEPTH, view, frames[0], renderer="raycast")}
    grid.capture = True
    ray = grid.ray_cast(RENDER_MAX_DEPTH, view, frames[0], renderer="raycast")
    pose0 = SE3.from_matrix(frames[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got["plain on the card"] = raycast_reference(grid.volume, cam, pose0, RENDER_MAX_DEPTH)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    got["the port on the CPU"] = raycast_reference(to_cpu(grid.volume), cam, pose0,
                                                   RENDER_MAX_DEPTH)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    equal = {k: all(torch.equal(getattr(r, f).cpu(), getattr(ray, f).cpu()) for f in RAY_FIELDS)
             for k, r in got.items()}
    report = {"captured_ms_per_render": captured, "captured_ms": statistics.median(captured),
              "eager_ms_per_render": eager, "eager_ms": statistics.median(eager),
              "plain_ms": plain_ms, "cpu_ms": cpu_ms, "launches": launches,
              "bits_launches": bits_launches, "equal": equal,
              "hit_share": ray.hit.float().mean().item()}
    log(f"[chip_smoke] raycast (the kernels, {hgt}x{wid}, frames 0-4): captured ms/render "
        f"{captured} -> median {report['captured_ms']:.4f}, eager {eager} -> median "
        f"{report['eager_ms']:.4f}; launches {launches} raycast and {bits_launches} "
        f"superblock_bits for {n_renders} captured renders; the "
        f"plain march on the card {plain_ms:.1f} ms, on the CPU {cpu_ms:.1f} ms; frame 0 "
        f"captured bit-equal to {equal}; hit share {report['hit_share']:.4f}")
    if not all(equal.values()):
        raise AssertionError(f"the raycast kernel's render differs: {equal}")
    return ray, report


def raycast_hash(grid, view, frames) -> dict:
    """Phase 6b, the hash replay's volume through the raycast kernel (its
    probes): the captured frame-0 render, a replay and one eager launch
    against raycast_reference on the card and the port's CPU raycast of a
    host copy of the same volume, all four images bit for bit."""
    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel
    from disinfect_slam_tpu_torch.ops.raycast import raycast_reference

    intr, hgt, wid = view
    cam = CameraParams.create(CameraIntrinsics.create(*intr), hgt, wid)
    pose = SE3.from_matrix(frames[0])
    reset_launches(raycast_kernel.raycast, raycast_kernel.superblock_bits)
    got = {f"captured {i}": grid.ray_cast(RENDER_MAX_DEPTH, view, frames[0], renderer="raycast")
           for i in range(2)}
    got["eager"] = raycast_kernel.raycast(grid.volume, cam, pose, RENDER_MAX_DEPTH)
    launches = raycast_kernel.raycast.launches
    bits_launches = raycast_kernel.superblock_bits.launches
    if bits_launches:
        raise AssertionError("superblock_bits launched on the hash volume")
    got["plain on the card"] = raycast_reference(grid.volume, cam, pose, RENDER_MAX_DEPTH)
    cpu = raycast_reference(to_cpu(grid.volume), cam, pose, RENDER_MAX_DEPTH)
    equal = {k: all(torch.equal(getattr(r, f).cpu(), getattr(cpu, f)) for f in RAY_FIELDS)
             for k, r in got.items()}
    log(f"[chip_smoke] hash raycast frame 0: launches {launches} (a capture, a replay, an "
        f"eager call); bit-equal to the port's CPU raycast of the same volume: {equal}; hit "
        f"share {cpu.hit.float().mean().item():.4f}")
    if not all(equal.values()) or launches != 3 or not cpu.hit.any():
        raise AssertionError(f"the raycast kernel on the hash volume: equal {equal}, "
                             f"launches {launches}")
    return {"launches": launches, "bits_launches": bits_launches, "equal": equal,
            "hit_share": cpu.hit.float().mean().item()}


# operations counted from csrc/raycast.cu, float32 (a division or root counted
# as 8): a ray's setup (the back-projection, its norm, three divisions, the
# rotation, the step and origin) 70; a march sample (its position, the
# rounding, the crossing test) 15; a hit's bisection step 12 and its final
# voxel, normal, shade and depth 110
RAY_SETUP_OPS, SAMPLE_OPS, REFINE_OPS, SHADE_OPS = 70, 15, 12, 110
CHASE_STEPS = 20000  # dependent loads a chase probe takes


def load_latency_ms(dev, n: int, fresh: bool) -> float:
    """ms a dependent load: the chase probe through a random cycle of n
    int32 (4 n bytes), from a trace of CHASE_STEPS loads a call.  Each call
    starts at index 0, so that its loads hit the lines the last call left
    in L2, or (fresh) at a new random index of a cycle far larger than L2,
    so that they come from device memory."""
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel

    g = torch.Generator().manual_seed(0)
    perm = torch.randperm(n, generator=g)
    nxt = torch.empty(n, dtype=torch.int32)
    nxt[perm] = perm.roll(-1).to(torch.int32)
    nxt = nxt.to(dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    starts = iter(torch.randint(0, n, (64,), generator=g).tolist())
    return kernel_ms(lambda: raycast_kernel.chase(nxt, CHASE_STEPS, out,
                                                  next(starts) if fresh else 0),
                     "chase_kernel", reps=3) / CHASE_STEPS


def raycast_replay_profile(vol, cam, pose) -> dict:
    """Phase 7, a captured render as the main path runs it (a RaycastStep):
    wall ms a render over five calls after the capture (host clock, ending
    in a sync), with an SE3 pose through the step's one-slot pinned
    staging and with a DevicePose copied in on the device; the device ms of
    the step's graph alone (CUDA events around a bare replay, median of
    10), the superblock_bits kernel's and the raycast kernel's within it
    (traces of replays, None where every trace lost the kernel's events)
    and the rest (the pose's copy, the tile counter's memset, the images'
    copies; None unless both kernels were measured); the graph's nodes,
    read from the graph itself: its kernels must be one superblock_bits
    and one raycast launch and nothing else (no torch op of the table the
    bits replace); the idle share of a render, 1 - the graph's device ms
    over the staged wall ms.  As context, not in the graph: the torch ops
    of superblock_table, the table the bits replace."""
    from disinfect_slam_tpu_torch.core.geometry import DevicePose
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel
    from disinfect_slam_tpu_torch.ops.raycast import superblock_table
    from disinfect_slam_tpu_torch.utils.graphs import StepGraphs

    step = raycast_kernel.RaycastStep(vol.device,
                                      graphs=StepGraphs(vol.device, keep_structure=True))
    n = 5
    wall = {}
    for name, p in (("staged", pose), ("device", DevicePose.from_se3(pose, vol.device))):
        for _ in range(2):
            step(vol, cam, p, RENDER_MAX_DEPTH)  # the capture, then a replay
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(vol, cam, p, RENDER_MAX_DEPTH)
        torch.cuda.synchronize()
        wall[name] = 1e3 * (time.perf_counter() - t0) / n
    key = step.graphs.keys()[0]  # the staged pose's graph, made first
    nodes = step.graphs.nodes(key)
    kernels = {k: v for k, v in nodes.items() if k.startswith("KERNEL")}
    named = {kname: sum(v for k, v in kernels.items() if kname in k)
             for kname in ("superblock_bits_kernel", "raycast_kernel")}
    if named != {"superblock_bits_kernel": 1, "raycast_kernel": 1} or len(kernels) != 2:
        raise AssertionError(f"a captured render's graph should hold one superblock_bits and "
                             f"one raycast kernel and no other kernel (no torch op of the "
                             f"superblock table): its nodes {dict(nodes)}")
    replay = step.graphs._graphs[key][0]
    graph_ms = cuda_time_ms(replay)
    kernel = kernel_ms(replay, "raycast_kernel", events=False)
    bits = kernel_ms(replay, "superblock_bits_kernel", events=False)
    rest = None if kernel is None or bits is None else graph_ms - kernel - bits
    if rest is not None and rest < 0:
        raise AssertionError(f"the kernels' traced times ({bits} + {kernel} ms) exceed the "
                             f"graph's device time {graph_ms} ms")
    table_ms = kernel_ms(lambda: superblock_table(vol))
    wall_ms = wall["staged"]
    res = {"wall_ms_per_render": wall_ms, "wall_ms_per_render_device_pose": wall["device"],
           "graph_device_ms": graph_ms, "superblock_bits_ms": bits, "raycast_kernel_ms": kernel,
           "rest_ms": rest, "table_ms_context": table_ms,
           "nodes_per_replay": sum(nodes.values()), "nodes": dict(nodes),
           "idle_share": 1 - graph_ms / wall_ms}
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"  # noqa: E731
    log(f"[chip_smoke] raycast captured replay ({cam.img_w}x{cam.img_h}): wall "
        f"{wall_ms:.4f} ms/render with the SE3 staged, {wall['device']:.4f} with a DevicePose; "
        f"the graph's device time {graph_ms:.4f} ms (CUDA events): superblock_bits "
        f"{fmt(bits)}, the raycast kernel {fmt(kernel)}, the rest {fmt(rest)}; idle "
        f"share {res['idle_share']:.3f}; the graph's {res['nodes_per_replay']} nodes (read "
        f"from the graph): {dict(nodes)}; as context, superblock_table's torch ops (the table "
        f"the bits replace, alone) {table_ms:.4f}")
    return res


def superblock_bits_yardsticks(vol, launches) -> dict:
    """Phase 7, the superblock_bits kernel on phase 3's volume (a 2^8 grid):
    bit-equal to its plain version; its device time; its bound (the table
    read once, the bits written once; one AND a cell); its plain version's
    time; library: torch.amax of the occupancy reshaped to [s, 4, s, 4, s,
    4] over the 4s, the comparison included."""
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel
    from disinfect_slam_tpu_torch.ops.raycast import superblock_bits_reference

    cfg = vol.cfg
    got = raycast_kernel.superblock_bits(vol)
    plain = superblock_bits_reference(vol)
    err = int((got != plain).sum())
    s = cfg.grid_side >> 2
    table = vol.block_table
    lib = lambda: (table >= 0).view(torch.uint8).reshape(s, 4, s, 4, s, 4).amax(  # noqa: E731
        dim=(1, 3, 5))
    lib_occ = lib().reshape(-1).bool()
    occ = ((got.long()[:, None] >> torch.arange(32, device=got.device)) & 1).reshape(-1)
    if err or not torch.equal(occ[:s ** 3].bool(), lib_occ):
        raise AssertionError(f"superblock_bits differs from its plain version in {err} words")
    r = {**bound(4 * table.numel() + 4 * got.numel(), table.numel()), "max_abs_err": err,
         "words": got.numel(), "superblocks_held": int(lib_occ.sum()), "launches": launches}
    time_kernel(r, lambda: raycast_kernel.superblock_bits(vol), "superblock_bits_kernel")
    r["plain_ms"] = cuda_time_ms(lambda: superblock_bits_reference(vol))
    r["library_ms"] = kernel_ms(lib)
    print_yardsticks(f"superblock_bits ({cfg.grid_side}^3 cells, {r['words']} words, "
                     f"{r['superblocks_held']} of {s ** 3} superblocks held)", r)
    return r


def raycast_yardsticks(vol, intrinsics, poses, launches) -> dict:
    """Phase 7, the raycast kernel on phase 3's volume at the frame-0 view
    (640x480) and the app's view (640x360, the last pose): its device time
    from a trace and one wrapper call by CUDA events (the superblock bits'
    launch included); the bound from the launch's own record of its work
    (RaycastWork): the images written (13 bytes a pixel), the bits and each
    distinct index entry and tsdf row read once, over 3.35 TB/s, against
    the operations above over 67 TFLOP/s; the order floor, the longest
    chain of dependent global loads the kernel counted for a ray (a bit
    read from shared memory and a reused lookup count none) times the
    dependent-load latency the chase probe measures in L2 (the same 20000
    lines each call; fresh lines of a 256 MB cycle, from device memory,
    for context), and beside it the two-loads-a-sample floor (a table and a voxel load
    for each of the longest ray's march samples, its bisection steps, the
    origin, the final voxel and the normal's six reads together); the plain
    version's time; library: none.  Then the launch's shape in each bits
    layout (registers, shared memory, resident warps), the layouts' A/B at
    640x480 (shared, device, device, shared: each bit-equal), the
    superblock bits' own yardsticks and a captured render's profile at
    the frame-0 view (raycast_replay_profile)."""
    from disinfect_slam_tpu_torch.core.geometry import (SE3, CameraIntrinsics, CameraParams,
                                                        DevicePose)
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel
    from disinfect_slam_tpu_torch.ops.raycast import raycast_reference, superblock_words

    dev = vol.device
    lat_l2 = load_latency_ms(dev, 1 << 20, fresh=False)
    lat_hbm = load_latency_ms(dev, 1 << 26, fresh=True)
    cfg = vol.cfg
    refine = cfg.refine_iters(cfg.truncation / 2.0)
    bits_bytes = 4 * superblock_words(cfg)
    out = {"load_latency_us": {"l2": 1e3 * lat_l2, "hbm": 1e3 * lat_hbm}}
    out["shape"] = {lay: raycast_kernel.launch_shape(vol, lay) for lay in raycast_kernel.LAYOUTS}
    log(f"[chip_smoke] raycast launch shape (bits layout: registers a thread, shared memory "
        f"a CTA, CTAs and warps resident an SM): {out['shape']}")
    for name, (i, hgt, wid) in {"frame0": (0, H, W), "app": (-1, 360, 640)}.items():
        cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), hgt, wid)
        pose = DevicePose.from_se3(SE3.from_matrix(poses[i]), dev)
        fn = lambda c=cam, p=pose: raycast_kernel.raycast(vol, c, p, RENDER_MAX_DEPTH)  # noqa: E731
        work = raycast_kernel.RaycastWork.zeros(vol, cam)
        res = raycast_kernel.raycast(vol, cam, pose, RENDER_MAX_DEPTH, work=work)
        plain = raycast_reference(vol, cam, pose, RENDER_MAX_DEPTH)
        err = max(float((getattr(res, f).double() - getattr(plain, f).double()).abs().max())
                  for f in RAY_FIELDS)
        samples = work.samples
        cells, rows = int(work.cells.sum()), int(work.rows.sum())
        hits = int(res.hit.sum())
        nbytes = (hgt * wid * 13 + bits_bytes + cells * (4 if cfg.backend == "dense" else 8)
                  + rows * 4 * 512)
        ops = (hgt * wid * RAY_SETUP_OPS + int(samples.sum()) * SAMPLE_OPS
               + hits * (refine * REFINE_OPS + SHADE_OPS))
        longest = int(samples.max())
        loads = int(work.loads.max())
        loads_pr21 = 2 * (longest + refine + 3)
        r = {"img": f"{wid}x{hgt}", **bound(nbytes, ops), "max_abs_err": err,
             "samples": int(samples.sum()), "longest_ray_samples": longest,
             "index_entries": cells, "tsdf_rows": rows, "hits": hits,
             "order_floor_loads": loads, "order_floor_ms": loads * lat_l2,
             "mean_ray_loads": float(work.loads.float().mean()),
             "order_floor_loads_pr21": loads_pr21, "order_floor_ms_pr21": loads_pr21 * lat_l2,
             "library_ms": None, "launches": launches["raycast"]}
        time_kernel(r, fn, "raycast_kernel")
        r["plain_ms"] = cuda_time_ms(lambda c=cam, p=pose: raycast_reference(
            vol, c, p, RENDER_MAX_DEPTH), 1)
        print_yardsticks(f"raycast {name} ({wid}x{hgt}, {hits} hits, {r['samples']} samples, "
                         f"{cells} index entries, {rows} tsdf rows)", r)
        log(f"[chip_smoke] raycast {name}: order floor {r['order_floor_ms']:.4f} ms (the "
            f"longest chain the kernel counted, {loads} dependent global loads; "
            f"{r['mean_ray_loads']:.1f} a ray on average; at {out['load_latency_us']['l2']:.3f} "
            f"us in L2, {out['load_latency_us']['hbm']:.3f} us from device memory): the kernel "
            f"at {r['ms'] / r['order_floor_ms']:.2f}x it; the two-loads-a-sample floor (two "
            f"loads for each of "
            f"the longest ray's {longest} march samples, {refine} bisection steps and 3 more: "
            f"{loads_pr21} loads) {r['order_floor_ms_pr21']:.4f} ms")
        if err != 0.0:
            raise AssertionError(f"the raycast kernel at {name} differs from its plain "
                                 f"version by {err}")
        out[name] = r
    # the bits layouts' A/B at 640x480: shared, device, device, shared
    cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), H, W)
    pose = DevicePose.from_se3(SE3.from_matrix(poses[0]), dev)
    plain = raycast_reference(vol, cam, pose, RENDER_MAX_DEPTH)
    ab = {lay: [] for lay in raycast_kernel.LAYOUTS}
    for lay in ("shared", "device", "device", "shared"):
        got = raycast_kernel.raycast(vol, cam, pose, RENDER_MAX_DEPTH, layout=lay)
        if not all(torch.equal(getattr(got, f), getattr(plain, f)) for f in RAY_FIELDS):
            raise AssertionError(f"the raycast kernel with its bits in {lay} memory differs")
        ab[lay].append(kernel_ms(lambda lay=lay: raycast_kernel.raycast(
            vol, cam, pose, RENDER_MAX_DEPTH, layout=lay), "raycast_kernel",
            floor_ms=out["frame0"]["bound_ms"], events=False))
    out["layout_ab_ms"] = ab
    log(f"[chip_smoke] raycast bits layouts at 640x480 (device ms, shared / device / device / "
        f"shared, each bit-equal; None where every trace lost the kernel's events): shared "
        f"memory {ab['shared']}, device memory {ab['device']}")
    out["superblock_bits"] = superblock_bits_yardsticks(vol, launches["superblock_bits"])
    out["replay_profile"] = raycast_replay_profile(vol, cam, SE3.from_matrix(poses[0]))
    return out


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
    # every (cadence, staging slot) key of the captured step
    warm = GRAPH_WARM

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
    from disinfect_slam_tpu_torch.core.geometry import DevicePose
    from disinfect_slam_tpu_torch.ops.integrate import depth_to_range, gather_visible, stack_frame

    cam, (fr,) = bench_frames(index, 1)
    pose = DevicePose.from_matrix(fr.cam_T_world, dev)
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
    ray = raycast_hash(grid, (intrinsics, H, W), poses)
    return {"ms_per_frame": ms, "fuse_rows_launches": fuse_launches,
            "splat_launches": launches, "fingerprint": fp, "frames": res["frames"],
            "raycast": ray}


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


def check_slam_fingerprint(res, vol_fp, ref, tol=TOL_SLAM, label="slam app") -> dict:
    """A SLAM run against the JAX DenseSLAM's fingerprint, within the
    limits `tol` (t, r: each camera's centre and rotation; ate; count:
    blocks; sum: the volume's sums; PERF.md §2): the same ok flags, lost,
    keyframe and closure counts; each frame's pose; ATE; the volume.  res
    holds ok and poses by frame id, the DenseSLAM and the evaluation's
    ate / rpe."""
    fids = ref["frame_ids"]
    ok = [bool(res["ok"][f]) for f in fids]
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
    log(f"[chip_smoke] {label} against the JAX fingerprint: ok flags equal "
        f"{out['ok_equal']}, lost {out['lost']} (ref {ref['lost']}), keyframes "
        f"{out['keyframes']} ({ref['keyframes']}), closures {out['closures']} "
        f"({ref['closures']}); max per-frame gap {out['max_translation_gap_m'] * 1e3:.3f} mm "
        f"(limit {tol['t'] * 1e3:.1f}), {out['max_rotation_gap_rad'] * 1e3:.4f} mrad "
        f"(limit {tol['r'] * 1e3:.1f}); ATE rmse {ate['rmse']:.6f} m against "
        f"{ref['ate']['rmse']:.6f} (limit +-{tol['ate'] * 1e3:.2f} mm); volume relative to "
        f"the reference {out['volume_rel']} (limits {tol['count']:.5f}, {tol['sum']:.5f})")
    bad = []
    if not out["ok_equal"] or (out["lost"], out["keyframes"], out["closures"]) != (
            ref["lost"], ref["keyframes"], ref["closures"]):
        bad.append("ok flags or lost / keyframe / closure counts")
    if out["max_translation_gap_m"] > tol["t"] or out["max_rotation_gap_rad"] > tol["r"]:
        bad.append("per-frame poses")
    if out["ate_rmse_gap_m"] > tol["ate"]:
        bad.append("ATE")
    rel = out["volume_rel"]
    if abs(rel["active_blocks"]) > tol["count"] or any(
            abs(rel[k]) > tol["sum"] for k in ("sum_abs_tsdf", "sum_weight", "sum_prob")):
        bad.append("volume")
    if bad:
        raise AssertionError(f"{label} outside the fingerprint limits: {bad}")
    return out


def port_poses() -> dict:
    with open(SLAM_PORT_POSES) as f:
        return json.load(f)


def check_port_poses(poses, oks, scale: int, label: str) -> dict:
    """A SLAM run on the card against the port's own run on the CPU
    (SLAM_PORT_POSES): every frame's cam_T_world bit for bit and every ok
    flag equal; the first frame that differs fails the phase."""
    ref = port_poses()[f"scale{scale}"]
    want = np.asarray(ref["cam_T_world"], np.float32)
    got = np.asarray(poses, np.float32)
    differ = [i for i in range(len(want))
              if not np.array_equal(got[i].view(np.uint32), want[i].view(np.uint32))
              or bool(oks[i]) != ref["ok"][i]]
    log(f"[chip_smoke] {label} against the port on the CPU: {len(want) - len(differ)} of "
        f"{len(want)} frames' poses and ok flags bit-equal"
        + (f"; first differing frame {differ[0]}, max |d| "
           f"{float(np.abs(got[differ[0]] - want[differ[0]]).max())}" if differ else ""))
    if differ:
        raise AssertionError(f"{label}: frame {differ[0]} parts from the CPU port's pose")
    return {"frames": len(want), "bit_equal": True}


def slam_parting(dev) -> dict:
    """Phase 8 (e): where the card's tracker parts from the CPU's
    (utils/parting.py): phase 8's DenseSLAM eager on the card and on the
    CPU in lockstep over frames 0-10 at track_res_scale 1 and 2, every
    stage of every frame compared bit for bit (the pose's inverse and the
    seed, the model depth, both pyramids, each ICP iteration, the gate, the
    volume, the descriptors, the match scores, the keyframe poses), and
    the tracker's stages recomputed on the card from the CPU's inputs; any
    parting fails the phase."""
    from disinfect_slam_tpu_torch.utils import parting

    frames = slam_frames()[:PARTING_FRAMES]
    out = {}
    for scale in (1, 2):
        slams = [new_slam(dev, scale, capture=False), new_slam("cpu", scale, capture=False)]
        t0 = time.perf_counter()
        res = parting.lockstep(slams, lambda i, slam: slam.process_frame(*frames[i]),
                               len(frames))
        res["seconds"] = time.perf_counter() - t0
        log(f"[chip_smoke] parting, card against CPU, track_res_scale={scale}: "
            f"{parting.describe(res)} ({res['seconds']:.1f} s)")
        del slams
        if res["parted"] is not None or res["isolated"]:
            raise AssertionError(f"the card's tracker parts from the CPU's at scale {scale}: "
                                 f"{parting.describe(res)}")
        out[scale] = res
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
    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel

    reset_launches(fuse_kernel.fuse_rows, splat_kernel.splat_zbuf_blocks,
                   splat_kernel.splat_payload_blocks, icp_kernel.icp_step)
    odometry.read_result.reads = 0
    t0 = time.perf_counter()
    r = app.main(slam_app_args(out_dir))
    wall_s = time.perf_counter() - t0
    launches = {"fuse_rows": fuse_kernel.fuse_rows.launches,
                "splat_zbuf_blocks": splat_kernel.splat_zbuf_blocks.launches,
                "splat_payload_blocks": splat_kernel.splat_payload_blocks.launches}
    icp_launches = icp_kernel.icp_step.launches
    reads = odometry.read_result.reads
    lc = r["slam"].lc
    tracked = r["frames"] - 1
    log(f"[chip_smoke] slam app: {r['frames']} frames in {r['seconds']:.2f} s of frame loop "
        f"({wall_s:.2f} s with the mesh and the checkpoint), launches {launches}, pose reads "
        f"{reads} ({lc.verifications} loop verifications; the tracked frames read none), "
        f"graph replays {r['slam'].graphs.replays}, mesh {r['mesh']}")
    if r["frames"] != ref["frames"] or launches != {
            "fuse_rows": r["frames"], "splat_zbuf_blocks": tracked, "splat_payload_blocks": 0}:
        raise AssertionError(f"slam app: {r['frames']} frames, launches {launches}")
    if reads != lc.verifications or r["slam"].graphs.replays < tracked - 2:
        raise AssertionError(f"slam app: {reads} pose reads for {lc.verifications} "
                             f"verifications, {r['slam'].graphs.replays} graph replays for "
                             f"{tracked} tracked frames")
    # one launch an ICP iteration: 19 a tracked frame and a verification
    icp_want = sum(ICP_ITERS) * (tracked + lc.verifications)
    log(f"[chip_smoke] slam app: icp_step launched {icp_launches} times ({icp_want} = "
        f"{sum(ICP_ITERS)} iterations x ({tracked} tracked frames + {lc.verifications} "
        f"verifications), graph replays included)")
    if icp_launches != icp_want:
        raise AssertionError(f"slam app: icp_step launched {icp_launches} times, expected "
                             f"{icp_want}")
    for name in ("traj.txt", "slam_volume.npz", "slam_mesh.obj"):
        if os.path.getsize(os.path.join(out_dir, name)) == 0:
            raise AssertionError(f"slam app wrote an empty {name}")
    fp = check_slam_fingerprint(r, volume_fingerprint(volume_to_numpy(r["slam"].volume)), ref)
    fids = ref["frame_ids"]
    port = check_port_poses([r["poses"][f] for f in fids], [r["ok"][f] for f in fids], 1,
                            "slam app")
    res = {"frames": r["frames"], "loop_s": r["seconds"], "wall_s": wall_s,
           "launches": launches, "icp_launches": icp_launches, "pose_reads": reads,
           "verifications": lc.verifications, "mesh": r["mesh"], "port_cpu": port, **fp}
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


def new_slam(dev, scale, capture=True):
    """DenseSLAM at the app's defaults (2 cm, 6 cm, 4 m, the default
    TSDFConfig, loop closure every 10 frames, a 60-frame gap); capture=False
    for the eager step."""
    from disinfect_slam_tpu_torch.io.config_reader import get_intrinsics, load_yaml
    from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM

    intr = get_intrinsics(load_yaml(os.path.join(DATASET, "cam.yaml")))
    return DenseSLAM(intr, H, W, voxel_size=0.02, truncation=0.06, max_depth=4.0,
                     loop_closure=True, kf_every=10, lc_kwargs=dict(min_gap_frames=60),
                     track_res_scale=scale, device=dev, capture=capture)


def slam_timing(dev, frames, smi) -> dict:
    """Phase 8 (b): ms/frame over frames 3-59 with one sync at the end,
    three fresh runs at each track_res_scale (the captured step); lost
    frames and ATE against trajectory.txt, and at scale 2 each run held to
    the JAX fingerprint at that scale (TOL_SLAM_S2); then one eager pass
    split by CUDA events at each mark of the tracked step (and the host
    clock beside them), keyframe work after."""
    from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
    from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint
    from disinfect_slam_tpu_torch.systems.dense_slam import STAGES as SLAM_STAGES
    from disinfect_slam_tpu_torch.utils import trajectory_eval as te

    ts_gt, gt = te.load_trajectory(os.path.join(DATASET, "trajectory.txt"))
    with open(SLAM_S2_FINGERPRINT) as f:
        ref_s2 = json.load(f)
    out = {}
    for scale in (1, 2):
        ms, lost, ates, held = [], [], [], []
        for run in range(3):
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
            cam_T_world = torch.stack([p for p, _ in poses]).cpu().numpy()
            check_port_poses(cam_T_world, oks, scale, f"slam track_res_scale={scale} run {run}")
            est = np.linalg.inv(cam_T_world[oks])
            ates.append(te.ate(gt[oks], est)["rmse"])
            lost.append(slam.lost_count)
            if scale == 2:
                ate = {k: v for k, v in te.ate(gt[oks], est).items()
                       if k in ("rmse", "mean", "median", "max", "n")}  # the app's keys
                res = {"ok": oks, "poses": cam_T_world, "slam": slam,
                       "evaluation": {"ate": ate, "rpe": te.rpe(gt[oks], est, delta=1)}}
                held.append(check_slam_fingerprint(
                    res, volume_fingerprint(volume_to_numpy(slam.volume)), ref_s2, TOL_SLAM_S2,
                    f"slam track_res_scale=2 run {run}"))
            del slam
        # one eager pass split at the marks (frames SLAM_WARM-59)
        slam = new_slam(dev, scale, capture=False)
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
                      "host_split_ms": host_split, "held_to_reference": held}
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


# phase 8 (d)'s 12 keyframes with the pose graph's Jacobians outside the
# kernel (forward mode in torch, captured): chip_smoke.py's own run on the
# parent tree (NVIDIA H100 80GB HBM3, 700.00 W)
LC_PARENT_WALL_MS = 6706.9509520000565


def slam_loop_closure(dev) -> dict:
    """Phase 8 (d): the port's LoopClosureManager on the card over the
    drifted out-and-back keyframes of tests/test_loop_closure.py (its
    JAX-free copy, tests/torch_cases.py): a loop closes, first at keyframe
    5 or later, and the optimised keyframes' error falls below 60% of the
    drifted estimates' (the CPU test's limits); the keyframes' queries and
    the closures' pose graphs run as captured steps (each key's first call
    captures, within the wall time), each closure's pose graph 12
    pose_graph_solve launches, counted here."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel
    from disinfect_slam_tpu_torch.systems.loop_closure import LoopClosureManager
    from disinfect_slam_tpu_torch.utils.graphs import REPLAYS
    from tests.torch_cases import LC_ARGS, LC_H, LC_K, LC_W, out_and_back_keyframes

    true_poses, est_poses, depths = out_and_back_keyframes()
    lc = LoopClosureManager(LC_K, LC_H, LC_W, device=dev, **LC_ARGS)
    reset_launches(pose_graph_kernel.pose_graph_solve)
    replays = REPLAYS["graph"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    firsts = [k for k, (d, e) in enumerate(zip(depths, est_poses))
              if lc.add_keyframe(d, e, frame_id=10 * k) is not None]
    wall_ms = 1e3 * (time.perf_counter() - t0)
    err = lambda poses: float(np.mean([np.linalg.norm(p[:3, 3] - g[:3, 3])  # noqa: E731
                                       for p, g in zip(poses, true_poses)]))
    res = {"closures": lc.closures, "corrections_at": firsts, "verifications": lc.verifications,
           "err_est_m": err(est_poses), "err_opt_m": err(lc.kf_pose_opt),
           "wall_ms_12_keyframes": wall_ms, "wall_ms_12_keyframes_parent": LC_PARENT_WALL_MS,
           "pose_graph_solve_launches": pose_graph_kernel.pose_graph_solve.launches,
           "graph_captures": lc.graphs.captures, "graph_replays": REPLAYS["graph"] - replays}
    log(f"[chip_smoke] slam loop closure on the card: {res}")
    if not (lc.closures >= 1 and firsts and firsts[0] >= 5
            and res["err_opt_m"] < 0.6 * res["err_est_m"]):
        raise AssertionError(f"loop closure on the card did not close the chain: {res}")
    if res["pose_graph_solve_launches"] != 12 * lc.closures:
        raise AssertionError(f"pose_graph_solve launched {res['pose_graph_solve_launches']} "
                             f"times for {lc.closures} closures")
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


# float32 operations per pixel of an ICP iteration, counted from
# csrc/icp_step.cu (a division counted as 8): the two transforms (36), the
# projection (4 and 2 divisions, the rounding and clip: 28), the row's
# distance, residual and Huber weight (20 and a division: 28), the Jacobian
# and its weighting (15), the 29 products and the 29 adds of the sums
ICP_OPS_PER_PIXEL = 36 + 28 + 28 + 15 + 58


def icp_inputs(dev, scale: int, frame: int = 59) -> list:
    """ICP's inputs at each level, as _icp_level builds them, for orbit_vga's
    frame `frame` against frame - 1 at track_res_scale `scale`, made on the
    CPU: [(T0, src, ref_pack, ref_pose, intr, w, h)] finest level first."""
    from disinfect_slam_tpu_torch.io.png_io import read_image
    from disinfect_slam_tpu_torch.systems.odometry import ICPOdometry

    depth = [torch.from_numpy(read_image(os.path.join(DATASET, f"{i}_depth.png"),
                                         unchanged=True).astype(np.float32)[::scale, ::scale]
                              / 5000.0) for i in (frame - 1, frame)]
    k = tuple(v / scale for v in (525.1, 525.3, 319.6, 239.7))
    icp = ICPOdometry(k, H // scale, W // scale, device="cpu")
    pyr_ref, pyr_cur = icp._prep(depth[0]), icp._prep(depth[1])
    T0 = torch.eye(4)
    T0[:3, 3] = torch.tensor([0.004, -0.002, 0.003])
    out = []
    for lv, ((v, n, valid), (vc, _, _)) in enumerate(zip(pyr_ref, pyr_cur)):
        h, w = v.shape[:2]
        pack = torch.cat([v.reshape(-1, 3), n.reshape(-1, 3), valid.reshape(-1, 1).float(),
                          torch.zeros((h * w, 1))], 1)
        c = icp.cams[lv].intrinsics
        out.append((T0, vc.reshape(-1, 3).contiguous(), pack, torch.eye(4),
                    (c.fx, c.fy, c.cx, c.cy), w, h))
    return out


def icp_yardsticks(dev) -> dict:
    """Phase 7, the ICP kernel (csrc/icp_step.cu) at the SLAM's shapes:
    orbit_vga's frame 59 against frame 58 at track_res_scale 1 and 2, each
    pyramid level's inputs as _icp_level builds them: the kernel's result
    bit-equal to its plain version on the card and on the CPU, one call's
    device time beside its bound (each input read once: 12 B of source
    point and a 32 B reference row a pixel), its order floor (the device
    time of icp_kernel.chain: 29 register chains of N / 8 dependent
    float32 adds, the least the kernel's fixed sum order allows) and the
    plain version's time; then a tracked frame's totals (4, 5 and 10
    iterations of levels 0, 1 and 2).  No torch call computes the same
    function (library_ms null)."""
    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel

    delta = torch.tensor(0.05)
    dist2 = float(np.float32(0.25 * 0.25))
    seed = torch.full((32,), 1e-3, device=dev)
    sink = torch.empty(32, device=dev)
    out = {}
    for scale in (1, 2):
        levels = []
        for (T0, src, pack, ref_pose, intr, w, h), iters in zip(icp_inputs(dev, scale),
                                                                 ICP_ITERS):
            args = [t.to(dev) for t in (T0, src, pack, ref_pose, delta)]
            fn = lambda a=args, i=intr, w=w, h=h: icp_kernel.icp_step(  # noqa: E731
                *a, i, w, h, dist2)
            plain = lambda a=args, i=intr, w=w, h=h: icp_kernel.icp_step_reference(  # noqa: E731
                *a, i, w, h, dist2)
            got, on_card = fn(), plain()
            host = icp_kernel.icp_step_reference(T0, src, pack, ref_pose, delta, intr, w, h,
                                                 dist2)
            err = max(float((a.cpu().double() - b.double()).abs().max())
                      for pair in (zip(got, host), zip(on_card, host)) for a, b in pair)
            n = w * h
            res = bound(n * (12 + 32) + 2 * 64 + 4 + 64 + 8, n * ICP_OPS_PER_PIXEL)
            res.update({"w": w, "h": h, "iters": iters, "inliers": float(host[2]),
                        "max_abs_err": err})
            time_kernel(res, fn, "icp_step")
            chain = -(-n // icp_kernel.ACC)  # an accumulator's dependent adds
            res["order_floor_ms"] = kernel_ms(
                lambda r=chain: icp_kernel.chain(seed, r, sink), "icp_chain")
            res["plain_ms"] = cuda_time_ms(plain)
            res["library_ms"] = None
            print_yardsticks(f"icp_step {w}x{h}", res)
            log(f"[chip_smoke] icp_step {w}x{h}: order floor {res['order_floor_ms']:.4f} ms "
                f"({chain} dependent adds a chain) beside the byte bound "
                f"{res['bound_ms']:.4f} ms: the kernel at "
                f"{res['ms'] / res['order_floor_ms']:.2f}x the floor")
            if err != 0.0:
                raise AssertionError(f"icp_step at {w}x{h} differs from its plain version "
                                     f"by {err}")
            levels.append(res)
        frame = {k: sum(lv["iters"] * lv[k] for lv in levels)
                 for k in ("ms", "bound_ms", "order_floor_ms", "plain_ms")}
        log(f"[chip_smoke] icp_step a tracked frame at track_res_scale={scale}: kernel "
            f"{frame['ms']:.4f} ms, bound {frame['bound_ms']:.4f} ms "
            f"({frame['bound_ms'] / frame['ms']:.1%}), order floor "
            f"{frame['order_floor_ms']:.4f} ms, plain torch {frame['plain_ms']:.4f} ms, "
            f"{sum(ICP_ITERS)} launches")
        out[scale] = {"levels": levels, "per_frame": frame}
    return out


# pose_graph_solve's sizes (nodes, edges as LoopClosureManager pads them):
# the out-and-back chain, the soak's cap of 24 keyframes, the manager's
# default cap of 256 and half of it, and twice it (the columns in device
# memory)
POSE_GRAPH_SIZES = ((8, 16), (32, 64), (128, 256), (256, 512), (512, 1024))
# float64 outside the tensor cores on an H100 SXM (NVIDIA's data sheet,
# 700 W; an FMA counted as two operations, and the kernel fuses none)
PEAK_F64_OPS_PER_S = 34e12
# the order floor of the kernel this design replaced (m - 1 pivot steps,
# one cluster barrier each): chip_smoke.py's own run on the parent tree
# (NVIDIA H100 80GB HBM3, 700.00 W), ms at POSE_GRAPH_SIZES' nodes (not
# measured at 512)
PARENT_ORDER_FLOOR_MS = {8: 0.0821, 32: 0.3372, 128: 1.4011, 256: 2.9395}


def lu_counts(h: torch.Tensor, g: torch.Tensor) -> dict:
    """What the LU of [h | g] and its back substitution must compute, on
    this data (core/exact.solve_lu's steps on the device, counted there):
    the divisions of nonzero entries below each pivot, the multiply-
    subtract pairs of rows with a nonzero multiplier over the trailing
    columns (g's included), the back substitution's m divisions and a pair
    for each nonzero entry of U above the diagonal.  A zero's division and
    a zero multiplier's update change no bit: the data needs neither (the
    kernel skips the divisions, csrc/pose_graph.cu's quotient)."""
    a = torch.cat([h, g[:, None]], 1).clone()
    n = h.shape[0]
    rows = torch.arange(n, device=h.device)
    div = torch.zeros((), dtype=torch.int64, device=h.device)
    pairs = torch.zeros((), dtype=torch.int64, device=h.device)
    for k in range(n - 1):
        p = k + torch.argmax(torch.abs(a[k:, k]))
        kp = torch.stack([rows[k], p])
        a.index_copy_(0, kp, a.index_select(0, kp.flip(0)))
        col = a[k + 1:, k]
        div += (col != 0).sum()
        lo = col / a[k, k]
        pairs += (lo != 0).sum() * (n - k)
        a[k + 1:, k + 1:] -= lo[:, None] * a[k, k + 1:]
    upper = int((torch.triu(a[:, :n], 1) != 0).sum())
    return {"divisions": int(div) + n, "pairs": int(pairs) + upper}


def pose_graph_ops(m: int, e: int, nonzero: int, lu: dict) -> int:
    """pose_graph_solve's float64 operations on an m-row system of e edges,
    `nonzero` of them with Jacobians that are not all zero, counted from
    csrc/pose_graph.cu: each edge's 156 block entries of 6 products and 5
    adds, the nonzero edges' adds into H and g (156 each; the others add
    +-0 and are skipped), the diagonal's m adds; the LU's and the back
    substitution's divisions and multiply-subtract pairs on this data
    (lu_counts)."""
    return e * 156 * 11 + nonzero * 156 + m + lu["divisions"] + 2 * lu["pairs"]


def jacobian_ops(args) -> dict:
    """The float32 and float64 operations the edges' residuals and
    Jacobians need (args: the fused entry's CPU inputs): the adds,
    subtracts, products, divisions and roots of edge_jacobians_reference,
    counted under a dispatch mode by the elements they write, the primal's
    ([E, ...]) and the tangents' ([12, E, ...]) once each.  (The kernel
    computes each edge's primal in all 12 of its threads: work the
    function does not need, so not in the bound.)"""
    from torch.utils._python_dispatch import TorchDispatchMode

    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk

    arith = {"add", "sub", "rsub", "mul", "div", "sqrt"}
    counts = {torch.float32: 0, torch.float64: 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if func._schema.name.split("::")[-1] in arith and out.dtype in counts:
                counts[out.dtype] += out.numel()
            return out

    poses, ei, ej, z_inv, w, _ = args
    with Count():
        pk.edge_jacobians_reference(poses[ei.long()], poses[ej.long()], z_inv, w[:, None])
    return {"f32": counts[torch.float32], "f64": counts[torch.float64]}


def _timeline_breakdown(pk, fn, m: int, dev) -> dict:
    """One call's stages from the kernel's timeline (device clock, us): the
    Jacobians (fused entry), the edges' blocks, the assembly (CTA 0's), the
    panels' factorizations, their publishing, the flag hand-overs, the next
    panel's update by its owner, the back substitution."""
    tl = torch.zeros(pk.timeline_slots(m), dtype=torch.int64, device=dev)
    for _ in range(3):
        fn(tl)
    torch.cuda.synchronize()
    v = tl.cpu().numpy().astype(np.int64)
    p = v[8:].reshape(pk.panels(m), 4)
    return {"total_us": (v[3] - v[0]) / 1e3, "jacobians_us": (v[4] - v[0]) / 1e3,
            "edge_blocks_us": (v[5] - v[4]) / 1e3, "assembly_us": (v[1] - v[5]) / 1e3,
            "factor_us": float((p[:, 2] - p[:, 1]).sum()) / 1e3,
            "publish_us": float((p[:, 3] - p[:, 2]).sum()) / 1e3,
            "hand_over_us": float((p[1:, 0] - p[:-1, 3]).sum()) / 1e3,
            "update_next_us": float((p[1:, 1] - p[1:, 0]).sum()) / 1e3,
            "back_substitution_us": (v[3] - v[2]) / 1e3}


def pose_graph_yardsticks(dev) -> dict:
    """Phase 7, the pose graph's kernel (csrc/pose_graph.cu) at
    POSE_GRAPH_SIZES on tests/torch_cases.pose_graph_case's graphs, the
    first Gauss-Newton iteration, both entries: the solve-only entry's dx
    (from the forward-mode Jacobians) and the fused entry's dx and
    residuals (from the poses) bit-equal to their plain versions on the
    card and (up to 32 nodes) on the CPU; each entry's device time beside
    its bound (the larger of its bytes over 3.35 TB/s and its operations
    over the peak of their type), the order floor (the chain probe: the
    m - 1 pivot steps alone at the same launch shape) beside the parent
    design's, torch.linalg.solve_ex of the same H on the card (the library
    call; never used by the port), the plain versions' times, and one
    call's stages from the kernel's timeline."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
    from disinfect_slam_tpu_torch.systems import loop_closure as lc
    from tests.torch_cases import pose_graph_case

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.empty(sms, dtype=torch.int32, device=dev)
    out = {}
    for n_pad, e_pad in POSE_GRAPH_SIZES:
        graph = [torch.from_numpy(a) for a in pose_graph_case(n_pad, e_pad, seed=n_pad)]
        host = lc.pose_graph_system(*graph)
        fused_host = [graph[0], host[3], host[4], lc._inv_rigid(graph[3]).contiguous(), graph[4],
                      host[5]]
        args = [t.to(dev) for t in host]
        fargs = [t.to(dev) for t in fused_host]
        m = 6 * n_pad
        fn = lambda a=args: pk.pose_graph_solve(*a)  # noqa: E731
        fused = lambda a=fargs: pk.pose_graph_fused(*a)  # noqa: E731
        plain = lambda a=args: pk.pose_graph_solve_reference(*a)  # noqa: E731
        fused_plain = lambda a=fargs: pk.pose_graph_fused_reference(*a)  # noqa: E731
        diff = lambda x, y: float((x.cpu().double() - y.cpu().double()).abs().max())  # noqa: E731
        got, on_card = fn(), plain()
        err = diff(got, on_card)
        (fdx, frd), (pdx, prd) = fused(), fused_plain()
        ferr = max(diff(fdx, pdx), diff(frd, prd))
        if n_pad <= 32:
            err = max(err, diff(got, pk.pose_graph_solve_reference(*host)))
            cdx, crd = pk.pose_graph_fused_reference(*fused_host)
            ferr = max(ferr, diff(fdx, cdx), diff(frd, crd))
        nonzero = int(((host[0] != 0).flatten(1).any(1) | (host[1] != 0).flatten(1).any(1)).sum())
        nbytes = e_pad * (72 * 8 + 6 * 8 + 8) + m * 8 + m * 4
        h, g = pk.normal_equations(*args)
        lu = lu_counts(h, g)
        ops = pose_graph_ops(m, e_pad, nonzero, lu)
        by_bytes, by_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * ops / PEAK_F64_OPS_PER_S
        ctas, shared = pk.grid_shape(m, sms)
        res = {"n_pad": n_pad, "e_pad": e_pad, "m": m, "ctas": ctas, "shared": shared,
               "lu_counts": lu,
               "bound_ms": max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations", "bytes": nbytes,
               "ops": ops, "max_abs_err": max(err, ferr), "solve_err": err, "fused_err": ferr}
        time_kernel(res, fn, "pose_graph_kernel")
        # the fused entry: its Jacobians' float32 and float64 operations too
        jops = jacobian_ops(fused_host)
        fbytes = n_pad * 64 + e_pad * (8 + 64 + 4 + 48) + m * 8 + m * 4
        f_by_ops = max(1e3 * (ops + jops["f64"]) / PEAK_F64_OPS_PER_S,
                       1e3 * jops["f32"] / PEAK_F32_OPS_PER_S)
        res["fused_bound_ms"] = max(1e3 * fbytes / PEAK_BYTES_PER_S, f_by_ops)
        res["jacobian_ops"] = jops
        res["fused_ms"] = kernel_ms(fused, "pose_graph_kernel", floor_ms=res["fused_bound_ms"])
        res["fused_call_ms"] = cuda_time_ms(fused)
        col = h[:, 0].contiguous()  # the system's first column: its zeros are not divided
        res["order_floor_ms"] = kernel_ms(lambda c=col, k=ctas: pk.chain(c, k, sink),
                                          "pose_graph_chain")
        res["parent_order_floor_ms"] = PARENT_ORDER_FLOOR_MS.get(n_pad)
        res["library_ms"] = kernel_ms(lambda: torch.linalg.solve_ex(h, g))
        res["plain_ms"] = cuda_time_ms(plain, 1 if n_pad > 32 else 3)
        res["fused_plain_ms"] = cuda_time_ms(fused_plain, 1 if n_pad > 32 else 3)
        res["stages"] = _timeline_breakdown(
            pk, lambda tl, a=fargs: pk.pose_graph_fused(*a, timeline=tl), m, dev)
        print_yardsticks(f"pose_graph_solve m={m} ({n_pad} nodes, {e_pad} edges, "
                         f"{ctas} CTAs, columns in {'shared' if shared else 'device'} memory)",
                         res)
        log(f"[chip_smoke] pose_graph_fused m={m}: kernel {res['fused_ms']:.4f} ms (one call "
            f"{res['fused_call_ms']:.4f} ms), bound {res['fused_bound_ms']:.4f} ms ({jops}), "
            f"plain torch {res['fused_plain_ms']:.4f} ms; stages {res['stages']}")
        log(f"[chip_smoke] pose_graph_solve m={m}: order floor {res['order_floor_ms']:.4f} ms "
            f"({m - 1} pivot steps, {1e3 * res['order_floor_ms'] / (m - 1):.2f} us each; the "
            f"parent design's {res['parent_order_floor_ms']} ms): the kernel at "
            f"{res['ms'] / res['order_floor_ms']:.2f}x it; solve_ex / kernel "
            f"{res['library_ms'] / res['ms']:.2f}")
        if err != 0.0 or ferr != 0.0:
            raise AssertionError(f"pose_graph_solve at m={m} differs from its plain version "
                                 f"by {err} (solve-only) and {ferr} (fused)")
        out[n_pad] = res
        del h, g
        torch.cuda.empty_cache()
    return out


# the pass layout (csrc/pose_graph.cu: the threads stride over a panel's
# rows, their state in device memory): forced at 8 and 512 nodes, and
# taken by itself at 2736 nodes (m = 16416, just past the register
# layouts' 16384 rows); (nodes, edges, forced)
PASS_LAYOUT_CASES = ((8, 16, True), (512, 1024, True), (2736, 5472, False))


def pose_graph_pass_layout(dev) -> dict:
    """Phase 7, the pose graph's kernel in the pass layout on
    kernel_verify.pose_graph_inputs' random graphs: dx bit-equal to the
    plain version (normal_equations, then core/exact.solve_lu) on the card,
    and at 8 nodes to the CPU's; the kernel's time from a trace (one call
    by CUDA events at 2736 nodes), the plain version's by CUDA events."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
    from disinfect_slam_tpu_torch.utils.kernel_verify import pose_graph_inputs

    out = {}
    for n_pad, e, forced in PASS_LAYOUT_CASES:
        m = 6 * n_pad
        host = pose_graph_inputs(n_pad, e, seed=n_pad + 1, device="cpu")
        args = [t.to(dev) for t in host]
        fn = lambda a=args, f=forced: pk.pose_graph_solve(*a, passes=f)  # noqa: E731
        t0 = time.perf_counter()
        want = pk.pose_graph_solve_reference(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        got = fn()
        err = float((got.double() - want.double()).abs().max())
        equal = torch.equal(got, want)
        if n_pad <= 8:
            equal &= torch.equal(got.cpu(), pk.pose_graph_solve_reference(*host))
        big = n_pad > 512
        ms = cuda_time_ms(fn, 1) if big else kernel_ms(fn, "pose_graph_kernel", reps=5)
        layout = pk.launch_layout(m, torch.cuda.get_device_properties(dev).multi_processor_count,
                                  passes=forced)
        if not layout[1]:
            raise AssertionError(f"pose_graph_solve at m={m} does not take the pass layout")
        res = {"n_pad": n_pad, "e": e, "m": m, "forced": forced, "equal": equal,
               "max_abs_err": err, "ms": ms, "timed_by": "cuda events" if big else "trace",
               "plain_ms": plain_ms, "scratch_gb": pk.scratch_bytes(m, e) / 1e9}
        log(f"[chip_smoke] pose_graph_solve pass layout m={m} ({n_pad} nodes, {e} edges, "
            f"{'forced' if forced else 'by itself'}): bit-equal to solve_lu {equal}; kernel {ms:.4f} ms "
            f"({res['timed_by']}), plain {plain_ms:.1f} ms, scratch {res['scratch_gb']:.2f} GB")
        if not equal:
            raise AssertionError(f"pose_graph_solve in the pass layout at m={m} differs from "
                                 f"its plain version by {err}")
        out[n_pad] = res
        del args, want, got
        torch.cuda.empty_cache()
    return out


def slam_profile(dev) -> dict:
    """Phase 7, the SLAM frame under the profiler: a fresh (captured)
    DenseSLAM at track_res_scale 1 over frames 0-44, then frames 45-59
    profiled (step_profile); then ICP alone (ICPOdometry._track, eager,
    on frame 59 against the model depth, five calls): kernels, device
    and wall ms a call, and the torch ops that take the most host time in
    it."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.core.geometry import SE3
    from disinfect_slam_tpu_torch.systems.dense_slam import model_depth
    from disinfect_slam_tpu_torch.utils.device import upload

    frames = slam_frames()
    slam = new_slam(dev, 1)
    res = slam_frames_profile(slam, frames)

    prev = np.linalg.inv(slam.world_T_cam)
    tracker = slam.tracker
    pyr_ref = tracker._prep(model_depth(slam.volume, slam.track_cam, SE3.from_matrix(prev),
                                        slam.max_depth))
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
        f"{res['wall_ms_per_frame']:.3f} ms/frame, device kernel time "
        f"{res['device_ms_per_frame']:.3f} ms/frame in {res['kernels_per_frame']:.1f} "
        f"kernels/frame, idle share "
        + (f"{res['idle_share']:.3f}" if res["idle_share"] is not None else "not measured")
        + f"; ICP alone {res['icp']['wall_ms_per_call']:.3f} ms a call, "
        f"{res['icp']['kernels_per_call']:.1f} kernels, "
        f"{res['icp']['device_ms_per_call']:.3f} ms of device time; host time by op "
        f"(ms a call): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     res["icp"]["top_host_ops_ms_per_call"].items()))
    del slam
    torch.cuda.empty_cache()
    return res


def slam_slice(fuse_kernel, splat_kernel, dev, smi) -> dict:
    """Phase 8 (a)-(e); returns the report entry and the SLAM volume and
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
    parted = slam_parting(dev)
    return ({"app": app, "timing": timing, "zbuf": zbuf, "loop_closure": lc, "parting": parted},
            vol, pose)


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


def noseg_replay(offline, dev):
    """The bench replay on the card fed ht = lt = None, as the service
    fuses POSTed frames in disinf mode (it drops their ht / lt): a TSDFGrid
    at the bench preset."""
    from disinfect_slam_tpu_torch.io.config_reader import get_intrinsics, load_yaml
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
    from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

    cfg, voxel, trunc, max_depth = offline.make_config(offline.parse_args(
        ["--logdir", DATASET, "--preset", "bench", "--sampler", "pallas_fused"]))
    intrinsics = get_intrinsics(load_yaml(os.path.join(DATASET, "cam.yaml")))
    grid = TSDFGrid(voxel, trunc, cfg=cfg, device=dev)
    for fr in LoggedReplay(DATASET, 5000.0):
        grid.integrate(fr.rgb, fr.depth, None, None, max_depth, intrinsics, fr.cam_T_world)
    return grid


def served_map(offline, grid, fuse_kernel, splat_kernel, ref, export_ref, smi, dev) -> dict:
    """Phase 9a: the service in process.  POST every frame of the bench
    replay (rgb, depth, ht, lt, pose as npz); fuse_rows launches once a
    frame; the service drops the POSTed ht / lt, as the JAX service does,
    so the served volume equals a card replay fed ht = lt = None bit for
    bit and meets that replay's JAX fingerprint
    (data/orbit_vga_bench_noseg_fingerprint.json); /render at frame 0's pose launches each splat kernel once
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
        noseg = noseg_replay(offline, dev)
        equal = volumes_equal(served.volume, noseg.volume)
        del noseg
        log(f"[chip_smoke] served replay: {len(replay)} frames POSTed in {stream_s:.2f} s "
            f"(median {statistics.median(post_ms):.1f} ms a POST, npz of rgb, depth, ht, lt, "
            f"pose), fuse_rows launches {launches}; the served volume equals the card replay "
            f"fed ht = lt = None bit for bit: {equal} ({smi})")
        if not all(equal.values()):
            raise AssertionError(f"served volume differs from the no-semantics replay's: {equal}")
        with open(NOSEG_FINGERPRINT) as f:
            noseg_ref = json.load(f)
        fp = check_fingerprint(served, int(served.gather_valid().count), noseg_ref,
                               "served volume (no semantics)")

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


def _train_run(dev, arch, batches, capture) -> dict:
    """TRAIN_STEPS steps of make_train_step (capture as given) of a fresh
    seed-0 `arch` net, each between CUDA events; the losses kept in a
    buffer this function holds (a step's returned tensor is its own, but
    the list must not lean on that), read once after the loop."""
    from disinfect_slam_tpu_torch.models import train

    free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    state = train.create_train_state(arch=arch, lr=3e-3, device=dev,
                                     generator=torch.Generator().manual_seed(0))
    step = train.make_train_step(state.model, state.opt, capture=capture)
    losses = torch.empty(len(batches), device=dev)
    events = []
    for i, (imgs, labs) in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, imgs, labs)
        end.record()
        losses[i] = loss
        events.append((start, end))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    return {"losses": losses.tolist(), "step_ms": ms, "step_ms_median": statistics.median(ms[2:]),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "params": [p.detach().clone() for p in state.model.parameters()],
            "replays": step.graphs.replays if capture else 0,
            "n_params": sum(p.numel() for p in state.model.parameters())}


def train_full_width(dev, batches, smi) -> dict:
    """Phase 10a: UNetSeg and FastSeg at their shipped widths, TRAIN_STEPS
    steps of make_train_step each (AdamW at 3e-3, the rate
    tests/test_seg_training.py's falling-loss test uses), eager
    (capture=False) and captured (the default: the first two steps eager
    and captured, one per staging slot, then replays), first with cuDNN
    deterministic, where the captured losses and parameters must equal
    the eager ones bit for bit, then at cuDNN's defaults (as the app
    trains): the loss finite and falling, each step's ms (CUDA events,
    median of the last 8), graph replays and peak memory."""
    res = {}
    for arch in ("unet", "fast"):
        r = {}
        for mode, deterministic in (("deterministic", True), ("default", False)):
            prev = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = deterministic
            try:
                runs = {name: _train_run(dev, arch, batches, capture)
                        for name, capture in (("eager", False), ("captured", True))}
            finally:
                torch.backends.cudnn.deterministic = prev
            eager, captured = runs["eager"], runs["captured"]
            if deterministic:
                same = (eager["losses"] == captured["losses"]
                        and all(torch.equal(a, b) for a, b in zip(eager["params"],
                                                                  captured["params"])))
                if not same:
                    raise AssertionError(f"train {arch}: the captured steps differ from the "
                                         f"eager ones: {captured['losses']} vs "
                                         f"{eager['losses']}")
            if captured["replays"] != len(batches) - 2:
                raise AssertionError(f"train {arch}: {captured['replays']} graph replays for "
                                     f"{len(batches)} steps")
            for run in runs.values():
                del run["params"]
                losses = run["losses"]
                if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                    raise AssertionError(f"train {arch}: the loss did not fall: {losses}")
            r[mode] = runs
            log(f"[chip_smoke] train {arch} ({eager['n_params'] / 1e6:.2f} M params) at "
                f"{TRAIN_H}x{TRAIN_W} batch {TRAIN_BATCH}, cuDNN {mode}: loss "
                f"{eager['losses'][0]:.4f} -> {eager['losses'][-1]:.4f}; step eager "
                f"{eager['step_ms_median']:.2f} ms, captured {captured['step_ms_median']:.2f} "
                f"ms (median of the last {len(batches) - 2}; first {captured['step_ms'][0]:.1f} "
                f"/ {captured['step_ms'][1]:.1f} ms eager and captured, {captured['replays']} "
                f"graph replays); peak memory {eager['peak_gb']:.2f} / "
                f"{captured['peak_gb']:.2f} GB"
                + ("; captured losses and parameters bit-equal to eager" if deterministic
                   else "") + f" ({smi})")
        # the figures earlier PRs report: eager, at cuDNN's defaults
        r.update(params=r["default"]["eager"]["n_params"],
                 step_ms_median=r["default"]["eager"]["step_ms_median"],
                 captured_step_ms_median=r["default"]["captured"]["step_ms_median"])
        res[arch] = r
    free_graphs()
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
    """Phase 10a's profiles: one eager step and one replay of the captured
    step per net (step_profile: kernels, device ms, host launch calls,
    graph launches, idle share), after phase 10's timed work (a trace
    slows the host for the rest of the process)."""
    from disinfect_slam_tpu_torch.models import train

    dev = torch.device("cuda", 0)
    res = {}
    for arch in ("unet", "fast"):
        for capture in (False, True):
            state = train.create_train_state(arch=arch, lr=3e-3, device=dev)
            step = train.make_train_step(state.model, state.opt, capture=capture)
            for imgs, labs in batches[:2]:  # both staging slots captured
                step(state, imgs, labs)
            name = f"{arch}_{'captured' if capture else 'eager'}"
            res[name] = step_profile(lambda: step(state, *batches[2]), 1)
            log_profile(f"train {arch} step, {'a replay' if capture else 'eager'}", res[name])
            if capture and res[name]["launch_calls_per_frame"]:
                raise AssertionError(f"a replayed train step launched kernels from the host: "
                                     f"{res[name]}")
            del state, step
            free_graphs()
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


# the soak before the pose graph's kernel was redesigned: chip_smoke.py's
# phase 12 on the parent tree, 162f905 (NVIDIA H100 80GB HBM3, 700.00 W)
SOAK_PARENT_WALL_S = 16.8


def soak(fuse_kernel, splat_kernel, dev, smi) -> dict:
    """Phase 12: tests/test_soak.py's corridor, all SOAK_FRAMES frames,
    through DenseSLAM on the card (tests/torch_cases.py:run_soak) with the
    JAX soak's assertions and within the JAX soak's own counts
    (data/soak_fingerprint.json), and every count and the end position
    equal to the port's soak on the CPU (SLAM_PORT_POSES); fuse_rows once a frame,
    splat_zbuf_blocks once a tracked frame, and both held against their
    plain versions on the soak's own inputs after the run."""
    from tests.torch_cases import check_soak, check_soak_fingerprint, run_soak, soak_fingerprint

    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel, pose_graph_kernel

    fns = (fuse_kernel.fuse_rows, splat_kernel.splat_zbuf_blocks,
           splat_kernel.splat_payload_blocks)
    reset_launches(*fns, icp_kernel.icp_step, pose_graph_kernel.pose_graph_solve)
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
    res["launches"]["icp_step"] = icp_kernel.icp_step.launches
    icp_want = sum(ICP_ITERS) * (SOAK_FRAMES - 1 + slam.lc.verifications)
    log(f"[chip_smoke] soak: icp_step launched {res['launches']['icp_step']} times ({icp_want} "
        f"= {sum(ICP_ITERS)} x ({SOAK_FRAMES - 1} tracked frames + "
        f"{slam.lc.verifications} verifications))")
    if res["launches"]["icp_step"] != icp_want:
        raise AssertionError(f"soak: icp_step launched {res['launches']['icp_step']} times, "
                             f"expected {icp_want}")
    res["launches"]["pose_graph_solve"] = pose_graph_kernel.pose_graph_solve.launches
    log(f"[chip_smoke] soak: pose_graph_solve launched {res['launches']['pose_graph_solve']} "
        f"times (12 x {res['closures']} closures); the soak took {res['wall_s']:.1f} s "
        f"against the parent's {SOAK_PARENT_WALL_S} s")
    if res["launches"]["pose_graph_solve"] != 12 * res["closures"]:
        raise AssertionError(f"soak: pose_graph_solve launched "
                             f"{res['launches']['pose_graph_solve']} times for "
                             f"{res['closures']} closures")
    ref = soak_fingerprint()
    log(f"[chip_smoke] soak against the JAX soak's counts {ref}")
    check_soak_fingerprint(res, ref)
    cpu = port_poses()["soak"]
    same = {k: res[k] == v for k, v in cpu.items()}
    log(f"[chip_smoke] soak against the port's soak on the CPU {cpu}: equal {same}")
    if not all(same.values()):
        raise AssertionError(f"the card's soak parts from the CPU's: {same}")
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
VERIFY_CHECKS = 11  # K1 (three), K1 and K2 in integrate, K4/K5, the captured steps,
# icp_step, pose_graph_solve, raycast, superblock_bits


def _net(dev, dtype=torch.bfloat16):
    """The shipped UNetSeg's architecture at its full width, seed-0
    parameters, in training mode on dev."""
    from disinfect_slam_tpu_torch.models import segmentation as seg

    return seg.create_model(dtype=dtype, generator=torch.Generator().manual_seed(0)).to(dev).train()


def _seg_step(kind, dev, sd, capture):
    """A fresh state from the state dict sd and its step: kind
    "make_train_step" (models/train.py) or "sharded_N" (seg_parallel over
    [dev] * N)."""
    from disinfect_slam_tpu_torch.models import train
    from disinfect_slam_tpu_torch.parallel import seg_parallel as sp

    net = _net(dev)
    net.load_state_dict(sd)
    if kind == "make_train_step":
        state = train.create_train_state(net, lr=SEG_PAR_LR, device=dev)
        return state, train.make_train_step(state.model, state.opt, capture=capture)
    mesh = sp.make_mesh_2d(devices=[dev] * int(kind.split("_")[1]))
    return (sp.ShardedTrainState(sp.shard_params(net, mesh)),
            sp.make_sharded_train_step(net, dict(lr=SEG_PAR_LR), mesh, capture=capture))


def _seg_run(kind, dev, sd, batches, capture, profile=True) -> dict:
    """One step of _seg_step a batch, each between CUDA events, then (if
    `profile`) one profiled step (step_profile; for a captured step, a
    replay): the losses (in a buffer this function holds), the parameters
    after them under their names, the ms, graph replays and the
    profile."""
    torch.cuda.reset_peak_memory_stats(dev)
    state, step = _seg_step(kind, dev, sd, capture)
    losses = torch.empty(len(batches), device=dev)
    events = []
    for i, (imgs, labs) in enumerate(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, imgs, labs)
        end.record()
        losses[i] = loss
        events.append((start, end))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    # copies: the profiled step below moves the parameters on
    params = {k: p.detach().clone() for k, p in (
        state.model.named_parameters() if kind == "make_train_step"
        else state.params.full().items())}
    res = {"losses": losses, "params": params, "step_ms": ms,
           "step_ms_median": statistics.median(ms[2:]),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "replays": step.graphs.replays if capture else None}
    if profile:
        res["profile"] = step_profile(lambda: step(state, *batches[0]), 1)
    return res


def seg_parallel_checks(dev, batches, mesh_sizes=(1, 4)) -> dict:
    """Phase 13's steps on any device (the card here; the CPU tests run
    the same checks at a narrow width), with cuDNN on its deterministic
    algorithms (a weight gradient summed by atomics differs between two
    runs of one step): make_train_step and the sharded step over [dev]
    (1x1) and [dev] * 4 (2x2), each captured (the default) and eager
    (capture=False) over the batches from the same parameters, timed
    (CUDA events) and then profiled (an eager step, a replay): each
    captured run equal to its eager twin bit for bit, every loss and
    parameter, and the 1x1 sharded run equal to make_train_step's; over
    2x2 the first step's loss (bfloat16 net) and gradients (the same net
    in float32) within the CPU tests' limits, AdamW held on the same
    gradients (bit-equal)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _seg_parallel_checks(dev, batches, mesh_sizes)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _same_run(a: dict, b: dict) -> bool:
    return torch.equal(a["losses"], b["losses"]) and a["params"].keys() == b["params"].keys() \
        and all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def _seg_parallel_checks(dev, batches, mesh_sizes) -> dict:
    from disinfect_slam_tpu_torch.models import train
    from disinfect_slam_tpu_torch.parallel import seg_parallel as sp

    sd = _net(dev).state_dict()
    names = {"make_train_step": "make_train_step", f"sharded_{mesh_sizes[0]}": "sharded_1x1",
             f"sharded_{mesh_sizes[1]}": "sharded_2x2"}
    timing, params = {}, {}
    for kind, name in names.items():
        runs = {}
        for capture in (False, True):
            free_graphs()
            runs[capture] = _seg_run(kind, dev, sd, batches, capture)
            if capture and runs[capture]["profile"]["launch_calls_per_frame"]:
                raise AssertionError(f"a replayed {name} step launched kernels from the host: "
                                     f"{runs[capture]['profile']}")
        if not _same_run(runs[True], runs[False]):
            raise AssertionError(f"{name}: the captured steps differ from the eager ones: "
                                 f"{runs[True]['losses'].tolist()} vs "
                                 f"{runs[False]['losses'].tolist()}")
        params[name] = runs[True]
        timing[name] = {("captured" if c else "eager"): {
            k: r[k] for k in ("step_ms", "step_ms_median", "peak_gb", "replays", "profile")}
            for c, r in runs.items()}
        timing[name]["captured"]["losses"] = runs[True]["losses"].tolist()
        del runs
    if not _same_run(params["make_train_step"], params["sharded_1x1"]):
        raise AssertionError("1x1 mesh differs from make_train_step: "
                             f"{params['sharded_1x1']['losses'].tolist()} vs "
                             f"{params['make_train_step']['losses'].tolist()}")
    del params
    free_graphs()
    res = {"timing": timing, "steps_bit_equal": len(batches)}
    imgs, labs = batches[0]
    for dtype, label in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        base = _net(dev, dtype)
        base.load_state_dict(sd)
        one = train.create_train_state(_net(dev, dtype), lr=SEG_PAR_LR, device=dev)
        one.model.load_state_dict(sd)
        _, one_loss = train.make_train_step(one.model, one.opt, capture=False)(one, imgs, labs)
        grads = {k: p.grad for k, p in one.model.named_parameters()}
        mesh = sp.make_mesh_2d(devices=[dev] * mesh_sizes[1])
        st = sp.ShardedTrainState(sp.shard_params(base, mesh))
        st, loss = sp.make_sharded_train_step(base, dict(lr=SEG_PAR_LR), mesh,
                                              capture=False)(st, imgs, labs)
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
        free_graphs()
    return res


def _call_ms(fn, calls: int) -> list:
    """fn() `calls` times, each between CUDA events: the ms list."""
    events = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def seg_parallel_infer(dev, imgs, n_devices=4) -> dict:
    """Phase 13's inference: make_sharded_infer of the shipped UNet over
    [dev] * n_devices against sigmoid(model) on the whole batch, in
    bfloat16 (as shipped; captured, the default) and with the same weights
    in float32 (eager), within SEG_PAR_INFER_TOL; in bfloat16 the captured
    inference (its second call a replay) bit-equal to capture=False with
    cuDNN deterministic, and both timed (ms a call, CUDA events, median
    of the last 8 of 10, captured anew at cuDNN's defaults)."""
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
        r = {"mesh": list(mesh.shape)}
        if dtype == torch.bfloat16:
            infers = {c: sp.make_sharded_infer(model, mesh, capture=c) for c in (True, False)}
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                probs = [infers[True](imgs) for _ in range(2)]
                eager = infers[False](imgs)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            if not all(torch.equal(p, eager) for p in probs):
                raise AssertionError("sharded inference: captured differs from eager")
            r["replays"] = infers[True].graphs.replays
            probs = probs[-1]
            del eager, infers
            free_graphs()
            r["ms"] = {("captured" if c else "eager"): statistics.median(_call_ms(
                lambda f=sp.make_sharded_infer(model, mesh, capture=c): f(imgs), 10)[2:])
                for c in (False, True)}
        else:
            probs = sp.make_sharded_infer(model, mesh, capture=False)(imgs)
        if probs.shape != full.shape or not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"sharded inference: {tuple(probs.shape)} vs "
                                 f"{tuple(full.shape)}")
        d = (probs - full).abs()
        r.update(max_abs_err=float(d.max()), mean_abs_err=float(d.mean()),
                 labels_flipped=float(((probs > 0.5) != (full > 0.5)).float().mean()))
        res[label] = r
        if r["max_abs_err"] > SEG_PAR_INFER_TOL[label]:
            raise AssertionError(f"sharded inference off the net ({label}): {r}")
        del model, full, probs
        free_graphs()
    return res


def seg_parallel_slice(fuse_kernel, sample_kernel, splat_kernel, dev, smi) -> dict:
    """Phase 13 (see the docstring)."""
    hand = (fuse_kernel.fuse_rows, sample_kernel.sample_rows, splat_kernel.splat_zbuf_blocks,
            splat_kernel.splat_payload_blocks)
    reset_launches(*hand)
    t = time.perf_counter()
    batches = train_batches(TRAIN_STEPS, dev)
    res = {"batches_s": time.perf_counter() - t}
    res["checks"] = seg_parallel_checks(dev, batches)
    timing = res["timing"] = res["checks"].pop("timing")
    for k, v in timing.items():
        for c, r in v.items():
            log_profile(f"seg_parallel {k} {c} step" + (" (a replay)" if c == "captured" else ""),
                        r["profile"])
    log(f"[chip_smoke] seg_parallel, cuDNN deterministic: every captured step bit-equal to its "
        f"eager twin over {TRAIN_STEPS} steps (loss and every parameter), the 1x1 mesh over "
        f"[{dev}] bit-equal to make_train_step; 2x2 over [{dev}] * 4: "
        + "; ".join(f"{k} loss {v['loss']:.6f} vs {v['loss_1x1']:.6f} (rel {v['loss_rel']:.2e})"
                    + (f", gradients {v['grad_rel']:.2e} of each largest, AdamW held on them "
                       f"bit-equal" if "grad_rel" in v else "")
                    for k, v in res["checks"].items() if k.startswith("2x2")))
    log(f"[chip_smoke] seg_parallel step at {TRAIN_H}x{TRAIN_W} batch {TRAIN_BATCH} (UNet "
        f"full width, cuDNN deterministic, median of the last {TRAIN_STEPS - 2} of "
        f"{TRAIN_STEPS}, CUDA events; the captured step's first two calls eager and captured), "
        f"eager / captured: " + "; ".join(
            f"{k} {v['eager']['step_ms_median']:.2f} / {v['captured']['step_ms_median']:.2f} "
            f"ms, peak {v['eager']['peak_gb']:.2f} / {v['captured']['peak_gb']:.2f} GB, "
            f"{v['captured']['replays']} graph replays" for k, v in timing.items())
        + f" ({smi})")
    # the 2x2 step again at cuDNN's defaults, the algorithms training runs
    sd = _net(dev).state_dict()
    for capture in (False, True):
        free_graphs()
        r = _seg_run("sharded_4", dev, sd, batches, capture, profile=False)
        timing["sharded_2x2"][f"{'captured' if capture else 'eager'}_default"] = {
            "step_ms": r["step_ms"], "step_ms_median": r["step_ms_median"]}
        del r
    free_graphs()
    d = timing["sharded_2x2"]
    log(f"[chip_smoke] seg_parallel sharded_2x2 step at cuDNN's defaults, eager / captured: "
        f"{d['eager_default']['step_ms_median']:.2f} / "
        f"{d['captured_default']['step_ms_median']:.2f} ms (median of the last "
        f"{TRAIN_STEPS - 2} of {TRAIN_STEPS}, CUDA events) ({smi})")
    res["infer"] = seg_parallel_infer(dev, batches[0][0])
    res["hand_kernel_launches"] = {fn.__name__: fn.launches for fn in hand}
    log(f"[chip_smoke] seg_parallel inference of the shipped UNet over [{dev}] * 4 at "
        f"{TRAIN_H}x{TRAIN_W} batch {TRAIN_BATCH}: " + "; ".join(
            f"{k} max |dp| {v['max_abs_err']:.3e} (limit {SEG_PAR_INFER_TOL[k]:g}), mean "
            f"{v['mean_abs_err']:.3e}, labels flipped {v['labels_flipped']:.2e}"
            + (f", captured bit-equal to eager ({v['replays']} graph replay), ms a call eager "
               f"{v['ms']['eager']:.2f} / captured {v['ms']['captured']:.2f}" if "ms" in v
               else "") for k, v in res["infer"].items())
        + f"; hand kernel launches {res['hand_kernel_launches']} (cuDNN and torch ops only) "
        f"({smi})")
    if any(res["hand_kernel_launches"].values()):
        raise AssertionError("seg_parallel launched a fusion or splat kernel")
    del batches
    free_graphs()
    return res


def kernel_self_check(fuse_kernel, sample_kernel, splat_kernel, dev, smi) -> dict:
    """Phase 14: utils/kernel_verify.verify_all() on the card, every check
    PASS in under VERIFY_BUDGET_S; its comparison launches are counted
    apart from the main paths'."""
    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel, pose_graph_kernel, raycast_kernel
    from disinfect_slam_tpu_torch.utils import kernel_verify

    fns = (sample_kernel.sample_rows, fuse_kernel.fuse_rows, splat_kernel.splat_zbuf_blocks,
           splat_kernel.splat_payload_blocks, icp_kernel.icp_step,
           pose_graph_kernel.pose_graph_solve, raycast_kernel.raycast,
           raycast_kernel.superblock_bits)
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
    if len(kernel_verify.CHECKS) != VERIFY_CHECKS:
        raise AssertionError(f"the self-check has {len(kernel_verify.CHECKS)} checks, "
                             f"not {VERIFY_CHECKS}")
    return {"checks": len(kernel_verify.CHECKS), "wall_s": wall, "launches": launches}


# ----------------------------------------------------------------------
# phase 15: the port's benchmark
# ----------------------------------------------------------------------
BENCH_TIMEOUT_S = 600
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "platform", "img", "voxel_m",
              "online_fps", "online_fps_fast", "stereo_ms", "fallback", "dataset"]
BENCH_FRAMES, BENCH_WARM = 60, 2  # the fusion stage's timed frames; warm-up frames
BENCH_RENDERS = 6  # a warm-up and five timed renders (splat, raycast)


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
        ("raycast", "raycast"): BENCH_RENDERS, ("raycast plain", "raycast"): 0,
        ("raycast", "superblock_bits"): BENCH_RENDERS, ("raycast plain", "superblock_bits"): 0,
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


# ----------------------------------------------------------------------
# phase 16: the captured steps (CUDA graphs of the per-frame steps, the
# pose in device memory)
# ----------------------------------------------------------------------
GRAPH_REPS = 3  # timed runs of each side (median)
GRAPH_WARM = 6  # frames before the timed ones: every (cadence, slot) key captured
GRAPH_PROFILED = 12  # frames 6-17 profiled on each side (four allocation cycles)


IO_CALLS = 5  # timed calls of each side of a phase-16h step
IO_PROFILED = 3  # profiled calls of each side


def timed_call_ms(fn, calls: int = IO_CALLS) -> float:
    """ms a call of fn over `calls` calls (CUDA events, one sync), after
    a sync."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def io_step(label: str, sides: dict, same, smi) -> dict:
    """One phase-16h step: sides {"eager": fn, "captured": fn}, each
    called twice first (the captured side captures both staging slots),
    then timed; same(a, b) holds the two sides' outputs equal.  Returns ms
    a call and graph replays a call; the profiles come later
    (io_profiles)."""
    from disinfect_slam_tpu_torch.utils.graphs import REPLAYS

    outs = {name: [fn(), fn()][-1] for name, fn in sides.items()}
    if not same(outs["eager"], outs["captured"]):
        raise AssertionError(f"captured {label} differs from the eager one")
    ms, replays = {}, 0.0
    for name, fn in sides.items():
        before = REPLAYS["graph"]
        ms[name] = timed_call_ms(fn)
        if name == "captured":
            replays = (REPLAYS["graph"] - before) / IO_CALLS
    if not same(sides["eager"](), sides["captured"]()):
        raise AssertionError(f"captured {label} differs from the eager one after its replays")
    log(f"[chip_smoke] captured {label}: ms a call eager {ms['eager']:.3f}, captured "
        f"{ms['captured']:.3f}; graph replays {replays:.2f} a call; outputs bit-equal ({smi})")
    return {"ms": ms, "graph_replays_per_call": replays}


def io_steps(grid, dev, smi) -> tuple:
    """Phase 16h (see the docstring) -> (report, the steps' sides for
    io_profiles)."""
    from disinfect_slam_tpu_torch.io.png_io import read_image
    from disinfect_slam_tpu_torch.io.zed_calib import rectifier_from_factory_conf
    from disinfect_slam_tpu_torch.models import segmentation as seg
    from disinfect_slam_tpu_torch.ops import mesh as tmesh
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.ops.image_ops import StereoRectifier
    from disinfect_slam_tpu_torch.ops.stereo import StereoDepthEstimator
    from tests.torch_cases import ZED_FACTORY_CONF

    out, profiled = {}, {}
    left, right = (t.cpu().numpy() for t in stereo_bench_pair(dev))
    fx = 525.1
    for method in ("flat", "pyramid"):
        est = {c: StereoDepthEstimator(fx, 0.12, max_disp=64, method=method, device=dev,
                                       capture=c) for c in (False, True)}
        sides = {"eager": lambda e=est[False]: e.depth_device(left, right),
                 "captured": lambda e=est[True]: e.depth_device(left, right)}
        out[f"stereo_{method}"] = io_step(f"stereo {method} (640x480, 64 disparities, host "
                                          f"pair)", sides, torch.equal, smi)
        profiled[f"stereo_{method}"] = sides
    conf = os.path.join(str(build.BUILD_DIR), "SN12345_16h.conf")
    with open(conf, "w") as f:
        f.write(ZED_FACTORY_CONF)
    rect = rectifier_from_factory_conf(conf, "VGA", device=dev)
    rect_eager = StereoRectifier(rect.maps, device=dev, capture=False)
    rng = np.random.default_rng(16)
    h, w = rect.maps.left_x.shape
    pair = (rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (h, w)).astype(np.float32))
    sides = {"eager": lambda: rect_eager.rectify(*pair), "captured": lambda: rect.rectify(*pair)}
    out["remap"] = io_step(f"remap ({w}x{h}, RGB + gray, host in and out)", sides,
                           lambda a, b: all(np.array_equal(x, y) for x, y in zip(a, b)), smi)
    profiled["remap"] = sides
    rgb = read_image(os.path.join(DATASET, "0_rgb.png"))
    model = seg.load_model("unet", device=dev)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # both sides on the same algorithms
    try:
        engines = {c: seg.InferenceEngine(model, capture=c) for c in (False, True)}
        sides = {"eager": lambda: engines[False].infer_one(rgb),
                 "captured": lambda: engines[True].infer_one(rgb)}
        out["seg"] = io_step("infer_one (UNet, 480x640 u8, maps to the host)", sides,
                             lambda a, b: all(np.array_equal(x, y) for x, y in zip(a, b)), smi)
    finally:
        torch.backends.cudnn.deterministic = prev
    profiled["seg"] = sides
    with open(EXPORT_FINGERPRINT) as f:
        export_ref = json.load(f)
    vol = grid.volume
    mesh = {}
    for transfer in ("f32", "q16"):
        def call(t=transfer, **kw):
            return tmesh.extract_mesh_chunked(vol, transfer=t, **kw)

        wall = {}
        t0 = time.perf_counter()
        eager = call(capture=False)
        wall["eager"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with tmesh.counting_clips() as clipped:
            first = call()
        wall["captured_first"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        kept = tmesh.MeshGraphs(dev)
        call(graphs=kept)
        replays_first = kept.graphs.replays  # the chunks after the first
        t0 = time.perf_counter()
        again = call(graphs=kept)
        wall["captured_repeat"] = time.perf_counter() - t0
        replays_repeat = kept.graphs.replays - replays_first  # every chunk, the candidates
        if not (np.array_equal(first, eager) and np.array_equal(again, eager)):
            raise AssertionError(f"captured mesh {transfer} differs from the eager one")
        fp = tmesh.mesh_fingerprint(first, clipped[0])
        check_mesh_fingerprint(fp, export_ref["mesh"][transfer],
                               f"captured mesh {transfer} (first call and repeat: equal)")
        mesh[transfer] = {"wall_s": wall, "peak_bytes": peak, "replays_first_call": replays_first,
                          "replays_repeat": replays_repeat, **fp}
        log(f"[chip_smoke] captured mesh {transfer}: wall s eager {wall['eager']:.3f}, captured "
            f"first call {wall['captured_first']:.3f} (the candidates and one chunk eager, two "
            f"captures, {replays_first} replays), repeat on kept graphs "
            f"{wall['captured_repeat']:.3f} ({replays_repeat} replays); peak "
            f"{peak / 2**20:.0f} MiB above the volume; {first.shape[0]} triangles, equal on "
            f"every call ({smi})")
        if transfer == "f32":
            profiled["mesh_f32"] = {"eager": lambda c=call: c(capture=False),
                                    "captured": lambda c=call, k=kept: c(graphs=k)}
        else:
            del kept
        torch.cuda.empty_cache()
    out["mesh"] = mesh
    return out, profiled


def io_profiles(profiled: dict) -> dict:
    """Each phase-16h step's sides under the profiler: IO_PROFILED calls
    (one for the mesh) -> step_profile's numbers a call."""
    res = {}
    for name, sides in profiled.items():
        n = 1 if name.startswith("mesh") else IO_PROFILED
        for side, fn in sides.items():
            res[f"{name}_{side}"] = p = step_profile(lambda fn=fn: [fn() for _ in range(n)], n)
            log_profile(f"{side} {name} (a call)", p)
    return res


def smi_clocks() -> str:
    """The card's SM clock and power draw now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def bench_grid(offline, dev, capture: bool):
    """A TSDFGrid at the offline app's bench preset, captured or eager ->
    (grid, max_depth)."""
    from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

    cfg, voxel, trunc, max_depth = offline.make_config(offline.parse_args(
        ["--logdir", DATASET, "--preset", "bench", "--sampler", "pallas_fused"]))
    return TSDFGrid(voxel, trunc, cfg=cfg, device=dev, capture=capture), max_depth


def replay_frames() -> list:
    """Every frame of the bench replay, decoded once: (rgb, depth, ht, lt,
    cam_T_world) host arrays."""
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay

    return [(fr.rgb, fr.depth, fr.ht, fr.lt, fr.cam_T_world)
            for fr in LoggedReplay(DATASET, 5000.0)]


def timed_replay(offline, dev, frames, intrinsics, capture: bool):
    """All frames through a fresh bench grid, the upload included; CUDA
    events around frames GRAPH_WARM.. -> (grid, ms/frame of those)."""
    grid, max_depth = bench_grid(offline, dev, capture)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i, (rgb, depth, ht, lt, pose) in enumerate(frames):
        if i == GRAPH_WARM:
            torch.cuda.synchronize()
            start.record()
        grid.integrate(rgb, depth, ht, lt, max_depth, intrinsics, pose)
    end.record()
    torch.cuda.synchronize()
    return grid, start.elapsed_time(end) / (len(frames) - GRAPH_WARM)


def replay_profile(offline, dev, frames, intrinsics, capture: bool) -> dict:
    """Frames GRAPH_WARM.. GRAPH_WARM + GRAPH_PROFILED - 1 of a fresh bench
    grid under torch.profiler (step_profile)."""
    grid, max_depth = bench_grid(offline, dev, capture)
    go = lambda part: [grid.integrate(*f[:4], max_depth, intrinsics, f[4])  # noqa: E731
                       for f in part]
    go(frames[:GRAPH_WARM])
    part = frames[GRAPH_WARM:GRAPH_WARM + GRAPH_PROFILED]
    res = step_profile(lambda: go(part), len(part))
    del grid
    torch.cuda.empty_cache()
    return res


def captured_fusion(offline, dev, frames, intrinsics, ref, fuse_kernel, smi):
    """Phase 16a: the bench replay eager, then captured, GRAPH_REPS times
    each in turns; every volume array equal, the captured volume within the
    fingerprint; ms/frame (CUDA events, median), launches and graph
    replays a frame, the clocks.  Returns (report, the last captured
    grid)."""
    from disinfect_slam_tpu_torch.utils.graphs import REPLAYS

    runs = {"eager": [], "captured": []}
    counts = {}
    grid = None
    for rep in range(GRAPH_REPS):
        eager, ms = timed_replay(offline, dev, frames, intrinsics, False)
        runs["eager"].append(ms)
        launches, replays = fuse_kernel.fuse_rows.launches, REPLAYS["graph"]
        del grid
        torch.cuda.empty_cache()
        grid, ms = timed_replay(offline, dev, frames, intrinsics, True)
        runs["captured"].append(ms)
        counts = {"fuse_rows_per_frame": (fuse_kernel.fuse_rows.launches - launches) / len(frames),
                  "graph_replays_per_frame": (REPLAYS["graph"] - replays) / len(frames),
                  "graph_replays": REPLAYS["graph"] - replays,
                  "captures": grid.graphs.captures}
        equal = volumes_equal(grid.volume, eager.volume)
        del eager
        torch.cuda.empty_cache()
        if not all(equal.values()):
            raise AssertionError(f"captured replay {rep}: the volume differs from the eager "
                                 f"one's: {equal}")
    fp = check_fingerprint(grid, int(grid.gather_valid().count), ref, "captured replay")
    med = {k: statistics.median(v) for k, v in runs.items()}
    clocks = smi_clocks()
    log(f"[chip_smoke] captured bench replay: ms/frame over frames {GRAPH_WARM}-"
        f"{len(frames) - 1} (CUDA events, upload included) eager {runs['eager']} -> median "
        f"{med['eager']:.3f}, captured {runs['captured']} -> median {med['captured']:.3f}; "
        f"every volume array equal; fuse_rows {counts['fuse_rows_per_frame']:.2f} a frame, "
        f"graph replays {counts['graph_replays_per_frame']:.2f} a frame, {counts['captures']} "
        f"captures; clocks.sm, power.draw: {clocks} ({smi})")
    return {"ms_per_frame": runs, "median_ms": med, "counts": counts, "fingerprint": fp,
            "clocks": clocks}, grid


def captured_online(dev, fuse_kernel, smi) -> dict:
    """Phase 16b: FusedOnlineStep with the UNet and with FastSeg over the
    first 30 frames, eager and captured: the volumes bit-equal, online_fps
    of each (bench.time_online, GRAPH_WARM frames of warm-up)."""
    from disinfect_slam_tpu_torch.apps.bench import time_online
    from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH
    from disinfect_slam_tpu_torch.io.config_reader import get_intrinsics, load_yaml
    from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
    from disinfect_slam_tpu_torch.io.png_io import read_image
    from disinfect_slam_tpu_torch.models import segmentation as seg
    from disinfect_slam_tpu_torch.systems.online_step import FusedOnlineStep

    intrinsics = get_intrinsics(load_yaml(os.path.join(DATASET, "cam.yaml")))
    frames = []
    for fid, pose in LoggedReplay(DATASET, 5000.0).entries[:ONLINE_FRAMES]:
        base = os.path.join(DATASET, str(fid))
        frames.append((read_image(base + "_rgb.png"),
                       read_image(base + "_depth.png", unchanged=True), pose))
    out = {}
    for arch in ("unet", "fast"):
        model = seg.load_model(arch, device=dev)
        steps, fps = {}, {}
        for name, capture in (("eager", False), ("captured", True)):
            steps[name] = FusedOnlineStep(BENCH, intrinsics, H, W, BENCH_MAX_DEPTH,
                                          seg_model=model, depth_factor=5000.0, device=dev,
                                          capture=capture)
            fps[name] = time_online(steps[name], frames, GRAPH_WARM)
        equal = volumes_equal(steps["captured"].volume, steps["eager"].volume)
        replays = steps["captured"].graphs.replays
        del steps, model
        torch.cuda.empty_cache()
        log(f"[chip_smoke] captured online step ({arch}): online_fps eager {fps['eager']:.3f}, "
            f"captured {fps['captured']:.3f} (frames {GRAPH_WARM}-{ONLINE_FRAMES - 1}); "
            f"{replays} graph replays; every volume array equal: {all(equal.values())} ({smi})")
        if not all(equal.values()):
            raise AssertionError(f"captured online step ({arch}) differs: {equal}")
        out[arch] = {"online_fps": fps, "graph_replays": replays}
    return out


def captured_render(grid, splat_kernel, intrinsics, poses, smi) -> dict:
    """Phase 16c: the splat render at frames 0-4's poses, 640x480, captured
    (TSDFGrid.ray_cast) against eager (splat_render_cuda) on the captured
    replay's volume: every image bit-equal; ms a render of each (CUDA
    events over the five, median of GRAPH_REPS passes, after a warm-up)."""
    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams

    cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), H, W)
    view = (intrinsics, H, W)
    views = poses[:5]
    sides = {
        "eager": lambda p: splat_kernel.splat_render_cuda(grid.volume, cam, SE3.from_matrix(p),
                                                          RENDER_MAX_DEPTH),
        "captured": lambda p: grid.ray_cast(RENDER_MAX_DEPTH, view, p, renderer="splat"),
    }
    images, ms = {}, {}
    for name, render in sides.items():
        images[name] = [render(p) for p in views]  # the warm-up (and the capture)
        passes = []
        for _ in range(GRAPH_REPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for p in views:
                render(p)
            end.record()
            torch.cuda.synchronize()
            passes.append(start.elapsed_time(end) / len(views))
        ms[name] = passes
    images["captured"] = [sides["captured"](p) for p in views]  # replays
    equal = all(torch.equal(a, b) for ra, rb in zip(images["eager"], images["captured"])
                for a, b in zip(ra[:4], rb[:4]))
    med = {k: statistics.median(v) for k, v in ms.items()}
    log(f"[chip_smoke] captured splat render at frames 0-4's poses: ms/render eager {ms['eager']} "
        f"-> {med['eager']:.3f}, captured {ms['captured']} -> {med['captured']:.3f}; every "
        f"image bit-equal: {equal} ({smi})")
    if not equal:
        raise AssertionError("the captured splat render differs from the eager one")
    return {"ms_per_render": ms, "median_ms": med}


def captured_system(offline, dev, frames, intrinsics, smi) -> dict:
    """Phase 16d: DISINFSystem at the bench preset integrating on its own
    thread (captures there: thread-local mode), 30 frames with their
    poses, against its eager twin: every volume array equal."""
    from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem

    cfg, voxel, trunc, max_depth = offline.make_config(offline.parse_args(
        ["--logdir", DATASET, "--preset", "bench", "--sampler", "pallas_fused"]))
    kw = dict(depth_factor=1.0, voxel_size=voxel, truncation=trunc, max_depth=max_depth,
              cfg=cfg, half_scale=False, device=dev)
    with DISINFSystem(intrinsics, **kw) as captured, DISINFSystem(intrinsics, **kw) as eager:
        eager.tsdf.tsdf.capture = False
        for i, (rgb, depth, _, _, pose) in enumerate(frames[:ONLINE_FRAMES]):
            for system in (captured, eager):
                system.feed_pose(33 * i, pose)
                system.feed_rgbd_frame(rgb, depth, 33 * i)
        for system in (captured, eager):
            system.tsdf.flush()
        grids = [s.tsdf.tsdf for s in (captured, eager)]
        equal = volumes_equal(grids[0].volume, grids[1].volume)
        res = {"graph_replays": grids[0].graphs.replays, "captures": grids[0].graphs.captures,
               "dropped": [s.tsdf.dropped_frames for s in (captured, eager)]}
    log(f"[chip_smoke] DISINFSystem on its own thread: {res['captures']} captures, "
        f"{res['graph_replays']} replays over {ONLINE_FRAMES} frames, dropped {res['dropped']}; "
        f"every volume array equal to the eager twin's: {all(equal.values())} ({smi})")
    if not all(equal.values()) or any(res["dropped"]) or not res["graph_replays"]:
        raise AssertionError(f"DISINFSystem captured on its thread: {res}, {equal}")
    torch.cuda.empty_cache()
    return res


def captured_recenter(offline, dev, frames, intrinsics, smi) -> dict:
    """Phase 16e: one recenter in the middle of a captured replay (frames
    0-29, the window moved 1 m along x at frame 15): the captured grid
    captures anew and still equals its eager twin in every array."""
    (captured, max_depth), (eager, _) = (bench_grid(offline, dev, c) for c in (True, False))
    grids = [captured, eager]
    captures = []
    for i, (rgb, depth, ht, lt, pose) in enumerate(frames[:ONLINE_FRAMES]):
        if i == ONLINE_FRAMES // 2:
            captures.append(grids[0].graphs.captures)
            cam_pos = np.linalg.inv(np.asarray(pose, np.float64))[:3, 3] + (1.0, 0.0, 0.0)
            moved = [g.recenter(cam_pos) for g in grids]
            if moved != [True, True]:
                raise AssertionError(f"the recenter did not move the window: {moved}")
        for g in grids:
            g.integrate(rgb, depth, ht, lt, max_depth, intrinsics, pose)
    captures.append(grids[0].graphs.captures)
    equal = volumes_equal(grids[0].volume, grids[1].volume)
    log(f"[chip_smoke] recenter at frame {ONLINE_FRAMES // 2} of a captured replay: captures "
        f"{captures[0]} before, {captures[1]} after; every volume array equal to the eager "
        f"twin's: {all(equal.values())} ({smi})")
    if not all(equal.values()) or captures[1] <= captures[0]:
        raise AssertionError(f"recentred captured replay: captures {captures}, {equal}")
    del grids, captured, eager
    torch.cuda.empty_cache()
    return {"captures": captures}


def timed_slam(dev, frames, scale, capture):
    """All frames through a fresh phase-8 DenseSLAM, CUDA events around
    frames SLAM_WARM.. -> (slam, [(cam_T_world, ok)] on the host, ms/frame,
    graph replays and K4 / K2 / icp_step launches of the run)."""
    from disinfect_slam_tpu_torch.ops.cuda import fuse_kernel, icp_kernel, splat_kernel
    from disinfect_slam_tpu_torch.utils.graphs import REPLAYS

    counters = lambda: (REPLAYS["graph"], splat_kernel.splat_zbuf_blocks.launches,  # noqa: E731
                        fuse_kernel.fuse_rows.launches, icp_kernel.icp_step.launches)
    before = counters()
    slam = new_slam(dev, scale, capture)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for i, (rgb, depth) in enumerate(frames):
        if i == SLAM_WARM:
            torch.cuda.synchronize()
            start.record()
        out.append(slam.process_frame(rgb, depth))
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (len(frames) - SLAM_WARM)
    counts = [a - b for a, b in zip(counters(), before)]
    return slam, [(p.cpu().numpy(), bool(ok)) for p, ok in out], ms, counts


def captured_slam(dev, frames, smi) -> dict:
    """Phase 16f: phase 8's DenseSLAM over the 60 frames, eager then
    captured, GRAPH_REPS - 1 times in turns at each track_res_scale: every
    pose, ok flag and volume array equal, and every pose bit-equal to the
    port's on the CPU (SLAM_PORT_POSES); ms/frame of each (CUDA events,
    frames SLAM_WARM-59, median), graph replays and K4 / K2 / icp_step
    launches a frame (icp_step once an ICP iteration: 19 a tracked frame
    and a loop verification), the clocks."""
    n = len(frames)
    out = {}
    for scale in (1, 2):
        runs = {"eager": [], "captured": []}
        counts = {}
        for rep in range(GRAPH_REPS - 1):
            sides = {}
            for name, capture in (("eager", False), ("captured", True)):
                slam, poses, ms, c = timed_slam(dev, frames, scale, capture)
                runs[name].append(ms)
                counts[name] = {"graph_replays_per_frame": c[0] / n, "k4_per_frame": c[1] / n,
                                "k2_per_frame": c[2] / n, "icp_step_per_frame": c[3] / n}
                # one icp_step launch an ICP iteration: 19 a tracked frame and a verification
                icp_want = sum(ICP_ITERS) * (n - 1 + slam.lc.verifications)
                if c[3] != icp_want:
                    raise AssertionError(f"{name} SLAM (scale {scale}): icp_step launched "
                                         f"{c[3]} times, expected {icp_want}")
                sides[name] = (slam, poses)
            (es, ep), (cs, cp) = sides["eager"], sides["captured"]
            check_port_poses([p for p, _ in cp], [ok for _, ok in cp], scale,
                             f"captured SLAM track_res_scale={scale} run {rep}")
            same = all(np.array_equal(a[0], b[0]) and a[1] == b[1] for a, b in zip(ep, cp))
            equal = volumes_equal(cs.volume, es.volume)
            lost = [cs.lost_count, es.lost_count]
            del sides, es, cs
            torch.cuda.empty_cache()
            if not same or not all(equal.values()) or any(lost):
                raise AssertionError(f"captured SLAM (scale {scale}, run {rep}): poses and ok "
                                     f"flags equal {same}, volume {equal}, lost {lost}")
        med = {k: statistics.median(v) for k, v in runs.items()}
        clocks = smi_clocks()
        log(f"[chip_smoke] captured SLAM, track_res_scale={scale}: ms/frame over frames "
            f"{SLAM_WARM}-{n - 1} (CUDA events) eager {runs['eager']} -> {med['eager']:.3f}, "
            f"captured {runs['captured']} -> {med['captured']:.3f}; every pose, ok flag and "
            f"volume array equal; captured a frame: {counts['captured']} (eager "
            f"{counts['eager']}); clocks.sm, power.draw: {clocks} ({smi})")
        out[scale] = {"ms_per_frame": runs, "median_ms": med, "counts": counts,
                      "clocks": clocks}
    return out


def timed_shards(frames, intrinsics, mesh, capture):
    """The bench preset's DistributedTSDF over `mesh`, every frame with
    one sync at the end, CUDA events around frames GRAPH_WARM.. -> (dist,
    ms/frame, the cuts of every frame and shard, graph replays a frame)."""
    from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput
    from disinfect_slam_tpu_torch.parallel.sharding import DistributedTSDF
    from disinfect_slam_tpu_torch.utils.graphs import REPLAYS

    dist = DistributedTSDF(BENCH, mesh, capture=capture)
    replays = REPLAYS["graph"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cuts = []
    for i, (rgb, depth, ht, lt, pose) in enumerate(frames):
        if i == GRAPH_WARM:
            torch.cuda.synchronize()
            start.record()
        dist.integrate(FrameInput(rgb, depth, ht, lt), intrinsics, pose, BENCH_MAX_DEPTH,
                       cuts=cuts)
    end.record()
    torch.cuda.synchronize()
    cut_list = [[None if t is None else int(t) for t in c] for c in cuts]
    return (dist, start.elapsed_time(end) / (len(frames) - GRAPH_WARM), cut_list,
            (REPLAYS["graph"] - replays) / len(frames))


def captured_shards(dev, frames, intrinsics, smi) -> dict:
    """Phase 16g: the sharded step at the bench preset over [cuda:0] * 4
    and [cuda:0], eager then captured, GRAPH_REPS - 1 times in turns: every
    block and every frame's cuts equal; ms/frame of each (CUDA events,
    frames GRAPH_WARM-59, median), graph replays a frame."""
    out = {}
    for shards in (DIST_SHARDS, 1):
        runs = {"eager": [], "captured": []}
        replays = 0.0
        for rep in range(GRAPH_REPS - 1):
            sides = {}
            for name, capture in (("eager", False), ("captured", True)):
                dist, ms, cuts, rp = timed_shards(frames, intrinsics, [dev] * shards, capture)
                runs[name].append(ms)
                sides[name] = (dist, cuts)
                if capture:
                    replays = rp
            (ed, ec), (cd, cc) = sides["eager"], sides["captured"]
            equal = same_rows(dist_rows(cd), dist_rows(ed)) and ec == cc
            del sides, ed, cd
            torch.cuda.empty_cache()
            if not equal:
                raise AssertionError(f"captured sharded step ({shards} shards, run {rep}) "
                                     "differs from the eager one")
        med = {k: statistics.median(v) for k, v in runs.items()}
        log(f"[chip_smoke] captured sharded step, {shards} shard(s) on one card: ms/frame over "
            f"frames {GRAPH_WARM}-{len(frames) - 1} (CUDA events, staging included) eager "
            f"{runs['eager']} -> {med['eager']:.3f}, captured {runs['captured']} -> "
            f"{med['captured']:.3f}; every block and cut equal; graph replays {replays:.2f} a "
            f"frame; clocks.sm, power.draw: {smi_clocks()} ({smi})")
        out[shards] = {"ms_per_frame": runs, "median_ms": med,
                       "graph_replays_per_frame": replays}
    return out


def step_profile(run_frames, n_frames) -> dict:
    """run_frames() under torch.profiler, n_frames frames: device kernels
    and their time a frame, the host's kernel launch calls and graph
    launches a frame, the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frames()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    launch_calls = sum(1 for e in events if e.device_type.name == "CPU"
                       and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                                      "cuLaunchKernelEx"))
    graph_calls = sum(1 for e in events if e.device_type.name == "CPU"
                      and e.name in ("cudaGraphLaunch", "cuGraphLaunch"))
    n = n_frames
    return {"frames": n, "wall_ms_per_frame": wall_ms / n, "device_ms_per_frame": device_ms / n,
            "kernels_per_frame": len(kernels) / n, "launch_calls_per_frame": launch_calls / n,
            "graph_launches_per_frame": graph_calls / n,
            "idle_share": 1 - device_ms / wall_ms if device_ms else None}


def slam_frames_profile(slam, frames) -> dict:
    """frames[:SPLIT_FIRST] through a fresh DenseSLAM, then the rest under
    the profiler (step_profile; frame 50 a keyframe)."""
    for rgb, depth in frames[:SPLIT_FIRST]:
        slam.process_frame(rgb, depth)
    part = frames[SPLIT_FIRST:]

    def run():
        for rgb, depth in part:
            slam.process_frame(rgb, depth)

    return step_profile(run, len(part))


def slam_step_profile(dev, frames, capture) -> dict:
    """Frames SPLIT_FIRST-59 of a fresh phase-8 DenseSLAM (scale 1) under
    the profiler."""
    slam = new_slam(dev, 1, capture)
    res = slam_frames_profile(slam, frames)
    del slam
    torch.cuda.empty_cache()
    return res


def shards_step_profile(dev, frames, intrinsics, shards, capture) -> dict:
    """Frames GRAPH_WARM.. GRAPH_WARM + GRAPH_PROFILED - 1 of a fresh
    sharded volume at the bench preset under the profiler."""
    from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput
    from disinfect_slam_tpu_torch.parallel.sharding import DistributedTSDF

    dist = DistributedTSDF(BENCH, [dev] * shards, capture=capture)
    go = lambda part: [dist.integrate(FrameInput(*f[:4]), intrinsics, f[4],  # noqa: E731
                                      BENCH_MAX_DEPTH) for f in part]
    go(frames[:GRAPH_WARM])
    part = frames[GRAPH_WARM:GRAPH_WARM + GRAPH_PROFILED]
    res = step_profile(lambda: go(part), len(part))
    del dist
    torch.cuda.empty_cache()
    return res


def log_profile(label: str, p: dict) -> None:
    log(f"[chip_smoke] {label} profiled: wall {p['wall_ms_per_frame']:.3f} ms/frame, device "
        f"{p['device_ms_per_frame']:.3f} ms/frame in {p['kernels_per_frame']:.1f} kernels; host "
        f"launch calls {p['launch_calls_per_frame']:.1f} and graph launches "
        f"{p['graph_launches_per_frame']:.1f} a frame; idle share "
        + (f"{p['idle_share']:.3f}" if p["idle_share"] is not None else "not measured"))


def captured_steps(offline, fuse_kernel, splat_kernel, intrinsics, poses, ref, dev, smi) -> dict:
    """Phase 16 (see the docstring); returns the report entry."""
    frames = replay_frames()
    fusion, grid = captured_fusion(offline, dev, frames, intrinsics, ref, fuse_kernel, smi)
    render = captured_render(grid, splat_kernel, intrinsics, poses, smi)
    io, io_sides = io_steps(grid, dev, smi)
    del grid
    torch.cuda.empty_cache()
    online = captured_online(dev, fuse_kernel, smi)
    system = captured_system(offline, dev, frames, intrinsics, smi)
    recenter = captured_recenter(offline, dev, frames, intrinsics, smi)
    slam_frames_ = slam_frames()
    slam = captured_slam(dev, slam_frames_, smi)
    shards = captured_shards(dev, frames, intrinsics, smi)
    # the profiles last: a profiler trace leaves the host slower afterwards
    last = GRAPH_WARM + GRAPH_PROFILED - 1
    profile = {}
    for name, capture in (("eager", False), ("captured", True)):
        profile[name] = replay_profile(offline, dev, frames, intrinsics, capture)
        log_profile(f"{name} bench replay (frames {GRAPH_WARM}-{last})", profile[name])
        profile[f"slam_{name}"] = slam_step_profile(dev, slam_frames_, capture)
        log_profile(f"{name} SLAM step (frames {SPLIT_FIRST}-59, scale 1)",
                    profile[f"slam_{name}"])
        for n in (DIST_SHARDS, 1):
            profile[f"shards_{n}_{name}"] = shards_step_profile(dev, frames, intrinsics, n,
                                                                capture)
            log_profile(f"{name} sharded step, {n} shard(s) (frames {GRAPH_WARM}-{last})",
                        profile[f"shards_{n}_{name}"])
    profile["io"] = io_profiles(io_sides)
    del io_sides
    torch.cuda.empty_cache()
    return {"fusion": fusion, "render": render, "online": online, "system": system,
            "recenter": recenter, "slam": slam, "shards": shards, "io": io, "profile": profile}


def probe_timer(fn, name, nbytes=0) -> float:
    """The probes' timer: kernel_ms, with the bound of nbytes as its
    floor."""
    return kernel_ms(fn, name, floor_ms=bound(nbytes, 0)["bound_ms"])


def probe_launches(splat_probe, feature_probe, sp) -> list:
    """The probe wrappers that count their launches."""
    return [splat_probe.zbuf_atomic, splat_probe.zbuf_tile, splat_probe.splat_zbuf_given,
            feature_probe.launch, sp.sample_patch, sp.sample_direct, sp.fuse_stage,
            sp.sample_modes]


def probes(dev, splat_probe, feature_probe, sp, fuse_kernel) -> dict:
    """Phase 7: the probes, each kernel timed by its device time: K4's
    instruments (splat_probe, on phase 2's block rows at 640x480 and
    1080p: the per-voxel atomics against the tile, the tile-shape sweep),
    P8 and P9 (splat_probe.run_given: the Pallas z-buffer from the
    scripts' own inputs, every function bit-equal to its plain version on
    the card and to probe_splat2.py main's numpy z-buffer), P7 (feature_probe: the
    Pallas probe's eight functions and the port's primitives as one
    launch, every role bit-equal to the plain version on the card and
    every check passed; its device time beside its bound and floors, and
    its plain torch version's), P4 and P5 (sample_probe.run_modes: the
    Pallas sampler's modes on the scripts' own inputs, every mode
    bit-equal to its plain version on the card), and P1-P3 and P6 with
    the port's instruments of K1 and K2 (sample_probe.run: K1's direct
    modes, the window selections with P3's, what each window stages
    beside K1's direct time, and fuse_rows' stages, each against its
    plain version, at K1's and fuse_rows' phase 2 rows)."""
    t0 = time.perf_counter()
    cases = {"640x480": make_splat_blocks(3, H, W, dev),
             "1080p": make_splat_blocks(4, 1080, 1920, dev)}
    probe = splat_probe.run(dev, probe_timer, cases)
    del cases
    torch.cuda.empty_cache()
    ab = probe["k4_ab"]
    log(f"[chip_smoke] K4's A/B (block rows, S={ab['rows']}, count {ab['count']}, "
        f"{ab['image'][1]}x{ab['image'][0]}): per-voxel atomics {ab['atomic_ms']:.4f} ms, "
        f"tile kernel {ab['tile_ms']:.4f} ms, both bit-equal to the plain scatter-min; tile "
        f"rows on the tile / atomic branch {ab['tile_branches']}")
    for r in probe["k4_tiles"]:
        log(f"[chip_smoke] K4's tile sweep {r['tile'][0]}x{r['tile'][1]}: {r['registers']} "
            f"registers, {r['local_bytes']} local (spill) bytes, {r['shared_bytes']} shared "
            f"bytes; " + "; ".join(f"{k} rows {r[k]['ms']:.4f} ms (branches "
                                   f"{r[k]['branches']})" for k in ("640x480", "1080p"))
            + "; launches and agrees")

    given = splat_probe.run_given(dev, probe_timer)
    for name, g in given.items():
        g.update(bound(g["bytes"], 0))
        head = g["functions"][g["head"]]
        log(f"[chip_smoke] probe {name} (S={g['blocks']}, {g['footprint_pixels']} footprint "
            f"pixels, {g['numpy_zbuf_set']} z-buffer pixels set): "
            + "; ".join(f"{f} {r['ms']:.4f} ms (mode {r['kernel_mode']}, "
                        f"{r['pixels_set']} set)" for f, r in g["functions"].items())
            + f"; every function bit-equal to its plain version, "
            f"{'/'.join(splat_probe.NUMPY_EQUAL)} to main's numpy z-buffer, those that merge "
            f"nothing to the fill; {g['head']} {head['ms']:.4f} ms against a bound of "
            f"{g['bound_ms']:.4f} ms ({g['bytes'] / 1e6:.2f} MB), "
            f"{g['bound_ms'] / head['ms']:.1%} of it; plain {g['plain_ms']:.4f} ms; "
            f"scatter_reduce amin {g['library_ms']:.4f} ms ({card_name_and_power()})")
    probe["given"] = given
    launches = feature_probe.launch.launches
    checks = feature_probe.run(dev)
    if feature_probe.launch.launches != launches + 1:
        raise AssertionError("probe P7: run launched "
                             f"{feature_probe.launch.launches - launches} kernels, not one")
    kernel_fn, plain_fn, nbytes, ops = feature_probe.timed_pair(dev)
    p7 = {"checks": checks, **bound(nbytes, ops), **P7_FLOORS_MS,
          "max_abs_err": max(r["max_abs_err"] for r in checks.values())}
    p7["ms"] = kernel_ms(kernel_fn, "feature_", floor_ms=p7["bound_ms"])
    p7["plain_ms"] = cuda_time_ms(plain_fn)
    probe["p7"] = p7
    log(f"[chip_smoke] probe P7: one launch, every role bit-equal to the plain version on the "
        f"card and every check passed {checks}; {p7['ms']:.4f} ms of device time, bound "
        f"{p7['bound_ms']:.4f} ms by {p7['bound_by']} ({p7['bytes'] / 1e6:.2f} MB, "
        f"{p7['ops'] / 1e6:.1f} M float32 operations), {p7['bound_ms'] / p7['ms']:.1%} of it; "
        f"issue floor {p7['issue_floor_ms']:.4f} ms, order floor {p7['order_floor_ms']:.4f} ms; "
        f"the torch version {p7['plain_ms']:.4f} ms ({card_name_and_power()})")

    modes = sp.run_modes(dev, probe_timer)
    for name, m in modes.items():
        for r in m["functions"].values():
            r.update(bound(r["bytes"], 0))
        head = m["functions"][m["head"]]
        log(f"[chip_smoke] probe {name} ({m['rows']} rows, {m['rows_computed']} computed): "
            + "; ".join(f"{k} {r['ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB, bound "
                        f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%})"
                        for k, r in m["functions"].items())
            + f"; every mode bit-equal to its plain version; {m['head']} {head['ms']:.4f} ms; "
            f"plain {m['plain_ms']:.4f} ms; the index_select gather {m['library_ms']:.4f} ms "
            f"({card_name_and_power()})")
    probe["modes"] = modes

    img, u, v = make_frame(np.random.default_rng(7), H, W, dev)
    count = torch.tensor(COUNT, dtype=torch.int32, device=dev)
    fimg, block_pos, pool_idx, geometry = block_rows(1, H, W, False, dev)
    pool = make_pool(dev, 1)
    consts = dict(CONSTS, **geometry)
    res = sp.run(dev, probe_timer, (img, u, v, count),
                 (fimg, block_pos, pool_idx, count, pool, consts),
                 fuse_kernel.fuse_rows)
    labels = {"k1_direct": "K1's split", "patch": "probe patch", "k2_stages": "K2's stages"}
    for group in ("k1_direct", "patch", "k2_stages"):
        for r in res[group]:
            if "bytes" in r:
                r.update(bound(r["bytes"], 0))
            log(f"[chip_smoke] {labels[group]} {r.get('mode', r.get('stage'))}: {r['ms']:.4f} ms"
                + (f", bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB), "
                   f"{r['bound_ms'] / r['ms']:.1%} of it" if "bound_ms" in r else "")
                + (f"; skipped {r['skipped_voxels']} voxels in {r['skipped_rows']} rows"
                   if "skipped_voxels" in r else "")
                + (f"; voxels let through {r['voxels_through']}"
                   if "voxels_through" in r else ""))
    k1 = next(r for r in res["k1_direct"] if r["mode"] == "full")
    for ph, pw in sp.PATCH_SHAPES:
        st = next(r for r in res["patch"] if r["mode"].startswith(f"patch {ph}x{pw}"))["staging"]
        log(f"[chip_smoke] probe patch {ph}x{pw} staging: {st['staged_bytes'] / 1e6:.1f} MB "
            f"in {st['turns']} ring turns of {st['slot_bytes']} B slots (whole windows: "
            f"{st['window_bytes'] / 1e6:.1f} MB); median box {st['box_median_px']} px, largest "
            f"{st['box_largest'][0]}x{st['box_largest'][1]}; {st['rows_in_strips']} rows in "
            f"strips, {st['empty_rows']} empty; K1's direct body on the same rows "
            f"{k1['ms']:.4f} ms ({card_name_and_power()})")
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
    p3 = sample["patch"][-1]
    direct = pick("k1_direct", "mode", "full")
    stage = pick("k2_stages", "stage", "ring")
    entry = lambda name, source, replaces, r, plain, mode, n, err: {  # noqa: E731
        "name": name, "route": "cuda", "source": src + source, "replaces": replaces,
        "launches": n, "max_abs_err": err, "ms": r["ms"], "plain_ms": plain,
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "mode": mode}
    p7 = probe["p7"]
    given, modes = probe["given"], probe["modes"]
    p8, p9 = given["P8"], given["P9"]
    p4, p5 = modes["P4"], modes["P5"]
    p4_head, p5_head = p4["functions"][p4["head"]], p5["functions"][p5["head"]]
    given_err = max(r["max_abs_err"] for g in given.values() for r in g["functions"].values())
    modes_err = max(r["max_abs_err"] for m in modes.values() for r in m["functions"].values())
    return [
        entry("probe sample_patch_kernel (P1/P2/P6)", "sample_probe.cu",
              "scripts/probe_sample2.py:132", patch, sample["plain_ms"]["patch"], patch["mode"],
              launches["sample_patch"], worst(sample["patch"][:-1])),
        entry("probe sample_patch_kernel (P3)", "sample_probe.cu", "scripts/probe_sample4.py:132",
              p3, sample["plain_ms"]["patch"], p3["mode"], launches["sample_patch"],
              p3["max_abs_err"]),
        {**entry("probe sample_modes_kernel (P4/P5)", "sample_probe.cu",
                 "scripts/probe_sample_overhead.py:131; scripts/probe_kernel_stages.py:187,216",
                 p4_head, p4["plain_ms"], f"P4 {p4['head']} at V = {p4['rows']}",
                 launches["sample_modes"], modes_err),
         "library_ms": p4["library_ms"],
         "ms_p5": p5_head["ms"], "bound_ms_p5": p5_head["bound_ms"], "plain_ms_p5": p5["plain_ms"],
         "library_ms_p5": p5["library_ms"], "mode_p5": f"P5 {p5['head']} at count "
                                                       f"{p5['rows_computed']}"},
        entry("probe sample_direct_kernel (K1's split)", "sample_probe.cu",
              "none: the port's own instrument of K1 (disinfect_slam_tpu/ops/pallas/"
              "sample_kernel.py:359)", direct, sample["plain_ms"]["direct"], direct["mode"],
              launches["sample_direct"], worst(sample["k1_direct"])),
        entry("probe fuse_rows_kernel stages (K2's stages)", "fuse_rows.cuh",
              "none: the port's own instrument of K2 (disinfect_slam_tpu/ops/pallas/"
              "fuse_kernel.py:262)", stage, sample["plain_ms"]["fuse_stage"], stage["stage"],
              launches["fuse_stage"], worst(sample["k2_stages"])),
        {"name": "probe feature kernels (P7)", "route": "cuda", "source": src + "feature_probe.cu",
         "replaces": "scripts/probe_mosaic_features.py:39,57,76,91,104,116,128,139",
         "launches": launches["launch"],
         "max_abs_err": p7["max_abs_err"], "ms": p7["ms"], "plain_ms": p7["plain_ms"],
         "bound_ms": p7["bound_ms"], "bound_by": p7["bound_by"], "library_ms": None},
        {"name": "probe splat_zbuf_given_kernel (P8/P9)", "route": "cuda",
         "source": src + "splat_probe.cu",
         "replaces": "scripts/probe_splat2.py:91,121,191; scripts/probe_splat2b.py:80",
         "launches": launches["splat_zbuf_given"], "max_abs_err": given_err,
         "ms": p8["functions"][p8["head"]]["ms"], "plain_ms": p8["plain_ms"],
         "bound_ms": p8["bound_ms"], "bound_by": p8["bound_by"], "library_ms": p8["library_ms"],
         "mode": f"P8 {p8['head']} at S = {p8['blocks']}",
         "ms_p9": p9["functions"][p9["head"]]["ms"], "bound_ms_p9": p9["bound_ms"],
         "plain_ms_p9": p9["plain_ms"], "library_ms_p9": p9["library_ms"]},
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
    phase_wall("1", t0)

    # phase 2: kernels against their plain versions at the slice's shapes
    # (their times come in phase 7: a profiler trace would slow what follows)
    t2 = time.perf_counter()
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
    phase_wall("2", t2)

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
    t3 = time.perf_counter()
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
    phase_wall("3", t3)

    # phase 4: the two-stage path
    t4 = time.perf_counter()
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
    phase_wall("4", t4)

    # phase 5: the render slice on the last fused volume
    t5 = time.perf_counter()
    intrinsics = get_intrinsics(load_yaml(os.path.join(DATASET, "cam.yaml")))
    poses = [pose for _, pose in LoggedReplay(DATASET, 5000.0).entries]
    render, splat_launches, render_err = render_views(
        grid, render_fast, splat_kernel, intrinsics, poses, ref)
    log(f"[chip_smoke] phase 5: render slice ok; splat {render['splat_ms']:.3f} "
        f"ms/render, raycast {render['raycast']['captured_ms']:.3f} ms/render captured, "
        f"{render['raycast']['eager_ms']:.3f} eager, its plain version "
        f"{render['raycast']['plain_ms']:.1f} ms ({smi}) "
        f"({time.perf_counter() - t_start:.1f} s)")
    # fuse_rows on a real frame's visible set of the fused volume
    fuse_real = check_fuse_real_frame(fuse_kernel, grid, 30, dev)
    torch.cuda.empty_cache()
    phase_wall("5", t5)

    # phase 6: the online slice, segmentation feeding fuse_rows
    t6 = time.perf_counter()
    online = online_slice(fuse_kernel, sample_kernel, dev, smi,
                          os.path.join(str(build.BUILD_DIR), "online_render"))
    log(f"[chip_smoke] phase 6: online slice ok; online_fps {online['online_fps']:.3f}, "
        f"online_fps_fast {online['online_fps_fast']:.3f}, seg_ms "
        f"{online['seg']['unet']['seg_ms']:.3f} (UNet) ({smi}) "
        f"({time.perf_counter() - t6:.1f} s added, {time.perf_counter() - t_start:.1f} s)")
    phase_wall("6", t6)

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
    phase_wall("6b", t6b)

    # phase 9: the served map on phase 3's volume
    t9 = time.perf_counter()
    served = served_map_slice(offline, grid, fuse_kernel, splat_kernel, ref, fused_ms, smi, dev)
    raycast_vol = grid.volume  # phase 7 times the raycast kernel on it
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
    phase_wall("9", t9)

    # phase 8: the tracking slice (pose-free dense SLAM)
    t8 = time.perf_counter()
    slam, slam_vol, slam_pose = slam_slice(fuse_kernel, splat_kernel, dev, smi)
    torch.cuda.empty_cache()
    log(f"[chip_smoke] phase 8: tracking slice ok; slam ms/frame "
        f"{slam['timing'][1]['ms_per_frame']:.3f} at track_res_scale 1, "
        f"{slam['timing'][2]['ms_per_frame']:.3f} at 2 ({smi}) "
        f"({time.perf_counter() - t8:.1f} s added, {time.perf_counter() - t_start:.1f} s)")
    phase_wall("8", t8)

    # phase 10: training the seg net, the sharded volume, the host library
    t10 = time.perf_counter()
    p10 = train_dist_host(fuse_kernel, splat_kernel, intrinsics, poses, fused_ms, smi)
    dist = p10["dist"]
    log(f"[chip_smoke] phase 10: training, sharded volume and host library ok; UNet step "
        f"{p10['train']['unet']['step_ms_median']:.2f} ms eager, "
        f"{p10['train']['unet']['captured_step_ms_median']:.2f} captured, FastSeg "
        f"{p10['train']['fast']['step_ms_median']:.2f} / "
        f"{p10['train']['fast']['captured_step_ms_median']:.2f} ms at {TRAIN_H}x{TRAIN_W} batch "
        f"{TRAIN_BATCH}; train_seg {TRAIN_APP_STEPS} steps {p10['train_app']['wall_s']:.1f} s, "
        f"IoU {p10['train_app']['iou']}; sharded replay "
        f"{dist[f'shards_{DIST_SHARDS}']['ms_per_frame']:.3f} ms/frame on {DIST_SHARDS} shards, "
        f"{dist['shards_1']['ms_per_frame']:.3f} on 1 (phase 3 {fused_ms:.3f}) ({smi}) "
        f"({time.perf_counter() - t10:.1f} s added, {time.perf_counter() - t_start:.1f} s)")
    phase_wall("10", t10)

    # phase 11: stereo-only depth
    t11 = time.perf_counter()
    stereo = stereo_slice(read_png, smi, dev)
    log(f"[chip_smoke] phase 11: stereo slice ok; stereo_ms flat "
        f"{stereo['stereo_ms']['flat']['ms']:.3f}, pyramid "
        f"{stereo['stereo_ms']['pyramid']['ms']:.3f}; stereo app --fused "
        f"{stereo['app']['fused']['fps']:.3f} FPS ({smi}) "
        f"({time.perf_counter() - t11:.1f} s added, {time.perf_counter() - t_start:.1f} s)")
    phase_wall("11", t11)

    # phase 12: the soak
    t12 = time.perf_counter()
    soak_res = soak(fuse_kernel, splat_kernel, dev, smi)
    torch.cuda.empty_cache()
    log(f"[chip_smoke] phase 12: soak ok; {soak_res['frames']} frames, "
        f"{soak_res['ms_per_frame']:.3f} ms/frame, {soak_res['closures']} closures ({smi}) "
        f"({time.perf_counter() - t12:.1f} s added, {time.perf_counter() - t_start:.1f} s)")
    phase_wall("12", t12)

    # phase 13: the seg net over a (data, model) mesh on the card
    t13 = time.perf_counter()
    seg_par = seg_parallel_slice(fuse_kernel, sample_kernel, splat_kernel, dev, smi)
    tm = {k: {c: v[c]["step_ms_median"] for c in ("eager", "captured")}
          for k, v in seg_par["timing"].items()}
    log(f"[chip_smoke] phase 13: seg_parallel ok; step eager / captured "
        f"{tm['sharded_1x1']['eager']:.2f} / {tm['sharded_1x1']['captured']:.2f} ms (1x1), "
        f"{tm['sharded_2x2']['eager']:.2f} / {tm['sharded_2x2']['captured']:.2f} ms (2x2) "
        f"against make_train_step's {tm['make_train_step']['eager']:.2f} / "
        f"{tm['make_train_step']['captured']:.2f} ms "
        f"({smi}) ({time.perf_counter() - t13:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")
    phase_wall("13", t13)

    probe_main_launches = {fn.__name__: fn.launches for fn in probe_fns}
    log(f"[chip_smoke] probe launches on the main path (phases 3-13): {probe_main_launches}")

    # phase 14: the kernels' self-check
    t14 = time.perf_counter()
    verify = kernel_self_check(fuse_kernel, sample_kernel, splat_kernel, dev, smi)
    log(f"[chip_smoke] phase 14: kernel self-check ok ({time.perf_counter() - t14:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")
    phase_wall("14", t14)

    # phase 15: the port's benchmark, as a user runs it
    t15 = time.perf_counter()
    bench = bench_phase(smi)
    log(f"[chip_smoke] phase 15: bench_torch.py ok; tsdf_fusion_fps {bench['payload']['value']}, "
        f"online_fps {bench['payload']['online_fps']}, stereo_ms "
        f"{bench['payload']['stereo_ms']} ({smi}) ({time.perf_counter() - t15:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")
    phase_wall("15", t15)

    # phase 16: the captured steps
    t16 = time.perf_counter()
    captured = captured_steps(offline, fuse_kernel, splat_kernel, intrinsics, poses, ref, dev,
                              smi)
    log(f"[chip_smoke] phase 16: captured steps ok; bench replay "
        f"{captured['fusion']['median_ms']['eager']:.3f} ms/frame eager, "
        f"{captured['fusion']['median_ms']['captured']:.3f} captured; splat "
        f"{captured['render']['median_ms']['eager']:.3f} / "
        f"{captured['render']['median_ms']['captured']:.3f} ms/render; online_fps (UNet) "
        f"{captured['online']['unet']['online_fps']['eager']:.3f} / "
        f"{captured['online']['unet']['online_fps']['captured']:.3f}; SLAM "
        f"{captured['slam'][1]['median_ms']['eager']:.3f} / "
        f"{captured['slam'][1]['median_ms']['captured']:.3f} ms/frame (scale 1), "
        f"{captured['slam'][2]['median_ms']['eager']:.3f} / "
        f"{captured['slam'][2]['median_ms']['captured']:.3f} (scale 2); sharded step "
        f"{captured['shards'][DIST_SHARDS]['median_ms']['eager']:.3f} / "
        f"{captured['shards'][DIST_SHARDS]['median_ms']['captured']:.3f} ms/frame ({DIST_SHARDS} "
        f"shards), {captured['shards'][1]['median_ms']['eager']:.3f} / "
        f"{captured['shards'][1]['median_ms']['captured']:.3f} (1); stereo flat "
        f"{captured['io']['stereo_flat']['ms']['eager']:.3f} / "
        f"{captured['io']['stereo_flat']['ms']['captured']:.3f} ms, pyramid "
        f"{captured['io']['stereo_pyramid']['ms']['eager']:.3f} / "
        f"{captured['io']['stereo_pyramid']['ms']['captured']:.3f}, remap "
        f"{captured['io']['remap']['ms']['eager']:.3f} / "
        f"{captured['io']['remap']['ms']['captured']:.3f}, infer_one "
        f"{captured['io']['seg']['ms']['eager']:.3f} / "
        f"{captured['io']['seg']['ms']['captured']:.3f}, mesh f32 "
        f"{captured['io']['mesh']['f32']['wall_s']['eager']:.3f} / "
        f"{captured['io']['mesh']['f32']['wall_s']['captured_first']:.3f} / "
        f"{captured['io']['mesh']['f32']['wall_s']['captured_repeat']:.3f} s (eager / first / "
        f"repeat) ({smi}) "
        f"({time.perf_counter() - t16:.1f} s added, {time.perf_counter() - t_start:.1f} s)")
    phase_wall("16", t16)

    # phase 7: device times, after every end-to-end measurement
    t7 = time.perf_counter()
    fusion["profile"] = fusion_profile(offline, dev)
    torch.cuda.empty_cache()
    fuse, fuse_1080, sample, splat, splat_1080 = (check(True) for check in checks)
    probe = probes(dev, splat_probe, feature_probe, sample_probe, fuse_kernel)
    splat_slam = slam_zbuf_yardsticks(splat_kernel, slam_vol, slam_pose)
    icp = icp_yardsticks(dev)
    pose_graph = pose_graph_yardsticks(dev)
    pass_layout = pose_graph_pass_layout(dev)
    raycast = raycast_yardsticks(raycast_vol, intrinsics, poses,
                                 {"raycast": render["raycast"]["launches"],
                                  "superblock_bits": render["raycast"]["bits_launches"]})
    del slam_vol, raycast_vol
    slam["profile"] = slam_profile(dev)
    stereo["profile"] = stereo_profile(dev)
    log(f"[chip_smoke] phase 7: device times ({smi}) ({time.perf_counter() - t7:.1f} s added, "
        f"{time.perf_counter() - t_start:.1f} s)")
    phase_wall("7", t7)

    from disinfect_slam_tpu_torch.utils.graphs import REPLAYS as graph_replays

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
        "captured": captured,
        "graph_replays": dict(graph_replays),
        "splat_zbuf_slam_320x240": splat_slam,
        "icp_step": icp,
        "pose_graph_solve": pose_graph,
        "pose_graph_pass_layout": pass_layout,
        "raycast": raycast,
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
        {"name": "icp_step", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/icp_step.cu",
         "replaces": "disinfect_slam_tpu/systems/odometry.py:116 (the _icp_level loop body: "
                     "XLA ops inside jax.jit, no Pallas kernel)",
         "launches": slam["app"]["icp_launches"],
         "soak_launches": soak_res["launches"]["icp_step"],
         "verify_launches": verify["launches"]["icp_step"],
         **{k: icp[1]["levels"][0][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                                "bound_by", "order_floor_ms", "library_ms")},
         "max_abs_err": max(lv["max_abs_err"] for sc in icp.values() for lv in sc["levels"]),
         **{f"{k}_per_frame_scale{sc}": icp[sc]["per_frame"][k]
            for sc in (1, 2) for k in ("ms", "bound_ms", "order_floor_ms", "plain_ms")}},
        {"name": "pose_graph_solve", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/pose_graph.cu",
         "replaces": "disinfect_slam_tpu/systems/loop_closure.py:243 (the optimize_pose_graph "
                     "scan body: XLA ops inside jax.jit and lax.scan, no Pallas kernel)",
         "launches": soak_res["launches"]["pose_graph_solve"],
         "loop_closure_launches": slam["loop_closure"]["pose_graph_solve_launches"],
         "verify_launches": verify["launches"]["pose_graph_solve"],
         **{k: pose_graph[32][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                           "order_floor_ms", "library_ms", "fused_ms",
                                           "fused_bound_ms", "fused_plain_ms")},
         "max_abs_err": max(r["max_abs_err"] for r in pose_graph.values()),
         **{f"{k}_{n}_nodes": pose_graph[n][k] for n in (8, 128, 256, 512)
            for k in ("ms", "bound_ms", "order_floor_ms", "library_ms", "plain_ms", "fused_ms",
                      "fused_bound_ms")},
         **{f"pass_layout_{k}_{n}_nodes": pass_layout[n][k] for n in pass_layout
            for k in ("ms", "plain_ms", "forced")}},
        {"name": "raycast", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/raycast.cu",
         "replaces": "disinfect_slam_tpu/ops/raycast.py:186 (the march: a lax.while_loop of "
                     "XLA ops inside jax.jit, no Pallas kernel)",
         "launches": render["raycast"]["launches"],
         "hash_launches": export["hash"]["raycast"]["launches"],
         "verify_launches": verify["launches"]["raycast"],
         "bench_launches": bench["launches"]["total"]["raycast"],
         **{k: raycast["frame0"][k] for k in ("ms", "call_ms", "bound_ms", "bound_by",
                                              "order_floor_ms", "library_ms", "plain_ms")},
         "max_abs_err": max(raycast[v]["max_abs_err"] for v in ("frame0", "app")),
         **{f"{k}_640x360": raycast["app"][k] for k in ("ms", "bound_ms", "order_floor_ms",
                                                       "plain_ms")},
         "order_floor_loads": raycast["frame0"]["order_floor_loads"],
         "order_floor_ms_pr21": raycast["frame0"]["order_floor_ms_pr21"],
         "captured_ms_per_render": render["raycast"]["captured_ms"],
         "eager_ms_per_render": render["raycast"]["eager_ms"],
         "layout_ab_ms": raycast["layout_ab_ms"], "shape": raycast["shape"],
         **{f"replay_{k}": raycast["replay_profile"][k]
            for k in ("graph_device_ms", "superblock_bits_ms", "raycast_kernel_ms", "rest_ms",
                      "nodes_per_replay", "table_ms_context", "wall_ms_per_render",
                      "wall_ms_per_render_device_pose", "idle_share")}},
        {"name": "superblock_bits", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/raycast_bits.cu",
         "replaces": "disinfect_slam_tpu/ops/raycast.py:116 (the superblock table: XLA ops "
                     "inside jax.jit, no Pallas kernel)",
         "launches": render["raycast"]["bits_launches"],
         "hash_launches": export["hash"]["raycast"]["bits_launches"],
         "verify_launches": verify["launches"]["superblock_bits"],
         "bench_launches": bench["launches"]["total"]["superblock_bits"],
         **{k: raycast["superblock_bits"][k] for k in (
             "ms", "call_ms", "bound_ms", "bound_by", "library_ms", "plain_ms", "max_abs_err",
             "words", "superblocks_held")}},
        *probe_kernels(probe, probe_main_launches),
    ]
    # the launches each kernel made through graph replays over the whole run
    for k in kernels:
        k["graph_replays"] = graph_replays.get(k["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
