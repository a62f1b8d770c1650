#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (disinfect_slam_tpu_torch).

Phases, each printed as it ends; any failure raises and the process
exits non-zero:

  0. the card (nvidia-smi name and power limit) and torch / CUDA versions;
  1. builds the CUDA kernels from csrc/ (nvcc, sm_90a);
  2. holds each kernel against its plain torch version on the card at the
     slice's shapes (32768 visible blocks, 640x480 frame, a 2^18-row pool)
     plus fuse_rows on a 1920x1080 frame, and times both (CUDA events,
     median of 10);
  3. the slice: apps.offline over all 60 frames of datasets/orbit_vga at
     the bench preset through the fused kernel, three times; fuse_rows
     must launch once per frame, and the fused volume must agree with
     the JAX reference's fingerprint (disinfect_slam_tpu_torch/data/);
     the last of the three also renders the app's final view
     (--render-dir), which must launch splat_zbuf_rows and
     splat_payload_rows once each and write two 640x360 RGBA PNGs;
  4. the same replay through the two-stage path (sample_rows + torch
     fusion math), once, with the same checks;
  5. the render slice on the last fused volume: TSDFGrid.ray_cast
     (renderer="auto", the two splat kernels) at the poses of frames 0-4,
     640x480, one warm-up and three timed passes of five renders; one
     launch of each kernel per render; the frame-0 render bit-equal, in
     both buffers and all four images, to the plain torch splat on the
     same volume; the frame-0 and the app's view held against the JAX
     reference's render fingerprint; the parity raycaster on the frame-0
     view, timed, with its divergence from the splat.

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
     the asynchronous DISINFSystem path at --fps 120.

Phase 2 also holds splat_zbuf_rows and splat_payload_rows against their
plain versions at the render's capacity (16384 rows, 640x480 and
1920x1080), bit for bit.

The line before the last is a JSON object describing each kernel; the
last line is the JSON result.  The full report, and the data.bin of the
last replay, go to disinfect_slam_tpu_torch/_build/.  Run from the
repository root, with no arguments:  python3 chip_smoke.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATASET = os.path.join(ROOT, "datasets", "orbit_vga")
FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                           "orbit_vga_bench_fingerprint.json")
V, H, W = 32768, 480, 640
POOL = 1 << 18
COUNT = 32207  # visible rows below the capacity, as in the slice's last frames
CONSTS = dict(truncation=0.024, max_depth=4.0, max_weight=40.0, prob_eps=0.0)
# agreement with the JAX reference (CPU, with XLA's FMA contraction and
# its own exp/log) after 60 frames: counts within 0.1%, sums relative
TOL_COUNT, TOL_TSDF, TOL_WP = 1e-3, 1e-4, 1e-3
# splat renders of the fused volume against the JAX reference's: hit
# count and every sum within 1e-3 relative; dropped surface blocks within
# 0.1% of the surface-block count
TOL_RENDER = 1e-3
SPLAT_ROWS, SPLAT_COUNT = 16384, 14000  # the render's surf_cap; live rows
RENDER_MAX_DEPTH = 4.0
ONLINE_FINGERPRINT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                                  "orbit_vga_online_fingerprint.json")
ONLINE_FRAMES = 30
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


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 10) -> float:
    """Median device time of fn() over reps runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_frame(rng, img_h, img_w, dev):
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
    uc, vc = np.clip(u, 0, img_w - 1), np.clip(v, 0, img_h - 1)
    z = img[vc, uc, 0] + rng.uniform(-0.03, 0.02, (V, 512))
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)  # noqa: E731
    return (t(img, np.float32), t(u, np.int32), t(v, np.int32),
            t(z, np.float32), off)


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


def check_fuse_rows(fuse_kernel, img_h, img_w, seed, dev, timed):
    rng = np.random.default_rng(seed)
    img, u, v, z, off = make_frame(rng, img_h, img_w, dev)
    us, vs = u.clamp(0, img_w - 1), v.clamp(0, img_h - 1)
    gate = torch.from_numpy((rng.uniform(size=(V, 512)) < 0.9) & ~off).to(dev)
    gate[COUNT:] = False
    pool_idx = torch.from_numpy(rng.permutation(POOL)[:V].astype(np.int32)).to(dev)
    pool_idx[COUNT:] = POOL  # padding rows, as compact_mask leaves them
    count = torch.tensor(COUNT, dtype=torch.int32, device=dev)
    tsdf, rgbw, prob = make_pool(dev, seed)
    ref = [a.clone() for a in (tsdf, rgbw, prob)]
    rgbw0 = rgbw.clone()
    minabs = fuse_kernel.fuse_rows(img, us, vs, z, gate, pool_idx, count,
                                   tsdf, rgbw, prob, **CONSTS)
    minabs_ref = fuse_kernel.fuse_rows_reference(img, us, vs, z, gate, pool_idx,
                                                 count, *ref, **CONSTS)
    torch.cuda.synchronize()
    err = {
        "tsdf": (tsdf - ref[0]).abs().max().item(),
        "rgbw": int((rgbw != ref[1]).sum().item()),
        "prob": (prob - ref[2]).abs().max().item(),
        "minabs": (minabs[:COUNT] - minabs_ref[:COUNT]).abs().max().item(),
    }
    changed = (rgbw != rgbw0).float().mean().item()
    del rgbw0
    log(f"[chip_smoke] fuse_rows {img_w}x{img_h}, V={V}, count={COUNT}: "
        f"max|dtsdf|={err['tsdf']:.3g} rgbw words differing={err['rgbw']} "
        f"max|dprob|={err['prob']:.3g} max|dminabs|={err['minabs']:.3g} "
        f"(fraction of pool words updated {changed:.4f})")
    # tsdf, rgbw and minabs bit-equal (same float32 ops, no contraction);
    # prob within 1e-6 (expf/logf of the kernel vs torch's exp/log)
    if err["tsdf"] != 0 or err["rgbw"] != 0 or err["minabs"] != 0 or err["prob"] > 1e-6:
        raise AssertionError(f"fuse_rows disagrees with its plain version: {err}")
    # rgbw enters as the largest difference of its r, g, b and weight bytes
    rgbw_err = (rgbw.view(torch.uint8).int() - ref[1].view(torch.uint8).int()).abs().max().item()
    res = {"max_abs_err": max(err["tsdf"], err["prob"], err["minabs"], rgbw_err)}
    if timed:
        res["ms"] = cuda_time_ms(lambda: fuse_kernel.fuse_rows(
            img, us, vs, z, gate, pool_idx, count, tsdf, rgbw, prob, **CONSTS))
        res["plain_ms"] = cuda_time_ms(lambda: fuse_kernel.fuse_rows_reference(
            img, us, vs, z, gate, pool_idx, count, *ref, **CONSTS))
        log(f"[chip_smoke] fuse_rows {img_w}x{img_h}: kernel {res['ms']:.4f} ms, "
            f"plain torch {res['plain_ms']:.4f} ms (median of 10)")
    return res


def check_sample_rows(sample_kernel, dev):
    rng = np.random.default_rng(7)
    img, u, v, _, _ = make_frame(rng, H, W, dev)
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
    res["ms"] = cuda_time_ms(lambda: sample_kernel.sample_rows(img, u, v, count))
    res["plain_ms"] = cuda_time_ms(
        lambda: sample_kernel.sample_rows_reference(img, u, v, count))
    log(f"[chip_smoke] sample_rows: kernel {res['ms']:.4f} ms, plain torch "
        f"{res['plain_ms']:.4f} ms (median of 10)")
    return res


def make_splat_rows(rng, img_h, img_w, dev):
    """Splat kernel inputs at the render's capacity: each block's voxels
    fall in a 12x12 px footprint, 1% of them off the image (some at
    negative pixels), 40% of voxels outside the band (BIG), depths drawn
    from 16 values so that many voxels tie at a pixel."""
    s = SPLAT_ROWS
    u0 = rng.integers(-2, img_w - 10, (s, 1)) + rng.integers(0, 12, (s, 512))
    v0 = rng.integers(-2, img_h - 10, (s, 1)) + rng.integers(0, 12, (s, 512))
    off = rng.uniform(size=(s, 512)) < 0.01
    u0[off] = np.where(rng.uniform(size=off.sum()) < 0.5, -3, img_w + 1)
    dq = rng.choice(np.arange(8000, 8016), (s, 512))
    dq[rng.uniform(size=(s, 512)) < 0.4] = 1 << 30
    pool_idx = rng.permutation(POOL)[:s]
    pool_idx[SPLAT_COUNT:] = POOL  # padding rows, as the compaction leaves them
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    return t(u0), t(v0), t(dq), t(pool_idx)


def u32_err(a, b) -> int:
    """Largest difference of two buffers of u32 bits held as i32."""
    return int(((a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)).abs().max().item())


def check_splat(splat_kernel, img_h, img_w, seed, dev, timed):
    rng = np.random.default_rng(seed)
    u0, v0, dq, pool_idx = make_splat_rows(rng, img_h, img_w, dev)
    _, rgbw, prob = make_pool(dev, seed)
    count = torch.tensor(SPLAT_COUNT, dtype=torch.int32, device=dev)
    zbuf = splat_kernel.splat_zbuf_rows(u0, v0, dq, count, img_h, img_w)
    pbuf = splat_kernel.splat_payload_rows(u0, v0, dq, pool_idx, rgbw, prob, count,
                                           zbuf, img_h, img_w)
    zref = splat_kernel.splat_zbuf_rows_reference(u0, v0, dq, count, img_h, img_w)
    pref = splat_kernel.splat_payload_rows_reference(u0, v0, dq, pool_idx, rgbw, prob,
                                                     count, zref, img_h, img_w)
    torch.cuda.synchronize()
    z_err, p_err = u32_err(zbuf, zref), u32_err(pbuf, pref)
    covered = (zbuf < splat_kernel.BIG).float().mean().item()
    top = (pbuf < 0).float().mean().item()
    log(f"[chip_smoke] splat {img_w}x{img_h}, S={SPLAT_ROWS}, count={SPLAT_COUNT}: "
        f"zbuf max|d|={z_err}, pbuf max|d|={p_err} (pixels covered {covered:.4f}, "
        f"payload words with the top bit set {top:.4f})")
    if not (torch.equal(zbuf, zref) and torch.equal(pbuf, pref)):
        raise AssertionError(f"splat kernels disagree with their plain versions "
                             f"at {img_w}x{img_h}")
    if top == 0 or covered == 0:
        raise AssertionError("splat inputs exercised no top-bit payload")
    res = {"zbuf": {"max_abs_err": z_err}, "payload": {"max_abs_err": p_err}}
    if timed:
        res["zbuf"]["ms"] = cuda_time_ms(lambda: splat_kernel.splat_zbuf_rows(
            u0, v0, dq, count, img_h, img_w))
        res["zbuf"]["plain_ms"] = cuda_time_ms(lambda: splat_kernel.splat_zbuf_rows_reference(
            u0, v0, dq, count, img_h, img_w))
        res["payload"]["ms"] = cuda_time_ms(lambda: splat_kernel.splat_payload_rows(
            u0, v0, dq, pool_idx, rgbw, prob, count, zbuf, img_h, img_w))
        res["payload"]["plain_ms"] = cuda_time_ms(
            lambda: splat_kernel.splat_payload_rows_reference(
                u0, v0, dq, pool_idx, rgbw, prob, count, zbuf, img_h, img_w))
        log(f"[chip_smoke] splat {img_w}x{img_h}: splat_zbuf_rows kernel "
            f"{res['zbuf']['ms']:.4f} ms, plain torch {res['zbuf']['plain_ms']:.4f} ms; "
            f"splat_payload_rows kernel {res['payload']['ms']:.4f} ms, plain torch "
            f"{res['payload']['plain_ms']:.4f} ms (median of 10)")
    return res


def reset_launches(*fns) -> None:
    for fn in fns:
        fn.launches = 0


def replay(offline, sampler: str, save: str, render_dir=None):
    argv = ["--logdir", DATASET, "--config", os.path.join(DATASET, "cam.yaml"),
            "--preset", "bench", "--device", "cuda", "--sampler", sampler,
            "--save", save]
    if render_dir:
        argv += ["--render-dir", render_dir, "--renderer", "auto"]
    return offline.main(argv)


def check_fingerprint(grid, records, ref, label, prob_tol=TOL_WP):
    from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
    from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint

    fp = volume_fingerprint(volume_to_numpy(grid.volume))
    fp["records"] = records
    rel = lambda k: abs(fp[k] - ref[k]) / abs(ref[k])  # noqa: E731
    checks = {
        "active_blocks": (rel("active_blocks"), TOL_COUNT),
        "records": (rel("records"), TOL_COUNT),
        "sum_abs_tsdf": (rel("sum_abs_tsdf"), TOL_TSDF),
        "sum_weight": (rel("sum_weight"), TOL_WP),
        "sum_prob": (rel("sum_prob"), prob_tol),
    }
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


def render_views(grid, render_fast, splat_kernel, intrinsics, poses, ref):
    """Phase 5: the render slice on the fused volume (see the docstring).
    Returns the report entries and the main path's launch counts."""
    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams

    kernels = (splat_kernel.splat_zbuf_rows, splat_kernel.splat_payload_rows)
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
    vol, pose0 = grid.volume, SE3.from_matrix(frames[0])
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

    # the render's own stages, device time by CUDA events (median of 10)
    u0, v0, dq, vis, _ = splat_kernel._kernel_inputs(vol, cam, pose0, RENDER_MAX_DEPTH,
                                                     1.25, render_fast.DEFAULT_SURF_CAP)
    zbuf = splat_kernel.splat_zbuf_rows(u0, v0, dq, vis.count, H, W)
    stages = {
        "prep (visibility, surface compaction, projection)": cuda_time_ms(
            lambda: splat_kernel._kernel_inputs(vol, cam, pose0, RENDER_MAX_DEPTH, 1.25,
                                                render_fast.DEFAULT_SURF_CAP)),
        "splat_zbuf_rows": cuda_time_ms(lambda: splat_kernel.splat_zbuf_rows(
            u0, v0, dq, vis.count, H, W)),
        "splat_payload_rows": cuda_time_ms(lambda: splat_kernel.splat_payload_rows(
            u0, v0, dq, vis.pool_idx, vol.rgbw, vol.prob, vis.count, zbuf, H, W)),
        "plain zbuf": cuda_time_ms(lambda: splat_kernel.splat_zbuf_rows_reference(
            u0, v0, dq, vis.count, H, W)),
        "plain payload": cuda_time_ms(lambda: splat_kernel.splat_payload_rows_reference(
            u0, v0, dq, vis.pool_idx, vol.rgbw, vol.prob, vis.count, zbuf, H, W)),
        "images_from_buffers": cuda_time_ms(
            lambda: render_fast.images_from_buffers(bufs[0], bufs[1], cam)),
        "plain splat_render": cuda_time_ms(
            lambda: render_fast.splat_render(vol, cam, pose0, RENDER_MAX_DEPTH)),
    }
    log("[chip_smoke] render frame 0 stages, CUDA-event ms (median of 10): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    del u0, v0, dq, zbuf, plain_bufs, plain

    # device busy share of the render, from a profiler trace of five renders
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pose in frames:
            grid.ray_cast(RENDER_MAX_DEPTH, view, pose, renderer="auto")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    n_kernels = len(events)
    busy = device_ms / wall_ms if device_ms else None
    log(f"[chip_smoke] render profile (5 renders): wall {wall_ms:.3f} ms, device "
        f"kernel time {device_ms:.3f} ms in {n_kernels} kernels"
        + (f", idle share {1 - busy:.3f}" if busy is not None else ", idle share not measured"))
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
              "surface_blocks": kept + overflow, "surf_overflow": overflow,
              "stages_ms": stages, "profile": {"wall_ms": wall_ms, "device_ms": device_ms,
                                               "kernels": n_kernels},
              "fingerprints": fps, "raycast_ms": raycast_ms, "divergence": divergence}
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


def warm_then_time(step, frames, warm):
    """Steps the first `warm` frames, then times the rest with the device
    synchronised at the end; returns frames per second of the timed part."""
    for f in frames[:warm]:
        step.step(*f)
    step.block_until_ready()
    t0 = time.perf_counter()
    for f in frames[warm:]:
        step.step(*f)
    step.block_until_ready()
    return (len(frames) - warm) / (time.perf_counter() - t0)


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
        fps = warm_then_time(step, frames, warm)
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
        build, fuse_kernel, sample_kernel, splat_kernel,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    # phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[chip_smoke] phase 0: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")

    # phase 1: build
    t0 = time.perf_counter()
    path, build_log, nvcc_s = build.build()
    build.library()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[chip_smoke] ptxas: {line.strip()}")
    log(f"[chip_smoke] phase 1: kernels built in {nvcc_s:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s) -> {os.path.relpath(path, ROOT)}")

    # phase 2: kernels against their plain versions at the slice's shapes
    fuse = check_fuse_rows(fuse_kernel, H, W, seed=1, dev=dev, timed=True)
    fuse_1080 = check_fuse_rows(fuse_kernel, 1080, 1920, seed=2, dev=dev, timed=True)
    sample = check_sample_rows(sample_kernel, dev)
    splat = check_splat(splat_kernel, H, W, seed=3, dev=dev, timed=True)
    splat_1080 = check_splat(splat_kernel, 1080, 1920, seed=4, dev=dev, timed=True)
    torch.cuda.empty_cache()
    log(f"[chip_smoke] phase 2: kernels agree with their plain versions "
        f"({time.perf_counter() - t_start:.1f} s)")

    with open(FINGERPRINT) as f:
        ref = json.load(f)
    save = os.path.join(str(build.BUILD_DIR), "data.bin")
    render_dir = os.path.join(str(build.BUILD_DIR), "render")
    splat_fns = (splat_kernel.splat_zbuf_rows, splat_kernel.splat_payload_rows)

    # phase 3: the slice through the fused kernel; the last replay also
    # renders the app's final view through the splat kernels
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

    # phase 4: the two-stage path
    fuse_kernel.fuse_rows.launches = 0
    sample_kernel.sample_rows.launches = 0
    res = replay(offline, "pallas", save)
    sample_launches = sample_kernel.sample_rows.launches
    if sample_launches != res["frames"] or fuse_kernel.fuse_rows.launches:
        raise AssertionError(f"two-stage replay: sample_rows launched "
                             f"{sample_launches} times, fuse_rows "
                             f"{fuse_kernel.fuse_rows.launches}")
    check_dump(save, res["records"])
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
    del grid
    torch.cuda.empty_cache()

    # phase 6: the online slice, segmentation feeding fuse_rows
    t6 = time.perf_counter()
    online = online_slice(fuse_kernel, sample_kernel, dev, smi,
                          os.path.join(str(build.BUILD_DIR), "online_render"))
    log(f"[chip_smoke] phase 6: online slice ok; online_fps {online['online_fps']:.3f}, "
        f"online_fps_fast {online['online_fps_fast']:.3f}, seg_ms "
        f"{online['seg']['unet']['seg_ms']:.3f} (UNet) ({smi}) "
        f"({time.perf_counter() - t6:.1f} s added, {time.perf_counter() - t_start:.1f} s)")

    report = {
        "card": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc_s": nvcc_s,
        "fuse_rows_1080p": fuse_1080,
        "splat_640x480": splat,
        "splat_1080p": splat_1080,
        "render": render,
        "online": online,
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
         "replaces": "disinfect_slam_tpu/ops/pallas/fuse_kernel.py:262",
         "also_replaces": "disinfect_slam_tpu/ops/pallas/fuse_kernel.py:519",
         "launches": fused_launches, "online_launches": online["online_launches"],
         "online_app_launches": online["app"]["fused"]["fuse_rows_launches"], **fuse},
        {"name": "sample_rows", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/sample_rows.cu",
         "replaces": "disinfect_slam_tpu/ops/pallas/sample_kernel.py:359",
         "launches": sample_launches, **sample},
        {"name": "splat_zbuf_rows", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/splat_rows.cu",
         "replaces": "disinfect_slam_tpu/ops/pallas/splat_kernel.py:149",
         "launches": splat_launches[0], **splat["zbuf"],
         "max_abs_err": max(splat["zbuf"]["max_abs_err"],
                            splat_1080["zbuf"]["max_abs_err"], render_err["zbuf"])},
        {"name": "splat_payload_rows", "route": "cuda",
         "source": "disinfect_slam_tpu_torch/csrc/splat_rows.cu",
         "replaces": "disinfect_slam_tpu/ops/pallas/splat_kernel.py:438",
         "launches": splat_launches[1], **splat["payload"],
         "max_abs_err": max(splat["payload"]["max_abs_err"],
                            splat_1080["payload"]["max_abs_err"], render_err["pbuf"])},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
