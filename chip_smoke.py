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


def check_fingerprint(grid, records, ref, label):
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
        "sum_prob": (rel("sum_prob"), TOL_WP),
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

    report = {
        "card": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc_s": nvcc_s,
        "fuse_rows_1080p": fuse_1080,
        "splat_640x480": splat,
        "splat_1080p": splat_1080,
        "render": render,
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
         "launches": fused_launches, **fuse},
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
