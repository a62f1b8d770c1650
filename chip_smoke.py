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
  4. the same replay through the two-stage path (sample_rows + torch
     fusion math), once, with the same checks.

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


def replay(offline, sampler: str, save: str):
    argv = ["--logdir", DATASET, "--config", os.path.join(DATASET, "cam.yaml"),
            "--preset", "bench", "--device", "cuda", "--sampler", sampler,
            "--save", save]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from disinfect_slam_tpu_torch.apps import offline
    from disinfect_slam_tpu_torch.ops.cuda import build, fuse_kernel, sample_kernel

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
    torch.cuda.empty_cache()
    log("[chip_smoke] phase 2: kernels agree with their plain versions")

    with open(FINGERPRINT) as f:
        ref = json.load(f)
    save = os.path.join(str(build.BUILD_DIR), "data.bin")

    # phase 3: the slice through the fused kernel
    ms_runs = []
    for i in range(3):
        fuse_kernel.fuse_rows.launches = 0
        sample_kernel.sample_rows.launches = 0
        res = replay(offline, "pallas_fused", save)
        fused_launches = fuse_kernel.fuse_rows.launches
        if fused_launches != res["frames"] or res["frames"] != ref["frames"]:
            raise AssertionError(f"fuse_rows launched {fused_launches} times "
                                 f"for {res['frames']} frames")
        if sample_kernel.sample_rows.launches:
            raise AssertionError("the fused path launched sample_rows")
        ms_runs.append(1e3 * statistics.mean(res["integrate_s"]))
        check_dump(save, res["records"])
        fp_fused = check_fingerprint(res["grid"], res["records"], ref, f"fused replay {i}")
        del res
        torch.cuda.empty_cache()
    fused_ms = statistics.median(ms_runs)
    log(f"[chip_smoke] phase 3: fused replay ms/frame {ms_runs} -> median "
        f"{fused_ms:.3f} ({smi}); fuse_rows launches {fused_launches}")

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
        f"sample_rows launches {sample_launches}")
    del res

    report = {
        "card": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc_s": nvcc_s,
        "fuse_rows_1080p": fuse_1080,
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
