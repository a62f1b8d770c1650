"""The hand kernels' self-check (counterpart of
disinfect_slam_tpu/utils/kernel_verify.py).

Silent numerical corruption that shows only on the hardware is what these
checks exist for.  Each runs a kernel wrapper and its plain `*_reference`
on the same tensors on one device and returns (ok, max_err, detail); the
wrapper launches the CUDA kernel on a CUDA device (and runs its plain
version on the CPU, where every check passes trivially and the suite is a
sanity check of the checks).  `verify_all` is the gate of under 60 s
that scripts/port_verify.py runs, and that a benchmark runs before it
trusts the kernels for a number.

The JAX suite's other checks have no counterpart here: the port samples
every pixel exactly (config.py: sampler_splits is ignored), so there is
no splits=2 tolerance mode, and the XLA gather promises
(verify_index_hints) and the windowed scatter (verify_scatter_window)
do not exist in the port.

Each check takes perturb=True to feed the kernel side an input that
differs from the plain side's, which must make it fail.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..ops import integrate as integrate_mod
from ..ops import render_fast
from ..ops.cuda.fuse_kernel import fuse_rows_reference
from ..ops.cuda.sample_kernel import sample_rows, sample_rows_reference
from ..ops.cuda.splat_kernel import splat_render_cuda
from ..ops.integrate import FrameInput, integrate
from .device import resolve_device

Result = Tuple[bool, float, str]

# the small scene of the JAX suite (_small_scene_step)
SCENE_W, SCENE_H = 160, 128
SCENE_K = (131.3, 131.3, 79.9, 63.9)


# ----------------------------------------------------------------------
def _sample_case(w: int, h: int, v_blocks: int, seed: int, device):
    """The JAX suite's sampler inputs: a random [h, w, 8] frame and each
    block's voxels at random pixels of a 16x16 window."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w, 8)).astype(np.float32)
    u0 = rng.integers(0, w - 32, v_blocks)
    v0 = rng.integers(0, h - 24, v_blocks)
    u = (u0[:, None] + rng.integers(0, 16, (v_blocks, 512))).astype(np.int32)
    v = (v0[:, None] + rng.integers(0, 16, (v_blocks, 512))).astype(np.int32)
    return (torch.from_numpy(img).to(device), torch.from_numpy(u).to(device),
            torch.from_numpy(v).to(device))


def verify_sample_kernel(w: int = 640, h: int = 480, v_blocks: int = 256, seed: int = 0,
                         device="cuda", perturb: bool = False) -> Result:
    """sample_rows (K1) against sample_rows_reference on random in-image
    pixels: bit-exact."""
    img, u, v = _sample_case(w, h, v_blocks, seed, device)
    count = torch.tensor(v_blocks, dtype=torch.int32, device=device)
    got, got_ok = sample_rows(img + 1.0 if perturb else img, u, v, count)
    want, want_ok = sample_rows_reference(img, u, v, count)
    if float(want_ok.float().mean()) < 0.99:
        return False, 1.0, "validity below 0.99"
    err = float((got - want).abs().max())
    ok = err == 0.0 and bool(torch.equal(got_ok, want_ok))
    return ok, err, "bit-exact required"


def verify_count_exit(seed: int = 1, device="cuda", perturb: bool = False) -> Result:
    """sample_rows with count=37 of 64 rows: the live rows equal the full
    run's and the plain version's bit for bit."""
    img, u, v = _sample_case(320, 240, 64, seed, device)
    full, _ = sample_rows(img, u, v, torch.tensor(64, dtype=torch.int32, device=device))
    cut, _ = sample_rows(img + 1.0 if perturb else img, u, v,
                         torch.tensor(37, dtype=torch.int32, device=device))
    want, _ = sample_rows_reference(img, u, v, torch.tensor(37, dtype=torch.int32,
                                                             device=device))
    err = max(float((full[:, :37] - cut[:, :37]).abs().max()),
              float((want[:, :37] - cut[:, :37]).abs().max()))
    return err == 0.0, err, "live rows must match bit-exactly"


@contextlib.contextmanager
def _plain(name: str, plain: Callable):
    """ops/integrate.py's kernel wrapper `name` replaced by its plain
    version while the block runs (the reference side of a check)."""
    kernel = getattr(integrate_mod, name)
    setattr(integrate_mod, name, plain)
    try:
        yield
    finally:
        setattr(integrate_mod, name, kernel)


def _small_scene_step(sampler: str, device="cuda", perturb: bool = False) -> TSDFVolume:
    """Two integrate passes of the JAX suite's small synthetic scene
    (160x128, voxel 8 mm, 2^12 blocks, a 2^6 dense grid; the second pass
    fuses onto nonzero weights) under `sampler`: "gather" is the
    two-stage path (K1 and the fusion formulas as torch ops),
    "pallas_fused" the fuse_rows kernel (K2).  perturb moves every depth
    by 1 mm."""
    device = resolve_device(device)
    cfg = TSDFConfig(voxel_size=0.008, truncation=0.048, num_blocks_log2=12,
                     max_candidates=8192, max_visible=2048, max_new_per_round=2048,
                     backend="dense", grid_log2=6, sampler=sampler)
    rng = np.random.default_rng(7)
    depth = (2.0 + 0.8 * rng.random((SCENE_H, SCENE_W))).astype(np.float32)
    rgb = rng.integers(0, 256, (SCENE_H, SCENE_W, 3)).astype(np.float32)
    ht = rng.random((SCENE_H, SCENE_W)).astype(np.float32)
    if perturb:
        depth = depth + np.float32(0.001)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    frame = FrameInput(rgb=t(rgb), depth=t(depth), ht=t(ht), lt=t(1.0 - ht))
    cam = CameraParams.create(CameraIntrinsics.create(*SCENE_K), SCENE_H, SCENE_W)
    vol = TSDFVolume.create(cfg, device)
    for _ in range(2):
        vol = integrate(vol, frame, cam, SE3.identity(), 4.0)
    return vol


def _payload_gaps(a: TSDFVolume, b: TSDFVolume) -> Tuple[float, int, int, float]:
    """(max |dtsdf|, max |dweight|, max |drgb| of a byte, max |dprob|)."""
    ra, rb = a.rgbw.long() & 0xFFFFFFFF, b.rgbw.long() & 0xFFFFFFFF
    rgb = max(int((((ra >> s) & 0xFF) - ((rb >> s) & 0xFF)).abs().max()) for s in (0, 8, 16))
    return (float((a.tsdf - b.tsdf).abs().max()), int(((ra >> 24) - (rb >> 24)).abs().max()),
            rgb, float((a.prob - b.prob).abs().max()))


def verify_integrate_parity(device="cuda", perturb: bool = False) -> Result:
    """The two-stage integrate with sample_rows (K1) against the same with
    sample_rows_reference: voxel for voxel, bit-exact."""
    with _plain("sample_rows", sample_rows_reference):
        a = _small_scene_step("gather", device)
    b = _small_scene_step("gather", device, perturb)
    terr, werr, rerr, perr = _payload_gaps(a, b)
    same_blocks = bool(torch.equal(a.block_table, b.block_table))
    ok = same_blocks and terr == 0.0 and werr == 0 and rerr == 0 and perr == 0.0
    return ok, max(terr, perr, float(rerr), float(werr)), "bit-exact"


def verify_fused_kernel(device="cuda", perturb: bool = False) -> Result:
    """The fused integrate with fuse_rows (K2) against the same with
    fuse_rows_reference, within the JAX suite's limits (tsdf and prob
    1e-5, rgb one step)."""
    with _plain("fuse_rows", fuse_rows_reference):
        a = _small_scene_step("pallas_fused", device)
    b = _small_scene_step("pallas_fused", device, perturb)
    terr, werr, rerr, perr = _payload_gaps(a, b)
    ok = terr < 1e-5 and rerr <= 1 and perr < 1e-5
    return ok, max(terr, perr), "tsdf, prob < 1e-5, rgb <= 1"


def verify_splat(device="cuda", perturb: bool = False) -> Result:
    """splat_render_cuda (K4 and K5) against the plain splat
    (render_fast.splat_render) on the small scene's volume:
    bit-identical rgba, normal and depth.  perturb moves the kernels'
    camera by 1 cm."""
    vol = _small_scene_step("gather", device)
    cam = CameraParams.create(CameraIntrinsics.create(*SCENE_K), SCENE_H, SCENE_W)
    pose = SE3.identity()
    moved = SE3(q=pose.q, t=pose.t + np.float32(0.01)) if perturb else pose
    a = render_fast.splat_render(vol, cam, pose, 4.0)
    b = splat_render_cuda(vol, cam, moved, 4.0)
    err = max(int((a.rgba.int() - b.rgba.int()).abs().max()),
              int((a.normal.int() - b.normal.int()).abs().max()))
    derr = float((a.depth - b.depth).abs().max())
    return err == 0 and derr == 0.0, float(err) + derr, "bit-identical"


CheckFn = Callable[..., Result]
CHECKS: List[Tuple[str, CheckFn]] = [
    ("sample_rows 640x480, 256 blocks (bit-exact)", verify_sample_kernel),
    # the JAX suite's splits=2 tolerance mode has no counterpart: the port
    # samples exactly (config.py: sampler_splits is ignored)
    # 1920x1080, the reference's largest frame (voxel_tsdf.cu:10-12)
    ("sample_rows 1080p, 64 blocks (bit-exact)",
     lambda **kw: verify_sample_kernel(w=1920, h=1080, v_blocks=64, **kw)),
    ("sample_rows count early exit", verify_count_exit),
    ("integrate two-stage K1 vs plain (bit-exact)", verify_integrate_parity),
    ("integrate fused K2 vs plain (JAX limits)", verify_fused_kernel),
    ("splat K4/K5 vs plain (bit-identical)", verify_splat),
    # verify_index_hints and verify_scatter_window check XLA gather
    # promises and the windowed scatter, which the port does not have
]


def verify_all(verbose: bool = True, device="cuda") -> bool:
    """Run every check on `device` (CUDA unless the caller asks for the
    CPU; raises without CUDA), print one PASS/FAIL line each to stderr,
    and return True only if all passed.  A check that raises counts as
    failed (its traceback is printed); the caller exits non-zero on
    False."""
    device = resolve_device(device)
    all_ok = True
    for name, fn in CHECKS:
        t0 = time.perf_counter()
        try:
            ok, err, detail = fn(device=device)
        except Exception as e:  # a failed check, reported; the gate goes on
            traceback.print_exc(file=sys.stderr)
            ok, err, detail = False, float("nan"), f"EXCEPTION: {e!r}"
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        all_ok &= ok
        if verbose:
            print(f"[port_verify] {'PASS' if ok else 'FAIL'}  {name}: err={err:.3g} ({detail}) "
                  f"[{dt:.1f}s]", file=sys.stderr, flush=True)
    return all_ok
