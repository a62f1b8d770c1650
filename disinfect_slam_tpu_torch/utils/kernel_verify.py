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

The kernel side of the K2, K4 and K5 checks takes its pose from device
memory (a DevicePose, as the captured steps hand it over), the plain side
the host pose (SE3), at a pose that is not the identity.  One more check
holds the captured steps (IntegrateStep, SplatStep: CUDA graphs on the
card) against the same steps run eagerly, one holds ICP's kernel
(icp_step) and one the pose graph's (pose_graph_solve) against their
plain versions on the device and on the CPU, one the raycast kernel
against raycast_reference on a dense volume (the superblock skip, both
layouts of its bits) and a hash volume, and one the superblock bits'
kernel against its plain version.

Each check takes perturb=True to feed the kernel side an input that
differs from the plain side's, which must make it fail.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams, DevicePose
from ..core.state import TSDFVolume
from ..ops import integrate as integrate_mod
from ..ops import render_fast
from ..ops.cuda import raycast_kernel
from ..ops.cuda.fuse_kernel import fuse_rows_reference
from ..ops.cuda.sample_kernel import sample_rows, sample_rows_reference
from ..ops.cuda.splat_kernel import SplatStep, splat_render_cuda
from ..ops.integrate import FrameInput, IntegrateStep, integrate
from ..ops.raycast import raycast_reference, superblock_bits_reference
from .device import resolve_device

Result = Tuple[bool, float, str]

# the small scene of the JAX suite (_small_scene_step)
SCENE_W, SCENE_H = 160, 128
SCENE_K = (131.3, 131.3, 79.9, 63.9)
# the scene's camera for the pose checks: turned 2 degrees about y and
# moved 1 cm, so that every rotation entry and translation is nonzero
_C2, _S2 = np.cos(np.radians(2.0)), np.sin(np.radians(2.0))
SCENE_POSE = np.asarray([[_C2, 0.0, _S2, 0.01], [0.0, 1.0, 0.0, -0.01],
                         [-_S2, 0.0, _C2, 0.005], [0.0, 0.0, 0.0, 1.0]], np.float32)


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


def _scene_cfg(sampler: str, backend: str = "dense") -> TSDFConfig:
    if backend == "hash":
        return TSDFConfig(voxel_size=0.008, truncation=0.048, num_blocks_log2=12,
                          num_buckets_log2=13, max_candidates=8192, max_visible=2048,
                          max_new_per_round=2048, backend="hash", alloc_dedup="sort",
                          sampler=sampler)
    return TSDFConfig(voxel_size=0.008, truncation=0.048, num_blocks_log2=12,
                      max_candidates=8192, max_visible=2048, max_new_per_round=2048,
                      backend="dense", grid_log2=6, sampler=sampler)


def _scene_frame(device, perturb: bool = False) -> FrameInput:
    """The small scene's frame: depth 2-2.8 m, random rgb and ht."""
    rng = np.random.default_rng(7)
    depth = (2.0 + 0.8 * rng.random((SCENE_H, SCENE_W))).astype(np.float32)
    rgb = rng.integers(0, 256, (SCENE_H, SCENE_W, 3)).astype(np.float32)
    ht = rng.random((SCENE_H, SCENE_W)).astype(np.float32)
    if perturb:
        depth = depth + np.float32(0.001)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return FrameInput(rgb=t(rgb), depth=t(depth), ht=t(ht), lt=t(1.0 - ht))


def _small_scene_step(sampler: str, device="cuda", perturb: bool = False,
                      pose: str = "identity", backend: str = "dense") -> TSDFVolume:
    """Two integrate passes of the JAX suite's small synthetic scene
    (160x128, voxel 8 mm, 2^12 blocks, a 2^6 dense grid; the second pass
    fuses onto nonzero weights) under `sampler`: "gather" is the
    two-stage path (K1 and the fusion formulas as torch ops),
    "pallas_fused" the fuse_rows kernel (K2).  perturb moves every depth
    by 1 mm.  pose: "identity" (the JAX suite's), or SCENE_POSE as an SE3
    ("host") or a DevicePose ("device")."""
    device = resolve_device(device)
    frame = _scene_frame(device, perturb)
    cam = CameraParams.create(CameraIntrinsics.create(*SCENE_K), SCENE_H, SCENE_W)
    cam_T_world = {"identity": lambda: SE3.identity(),
                   "host": lambda: SE3.from_matrix(SCENE_POSE),
                   "device": lambda: DevicePose.from_matrix(SCENE_POSE, device)}[pose]()
    vol = TSDFVolume.create(_scene_cfg(sampler, backend), device)
    for _ in range(2):
        vol = integrate(vol, frame, cam, cam_T_world, 4.0)
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
    """The fused integrate with fuse_rows (K2, the pose in device memory)
    against the same with fuse_rows_reference and the host pose, within
    the JAX suite's limits (tsdf and prob 1e-5, rgb one step)."""
    with _plain("fuse_rows", fuse_rows_reference):
        a = _small_scene_step("pallas_fused", device, pose="host")
    b = _small_scene_step("pallas_fused", device, perturb, pose="device")
    terr, werr, rerr, perr = _payload_gaps(a, b)
    ok = terr < 1e-5 and rerr <= 1 and perr < 1e-5
    return ok, max(terr, perr), "tsdf, prob < 1e-5, rgb <= 1"


def verify_splat(device="cuda", perturb: bool = False) -> Result:
    """splat_render_cuda (K4 and K5, the pose in device memory) against the
    plain splat (render_fast.splat_render, the host pose) on the small
    scene's volume: bit-identical rgba, normal and depth.  perturb moves
    the kernels' camera by 1 cm."""
    device = resolve_device(device)
    vol = _small_scene_step("gather", device)
    cam = CameraParams.create(CameraIntrinsics.create(*SCENE_K), SCENE_H, SCENE_W)
    pose = SE3.from_matrix(SCENE_POSE)
    moved = SE3(q=pose.q, t=pose.t + np.float32(0.01)) if perturb else pose
    a = render_fast.splat_render(vol, cam, pose, 4.0)
    b = splat_render_cuda(vol, cam, DevicePose.from_se3(moved, device), 4.0)
    err = max(int((a.rgba.int() - b.rgba.int()).abs().max()),
              int((a.normal.int() - b.normal.int()).abs().max()))
    derr = float((a.depth - b.depth).abs().max())
    return err == 0 and derr == 0.0, float(err) + derr, "bit-identical"


def verify_captured_steps(device="cuda", perturb: bool = False) -> Result:
    """Three frames of the small scene through IntegrateStep (captured on
    the card after its first frame of each key, replayed after it) and
    two SplatStep renders of the result (the second a replay), against the same frames through
    integrate and splat_render_cuda run eagerly: every volume array and
    every image bit-identical.  perturb moves the captured side's last
    frame by 1 mm."""
    device = resolve_device(device)
    cam = CameraParams.create(CameraIntrinsics.create(*SCENE_K), SCENE_H, SCENE_W)
    pose = SE3.from_matrix(SCENE_POSE)
    frame, moved = _scene_frame(device), _scene_frame(device, perturb)
    eager = TSDFVolume.create(_scene_cfg("pallas_fused"), device)
    captured = TSDFVolume.create(_scene_cfg("pallas_fused"), device)
    step = IntegrateStep(device)
    for i in range(3):
        integrate(eager, frame, cam, pose, 4.0, allocate=i != 1)
        step(captured, moved if i == 2 else frame, cam, pose, 4.0, allocate=i != 1)
    err = max(float((getattr(eager, f).double() - getattr(captured, f).double()).abs().max())
              for f in ("entry_block", "num_free", "tsdf", "rgbw", "prob"))
    a = splat_render_cuda(eager, cam, pose, 4.0)
    render = SplatStep(device)
    render(captured, cam, pose, 4.0)  # captured after this call, replayed by the next
    b = render(captured, cam, pose, 4.0)
    err += sum(float((x.double() - y.double()).abs().max()) for x, y in zip(a[:3], b[:3]))
    return err == 0.0, err, "bit-identical"


def verify_icp_step(device="cuda", perturb: bool = False) -> Result:
    """icp_step (csrc/icp_step.cu) on the small scene's pyramid, the frame
    tracked against itself seen from the check's pose, three iterations
    at each level, and on a ragged crop of level 0 (the top-left 23 x 89
    pixels: 2047, one under 8 x STAGE_ROWS, so seven accumulators fill one
    stage and the eighth ends a row short, on a padded pixel): T, rmse
    and inliers bit-exact against icp_step_reference on the same device
    and on the CPU (the kernel's contract: the CPU's bits on the card)."""
    from ..ops.cuda.icp_kernel import ACC, STAGE_ROWS, icp_step, icp_step_reference
    from ..systems.odometry import ICPOdometry, transform_points

    depth = _scene_frame("cpu").depth
    icp = ICPOdometry(SCENE_K, SCENE_H, SCENE_W, device="cpu")
    pyr = icp._prep(depth)
    ref_pose = torch.from_numpy(SCENE_POSE)
    world_T_ref = torch.from_numpy(np.linalg.inv(SCENE_POSE).astype(np.float32))
    delta = torch.tensor(0.05)
    dist2 = float(np.float32(0.25 * 0.25))
    ragged_h, ragged_w = 23, 89
    assert ragged_h * ragged_w == ACC * STAGE_ROWS - 1
    verts0, normals0, valid0 = pyr[0]
    levels = [(lv, *maps) for lv, maps in enumerate(pyr)]
    levels.append((0, *(m[:ragged_h, :ragged_w] for m in (verts0, normals0, valid0))))
    err = 0.0
    inliers = []
    for lv, verts, normals, valid in levels:
        h, w = verts.shape[:2]
        pack = torch.cat([transform_points(world_T_ref, verts).reshape(-1, 3),
                          transform_points(world_T_ref, normals, False).reshape(-1, 3),
                          valid.reshape(-1, 1).float(), torch.zeros((h * w, 1))], 1)
        src = verts.reshape(-1, 3).contiguous()
        c = icp.cams[lv].intrinsics
        intr = (c.fx, c.fy, c.cx, c.cy)
        host = dev_t = world_T_ref.clone()
        host[:3, 3] += torch.tensor([0.01, -0.005, 0.008])
        dev_t = host.to(device)
        on = lambda t: t.to(device)  # noqa: E731
        for _ in range(3):
            got = icp_step(dev_t + 1e-3 if perturb else dev_t, on(src), on(pack), on(ref_pose),
                           on(delta), intr, w, h, dist2)
            plain = icp_step_reference(dev_t, on(src), on(pack), on(ref_pose), on(delta), intr,
                                       w, h, dist2)
            want = icp_step_reference(host, src, pack, ref_pose, delta, intr, w, h, dist2)
            for a, b, c_ in zip(got, plain, want):
                err = max(err, float((a.cpu().double() - b.cpu().double()).abs().max()),
                          float((a.cpu().double() - c_.double()).abs().max()))
            dev_t, host = plain[0], want[0]
        inliers.append(int(want[2]))
    if min(inliers) <= 100:
        return False, 1.0, f"too few inliers {inliers}"
    return err == 0.0, err, f"bit-exact on the device and against the CPU, inliers {inliers}"


def pose_graph_inputs(n_pad: int, e_pad: int, seed: int, device) -> tuple:
    """pose_graph_solve's inputs for a random graph: n_pad nodes, e_pad -
    e_pad // 4 edges between random distinct nodes with float32 Jacobians
    and residuals (as float64), the rest padded (nodes 0 -> 0, zeros), the
    diagonal of optimize_pose_graph (node 0's gauge prior and the
    damping)."""
    from ..systems.loop_closure import _gauge_diag

    rng = np.random.default_rng(seed)
    e = e_pad - e_pad // 4
    ends = np.stack([rng.choice(n_pad, 2, replace=False) for _ in range(e)])
    ei = np.zeros(e_pad, np.int32)
    ej = np.zeros(e_pad, np.int32)
    ei[:e], ej[:e] = ends[:, 0], ends[:, 1]
    jac = np.zeros((2, e_pad, 6, 6), np.float64)
    rd = np.zeros((e_pad, 6), np.float64)
    jac[:, :e] = rng.normal(0, 1, (2, e, 6, 6)).astype(np.float32)
    rd[:e] = rng.normal(0, 0.01, (e, 6)).astype(np.float32)
    out = [torch.from_numpy(a) for a in (jac[0], jac[1], rd, ei, ej)]
    out.append(_gauge_diag(n_pad, 1e-4, "cpu"))
    return [t.to(device) for t in out]


def verify_pose_graph(device="cuda", perturb: bool = False) -> Result:
    """pose_graph_solve (csrc/pose_graph.cu) on random graphs of 8 nodes
    (16 edges, 4 padded) and 32 nodes (64, 16 padded), at the launch shape
    grid_shape picks, over the fewest CTAs the wrapper takes and with the
    columns in device memory (the layout of the sizes above 275 nodes); and its
    fused entry (the residuals and Jacobians in the kernel) on drifting
    graphs of the same sizes (tests/torch_cases.pose_graph_case's shape,
    from a seed): dx (and the residuals) bit-exact against the plain
    versions on the same device and on the CPU (the kernel's contract: the
    CPU's bits on the card)."""
    from ..ops.cuda import pose_graph_kernel as pk
    from ..systems.loop_closure import _gauge_diag, _inv_rigid

    def diff(a, b) -> float:
        return float((a.cpu().double() - b.cpu().double()).abs().max())

    device = torch.device(device)
    err = 0.0
    for n_pad, e_pad in ((8, 16), (32, 64)):
        host = pose_graph_inputs(n_pad, e_pad, n_pad, "cpu")
        want = pk.pose_graph_solve_reference(*host)
        args = [t.to(device) for t in host]
        plain = pk.pose_graph_solve_reference(*args)
        kernel_args = list(args)
        if perturb:
            kernel_args[2] = kernel_args[2] + 1e-3
        fewest = (pk.shapes(6 * n_pad, torch.cuda.get_device_properties(device)
                            .multi_processor_count)[0] if device.type == "cuda" else None)
        for ctas, shared in ((None, None), (fewest, None), (None, False)):
            got = pk.pose_graph_solve(*kernel_args, ctas=ctas, shared=shared)
            err = max(err, diff(got, plain), diff(got, want))
        # the fused entry on a drifting chain with a loop
        rng = np.random.default_rng(n_pad)
        poses = np.tile(np.eye(4, dtype=np.float32), (n_pad, 1, 1))
        poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.1, (n_pad, 3)), 0)
        ei = np.zeros(e_pad, np.int32)
        ej = np.zeros(e_pad, np.int32)
        ei[:n_pad - 1], ej[:n_pad - 1] = np.arange(n_pad - 1), np.arange(1, n_pad)
        ej[n_pad - 1] = n_pad - 1
        z = np.tile(np.eye(4, dtype=np.float32), (e_pad, 1, 1))
        z[:n_pad, :3, 3] = rng.normal(0, 0.1, (n_pad, 3))
        w = np.zeros(e_pad, np.float32)
        w[:n_pad] = 1.0
        fhost = [torch.from_numpy(poses), torch.from_numpy(ei), torch.from_numpy(ej),
                 _inv_rigid(torch.from_numpy(z)).contiguous(), torch.from_numpy(w),
                 _gauge_diag(n_pad, 1e-4, "cpu")]
        fwant = pk.pose_graph_fused_reference(*fhost)
        fargs = [t.to(device) for t in fhost]
        fplain = pk.pose_graph_fused_reference(*fargs)
        if perturb:
            fargs[4] = fargs[4] * 1.001
        for shared in (None, False):
            fgot = pk.pose_graph_fused(*fargs, shared=shared)
            for a, b, c in zip(fgot, fplain, fwant):
                err = max(err, diff(a, b), diff(a, c))
    return (err == 0.0, err, "both entries bit-exact on the device and against the CPU at m = 48 "
            "and 192")


def verify_raycast(device="cuda", perturb: bool = False) -> Result:
    """The raycast kernel (csrc/raycast.cu, the pose in device memory)
    against raycast_reference (the host pose) on the small scene's volume,
    dense (the march skips blocks and superblocks, its bits in shared
    memory and, forced, in device memory) and hash, from the check's pose:
    hit, depth, rgba and normal bit-identical.  perturb moves the kernel's
    camera by 1 cm."""
    device = resolve_device(device)
    cam = CameraParams.create(CameraIntrinsics.create(*SCENE_K), SCENE_H, SCENE_W)
    pose = SE3.from_matrix(SCENE_POSE)
    moved = SE3(q=pose.q, t=pose.t + np.float32(0.01)) if perturb else pose
    err, hits = 0.0, []
    for backend, layouts in (("dense", ("shared", "device")), ("hash", (None,))):
        vol = _small_scene_step("pallas_fused", device, backend=backend)
        a = raycast_reference(vol, cam, pose, 4.0)
        for layout in layouts:
            b = raycast_kernel.raycast(vol, cam, DevicePose.from_se3(moved, device), 4.0,
                                       layout=layout)
            for f in ("rgba", "normal", "depth", "hit"):
                err += float((getattr(a, f).double() - getattr(b, f).double()).abs().max())
        hits.append(float(a.hit.float().mean()))
    # the dense window (4.1 m across) holds the near edge of the scene's
    # 2-2.8 m depths: a few percent of the pixels hit it
    ok = err == 0.0 and min(hits) > 0.01
    return ok, err, (f"bit-identical, dense (both bit layouts) and hash (hit shares "
                     f"{hits[0]:.2f}, {hits[1]:.2f})")


def verify_superblock_bits(device="cuda", perturb: bool = False) -> Result:
    """The superblock_bits kernel (csrc/raycast_bits.cu) against
    superblock_bits_reference, word for word: on the small scene's dense
    volume (a 2^6 grid, 128 words) and on a 2^8 grid (the bench's, 8192
    words) holding a random 0.1% of its cells, its first and its last
    cell.  perturb takes the kernel's table with one more cell held."""
    device = resolve_device(device)
    vol = _small_scene_step("pallas_fused", device)
    cfg8 = TSDFConfig(grid_log2=8, num_blocks_log2=12)
    rng = np.random.default_rng(7)
    table = np.full(cfg8.grid_cells, -1, np.int32)
    held = rng.choice(cfg8.grid_cells, cfg8.grid_cells // 1000, replace=False)
    table[held] = rng.integers(0, 1 << 12, held.size)
    table[[0, cfg8.grid_cells - 1]] = (5, 6)
    big = SimpleNamespace(cfg=cfg8, device=device, block_table=torch.from_numpy(table).to(device))
    err, words = 0, 0
    for v in (vol, big):
        want = superblock_bits_reference(v)
        if perturb:
            # a block in the first empty superblock
            s, glog2 = v.cfg.grid_side >> 2, v.cfg.grid_log2
            occ = (want.long()[:, None] >> torch.arange(32, device=device)) & 1
            sb = int((occ.reshape(-1)[:s ** 3] == 0).nonzero()[0])
            sx, sy, sz = sb // (s * s), (sb // s) % s, sb % s
            t = v.block_table.clone()
            t[(4 * sx << 2 * glog2) | (4 * sy << glog2) | 4 * sz] = 0
            v = SimpleNamespace(cfg=v.cfg, device=v.device, block_table=t)
        got = raycast_kernel.superblock_bits(v)
        err += int((got != want).sum())
        words += want.numel()
    return err == 0, float(err), f"{words} words equal (words differing: {err})"


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
    ("captured steps vs eager (bit-identical)", verify_captured_steps),
    ("icp_step vs plain, on the device and the CPU (bit-exact)", verify_icp_step),
    ("pose_graph_solve vs plain, on the device and the CPU (bit-exact)", verify_pose_graph),
    ("raycast vs plain, dense and hash (bit-identical)", verify_raycast),
    ("superblock_bits vs plain, 2^6 and 2^8 grids (bit-exact)", verify_superblock_bits),
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
