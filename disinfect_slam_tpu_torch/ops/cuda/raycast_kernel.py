"""raycast: the parity raycaster as one kernel launch a render (and, on
the dense backend's superblock path, one superblock_bits launch before
it), and RaycastStep, the render as a captured step.

Replaces no TPU kernel.  Its counterpart is the JAX raycaster
(disinfect_slam_tpu/ops/raycast.py:186, a `lax.while_loop` of XLA ops,
jitted by `TSDFGrid._raycast`, no Pallas).  The port's plain version,
ops/raycast.py:raycast_reference, marches every pixel in lockstep and reads
the device once a march step, so it can be neither captured nor replayed;
the kernel (csrc/raycast.cu) gives each pixel its own thread, as the CUDA
original's ray_cast_kernel (voxel_tsdf.cu:232-307) does, with early exit,
and repeats the plain version's operations in their order, so that the
card gives the plain version's bits, and the plain version on the card
the CPU's.

The dense backend's superblocks reach the kernel as one occupancy bit a
superblock (superblock_bits, csrc/raycast_bits.cu: one pass over the block
table, in the same step as the march, so a replay after an allocation
reads fresh bits), in shared memory up to BITS_SMEM_BUDGET and from device
memory above it; the hash backend probes in the kernel.  Each wrapper
launches its kernel for a CUDA volume and raises if it cannot; for a CPU
volume it runs its plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ...core.geometry import CameraParams, device_pose
from ...utils.graphs import RenderStep, count_launch
from ..raycast import (RaycastResult, raycast_reference, superblock_bits_reference,
                       superblock_words, uses_superblocks)
from . import build

_C = ctypes

# the bits a CTA copies into shared memory at most (csrc/raycast.cu's
# kBitsSmemBudget): the dynamic shared memory a CTA takes without opting
# in, 32 KB of bits at grid_log2 = 8; at 9 they are 256 KB, more than an SM
# holds, and the kernel reads them from device memory
BITS_SMEM_BUDGET = 48 * 1024
LAYOUTS = ("shared", "device")


def launch_scalars(vol, cam: CameraParams, max_depth: float, step_size: Optional[float]):
    """The kernel's C floats and ints: the inverse intrinsics, the voxel
    size, float32(step_size / voxel_size), max_step, refine_iters, the
    image and the volume's layout; each float rounded to float32 as torch
    rounds a Python float against a float32 tensor."""
    cfg = vol.cfg
    if step_size is None:
        step_size = cfg.truncation / 2.0
    max_step = int(math.ceil(max_depth / step_size))
    k = cam.intrinsics_inv
    org = cfg.grid_origin or (-(cfg.grid_side >> 1),) * 3
    floats = (_C.c_float * 7)(k.fx, k.fy, k.cx, k.cy, cfg.voxel_size,
                              step_size / cfg.voxel_size, float(max_step))
    ints = (_C.c_int * 17)(
        max_step, cfg.refine_iters(step_size), cam.img_h, cam.img_w, cfg.block_len_log2,
        int(cfg.backend != "dense"), int(cfg.raycast_skip), int(uses_superblocks(cfg)),
        cfg.grid_log2, *org, cfg.bucket_mask, cfg.entries_per_bucket_log2, cfg.entry_mask,
        cfg.max_probe, cfg.coord_bits)
    return floats, ints


class RaycastWork(NamedTuple):
    """What a launch records of its work where the caller asks (the bound
    and the order floor in chip_smoke.py): each ray's march samples, a flag
    for each index entry (dense: table cell; hash: probed slot) and each
    pool row whose tsdf it read, and each ray's dependent global loads
    (the march's and the bisection's loads, then the shading's longest
    lookup and one voxel load; a bit read from shared memory or a reused
    lookup loads nothing).  The plain version records nothing."""

    samples: torch.Tensor  # i32 [H, W]
    cells: torch.Tensor  # u8 [grid cells] (dense) or [entries] (hash)
    rows: torch.Tensor  # u8 [blocks]
    loads: torch.Tensor  # i32 [H, W]

    @classmethod
    def zeros(cls, vol, cam: CameraParams) -> "RaycastWork":
        cfg, dev = vol.cfg, vol.device
        cells = cfg.grid_cells if cfg.backend == "dense" else cfg.num_entries
        u8 = dict(dtype=torch.uint8, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        return cls(torch.zeros((cam.img_h, cam.img_w), **i32), torch.zeros((cells,), **u8),
                   torch.zeros((vol.tsdf.shape[0],), **u8),
                   torch.zeros((cam.img_h, cam.img_w), **i32))


def _check(vol, cam: CameraParams) -> torch.device:
    dev = vol.device
    if dev.type != "cuda":
        raise ValueError(f"raycast takes a CPU or CUDA volume, got {dev}")
    if cam.img_h <= 0 or cam.img_w <= 0 or cam.img_h * cam.img_w >= 1 << 31:
        raise ValueError(f"bad image size {cam.img_h}x{cam.img_w}")
    cfg = vol.cfg
    bv = cfg.block_volume
    for name, dtype in (("tsdf", torch.float32), ("rgbw", torch.int32), ("prob", torch.float32)):
        t = getattr(vol, name)
        if t.dtype != dtype or t.dim() != 2 or t.shape[1] != bv or not t.is_contiguous():
            raise ValueError(f"the volume's {name} must be a contiguous {dtype} [blocks, {bv}]")
        if t.device != dev:
            raise ValueError("the volume's tensors must be on one device")
    if vol.tsdf.numel() >= 1 << 31:
        raise ValueError("the kernel indexes the pool's voxels in 32 bits")
    return dev


def superblock_bits(vol) -> torch.Tensor:
    """One launch of the superblock_bits kernel (csrc/raycast_bits.cu) on a
    dense CUDA volume: int32 [superblock_words(cfg)], see
    ops/raycast.py:superblock_bits_reference, which a CPU volume runs."""
    if vol.device.type == "cpu":
        return superblock_bits_reference(vol)
    dev = vol.device
    if dev.type != "cuda":
        raise ValueError(f"superblock_bits takes a CPU or CUDA volume, got {dev}")
    cfg = vol.cfg
    words = superblock_words(cfg)
    if cfg.backend != "dense" or words == 0 or cfg.grid_log2 > 10:
        raise ValueError("superblock bits need a dense grid of 8 to 1024 blocks a side")
    table = vol.block_table
    if (table.dtype != torch.int32 or not table.is_contiguous()
            or table.numel() != cfg.grid_cells or table.data_ptr() % 16):
        raise ValueError("the block table must be a contiguous, 16-byte aligned int32 "
                         "[grid cells]")
    out = torch.empty((words,), dtype=torch.int32, device=dev)
    fn = build.entry("raycast_bits", "dst_superblock_bits",
                     [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p])
    with torch.cuda.device(dev):
        err = fn(build.ptr(table), build.ptr(out), cfg.grid_log2, words, build.stream_of(out))
    count_launch(superblock_bits)
    build.check(err, "superblock_bits")
    return out


superblock_bits.launches = 0


def bits_layout(cfg, layout: Optional[str] = None) -> Optional[str]:
    """Where the march reads the superblock bits: None (no bits: the hash
    backend, no skip, or a grid under 8 blocks a side), "shared" (shared
    memory, up to BITS_SMEM_BUDGET) or "device" (device memory, above it);
    `layout` forces one of the two (shared only within the budget)."""
    if not uses_superblocks(cfg):
        if layout is not None:
            raise ValueError("this volume's march reads no superblock bits")
        return None
    fits = 4 * superblock_words(cfg) <= BITS_SMEM_BUDGET
    if layout is None:
        return "shared" if fits else "device"
    if layout not in LAYOUTS or (layout == "shared" and not fits):
        raise ValueError(f"bits layout {layout!r}: one of {LAYOUTS}, shared only up to "
                         f"{BITS_SMEM_BUDGET} bytes")
    return layout


def launch_shape(vol, layout: Optional[str] = None) -> dict:
    """The march's launch on the current card for the volume's layout
    (bits_layout): CTAs and warps resident an SM, threads a CTA, shared
    memory a CTA (dynamic, static), registers a thread, SMs, pixels a
    warp's tile."""
    cfg = vol.cfg
    where = bits_layout(cfg, layout)
    out = (_C.c_int * 7)()
    fn = build.entry("raycast", "dst_raycast_shape", [_C.c_int, _C.c_int, _C.POINTER(_C.c_int)])
    with torch.cuda.device(vol.device):
        build.check(fn(int(where == "shared"), superblock_words(cfg) if where else 0, out),
                    "raycast (shape)")
    per_sm, threads, smem, regs, static, sms, tile = list(out)
    return {"layout": where, "ctas_per_sm": per_sm, "threads_per_cta": threads,
            "warps_per_sm": per_sm * threads // 32, "dynamic_smem_bytes": smem,
            "static_smem_bytes": static, "registers_per_thread": regs, "sms": sms,
            "tile_pixels": tile}


def raycast(vol, cam: CameraParams, cam_T_world, max_depth: float,
            step_size: Optional[float] = None,
            work: Optional[RaycastWork] = None, layout: Optional[str] = None) -> RaycastResult:
    """One launch of the raycast kernel (see ops/raycast.py:raycast_reference
    for the contract; cam_T_world an SE3, uploaded first, or a DevicePose on
    the volume's device), after one superblock_bits launch where the march
    skips superblocks.  work (RaycastWork.zeros, on the device) receives
    the launch's record of its work; layout forces where the march reads
    the bits (bits_layout).  A CPU volume runs the plain version."""
    if vol.device.type == "cpu":
        return raycast_reference(vol, cam, cam_T_world, max_depth, step_size)
    dev = _check(vol, cam)
    cfg = vol.cfg
    where = bits_layout(cfg, layout)
    if cfg.backend == "dense":
        table, keys = vol.block_table, None
    else:
        table, keys = vol.entry_block, vol.entry_key
    for t in (table, keys):
        if t is not None and (t.dtype != torch.int32 or t.device != dev or not t.is_contiguous()):
            raise ValueError("the volume's index must be contiguous int32 on its device")
    bits = superblock_bits(vol) if where is not None else None
    # world_T_cam's slots (t at 9-11, the quaternion at 12-15)
    pose = device_pose(cam_T_world, dev)
    inv = pose.inverse()
    hgt, wid = cam.img_h, cam.img_w
    u8 = dict(dtype=torch.uint8, device=dev)
    rgba = torch.empty((hgt, wid, 4), **u8)
    normal = torch.empty((hgt, wid, 4), **u8)
    depth = torch.empty((hgt, wid), dtype=torch.float32, device=dev)
    hit = torch.empty((hgt, wid), dtype=torch.bool, device=dev)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the entry's memset
    floats, ints = launch_scalars(vol, cam, max_depth, step_size)
    if work is not None and (tuple(work.samples.shape) != (hgt, wid)
                             or tuple(work.loads.shape) != (hgt, wid)
                             or any(t.device != dev for t in work)):
        raise ValueError("work must be RaycastWork.zeros of this volume and camera")
    fn = build.entry("raycast", "dst_raycast", [_C.c_void_p] * 7 + [_C.POINTER(_C.c_float),
                     _C.POINTER(_C.c_int), _C.c_int, _C.c_int] + [_C.c_void_p] * 10)
    with torch.cuda.device(dev):
        err = fn(build.ptr(table), None if keys is None else build.ptr(keys),
                 None if bits is None else build.ptr(bits),
                 build.ptr(vol.tsdf), build.ptr(vol.rgbw), build.ptr(vol.prob),
                 _C.c_void_p(inv.kernel_ptr()), floats, ints,
                 0 if bits is None else bits.numel(), int(where == "shared"),
                 build.ptr(counter), build.ptr(rgba), build.ptr(normal), build.ptr(depth),
                 build.ptr(hit),
                 *((None,) * 4 if work is None else (build.ptr(t) for t in work)),
                 build.stream_of(depth))
    count_launch(raycast)
    build.check(err, "raycast")
    return RaycastResult(rgba=rgba, normal=normal, depth=depth, hit=hit)


raycast.launches = 0


def chase(nxt: torch.Tensor, steps: int, out: torch.Tensor, start: int = 0) -> None:
    """The order floor's probe (on no path, not counted): one thread taking
    `steps` dependent loads i = nxt[i] from i = start through nxt (int32, a
    cycle of indices, on the card); out int32 [1] the last index."""
    fn = build.entry("raycast", "dst_raycast_chase",
                     [_C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p])
    with torch.cuda.device(nxt.device):
        build.check(fn(build.ptr(nxt), int(start), int(steps), build.ptr(out),
                       build.stream_of(nxt)), "raycast (chase)")


class RaycastStep(RenderStep):
    """raycast as one captured step a view (utils/graphs.RenderStep; the
    JAX package's jitted `TSDFGrid._raycast`), keyed also by max_depth and
    step_size.  The superblock bits' kernel, the tile counter's memset and
    the march are the graph, so a replay after new allocations reads fresh
    bits.  On the CPU it runs the plain raycaster, eagerly."""

    name = "raycast"
    result = RaycastResult

    def render(self, vol, cam: CameraParams, pose, max_depth: float,
               step_size: Optional[float]) -> RaycastResult:
        return raycast(vol, cam, pose, max_depth, step_size)

    def __call__(self, vol, cam: CameraParams, pose, max_depth: float,
                 step_size: Optional[float] = None) -> RaycastResult:
        return self.run(vol, cam, pose, float(max_depth),
                        None if step_size is None else float(step_size))
