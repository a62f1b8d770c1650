"""raycast: the parity raycaster as one kernel launch a render, and
RaycastStep, the render as a captured step.

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

The dense backend's superblock table is built with torch ops before the
launch, in the same step; the hash backend probes in the kernel.  The
wrapper launches the kernel for a CUDA volume and raises if it cannot; for
a CPU volume it runs raycast_reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ...core.geometry import CameraParams, device_pose
from ...utils.graphs import RenderStep, count_launch
from ..raycast import RaycastResult, raycast_reference, superblock_table, uses_superblocks
from . import build

_C = ctypes


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
    in chip_smoke.py): each ray's march samples, and a flag for each index
    entry (dense: table cell; hash: probed slot) and each pool row whose
    tsdf it read.  The plain version records nothing."""

    samples: torch.Tensor  # i32 [H, W]
    cells: torch.Tensor  # u8 [grid cells] (dense) or [entries] (hash)
    rows: torch.Tensor  # u8 [blocks]

    @classmethod
    def zeros(cls, vol, cam: CameraParams) -> "RaycastWork":
        cfg, dev = vol.cfg, vol.device
        cells = cfg.grid_cells if cfg.backend == "dense" else cfg.num_entries
        u8 = dict(dtype=torch.uint8, device=dev)
        return cls(torch.zeros((cam.img_h, cam.img_w), dtype=torch.int32, device=dev),
                   torch.zeros((cells,), **u8), torch.zeros((vol.tsdf.shape[0],), **u8))


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
    return dev


def raycast(vol, cam: CameraParams, cam_T_world, max_depth: float,
            step_size: Optional[float] = None,
            work: Optional[RaycastWork] = None) -> RaycastResult:
    """One launch of the raycast kernel (see ops/raycast.py:raycast_reference
    for the contract; cam_T_world an SE3, uploaded first, or a DevicePose on
    the volume's device).  work (RaycastWork.zeros, on the device) receives
    the launch's record of its work.  A CPU volume runs the plain
    version."""
    if vol.device.type == "cpu":
        return raycast_reference(vol, cam, cam_T_world, max_depth, step_size)
    dev = _check(vol, cam)
    cfg = vol.cfg
    if cfg.backend == "dense":
        table = superblock_table(vol) if uses_superblocks(cfg) else vol.block_table
        keys = None
    else:
        table, keys = vol.entry_block, vol.entry_key
    for t in (table, keys):
        if t is not None and (t.dtype != torch.int32 or t.device != dev or not t.is_contiguous()):
            raise ValueError("the volume's index must be contiguous int32 on its device")
    # world_T_cam's slots (t at 9-11, the quaternion at 12-15)
    pose = device_pose(cam_T_world, dev)
    inv = pose.inverse()
    hgt, wid = cam.img_h, cam.img_w
    u8 = dict(dtype=torch.uint8, device=dev)
    rgba = torch.empty((hgt, wid, 4), **u8)
    normal = torch.empty((hgt, wid, 4), **u8)
    depth = torch.empty((hgt, wid), dtype=torch.float32, device=dev)
    hit = torch.empty((hgt, wid), dtype=torch.bool, device=dev)
    floats, ints = launch_scalars(vol, cam, max_depth, step_size)
    if work is not None and (tuple(work.samples.shape) != (hgt, wid)
                             or any(t.device != dev for t in work)):
        raise ValueError("work must be RaycastWork.zeros of this volume and camera")
    fn = build.entry("raycast", "dst_raycast", [_C.c_void_p] * 6 + [_C.POINTER(_C.c_float),
                     _C.POINTER(_C.c_int)] + [_C.c_void_p] * 8)
    with torch.cuda.device(dev):
        err = fn(build.ptr(table), None if keys is None else build.ptr(keys),
                 build.ptr(vol.tsdf), build.ptr(vol.rgbw), build.ptr(vol.prob),
                 _C.c_void_p(inv.kernel_ptr()), floats, ints, build.ptr(rgba),
                 build.ptr(normal), build.ptr(depth), build.ptr(hit),
                 *((None,) * 3 if work is None else (build.ptr(t) for t in work)),
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
    step_size.  The superblock table and the kernel are the graph.  On the
    CPU it runs the plain raycaster, eagerly."""

    name = "raycast"
    result = RaycastResult

    def render(self, vol, cam: CameraParams, pose, max_depth: float,
               step_size: Optional[float]) -> RaycastResult:
        return raycast(vol, cam, pose, max_depth, step_size)

    def __call__(self, vol, cam: CameraParams, pose, max_depth: float,
                 step_size: Optional[float] = None) -> RaycastResult:
        return self.run(vol, cam, pose, float(max_depth),
                        None if step_size is None else float(step_size))
