"""splat_zbuf_blocks / splat_payload_blocks: the z-buffer and payload
merges of the splat renderer, and the renders built on them.

Counterparts of the TPU kernels `splat_zbuf_rows` (K4) and
`splat_payload_rows` (K5) in disinfect_slam_tpu/ops/pallas/splat_kernel.py
and of its `splat_depth_pallas` / `splat_render_pallas`.  The CUDA
kernels (csrc/splat_rows.cu, csrc/splat_zbuf_tile.cuh,
csrc/splat_project.cuh) take the surface blocks' positions and pool
indices, the tsdf pool, the pose and the camera, and project every voxel
in registers (no [S, 512] plane of pixels or depths is written); K4
merges each block's footprint in a shared-memory tile and sends each
covered pixel to the z-buffer with one global atomic, K5 stages the
block's window of the final z-buffer, merges the winners' payload words in
a shared tile and sends each covered pixel with one global atomic; a
block whose footprint outgrows the tile merges per voxel with global
atomics in either kernel.  There is no footprint limit and no overflow
scatter: the buffers equal the plain torch scatter reductions of
ops/render_fast.py bit for bit.

Each wrapper launches its kernel for CUDA tensors and raises if it
cannot; for CPU tensors it runs its `*_reference`, the plain torch
version with the same signature: render_fast.project_splat_rows, then
the plane contract of the TPU kernels, `splat_zbuf_rows_reference` and
`splat_payload_rows_reference` (floor pixels and depths as [S, 512]
planes, kept for the Pallas parity tests).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...core.geometry import SE3, CameraParams
from .. import render_fast as rf
from . import build

_C = ctypes
BIG = rf.BIG


def _live(dq: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(dq.shape[0], device=dq.device)
    return (rows < count)[:, None] & (dq < BIG)


def splat_zbuf_rows_reference(
    u0: torch.Tensor, v0: torch.Tensor, dq: torch.Tensor, count: torch.Tensor,
    img_h: int, img_w: int,
) -> torch.Tensor:
    """The plane contract of the TPU kernel, in plain torch.  u0, v0 i32
    [S, 512] floor pixel of each voxel; dq i32 [S, 512] quantized depth,
    BIG for a voxel outside the surface band; count i32 [] live rows (rows
    at or past it are skipped).

    Returns the z-buffer i32 [img_h * img_w]: the min of dq over the 2x2
    footprints (u0 + du, v0 + dv) that land in the image, BIG where none
    does."""
    pix = rf.footprint(u0, v0, _live(dq, count), img_h, img_w)
    return rf.zbuf_scatter(pix, dq, img_h * img_w)


def splat_payload_rows_reference(
    u0: torch.Tensor, v0: torch.Tensor, dq: torch.Tensor,
    pool_idx: torch.Tensor, rgbw: torch.Tensor, prob: torch.Tensor,
    count: torch.Tensor, zbuf: torch.Tensor, img_h: int, img_w: int,
) -> torch.Tensor:
    """The plane contract of the TPU kernel, in plain torch.  u0, v0, dq,
    count as for splat_zbuf_rows_reference; pool_idx i32 [S] pool row of
    each row (clipped into the pool); rgbw i32 [B, 512] (u32 bits) and
    prob f32 [B, 512] the pool; zbuf the final z-buffer.

    Returns the payload buffer, u32 bits as i32 [img_h * img_w]: at each
    pixel, the max as u32 of the packed words
    (p8 << 24 | r << 16 | g << 8 | b) of the live voxels whose dq equals
    the z-buffer there; 0 where none does."""
    pix = rf.footprint(u0, v0, _live(dq, count), img_h, img_w)
    pool = pool_idx.clamp(0, rgbw.shape[0] - 1).long()
    packed = rf.pack_payload_rgbw(rgbw[pool], prob[pool])
    return rf.payload_scatter(pix, dq, packed, zbuf, img_h * img_w)


def splat_planes(
    block_pos: torch.Tensor, pool_idx: torch.Tensor, count: torch.Tensor,
    tsdf: torch.Tensor, *, cam_T_world: SE3, cam: CameraParams, voxel_size: float,
    truncation: float, max_depth: float, band: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block rows as the plane contract's (u0, v0, dq) i32 [S, 512]:
    render_fast.project_splat_rows, floor pixels, BIG outside the band."""
    uf, vf, depth_q, surf = rf.project_splat_rows(
        block_pos, pool_idx, count, tsdf, cam_T_world, cam, voxel_size, truncation,
        max_depth, band)
    u0 = torch.floor(uf).to(torch.int32)
    v0 = torch.floor(vf).to(torch.int32)
    return u0, v0, torch.where(surf, depth_q, BIG)


def _host_live_rows(block_pos: torch.Tensor, pool_idx: torch.Tensor, count: torch.Tensor):
    """The rows a plain version projects: on the host only the live ones
    (the rows past count are masked out either way, and a host count
    reads without a sync); on a device all of them."""
    if count.device.type != "cpu":
        return block_pos, pool_idx
    n = int(count)
    return block_pos[:n], pool_idx[:n]


def splat_zbuf_blocks_reference(
    block_pos: torch.Tensor, pool_idx: torch.Tensor, count: torch.Tensor,
    tsdf: torch.Tensor, *, cam_T_world: SE3, cam: CameraParams, voxel_size: float,
    truncation: float, max_depth: float, band: float = 1.25,
) -> torch.Tensor:
    """Plain version.  block_pos i32 [S, 3] block coordinates of the
    surface rows; pool_idx i32 [S] their pool rows (clipped into the
    pool); count i32 [] live rows; tsdf f32 [B, 512] the pool; the pose,
    the camera (intrinsics and image size), the voxel size and truncation,
    max_depth and the band half-width in voxels of
    render_fast.project_splat_rows.

    Returns the z-buffer i32 [cam.img_h * cam.img_w]: the min of the
    quantized corrected depth of the live rows' surface-band voxels over
    their 2x2 footprints in the image, BIG where none lands."""
    block_pos, pool_idx = _host_live_rows(block_pos, pool_idx, count)
    u0, v0, dq = splat_planes(block_pos, pool_idx, count, tsdf, cam_T_world=cam_T_world,
                              cam=cam, voxel_size=voxel_size, truncation=truncation,
                              max_depth=max_depth, band=band)
    return splat_zbuf_rows_reference(u0, v0, dq, count, cam.img_h, cam.img_w)


def splat_payload_blocks_reference(
    block_pos: torch.Tensor, pool_idx: torch.Tensor, count: torch.Tensor,
    tsdf: torch.Tensor, rgbw: torch.Tensor, prob: torch.Tensor, zbuf: torch.Tensor, *,
    cam_T_world: SE3, cam: CameraParams, voxel_size: float, truncation: float,
    max_depth: float, band: float = 1.25,
) -> torch.Tensor:
    """Plain version.  The rows and keywords of
    splat_zbuf_blocks_reference; rgbw i32 [B, 512] (u32 bits) and prob f32
    [B, 512] the pool's payload; zbuf the final z-buffer.

    Returns the payload buffer, u32 bits as i32 [H * W]: at each pixel,
    the max as u32 of the packed words (p8 << 24 | r << 16 | g << 8 | b)
    of the surface voxels whose depth equals the z-buffer there; 0 where
    none does."""
    block_pos, pool_idx = _host_live_rows(block_pos, pool_idx, count)
    u0, v0, dq = splat_planes(block_pos, pool_idx, count, tsdf, cam_T_world=cam_T_world,
                              cam=cam, voxel_size=voxel_size, truncation=truncation,
                              max_depth=max_depth, band=band)
    return splat_payload_rows_reference(u0, v0, dq, pool_idx, rgbw, prob, count, zbuf,
                                        cam.img_h, cam.img_w)


def _check_inputs(cam: CameraParams, **named) -> torch.device:
    """Raise unless the kernels can take these tensors: one CUDA device,
    block_pos i32 [S, 3], pool_idx i32 [S], count one i32, the pool arrays
    [B, 512] (tsdf f32, rgbw i32, prob f32), zbuf and branch_counts i32
    [H * W] and [2], all contiguous; an image of fewer than 2^31 pixels."""
    block_pos = named["block_pos"]
    dev = block_pos.device
    if dev.type != "cuda":
        raise ValueError(f"splat kernels take CPU or CUDA tensors, got {dev}")
    img_h, img_w = cam.img_h, cam.img_w
    if img_h <= 0 or img_w <= 0 or img_h * img_w >= 1 << 31:
        raise ValueError(f"bad image size {img_h}x{img_w}")
    rows, blocks = block_pos.shape[0], named["tsdf"].shape[0]
    want = {"block_pos": (torch.int32, (rows, 3)), "pool_idx": (torch.int32, (rows,)),
            "count": (torch.int32, None), "tsdf": (torch.float32, (blocks, 512)),
            "rgbw": (torch.int32, (blocks, 512)), "prob": (torch.float32, (blocks, 512)),
            "zbuf": (torch.int32, (img_h * img_w,)), "branch_counts": (torch.int32, (2,))}
    for name, t in named.items():
        dtype, shape = want[name]
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if named["count"].numel() != 1:
        raise ValueError("count must be a one-element i32 tensor")
    return dev


def c_scalars(cam_T_world: SE3, cam: CameraParams, voxel_size: float, truncation: float,
             max_depth: float, band: float):
    """The pose, intrinsics and constants as the C floats the kernels
    take: rounded to float32 as torch rounds a Python float against a
    float32 tensor (band_tsdf from the same double expression as the
    plain version)."""
    k = cam.intrinsics
    return ((_C.c_float * 12)(*cam_T_world.rotation_entries(),
                              *(float(x) for x in cam_T_world.t)),
            (_C.c_float * 4)(k.fx, k.fy, k.cx, k.cy),
            (_C.c_float * 4)(voxel_size, truncation, max_depth,
                             band * voxel_size / truncation))


def splat_zbuf_blocks(
    block_pos: torch.Tensor, pool_idx: torch.Tensor, count: torch.Tensor,
    tsdf: torch.Tensor, *, cam_T_world: SE3, cam: CameraParams, voxel_size: float,
    truncation: float, max_depth: float, band: float = 1.25,
    branch_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Project the surface rows and min-merge their depths into a
    z-buffer; see splat_zbuf_blocks_reference for the contract.
    branch_counts, an i32 [2] CUDA tensor, takes the rows the kernel
    merged through its shared-memory tile and through per-voxel global
    atomics (rows with no footprint pixel in the image take neither); the
    plain version has no branches and leaves it alone."""
    geometry = dict(cam_T_world=cam_T_world, cam=cam, voxel_size=voxel_size,
                    truncation=truncation, max_depth=max_depth, band=band)
    if block_pos.device.type == "cpu":
        return splat_zbuf_blocks_reference(block_pos, pool_idx, count, tsdf, **geometry)
    opt = {} if branch_counts is None else {"branch_counts": branch_counts}
    dev = _check_inputs(cam, block_pos=block_pos, pool_idx=pool_idx, count=count, tsdf=tsdf,
                        **opt)
    zbuf = torch.full((cam.img_h * cam.img_w,), BIG, dtype=torch.int32, device=dev)
    fn = build.entry("splat_rows", "dst_splat_zbuf_rows", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p,
        _C.POINTER(_C.c_float), _C.POINTER(_C.c_float), _C.POINTER(_C.c_float),
        _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ])
    pose, intr, consts = c_scalars(**geometry)
    with torch.cuda.device(dev):
        err = fn(build.ptr(block_pos), build.ptr(pool_idx), build.ptr(count),
                 block_pos.shape[0], tsdf.shape[0], build.ptr(tsdf), pose, intr, consts,
                 cam.img_h, cam.img_w, build.ptr(zbuf),
                 None if branch_counts is None else build.ptr(branch_counts),
                 build.stream_of(block_pos))
    splat_zbuf_blocks.launches += 1
    build.check(err, "splat_zbuf_blocks")
    return zbuf


splat_zbuf_blocks.launches = 0


def splat_payload_blocks(
    block_pos: torch.Tensor, pool_idx: torch.Tensor, count: torch.Tensor,
    tsdf: torch.Tensor, rgbw: torch.Tensor, prob: torch.Tensor, zbuf: torch.Tensor, *,
    cam_T_world: SE3, cam: CameraParams, voxel_size: float, truncation: float,
    max_depth: float, band: float = 1.25, branch_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Project the surface rows and max-merge the winners' packed payload
    words; see splat_payload_blocks_reference for the contract.  Launched
    on the same stream after splat_zbuf_blocks, whose final z-buffer it
    reads; branch_counts as for splat_zbuf_blocks."""
    geometry = dict(cam_T_world=cam_T_world, cam=cam, voxel_size=voxel_size,
                    truncation=truncation, max_depth=max_depth, band=band)
    if block_pos.device.type == "cpu":
        return splat_payload_blocks_reference(block_pos, pool_idx, count, tsdf, rgbw, prob,
                                              zbuf, **geometry)
    opt = {} if branch_counts is None else {"branch_counts": branch_counts}
    dev = _check_inputs(cam, block_pos=block_pos, pool_idx=pool_idx, count=count, tsdf=tsdf,
                        rgbw=rgbw, prob=prob, zbuf=zbuf, **opt)
    pbuf = torch.zeros((cam.img_h * cam.img_w,), dtype=torch.int32, device=dev)
    fn = build.entry("splat_rows", "dst_splat_payload_rows", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p,
        _C.c_void_p, _C.c_void_p, _C.POINTER(_C.c_float), _C.POINTER(_C.c_float),
        _C.POINTER(_C.c_float), _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p,
        _C.c_void_p, _C.c_void_p,
    ])
    pose, intr, consts = c_scalars(**geometry)
    with torch.cuda.device(dev):
        err = fn(build.ptr(block_pos), build.ptr(pool_idx), build.ptr(count),
                 block_pos.shape[0], tsdf.shape[0], build.ptr(tsdf), build.ptr(rgbw),
                 build.ptr(prob), pose, intr, consts, cam.img_h, cam.img_w,
                 build.ptr(zbuf), build.ptr(pbuf),
                 None if branch_counts is None else build.ptr(branch_counts),
                 build.stream_of(block_pos))
    splat_payload_blocks.launches += 1
    build.check(err, "splat_payload_blocks")
    return pbuf


splat_payload_blocks.launches = 0


def _rows(vol, cam, cam_T_world, max_depth, band, surf_cap):
    """The surface rows of a render and the kernels' keywords: (the
    VisibleSet, surface blocks dropped, geometry keywords)."""
    vis, overflow = rf.splat_visible(vol, cam, cam_T_world, band, surf_cap)
    geometry = dict(cam_T_world=cam_T_world, cam=cam, voxel_size=vol.cfg.voxel_size,
                    truncation=vol.cfg.truncation, max_depth=max_depth, band=band)
    return vis, overflow, geometry


# The TPU kernels' layout knobs (overflow_cap, tb, interpret, cw, ch) are
# accepted and ignored: the atomic merge has no patch, no footprint limit
# and no overflow path, so they cannot change a result.
def splat_buffers_cuda(
    vol, cam, cam_T_world, max_depth: float, band: float = 1.25,
    surf_cap=rf.DEFAULT_SURF_CAP, **_tpu_only,
):
    """render_fast.splat_buffers through the two kernels -> (zbuf, pbuf,
    surf_overflow, surface blocks kept)."""
    vis, overflow, geometry = _rows(vol, cam, cam_T_world, max_depth, band, surf_cap)
    zbuf = splat_zbuf_blocks(vis.block_pos, vis.pool_idx, vis.count, vol.tsdf, **geometry)
    pbuf = splat_payload_blocks(vis.block_pos, vis.pool_idx, vis.count, vol.tsdf, vol.rgbw,
                                vol.prob, zbuf, **geometry)
    return zbuf, pbuf, overflow, vis.count


def splat_depth(
    vol, cam, cam_T_world, max_depth: float, band: float = 1.25,
    surf_cap=rf.DEFAULT_SURF_CAP, plain: bool = False, **_tpu_only,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth (camera z) and hit images [H, W] from the z-buffer kernel
    alone (splat_depth_pallas); plain=True takes the z-buffer from its
    plain version on any device instead (the same bits)."""
    vis, _, geometry = _rows(vol, cam, cam_T_world, max_depth, band, surf_cap)
    zbuf_fn = splat_zbuf_blocks_reference if plain else splat_zbuf_blocks
    zbuf = zbuf_fn(vis.block_pos, vis.pool_idx, vis.count, vol.tsdf, **geometry)
    hit = (zbuf < BIG).reshape(cam.img_h, cam.img_w)
    depth = torch.where(hit, zbuf.reshape(hit.shape).float() / 4096.0, 0.0)
    return depth, hit


def splat_render_cuda(
    vol, cam, cam_T_world, max_depth: float, band: float = 1.25,
    surf_cap=rf.DEFAULT_SURF_CAP, **_tpu_only,
):
    """Full splat render through the two kernels (splat_render_pallas);
    equals render_fast.splat_render bit for bit."""
    zbuf, pbuf, overflow, _ = splat_buffers_cuda(vol, cam, cam_T_world,
                                                 max_depth, band, surf_cap)
    return rf.images_from_buffers(zbuf, pbuf, cam, surf_overflow=overflow)
