"""splat_zbuf_rows / splat_payload_rows: the z-buffer and payload merges
of the splat renderer, and the renders built on them.

Counterparts of the TPU kernels `splat_zbuf_rows` (K4) and
`splat_payload_rows` (K5) in disinfect_slam_tpu/ops/pallas/splat_kernel.py
and of its `splat_depth_pallas` / `splat_render_pallas`.  The CUDA
kernels (csrc/splat_rows.cu, csrc/splat_zbuf_tile.cuh): K4 merges each
surface block's footprint in a shared-memory tile and sends each covered
pixel to the z-buffer with one global atomic, or, for a footprint larger
than the tile, merges per voxel with global atomics; K5 takes one global
atomic per winning footprint pixel.  There is no footprint limit and no
overflow scatter: the buffers equal the plain torch scatter reductions of
ops/render_fast.py bit for bit.

Each wrapper launches its kernel for CUDA tensors and raises if it
cannot; for CPU tensors it runs its `*_reference`, the plain torch
version with the same signature.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

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
    """Plain version.  u0, v0 i32 [S, 512] floor pixel of each voxel; dq
    i32 [S, 512] quantized depth, BIG for a voxel outside the surface
    band; count i32 [] live rows (rows at or past it are skipped).

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
    """Plain version.  u0, v0, dq, count as for splat_zbuf_rows; pool_idx
    i32 [S] pool row of each row (clipped into the pool); rgbw i32 [B, 512]
    (u32 bits) and prob f32 [B, 512] the pool; zbuf the final z-buffer.

    Returns the payload buffer, u32 bits as i32 [img_h * img_w]: at each
    pixel, the max as u32 of the packed words
    (p8 << 24 | r << 16 | g << 8 | b) of the live voxels whose dq equals
    the z-buffer there; 0 where none does."""
    pix = rf.footprint(u0, v0, _live(dq, count), img_h, img_w)
    pool = pool_idx.clamp(0, rgbw.shape[0] - 1).long()
    packed = rf.pack_payload_rgbw(rgbw[pool], prob[pool])
    return rf.payload_scatter(pix, dq, packed, zbuf, img_h * img_w)


_DTYPES = dict(u0=torch.int32, v0=torch.int32, dq=torch.int32, count=torch.int32,
               pool_idx=torch.int32, rgbw=torch.int32, prob=torch.float32,
               zbuf=torch.int32)


def _check_inputs(img_h: int, img_w: int, **named) -> torch.device:
    """Raise unless the kernels can take these tensors: one CUDA device,
    the dtypes above, rows [S, 512] (pool [B, 512]), count 0-d, zbuf
    [img_h * img_w], all contiguous."""
    u0 = named["u0"]
    dev = u0.device
    if dev.type != "cuda":
        raise ValueError(f"splat kernels take CPU or CUDA tensors, got {dev}")
    if u0.dim() != 2 or u0.shape[1] != 512:
        raise ValueError(f"u0 must be i32 [S, 512], got {tuple(u0.shape)}")
    if img_h <= 0 or img_w <= 0 or img_h * img_w >= 1 << 31:
        raise ValueError(f"bad image size {img_h}x{img_w}")
    rows = tuple(u0.shape)
    shapes = dict(v0=rows, dq=rows, count=(), pool_idx=rows[:1], zbuf=(img_h * img_w,))
    if "rgbw" in named:
        if named["rgbw"].dim() != 2 or named["rgbw"].shape[1] != 512:
            raise ValueError("rgbw must be i32 [B, 512]")
        shapes["prob"] = tuple(named["rgbw"].shape)
    for name, t in named.items():
        if t.dtype != _DTYPES[name]:
            raise ValueError(f"{name} must be {_DTYPES[name]}, got {t.dtype}")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must have shape {shapes[name]}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    return dev


def splat_zbuf_rows(
    u0: torch.Tensor, v0: torch.Tensor, dq: torch.Tensor, count: torch.Tensor,
    img_h: int, img_w: int, branch_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Min-merge the surface voxels' depths into a z-buffer; see
    splat_zbuf_rows_reference for the contract.  branch_counts, an i32
    [2] CUDA tensor, takes the rows the kernel merged through its
    shared-memory tile and through per-voxel global atomics (rows with no
    footprint pixel in the image take neither); the plain version has no
    branches and leaves it alone."""
    if u0.device.type == "cpu":
        return splat_zbuf_rows_reference(u0, v0, dq, count, img_h, img_w)
    dev = _check_inputs(img_h, img_w, u0=u0, v0=v0, dq=dq, count=count)
    if branch_counts is not None and (
            branch_counts.dtype != torch.int32 or tuple(branch_counts.shape) != (2,)
            or branch_counts.device != dev or not branch_counts.is_contiguous()):
        raise ValueError("branch_counts must be a contiguous i32 [2] tensor on the "
                         "kernel's device")
    zbuf = torch.full((img_h * img_w,), BIG, dtype=torch.int32, device=dev)
    fn = build.entry("splat_rows", "dst_splat_zbuf_rows", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
        _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ])
    branches = None if branch_counts is None else build.ptr(branch_counts)
    with torch.cuda.device(dev):
        err = fn(build.ptr(u0), build.ptr(v0), build.ptr(dq), build.ptr(count),
                 u0.shape[0], img_h, img_w, build.ptr(zbuf), branches,
                 build.stream_of(u0))
    splat_zbuf_rows.launches += 1
    build.check(err, "splat_zbuf_rows")
    return zbuf


splat_zbuf_rows.launches = 0


def splat_payload_rows(
    u0: torch.Tensor, v0: torch.Tensor, dq: torch.Tensor,
    pool_idx: torch.Tensor, rgbw: torch.Tensor, prob: torch.Tensor,
    count: torch.Tensor, zbuf: torch.Tensor, img_h: int, img_w: int,
) -> torch.Tensor:
    """Max-merge the winners' packed payload words; see
    splat_payload_rows_reference for the contract.  Launched on the same
    stream after splat_zbuf_rows, whose final z-buffer it reads."""
    if u0.device.type == "cpu":
        return splat_payload_rows_reference(u0, v0, dq, pool_idx, rgbw, prob,
                                            count, zbuf, img_h, img_w)
    dev = _check_inputs(img_h, img_w, u0=u0, v0=v0, dq=dq, count=count,
                        pool_idx=pool_idx, rgbw=rgbw, prob=prob, zbuf=zbuf)
    pbuf = torch.zeros((img_h * img_w,), dtype=torch.int32, device=dev)
    fn = build.entry("splat_rows", "dst_splat_payload_rows", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int, _C.c_int,
        _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ])
    with torch.cuda.device(dev):
        err = fn(build.ptr(u0), build.ptr(v0), build.ptr(dq), build.ptr(pool_idx),
                 rgbw.shape[0], build.ptr(rgbw), build.ptr(prob), build.ptr(count),
                 u0.shape[0], img_h, img_w, build.ptr(zbuf), build.ptr(pbuf),
                 build.stream_of(u0))
    splat_payload_rows.launches += 1
    build.check(err, "splat_payload_rows")
    return pbuf


splat_payload_rows.launches = 0


def _kernel_inputs(vol, cam, cam_T_world, max_depth, band, surf_cap):
    """The shared projection, cut down to the kernels' inputs: floor
    pixels, depth (BIG outside the surface band) and the kept rows."""
    uf, vf, depth_q, surf, vis, overflow = rf._project_for_splat(
        vol, cam, cam_T_world, max_depth, band, surf_cap)
    u0 = torch.floor(uf).to(torch.int32)
    v0 = torch.floor(vf).to(torch.int32)
    dq = torch.where(surf, depth_q, BIG)
    return u0, v0, dq, vis, overflow


# The TPU kernels' layout knobs (overflow_cap, tb, interpret, cw, ch) are
# accepted and ignored: the atomic merge has no patch, no footprint limit
# and no overflow path, so they cannot change a result.
def splat_buffers_cuda(
    vol, cam, cam_T_world, max_depth: float, band: float = 1.25,
    surf_cap=rf.DEFAULT_SURF_CAP, **_tpu_only,
):
    """render_fast.splat_buffers through the two kernels -> (zbuf, pbuf,
    surf_overflow, surface blocks kept)."""
    u0, v0, dq, vis, overflow = _kernel_inputs(vol, cam, cam_T_world, max_depth,
                                               band, surf_cap)
    h, w = cam.img_h, cam.img_w
    zbuf = splat_zbuf_rows(u0, v0, dq, vis.count, h, w)
    pbuf = splat_payload_rows(u0, v0, dq, vis.pool_idx, vol.rgbw, vol.prob,
                              vis.count, zbuf, h, w)
    return zbuf, pbuf, overflow, vis.count


def splat_depth(
    vol, cam, cam_T_world, max_depth: float, band: float = 1.25,
    surf_cap=rf.DEFAULT_SURF_CAP, **_tpu_only,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth (camera z) and hit images [H, W] from the z-buffer kernel
    alone (splat_depth_pallas)."""
    u0, v0, dq, vis, _ = _kernel_inputs(vol, cam, cam_T_world, max_depth,
                                        band, surf_cap)
    zbuf = splat_zbuf_rows(u0, v0, dq, vis.count, cam.img_h, cam.img_w)
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
