"""Per-frame semantic TSDF integration (counterpart of
disinfect_slam_tpu/ops/integrate.py; reference TSDFGrid::Integrate,
voxel_tsdf.cu:347-375).

  allocate   per-pixel DDA candidates -> presence filter against the dense
             table -> compaction -> full-visibility gate -> batched insert
  visible    any-corner frustum test over every entry, cumsum + scatter
             compaction into max_visible rows; the count stays on the
             device as a 0-d tensor that the kernels read (no host sync)
  fuse       the fused sample+fusion kernel (ops/cuda/fuse_kernel.py), or
             the sample kernel (ops/cuda/sample_kernel.py) followed by the
             same fusion formulas as torch ops
  carve      delete visible blocks whose min |tsdf| >= carve_threshold

The arithmetic is written op for op as in the JAX package (same operand
order, float32 throughout), so that the two agree to the ulp where XLA
does not contract or approximate differently.  The volume is updated in
place.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import TSDFConfig
from ..core import voxel as vx
from ..core.geometry import SE3, CameraParams
from ..core.state import TSDFVolume
from . import hash as h
from .cuda.fuse_kernel import fuse_math, fuse_rows
from .cuda.sample_kernel import sample_rows


class FrameInput(NamedTuple):
    """One RGB-D(+semantics) frame on the device (TSDFSystemInput,
    modules/tsdf_module.h:16-30)."""

    rgb: torch.Tensor  # f32 [H, W, 3] in [0, 255]
    depth: torch.Tensor  # f32 [H, W] metres (0 = invalid)
    ht: torch.Tensor  # f32 [H, W] high-touch probability
    lt: torch.Tensor  # f32 [H, W] low-touch probability


def _i32_sum(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def depth_to_range(cam: CameraParams, device) -> torch.Tensor:
    """Per-pixel depth->range factors |K^-1 (u, v, 1)| [H, W]
    (voxel_tsdf.cu:117-120); the norm is the JAX package's sum of
    squares in the same order.  The square root is taken in float64 and
    rounded once to float32, which is the correctly rounded float32 root
    on every device (torch's vectorised CPU float32 sqrt is not)."""
    u = torch.arange(cam.img_w, dtype=torch.float32, device=device)
    v = torch.arange(cam.img_h, dtype=torch.float32, device=device)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    ki = cam.intrinsics_inv
    x = ki.fx * uu + ki.cx
    y = ki.fy * vv + ki.cy
    return torch.sqrt((x * x + y * y + 1.0).double()).float()


def block_visibility(
    block_pos: torch.Tensor,
    cam_T_world: SE3,
    cam: CameraParams,
    cfg: TSDFConfig,
    full: bool,
) -> torch.Tensor:
    """is_block_visible<Full> (voxel_tsdf.cu:59-80) over block coords
    [..., 3]: all 8 corners in view (full) or any corner (not full)."""
    base = vx.block_to_point(block_pos, cfg)
    bx, by, bz = base[..., 0], base[..., 1], base[..., 2]
    bl = cfg.block_len - 1
    vsz = cfg.voxel_size
    intr = cam.intrinsics
    acc = None
    for i in range(8):
        px = (bx + ((i >> 0) & 1) * bl).float() * vsz
        py = (by + ((i >> 1) & 1) * bl).float() * vsz
        pz = (bz + ((i >> 2) & 1) * bl).float() * vsz
        cxp, cyp, czp = cam_T_world.apply_xyz(px, py, pz)
        u = (intr.fx * cxp + intr.cx * czp) / czp
        v = (intr.fy * cyp + intr.cy * czp) / czp
        vis = (
            (u >= 0) & (u <= cam.img_w - 1) & (v >= 0) & (v <= cam.img_h - 1)
            & (czp >= 0)
        )
        if acc is None:
            acc = vis
        else:
            acc = (acc & vis) if full else (acc | vis)
    return acc


# ----------------------------------------------------------------------
# allocation (block_allocate_kernel, voxel_tsdf.cu:104-147)
# ----------------------------------------------------------------------
def _dda_steps(cfg: TSDFConfig) -> int:
    """Static bound on per-pixel DDA samples: the ray spans 2*truncation
    in block-length steps (voxel_tsdf.cu:136-138)."""
    return int(math.ceil(2.0 * cfg.truncation / (cfg.voxel_size * cfg.block_len))) + 1


def generate_candidates(
    frame_depth: torch.Tensor,
    d2r: torch.Tensor,
    cam: CameraParams,
    cam_T_world: SE3,
    world_T_cam: SE3,
    max_depth: float,
    cfg: TSDFConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel DDA over [-trunc, +trunc] around the surface sample of
    every alloc_stride-th pixel.  Returns (packed candidate keys
    [S * h * w], sentinel where invalid; count of samples outside the
    packed coord range, 0-d int32)."""
    hgt, wid = frame_depth.shape
    dev = frame_depth.device
    s = cfg.alloc_stride
    if s > 1:
        frame_depth = frame_depth[::s, ::s]
        d2r = d2r[::s, ::s]
    u = torch.arange(0, wid, s, dtype=torch.float32, device=dev)
    v = torch.arange(0, hgt, s, dtype=torch.float32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    ki = cam.intrinsics_inv
    dx = ki.fx * uu + ki.cx
    dy = ki.fy * vv + ki.cy

    depth = frame_depth
    valid = (depth > 0) & (depth <= max_depth)
    pwx, pwy, pwz = world_T_cam.apply_xyz(dx * depth, dy * depth, depth)
    inv_r = 1.0 / d2r
    rdx, rdy, rdz = world_T_cam.rotate_xyz(dx * inv_r, dy * inv_r, inv_r)
    tr = cfg.truncation
    inv_vs = 1.0 / cfg.voxel_size
    rsgx = (pwx - rdx * tr) * inv_vs
    rsgy = (pwy - rdy * tr) * inv_vs
    rsgz = (pwz - rdz * tr) * inv_vs
    k2 = 2.0 * tr * inv_vs
    rgx, rgy, rgz = rdx * k2, rdy * k2, rdz * k2

    n_steps = torch.ceil(
        torch.maximum(torch.maximum(rgx.abs(), rgy.abs()), rgz.abs()) / cfg.block_len
    ).to(torch.int32)
    nsf = torch.clamp(n_steps.float(), min=1.0)
    svx, svy, svz = rgx / nsf, rgy / nsf, rgz / nsf

    bl_log2 = cfg.block_len_log2
    cb = cfg.coord_bits
    off = 1 << (cb - 1)
    lo, hi = cfg.coord_min, cfg.coord_max
    keys = []
    oob = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(_dda_steps(cfg)):
        bx = vx.round_half_away(rsgx + svx * float(i)).to(torch.int32) >> bl_log2
        by = vx.round_half_away(rsgy + svy * float(i)).to(torch.int32) >> bl_log2
        bz = vx.round_half_away(rsgz + svz * float(i)).to(torch.int32) >> bl_log2
        # the full-visibility gate (voxel_tsdf.cu:144) runs once per unique
        # candidate in allocate_blocks: visibility depends only on the block
        wanted = valid & (i <= n_steps)
        in_rng = (
            (bx >= lo) & (bx <= hi) & (by >= lo) & (by <= hi) & (bz >= lo) & (bz <= hi)
        )
        oob = oob + _i32_sum(wanted & ~in_rng)
        key = torch.where(
            wanted & in_rng,
            (bx + off) | ((by + off) << cb) | ((bz + off) << (2 * cb)),
            vx.sentinel_key(cfg),
        )
        keys.append(key.reshape(-1))
    return torch.cat(keys), oob


def allocate_blocks(
    vol: TSDFVolume,
    frame_depth: torch.Tensor,
    d2r: torch.Tensor,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
) -> TSDFVolume:
    """Dedup candidates and batch-insert them (Allocate,
    voxel_tsdf.cu:377-386), the JAX package's alloc_dedup="filter" path:
    candidates whose cell is already allocated need no insert, so only
    genuinely new keys are compacted (no sort)."""
    cfg = vol.cfg
    if cfg.alloc_dedup != "filter" or cfg.backend != "dense":
        raise NotImplementedError(
            "only alloc_dedup='filter' on the dense backend is ported"
        )
    keys, oob = generate_candidates(
        frame_depth, d2r, cam, cam_T_world, cam_T_world.inverse(), max_depth, cfg
    )
    sent = vx.sentinel_key(cfg)
    # raster-adjacent duplicates are masked first (exact dedup happens in
    # the insert's claim)
    left = torch.cat([keys.new_full((1,), -1), keys[:-1]])
    keys = torch.where(keys == left, sent, keys)

    live = keys < sent
    ks = torch.where(live, keys, 0)
    cb = cfg.coord_bits
    koff = 1 << (cb - 1)
    kmask = (1 << cb) - 1
    cell, in_range = h.table_index_xyz(
        (ks & kmask) - koff, ((ks >> cb) & kmask) - koff,
        ((ks >> (2 * cb)) & kmask) - koff, cfg,
    )
    exists = vol.block_table[cell.long()] >= 0
    # candidates beyond the dense grid are dropped: count them
    oob = oob + _i32_sum(live & ~in_range)
    new = live & in_range & ~exists
    rank = h.cumsum_i32(new) - 1
    cap = cfg.max_candidates
    # compaction into max_candidates slots; slot `cap` is a scratch slot
    # that takes every dropped key
    slot = torch.where(new & (rank < cap), rank, cap).long()
    compact = keys.new_full((cap + 1,), sent)
    compact[slot] = keys
    compact = compact[:cap]
    valid = compact < sent
    coords = vx.unpack_block_coord(torch.where(valid, compact, 0), cfg)
    valid = valid & block_visibility(coords, cam_T_world, cam, cfg, full=True)
    vol, _ = h.insert(vol, coords, valid)
    vol.oob_count = vol.oob_count + oob
    return vol


# ----------------------------------------------------------------------
# visibility sweep + on-device compaction (GatherVisible)
# ----------------------------------------------------------------------
class VisibleSet(NamedTuple):
    """Compacted visible blocks; count stays on the device."""

    entry_idx: torch.Tensor  # i32 [V] entry index (pad: num_entries)
    block_pos: torch.Tensor  # i32 [V, 3]
    pool_idx: torch.Tensor  # i32 [V] (pad: num_blocks)
    mask: torch.Tensor  # bool [V], True exactly for rows < count
    count: torch.Tensor  # i32 [] live rows


def compact_mask(vol: TSDFVolume, mask: torch.Tensor) -> VisibleSet:
    """Stream-compact masked entries into max_visible rows (prefix_sum +
    gather_visible_blocks_kernel, voxel_tsdf.cu:456-472) with cumsum and
    a scatter; entries past the cap are dropped, like the JAX package."""
    cfg = vol.cfg
    vcap = cfg.max_visible
    e = cfg.num_entries
    dev = mask.device
    rank = h.cumsum_i32(mask) - 1
    # slot vcap is a scratch slot for unselected entries
    slot = torch.where(mask & (rank < vcap), rank, vcap).long()
    buf = torch.full((vcap + 1,), e, dtype=torch.int32, device=dev)
    buf[slot] = torch.arange(e, dtype=torch.int32, device=dev)
    entry_idx = buf[:vcap]
    count = torch.clamp(_i32_sum(mask), max=vcap)
    vmask = torch.arange(vcap, device=dev) < count
    safe = entry_idx.clamp(0, e - 1).long()
    block_pos = torch.where(
        vmask[:, None], vx.unpack_block_coord(vol.entry_key[safe], cfg), 0
    )
    pool_idx = torch.where(vmask, vol.entry_block[safe], cfg.num_blocks)
    return VisibleSet(entry_idx, block_pos, pool_idx, vmask, count)


def gather_visible(
    vol: TSDFVolume, cam: CameraParams, cam_T_world: SE3
) -> VisibleSet:
    """check_visibility_kernel (voxel_tsdf.cu:82-93): any-corner frustum
    test over every live entry, then compaction."""
    if vol.cfg.cull_occluded:
        raise NotImplementedError("cull_occluded is not ported yet")
    live = vol.entry_block >= 0
    vis = block_visibility(vol.entry_pos, cam_T_world, cam, vol.cfg, full=False)
    return compact_mask(vol, live & vis)


# ----------------------------------------------------------------------
# fusion (tsdf_integrate_kernel, voxel_tsdf.cu:149-205)
# ----------------------------------------------------------------------
def fuse_visible(
    vol: TSDFVolume,
    vis: VisibleSet,
    frame: FrameInput,
    d2r: torch.Tensor,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
) -> Tuple[TSDFVolume, torch.Tensor]:
    """Weighted running-average fusion of every visible block's 512
    voxels, in place on the pool rows.  Returns (volume, min |tsdf| per
    visible row; rows past vis.count are unspecified)."""
    cfg = vol.cfg
    bl = cfg.block_len_log2
    lmask = cfg.block_len - 1
    dev = vol.device
    vidx = torch.arange(cfg.block_volume, dtype=torch.int32, device=dev)
    ox = (vidx & lmask)[None, :]
    oy = ((vidx >> bl) & lmask)[None, :]
    oz = ((vidx >> (2 * bl)) & lmask)[None, :]
    vsz = cfg.voxel_size
    px = ((vis.block_pos[:, 0:1] << bl) + ox).float() * vsz
    py = ((vis.block_pos[:, 1:2] << bl) + oy).float() * vsz
    pz = ((vis.block_pos[:, 2:3] << bl) + oz).float() * vsz
    xc, yc, z = cam_T_world.apply_xyz(px, py, pz)  # [V, 512] camera coords
    del px, py, pz
    intr = cam.intrinsics
    u = vx.round_half_away((intr.fx * xc + intr.cx * z) / z).to(torch.int32)
    v = vx.round_half_away((intr.fy * yc + intr.cy * z) / z).to(torch.int32)
    del xc, yc

    # one stacked image carries every per-pixel channel: depth, depth->
    # range, r, g, b, ht, lt, pad (32 B per pixel)
    stacked = torch.stack(
        [frame.depth, d2r, frame.rgb[..., 0], frame.rgb[..., 1],
         frame.rgb[..., 2], frame.ht, frame.lt, torch.zeros_like(frame.depth)],
        dim=-1,
    ).contiguous()
    consts = dict(
        truncation=cfg.truncation, max_depth=max_depth,
        max_weight=cfg.max_weight, prob_eps=cfg.prob_eps,
    )

    if cfg.sampler in ("gather", "pallas"):
        # two stages: the sample kernel, then the fusion formulas as torch
        # ops on the gathered pool rows, written back to the live rows
        chans, sample_ok = sample_rows(stacked, u, v, vis.count)
        pool = vis.pool_idx.clamp(0, cfg.num_blocks - 1).long()
        t_fin, w_fin, p_fin = fuse_math(
            chans, z, vis.mask[:, None] & sample_ok,
            vol.tsdf[pool], vol.rgbw[pool], vol.prob[pool], **consts,
        )
        h.put_drop_(vol.tsdf, vis.pool_idx, t_fin, vis.mask)
        h.put_drop_(vol.rgbw, vis.pool_idx, w_fin, vis.mask)
        h.put_drop_(vol.prob, vis.pool_idx, p_fin, vis.mask)
        return vol, t_fin.abs().amin(dim=-1)

    in_img = (u >= 0) & (u < cam.img_w) & (v >= 0) & (v < cam.img_h)
    us = u.clamp_(0, cam.img_w - 1)
    vs = v.clamp_(0, cam.img_h - 1)
    min_abs = fuse_rows(
        stacked, us, vs, z, vis.mask[:, None] & in_img, vis.pool_idx,
        vis.count, vol.tsdf, vol.rgbw, vol.prob, **consts,
    )
    return vol, min_abs


def space_carve(
    vol: TSDFVolume, vis: VisibleSet, min_abs: torch.Tensor
) -> TSDFVolume:
    """Delete visible blocks whose min |tsdf| >= carve threshold
    (voxel_tsdf.cu:207-230, threshold 0.9 at :485)."""
    doomed = vis.mask & (min_abs >= vol.cfg.carve_threshold)
    return h.delete_entries(vol, vis.entry_idx, doomed)


def integrate(
    vol: TSDFVolume,
    frame: FrameInput,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
    allocate: bool = True,
) -> TSDFVolume:
    """One frame of semantic TSDF fusion, in place on `vol`.

    allocate=False skips block allocation (the alloc_every cadence):
    geometry first seen on a skipped frame starts fusing on a later one,
    the fail-open latency of the reference's lock misses
    (voxel_hash.cu:83-89)."""
    d2r = depth_to_range(cam, vol.device)
    if allocate:
        vol = allocate_blocks(vol, frame.depth, d2r, cam, cam_T_world, max_depth)
    vis = gather_visible(vol, cam, cam_T_world)
    vol, min_abs = fuse_visible(vol, vis, frame, d2r, cam, cam_T_world, max_depth)
    return space_carve(vol, vis, min_abs)
