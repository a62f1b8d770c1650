"""Per-frame semantic TSDF integration (counterpart of
disinfect_slam_tpu/ops/integrate.py; reference TSDFGrid::Integrate,
voxel_tsdf.cu:347-375).

  allocate   per-pixel DDA candidates -> dedup (the presence filter
             against the dense table, or a sort: the hash backend and
             alloc_dedup="sort") -> full-visibility gate -> batched insert
  visible    any-corner frustum test over every entry (with
             cfg.cull_occluded, less the blocks the frame's nearer surface
             occludes), cumsum + scatter compaction into max_visible
             rows; the count stays on the device as a 0-d tensor that the
             kernels read (no host sync)
  fuse       the fused projection+sample+fusion kernel
             (ops/cuda/fuse_kernel.py), or the projection as torch ops, the
             sample kernel (ops/cuda/sample_kernel.py) and the same fusion
             formulas as torch ops
  carve      delete visible blocks whose min |tsdf| >= carve_threshold

The arithmetic is written op for op as in the JAX package (same operand
order, float32 throughout), so that the two agree to the ulp where XLA
does not contract or approximate differently.  The volume is updated in
place.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import TSDFConfig
from ..core import voxel as vx
from ..core.geometry import SE3, CameraParams
from ..core.state import TSDFVolume
from . import hash as h
from .cuda.fuse_kernel import fuse_math, fuse_rows, project_rows
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


def unique_keys(keys: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The ascending distinct values of keys, cut to or padded to `size`
    with `fill` (jnp.unique(keys, size=size, fill_value=fill)): a sort,
    then the first key of every run compacted by its rank into `size`
    slots, slot `size` a scratch slot for the rest.  Unlike torch.unique
    it keeps the output shape fixed, so the device is never waited on."""
    s = torch.sort(keys).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = h.cumsum_i32(first) - 1
    slot = torch.where(first & (rank < size), rank, size).long()
    out = s.new_full((size + 1,), fill)
    out[slot] = s
    return out[:size]


def allocate_blocks(
    vol: TSDFVolume,
    frame_depth: torch.Tensor,
    d2r: torch.Tensor,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
) -> TSDFVolume:
    """Dedup candidates and batch-insert them (Allocate,
    voxel_tsdf.cu:377-386).  On the dense backend with
    alloc_dedup="filter", candidates whose cell is already allocated need
    no insert, so only genuinely new keys are compacted (no sort); the
    hash backend, and alloc_dedup="sort", sort the candidate keys and keep
    the first max_candidates distinct ones."""
    cfg = vol.cfg
    keys, oob = generate_candidates(
        frame_depth, d2r, cam, cam_T_world, cam_T_world.inverse(), max_depth, cfg
    )
    sent = vx.sentinel_key(cfg)
    # raster-adjacent duplicates are masked first (exact dedup happens in
    # the insert's claim)
    left = torch.cat([keys.new_full((1,), -1), keys[:-1]])
    keys = torch.where(keys == left, sent, keys)
    if cfg.alloc_dedup == "filter" and cfg.backend == "dense":
        coords, valid, oob = _filter_new(vol, keys, oob)
    else:
        uniq = unique_keys(keys, cfg.max_candidates, sent)
        valid = uniq < sent
        coords = vx.unpack_block_coord(uniq, cfg)
        if cfg.backend == "dense":
            # candidates beyond the dense grid are dropped: count them
            _, in_range = h.table_index(coords, cfg)
            oob = oob + _i32_sum(valid & ~in_range)
    valid = valid & block_visibility(coords, cam_T_world, cam, cfg, full=True)
    vol, _ = h.insert(vol, coords, valid)
    vol.oob_count = vol.oob_count + oob
    return vol


def _filter_new(vol: TSDFVolume, keys: torch.Tensor, oob: torch.Tensor):
    """The presence filter of the dense backend: the candidate keys whose
    cell holds no block yet, compacted into max_candidates slots ->
    (coords [C, 3], valid [C], oob count with the off-grid keys added).
    Duplicates within the frame survive; the insert's claim resolves
    them."""
    cfg = vol.cfg
    sent = vx.sentinel_key(cfg)
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
    return vx.unpack_block_coord(torch.where(valid, compact, 0), cfg), valid, oob


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
    vol: TSDFVolume,
    cam: CameraParams,
    cam_T_world: SE3,
    frame_depth: Optional[torch.Tensor] = None,
    d2r: Optional[torch.Tensor] = None,
) -> VisibleSet:
    """check_visibility_kernel (voxel_tsdf.cu:82-93): any-corner frustum
    test over every live entry, then compaction.

    With cfg.cull_occluded and a depth frame, blocks that nearer surface
    provably occludes are dropped: if the largest observed range over the
    block's screen box plus the truncation is still closer than the
    block's nearest point, no voxel can pass sdf > -truncation, so fusion
    leaves it as it is and the working set shrinks."""
    cfg = vol.cfg
    live = vol.entry_block >= 0
    vis = block_visibility(vol.entry_pos, cam_T_world, cam, cfg, full=False)
    mask = live & vis
    if cfg.cull_occluded and frame_depth is not None and d2r is not None:
        mask = mask & ~occluded_blocks(vol.entry_pos, cam, cam_T_world, frame_depth,
                                       d2r, cfg)
    return compact_mask(vol, mask)


def occluded_blocks(
    block_pos: torch.Tensor,
    cam: CameraParams,
    cam_T_world: SE3,
    frame_depth: torch.Tensor,
    d2r: torch.Tensor,
    cfg: TSDFConfig,
) -> torch.Tensor:
    """Mask [E] of blocks whose whole screen box observes range strictly
    closer than (the block's nearest range - truncation): a max-range mip
    pyramid of the frame, each block's 8 corners projected, the box grown
    by a pixel, and the level where the box spans at most 2x2 tiles.  Op
    for op as the JAX package's _occluded_blocks (its corners go through
    the quaternion rotation, SE3.apply, not the rotation entries)."""
    # observed range; invalid depth reads +inf, which never culls
    cur = torch.where(frame_depth > 0, frame_depth * d2r, math.inf)
    hgt, wid = cur.shape
    levels = []
    tile = 1
    while tile < max(hgt, wid):
        cur = F.pad(cur, (0, cur.shape[1] % 2, 0, cur.shape[0] % 2), value=-math.inf)
        cur = cur.reshape(cur.shape[0] // 2, 2, cur.shape[1] // 2, 2).amax(dim=(1, 3))
        tile *= 2
        levels.append(cur)

    base = vx.block_to_point(block_pos, cfg)
    bl = cfg.block_len - 1
    intr = cam.intrinsics
    t = torch.as_tensor(cam_T_world.t, device=block_pos.device)
    us, vs, rngs, valid = [], [], [], None
    for i in range(8):
        off = torch.tensor([(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1], dtype=torch.int32,
                           device=block_pos.device) * bl
        pos_cam = cam_T_world.rotate((base + off).float() * cfg.voxel_size) + t
        pih = intr.project(pos_cam)
        z = pih[..., 2]
        us.append(pih[..., 0] / z)
        vs.append(pih[..., 1] / z)
        x, y = pos_cam[..., 0], pos_cam[..., 1]
        # the correctly rounded float32 root, as XLA takes it
        rngs.append(torch.sqrt((x * x + y * y + z * z).double()).float())
        valid = z > 0 if valid is None else valid & (z > 0)
    # the box grown by 1 px (voxels round to their nearest pixel), clamped
    # into the image
    us, vs = torch.stack(us), torch.stack(vs)
    u_min = torch.clamp(us.amin(0) - 1.0, 0.0, wid - 1.0)
    u_max = torch.clamp(us.amax(0) + 1.0, 0.0, wid - 1.0)
    v_min = torch.clamp(vs.amin(0) - 1.0, 0.0, hgt - 1.0)
    v_max = torch.clamp(vs.amax(0) + 1.0, 0.0, hgt - 1.0)
    # nearest possible voxel range: the corners' minimum less the block's
    # diagonal (the interior minimum need not lie at a corner)
    diag = cfg.block_len * cfg.voxel_size * 1.7320508
    blk_near = torch.stack(rngs).amin(0) - diag

    # the first level whose tiles hold the box in at most 2x2 of them
    span = torch.maximum(u_max - u_min, v_max - v_min)
    chosen = torch.zeros_like(valid)
    region_max = torch.full_like(span, math.inf)
    for li, lv in enumerate(levels):
        tile = 2 ** (li + 1)
        fits = (span <= tile) & ~chosen
        lh, lw = lv.shape
        # float to int after the clamp, truncating as the JAX astype does
        tu = torch.clamp((u_min / tile).to(torch.int32), 0, lw - 1).long()
        tv = torch.clamp((v_min / tile).to(torch.int32), 0, lh - 1).long()
        tu1 = torch.clamp(tu + 1, 0, lw - 1)
        tv1 = torch.clamp(tv + 1, 0, lh - 1)
        m = torch.maximum(torch.maximum(lv[tv, tu], lv[tv, tu1]),
                          torch.maximum(lv[tv1, tu], lv[tv1, tu1]))
        region_max = torch.where(fits, m, region_max)
        chosen = chosen | fits
    return valid & (region_max + cfg.truncation < blk_near)


# ----------------------------------------------------------------------
# fusion (tsdf_integrate_kernel, voxel_tsdf.cu:149-205)
# ----------------------------------------------------------------------
def stack_frame(frame: FrameInput, d2r: torch.Tensor) -> torch.Tensor:
    """One stacked image carrying every per-pixel channel the fusion
    samples: depth, depth->range, r, g, b, ht, lt, pad (f32 [H, W, 8],
    32 B per pixel)."""
    return torch.stack(
        [frame.depth, d2r, frame.rgb[..., 0], frame.rgb[..., 1],
         frame.rgb[..., 2], frame.ht, frame.lt, torch.zeros_like(frame.depth)],
        dim=-1,
    ).contiguous()


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
    stacked = stack_frame(frame, d2r)
    consts = dict(
        truncation=cfg.truncation, max_depth=max_depth,
        max_weight=cfg.max_weight, prob_eps=cfg.prob_eps,
    )

    if cfg.sampler in ("gather", "pallas"):
        # two stages: the projection as torch ops over [V, 512], the sample
        # kernel, then the fusion formulas as torch ops on the gathered
        # pool rows, written back to the live rows
        u, v, z = project_rows(vis.block_pos, cam_T_world, cam.intrinsics,
                               cfg.voxel_size, cfg.block_len_log2)
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

    # fused: the kernel projects the voxels of the live rows itself
    min_abs = fuse_rows(
        stacked, vis.block_pos, vis.pool_idx, vis.count, vol.tsdf, vol.rgbw,
        vol.prob, cam_T_world=cam_T_world, intrinsics=cam.intrinsics,
        voxel_size=cfg.voxel_size, **consts,
    )
    return vol, min_abs


def space_carve(
    vol: TSDFVolume, vis: VisibleSet, min_abs: torch.Tensor
) -> TSDFVolume:
    """Delete visible blocks whose min |tsdf| >= carve threshold
    (voxel_tsdf.cu:207-230, threshold 0.9 at :485)."""
    doomed = vis.mask & (min_abs >= vol.cfg.carve_threshold)
    return h.delete_entries(vol, vis.entry_idx, doomed)


class IntegrateStats(NamedTuple):
    """Per-frame device scalars of integrate(return_stats=True).  The JAX
    package also counts the sampler's patch-overflow blocks; the port's
    kernels load every pixel directly and have none."""

    visible_count: torch.Tensor  # i32 [] visible blocks this frame


def integrate(
    vol: TSDFVolume,
    frame: FrameInput,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
    allocate: bool = True,
    return_stats: bool = False,
):
    """One frame of semantic TSDF fusion, in place on `vol`; with
    return_stats, (vol, IntegrateStats) (the same frame: the stats are
    read from the visible set, never recomputed).

    allocate=False skips block allocation (the alloc_every cadence):
    geometry first seen on a skipped frame starts fusing on a later one,
    the fail-open latency of the reference's lock misses
    (voxel_hash.cu:83-89)."""
    d2r = depth_to_range(cam, vol.device)
    if allocate:
        vol = allocate_blocks(vol, frame.depth, d2r, cam, cam_T_world, max_depth)
    vis = gather_visible(vol, cam, cam_T_world, frame.depth, d2r)
    vol, min_abs = fuse_visible(vol, vis, frame, d2r, cam, cam_T_world, max_depth)
    vol = space_carve(vol, vis, min_abs)
    if return_stats:
        return vol, IntegrateStats(visible_count=vis.count)
    return vol
