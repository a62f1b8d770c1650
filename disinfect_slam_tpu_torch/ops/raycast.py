"""TSDF raycasting, the parity renderer (counterpart of
disinfect_slam_tpu/ops/raycast.py; reference ray_cast_kernel,
voxel_tsdf.cu:232-307).

Every pixel marches its ray in step_size steps until the TSDF crosses
from positive to non-positive, then bisects the crossing and shades it
with a central-difference normal.  The JAX package marches in a
`lax.while_loop`; here the march is a Python loop over step index with a
per-pixel active mask, which stops when no pixel is active (one `.any()`
read of the device per step).  This is the exact oracle the splat
renderer (ops/render_fast.py) is held against, not a fast path.

Empty-space skipping: a sample inside an unallocated block provably
reads the default +1, so the march jumps whole steps that stay inside
that block, or, on the dense backend, inside its 4x4x4-block superblock
when the whole superblock is empty (a -3 sentinel folded into the block
table once per render; the hash backend has no table to fold it into).  Every sample the brute-force march would take is either taken
or provably +1, so skipping changes no image.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core import voxel as vx
from ..core.geometry import SE3, CameraParams
from ..core.state import DEFAULT_TSDF, TSDFVolume
from . import hash as h

_SUPER_EMPTY = -3


class RaycastResult(NamedTuple):
    rgba: torch.Tensor  # u8 [H, W, 4]
    normal: torch.Tensor  # u8 [H, W, 4]
    depth: torch.Tensor  # f32 [H, W] (ray range for raycast, camera z for splat; 0 = miss)
    hit: torch.Tensor  # bool [H, W]
    # splat renderers only: surface blocks dropped beyond surf_cap, a 0-d
    # device tensor (0 = complete image); None from the raycaster
    surf_overflow: Optional[torch.Tensor] = None


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis: float32 sum of squares, root
    taken in float64 and rounded once (torch's CPU float32 sqrt is not
    correctly rounded)."""
    return torch.sqrt((x * x).sum(-1).double()).float()


def _shade(rgb, prob, diffusivity, hit, shape):
    """Semantic overlay (voxel_tsdf.cu:293-299) of rgb [N, 3] and the
    diffuse shade -> (rgba, normal) u8 [*shape, 4], zero where not hit."""
    alpha = torch.clamp(prob - 0.5, min=0.0) / 0.5
    ones = torch.full_like(prob, 255.0)
    rgba = torch.stack([alpha * 255.0 + (1.0 - alpha) * rgb[:, 0],
                        (1.0 - alpha) * rgb[:, 1], (1.0 - alpha) * rgb[:, 2],
                        ones], -1)
    shade = diffusivity * 255.0
    ng = (1.0 - alpha) * shade
    normal = torch.stack([alpha * 255.0 + ng, ng, ng, ones], -1)
    hitf = hit[:, None].float()
    return ((rgba * hitf).to(torch.uint8).reshape(*shape, 4),
            (normal * hitf).to(torch.uint8).reshape(*shape, 4))


def raycast(
    vol: TSDFVolume,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
    step_size: Optional[float] = None,
) -> RaycastResult:
    """Render a virtual view (TSDFGrid::RayCast, voxel_tsdf.cu:490-506);
    step_size defaults to truncation / 2 like the host call site (:497)."""
    cfg = vol.cfg
    if step_size is None:
        step_size = cfg.truncation / 2.0
    dev = vol.device
    hgt, wid = cam.img_h, cam.img_w
    n_pix = hgt * wid
    f32 = dict(dtype=torch.float32, device=dev)

    world_T_cam = cam_T_world.inverse()
    uu, vv = torch.meshgrid(torch.arange(wid, **f32), torch.arange(hgt, **f32),
                            indexing="xy")
    pos_cam = cam.intrinsics_inv.project(
        torch.stack([uu, vv, torch.ones_like(uu)], -1)).reshape(n_pix, 3)
    ray_dir_cam = pos_cam / _norm(pos_cam)[:, None]
    ray_dir_world = world_T_cam.rotate(ray_dir_cam)  # [N, 3]
    step_grid = ray_dir_world * (step_size / cfg.voxel_size)
    # divide by a device tensor: torch on CUDA multiplies by the
    # reciprocal of a Python scalar divisor
    origin_grid = (torch.from_numpy(world_T_cam.t).to(dev)
                   / torch.tensor(cfg.voxel_size, **f32))
    max_step = int(math.ceil(max_depth / step_size))

    bl = cfg.block_len_log2
    sb_log2 = bl + 2
    use_super = cfg.raycast_skip and cfg.backend == "dense" and cfg.grid_side >= 8
    if use_super:
        g = cfg.grid_side
        s = g >> 2
        # table_index layout is x, y, z; superblocks tile it exactly
        occ = (vol.block_table >= 0).reshape(s, 4, s, 4, s, 4)
        super_occ = occ.any(dim=5, keepdim=True).any(dim=3, keepdim=True).any(
            dim=1, keepdim=True)
        aug_table = torch.where(
            vol.block_table >= 0, vol.block_table,
            torch.where(super_occ.expand(occ.shape).reshape(-1), -1, _SUPER_EMPTY),
        )

    def read(pt):
        """(tsdf, block missing, superblock empty) at voxel coords [N, 3]."""
        if not use_super:
            tsdf, missing = h.read_tsdf_miss(vol, pt)
            return tsdf, missing, torch.zeros_like(missing)
        idx, in_range = h.table_index(vx.point_to_block(pt, cfg), cfg)
        pool = torch.where(in_range, aug_table[idx.long()], _SUPER_EMPTY)
        found = pool >= 0
        row = torch.where(found, pool, 0).long()
        vidx = vx.offset_to_index(vx.point_to_offset(pt, cfg), cfg).long()
        tsdf = torch.where(found, vol.tsdf[row, vidx], DEFAULT_TSDF)
        return tsdf, ~found, pool == _SUPER_EMPTY

    d = step_grid
    dd = torch.where(d.abs() > 1e-9, d, 1.0)

    def skip_steps(pos, pt, span_log2):
        """Extra whole steps from pos whose rounded sample stays inside
        pt's aligned 2^span_log2-voxel region: round_half_away(x) lies in
        [base, base + span) iff x in [base - 0.5, base + span - 0.5)."""
        span = float(1 << span_log2)
        base = ((pt >> span_log2) << span_log2).float()
        safe_lo = base - 0.5 + 1e-4
        safe_hi = base + (span - 0.5) - 1e-4
        j_hi = torch.where(d > 1e-9, (safe_hi - pos) / dd, math.inf)
        j_lo = torch.where(d < -1e-9, (safe_lo - pos) / dd, math.inf)
        j_max = torch.minimum(j_hi, j_lo).amin(-1)
        return torch.clamp(torch.floor(j_max), 0.0, float(max_step)).to(torch.int32)

    prev = h.read_tsdf(vol, vx.round_half_away(origin_grid.expand(n_pix, 3)).int())
    i = torch.ones(n_pix, dtype=torch.int32, device=dev)
    active = torch.ones(n_pix, dtype=torch.bool, device=dev)
    hit = torch.zeros(n_pix, dtype=torch.bool, device=dev)
    lo = torch.zeros((n_pix, 3), **f32)
    hi = torch.zeros((n_pix, 3), **f32)
    while bool(active.any()):
        pos = origin_grid + step_grid * i.float()[:, None]
        pt = vx.round_half_away(pos).int()
        curr, missing, sup_empty = read(pt)
        # front-surface crossing (voxel_tsdf.cu:260)
        crossing = active & (prev > 0) & (curr <= 0) & (prev - curr <= 1.5)
        lo = torch.where(crossing[:, None], pos - step_grid, lo)
        hi = torch.where(crossing[:, None], pos, hi)
        hit |= crossing
        active &= ~crossing
        prev = torch.where(active, curr, prev)
        if cfg.raycast_skip:
            k = skip_steps(pos, pt, bl)
            if use_super:
                k = torch.where(sup_empty, skip_steps(pos, pt, sb_log2), k)
            i = i + torch.where(missing & active, 1 + k, 1)
        else:
            i = i + 1
        active &= i < max_step

    # binary refinement (voxel_tsdf.cu:265-274)
    mid = (lo + hi) * 0.5
    for _ in range(cfg.refine_iters(step_size)):
        neg = (h.read_tsdf(vol, vx.round_half_away(mid).int()) < 0)[:, None]
        hi = torch.where(neg, mid, hi)
        lo = torch.where(neg, lo, mid)
        mid = (lo + hi) * 0.5

    final = vx.round_half_away(mid).int()
    _, rgb, _, prob = h.read_voxels(vol, final)

    # central-difference normal (voxel_tsdf.cu:280-291)
    def t_at(off):
        return h.read_tsdf(vol, final + torch.tensor(off, dtype=torch.int32, device=dev))

    norm_raw = torch.stack([
        t_at([1, 0, 0]) - t_at([-1, 0, 0]),
        t_at([0, 1, 0]) - t_at([0, -1, 0]),
        t_at([0, 0, 1]) - t_at([0, 0, -1]),
    ], -1)
    nrm = _norm(norm_raw)
    nrm = torch.where(nrm == 0, 1.0, nrm)
    diffusivity = torch.clamp((norm_raw * -ray_dir_world).sum(-1) / nrm, min=0.0)
    rgba, normal = _shade(rgb, prob, diffusivity, hit, (hgt, wid))

    # hit depth along the ray (world metres)
    depth = torch.where(hit, _norm(mid - origin_grid) * cfg.voxel_size, 0.0)
    return RaycastResult(rgba=rgba, normal=normal, depth=depth.reshape(hgt, wid),
                         hit=hit.reshape(hgt, wid))
