"""TSDF raycasting, the parity renderer (counterpart of
disinfect_slam_tpu/ops/raycast.py; reference ray_cast_kernel,
voxel_tsdf.cu:232-307).

Every pixel marches its ray in step_size steps until the TSDF crosses
from positive to non-positive, then bisects the crossing and shades it
with a central-difference normal.  `raycast` launches the hand-written
kernel for a CUDA volume (ops/cuda/raycast_kernel.py, csrc/raycast.cu:
one thread a pixel, the march with early exit) and runs
`raycast_reference` for a CPU volume.  The plain version marches as the
JAX package's `lax.while_loop` does, as a Python loop over step index
with a per-pixel active mask, which stops when no pixel is active (one
`.any()` read of the device per step).  It is the exact oracle the splat
renderer (ops/render_fast.py) and the kernel are held against.

Each three-term sum (the norms, the shading's dot product) is written
as explicit adds, left to right: torch's reduction over a last axis of
three adds in another order on the card than on the CPU, so with these
sums the plain version gives the same bits on both devices, and the
kernel repeats them.

Empty-space skipping: a sample inside an unallocated block provably
reads the default +1, so the march jumps whole steps that stay inside
that block, or, on the dense backend, inside its 4x4x4-block superblock
when the whole superblock is empty (the plain version folds a -3
sentinel into the block table once per render, `superblock_table`; the
kernel reads one occupancy bit a superblock instead,
`superblock_bits_reference` and its kernel; the hash backend has no
table to fold it into).  Every sample the brute-force march would take
is either taken or provably +1, so skipping changes no image.
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


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """x[..., 0] + x[..., 1] + x[..., 2], left to right, in x's dtype."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis: float32 sum of squares (left to
    right), root taken in float64 and rounded once (torch's CPU float32
    sqrt is not correctly rounded)."""
    return torch.sqrt(_sum3(x * x).double()).float()


def superblock_table(vol: TSDFVolume) -> torch.Tensor:
    """The dense block table (int32) with each empty cell of an empty
    4x4x4-block superblock set to -3 (the march's skip sentinel), as torch
    ops on the volume's device."""
    s = vol.cfg.grid_side >> 2
    # table_index layout is x, y, z; superblocks tile it exactly
    occ = (vol.block_table >= 0).reshape(s, 4, s, 4, s, 4)
    super_occ = occ.any(dim=5, keepdim=True).any(dim=3, keepdim=True).any(dim=1, keepdim=True)
    return torch.where(
        vol.block_table >= 0, vol.block_table,
        torch.where(super_occ.expand(occ.shape).reshape(-1), -1, _SUPER_EMPTY),
    ).to(torch.int32)


def superblock_words(cfg) -> int:
    """The 32-bit words of a dense grid's superblock occupancy bits (one bit
    a 4x4x4-block superblock), padded to a multiple of four (16 bytes); 0
    on a grid under 8 blocks a side, which the march does not split into
    superblocks."""
    if cfg.grid_side < 8:
        return 0
    return -(-((cfg.grid_side >> 2) ** 3) // 128) * 4


def superblock_bits_reference(vol: TSDFVolume) -> torch.Tensor:
    """Plain version of the raycast kernel's superblock bits (csrc/
    raycast_bits.cu), as torch ops on the volume's device: int32
    [superblock_words], bit sb & 31 of word sb >> 5 set iff superblock
    sb = (sx * s + sy) * s + sz (the table's x, y, z order, s superblocks
    a side) holds a block, so clear exactly where superblock_table's cells
    are -3; the padding words are 0.  Empty on a grid under 8 blocks a
    side."""
    cfg, dev = vol.cfg, vol.device
    if cfg.backend != "dense":
        raise ValueError("superblock bits need the dense backend")
    words = superblock_words(cfg)
    if words == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    s = cfg.grid_side >> 2
    occ = (vol.block_table >= 0).reshape(s, 4, s, 4, s, 4)
    occ = occ.any(dim=5).any(dim=3).any(dim=1).reshape(-1)
    padded = torch.zeros((words * 32,), dtype=torch.int64, device=dev)
    padded[:occ.numel()] = occ.long()
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    w = (padded.reshape(words, 32) << shifts).sum(-1)  # distinct powers of two: exact
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def uses_superblocks(cfg) -> bool:
    """Whether the march skips whole empty superblocks (dense backend,
    skipping on, a grid of at least 8 blocks a side)."""
    return cfg.raycast_skip and cfg.backend == "dense" and cfg.grid_side >= 8


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
    step_size defaults to truncation / 2 like the host call site (:497).
    One kernel launch for a CUDA volume (cam_T_world an SE3 or a
    DevicePose), the plain version for a CPU volume."""
    from .cuda import raycast_kernel

    return raycast_kernel.raycast(vol, cam, cam_T_world, max_depth, step_size)


def raycast_reference(
    vol: TSDFVolume,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
    step_size: Optional[float] = None,
) -> RaycastResult:
    """Plain version of raycast, on any device (cam_T_world an SE3 or a
    DevicePose on the volume's device)."""
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
    origin_grid = (world_T_cam.translation_tensor(dev)
                   / torch.tensor(cfg.voxel_size, **f32))
    max_step = int(math.ceil(max_depth / step_size))

    bl = cfg.block_len_log2
    sb_log2 = bl + 2
    use_super = uses_superblocks(cfg)
    if use_super:
        aug_table = superblock_table(vol)

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
    diffusivity = torch.clamp(_sum3(norm_raw * -ray_dir_world) / nrm, min=0.0)
    rgba, normal = _shade(rgb, prob, diffusivity, hit, (hgt, wid))

    # hit depth along the ray (world metres)
    depth = torch.where(hit, _norm(mid - origin_grid) * cfg.voxel_size, 0.0)
    return RaycastResult(rgba=rgba, normal=normal, depth=depth.reshape(hgt, wid),
                         hit=hit.reshape(hgt, wid))
