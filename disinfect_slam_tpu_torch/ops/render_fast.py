"""TSDF rendering by surface splatting (counterpart of
disinfect_slam_tpu/ops/render_fast.py).

Instead of each pixel marching into the volume, every voxel in the
surface band pushes itself into the image:

  1. visible blocks holding a surface-band voxel are compacted (entry
     order kept) up to surf_cap; every voxel of them is projected
  2. each surface voxel min-merges its quantized corrected camera depth
     into the z-buffer over its 2x2 pixel footprint
  3. voxels whose depth equals the final z-buffer at a pixel max-merge
     their packed (ht prob, r, g, b) u32 word there: a deterministic
     tie-break
  4. normals come from screen-space depth gradients and are shaded with
     the reference's diffusivity and semantic overlay
     (voxel_tsdf.cu:292-299)

`splat_render` here is the plain torch version of the projection
(`project_splat_rows`) and steps 2-3 (scatter reductions with a dump
slot); ops/cuda/splat_kernel.py runs the same as two CUDA kernels that
project in registers, and shares the surface compaction of step 1
(`splat_visible`) and step 4 with it.  Min and max merges do not depend
on order, so the two give the same bits.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import voxel as vx
from ..core.geometry import SE3, CameraParams
from ..core.state import TSDFVolume
from . import hash as h
from .integrate import VisibleSet, gather_visible
from .raycast import RaycastResult, _shade

BIG = 1 << 30  # empty z-buffer pixel / dead voxel depth

# surface blocks kept for splatting; excess surface blocks are dropped
# for the render and counted in surf_overflow (fail-open, observable)
DEFAULT_SURF_CAP = 16384


def _surf_visible(
    vol: TSDFVolume, cam: CameraParams, cam_T_world: SE3, band: float, cap: int
) -> Tuple[VisibleSet, torch.Tensor]:
    """Visible blocks restricted to those with a voxel in the surface
    band (row min |tsdf| < band), compacted into min(cap, max_visible)
    rows in entry order.  Returns (set, surface blocks dropped, 0-d)."""
    cfg = vol.cfg
    vis = gather_visible(vol, cam, cam_T_world)
    pool = vis.pool_idx.clamp(0, cfg.num_blocks - 1).long()
    band_tsdf = band * cfg.voxel_size / cfg.truncation
    has = vis.mask & (vol.tsdf[pool].abs().amin(-1) < band_tsdf)
    cap = min(cap, cfg.max_visible)
    # cumsum compaction keeps entry order, as the JAX package's stable
    # argsort does; slot `cap` takes every row not kept
    rank = h.cumsum_i32(has) - 1
    slot = torch.where(has & (rank < cap), rank, cap).long()
    src = torch.full((cap + 1,), vis.mask.shape[0], dtype=torch.int64,
                     device=has.device)
    src[slot] = torch.arange(vis.mask.shape[0], device=has.device)
    src = src[:cap]
    n_surf = has.sum(dtype=torch.int32)
    count = torch.clamp(n_surf, max=cap)
    keep = torch.arange(cap, device=has.device) < count
    safe = src.clamp(max=vis.mask.shape[0] - 1)
    return VisibleSet(
        entry_idx=torch.where(keep, vis.entry_idx[safe], cfg.num_entries),
        block_pos=torch.where(keep[:, None], vis.block_pos[safe], 0),
        pool_idx=torch.where(keep, vis.pool_idx[safe], cfg.num_blocks),
        mask=keep,
        count=count,
    ), torch.clamp(n_surf - cap, min=0)


def splat_visible(
    vol: TSDFVolume, cam: CameraParams, cam_T_world: SE3, band: float, surf_cap=None
) -> Tuple[VisibleSet, torch.Tensor]:
    """The rows a splat render merges: the surface blocks (_surf_visible)
    up to surf_cap, or with surf_cap None every visible block.  Returns
    (set, surface blocks dropped, 0-d i32)."""
    if surf_cap is not None:
        return _surf_visible(vol, cam, cam_T_world, band, surf_cap)
    return (gather_visible(vol, cam, cam_T_world),
            torch.zeros((), dtype=torch.int32, device=vol.device))


def project_splat_rows(
    block_pos: torch.Tensor,
    pool_idx: torch.Tensor,
    count: torch.Tensor,
    tsdf_pool: torch.Tensor,
    cam_T_world: SE3,
    cam: CameraParams,
    voxel_size: float,
    truncation: float,
    max_depth: float,
    band: float,
    block_len_log2: int = 3,
):
    """Every voxel of the splat rows, projected: block_pos i32 [S, 3],
    pool_idx i32 [S] (clipped into the pool), count i32 [] live rows,
    tsdf_pool f32 [B, N] (N = 8 ** block_len_log2 voxels a block, x
    fastest).  The torch ops the splat kernels repeat in registers
    (csrc/splat_project.cuh), in this order.

    Returns (uf, vf, depth_q, surf) [S, N]: float pixel coordinates,
    quantized corrected camera depth (i32), and the surface-band mask
    (live row, pixel in the image, 0 < z <= max_depth, |tsdf| under the
    band)."""
    dev = block_pos.device
    bl = block_len_log2
    lmask = (1 << bl) - 1
    vidx = torch.arange(1 << (3 * bl), dtype=torch.int32, device=dev)
    ox = (vidx & lmask)[None, :]
    oy = ((vidx >> bl) & lmask)[None, :]
    oz = ((vidx >> (2 * bl)) & lmask)[None, :]
    px = ((block_pos[:, 0:1] << bl) + ox).float() * voxel_size
    py = ((block_pos[:, 1:2] << bl) + oy).float() * voxel_size
    pz = ((block_pos[:, 2:3] << bl) + oz).float() * voxel_size
    xc, yc, z = cam_T_world.apply_xyz(px, py, pz)  # [S, N] camera coords
    del px, py, pz
    intr = cam.intrinsics
    uf = (intr.fx * xc + intr.cx * z) / z
    vf = (intr.fy * yc + intr.cy * z) / z
    u = vx.round_half_away(uf).to(torch.int32)
    v = vx.round_half_away(vf).to(torch.int32)
    in_img = ((u >= 0) & (u < cam.img_w) & (v >= 0) & (v < cam.img_h) & (z > 0)
              & (z <= max_depth))
    del u, v

    tsdf = tsdf_pool[pool_idx.clamp(0, tsdf_pool.shape[0] - 1).long()]
    # surface band: within ~band voxels of the zero crossing, no weight
    # gate (the reference renders zero-weight voxels near max_depth too)
    band_tsdf = band * voxel_size / truncation
    live = torch.arange(block_pos.shape[0], device=dev) < count
    surf = live[:, None] & in_img & (tsdf.abs() < band_tsdf)

    # depth moved along the ray by tsdf, the sub-voxel correction to the
    # zero crossing: delta_z = tsdf * truncation * z / range; the root is
    # taken in float64 and rounded once (see ops/raycast.py:_norm)
    rng_cam = torch.sqrt((xc * xc + yc * yc + z * z).double()).float()
    z_corr = z + tsdf * truncation * z / torch.where(rng_cam == 0, 1.0, rng_cam)
    depth_q = torch.clamp(z_corr * 4096.0, 0, float(2**29)).to(torch.int32)
    return uf, vf, depth_q, surf


def _project_for_splat(vol, cam, cam_T_world, max_depth, band, surf_cap=None):
    """Per-voxel splat inputs of the plain path: float pixel coords,
    quantized corrected depth, the surface-band mask of the splat rows.

    Returns (uf, vf, depth_q, surf, vis, surf_overflow): [V, 512] f32,
    f32, i32, bool, the VisibleSet, and a 0-d i32."""
    cfg = vol.cfg
    vis, overflow = splat_visible(vol, cam, cam_T_world, band, surf_cap)
    uf, vf, depth_q, surf = project_splat_rows(
        vis.block_pos, vis.pool_idx, vis.count, vol.tsdf, cam_T_world, cam, cfg.voxel_size,
        cfg.truncation, max_depth, band, cfg.block_len_log2)
    return uf, vf, depth_q, surf, vis, overflow


def footprint(u0, v0, ok, img_h: int, img_w: int) -> torch.Tensor:
    """Pixel indices [4, ...] (int64) of each voxel's 2x2 footprint with
    top-left pixel (u0, v0); pixels off the image, and every pixel of a
    voxel where ok is False, go to the dump slot img_h * img_w.  A
    floor(uf) of -1 drops its du = 0 pixel and keeps its du = 1 pixel."""
    n_pix = img_h * img_w
    out = []
    for du in (0, 1):
        for dv in (0, 1):
            uu = u0.long() + du
            vv = v0.long() + dv
            inside = ok & (uu >= 0) & (uu < img_w) & (vv >= 0) & (vv < img_h)
            out.append(torch.where(inside, vv * img_w + uu, n_pix))
    return torch.stack(out)


def zbuf_scatter(pix: torch.Tensor, dq: torch.Tensor, n_pix: int) -> torch.Tensor:
    """Plain z-buffer: min of dq over the footprint pixels pix [4, ...]
    -> i32 [n_pix], BIG where nothing landed."""
    zbuf = torch.full((n_pix + 1,), BIG, dtype=torch.int32, device=dq.device)
    zbuf.scatter_reduce_(0, pix.reshape(-1), dq.expand(pix.shape).reshape(-1),
                         "amin", include_self=True)
    return zbuf[:n_pix]


def payload_scatter(pix, dq, packed, zbuf, n_pix: int) -> torch.Tensor:
    """Plain payload buffer: at every footprint pixel where dq equals the
    final zbuf, the max of the packed u32 words (int64 [...] values).
    Returns the u32 bits as i32 [n_pix]; 0 where nothing won.  The max
    is taken in int64, so words with the top bit set order as u32."""
    won = (pix < n_pix) & (dq == zbuf[pix.clamp(max=n_pix - 1)])
    pbuf = torch.zeros((n_pix + 1,), dtype=torch.int64, device=dq.device)
    pbuf.scatter_reduce_(0, torch.where(won, pix, n_pix).reshape(-1),
                         packed.expand(pix.shape).reshape(-1), "amax",
                         include_self=True)
    pbuf = pbuf[:n_pix]
    return torch.where(pbuf >= 1 << 31, pbuf - (1 << 32), pbuf).to(torch.int32)


def splat_buffers(
    vol: TSDFVolume,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
    band: float = 1.25,
    surf_cap: Optional[int] = DEFAULT_SURF_CAP,
):
    """The plain splat passes -> (zbuf i32 [H*W], pbuf u32 bits as i32
    [H*W], surf_overflow 0-d i32, surface blocks kept 0-d i32)."""
    cfg = vol.cfg
    n_pix = cam.img_h * cam.img_w
    uf, vf, depth_q, surf, vis, overflow = _project_for_splat(
        vol, cam, cam_T_world, max_depth, band, surf_cap)
    pix = footprint(torch.floor(uf).to(torch.int32), torch.floor(vf).to(torch.int32),
                    surf, cam.img_h, cam.img_w)
    zbuf = zbuf_scatter(pix, depth_q, n_pix)
    pool = vis.pool_idx.clamp(0, cfg.num_blocks - 1).long()
    packed = pack_payload_rgbw(vol.rgbw[pool], vol.prob[pool])
    pbuf = payload_scatter(pix, depth_q, packed, zbuf, n_pix)
    return zbuf, pbuf, overflow, vis.count


def splat_render(
    vol: TSDFVolume,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
    band: float = 1.25,
    surf_cap: Optional[int] = DEFAULT_SURF_CAP,
) -> RaycastResult:
    """Render rgba + normal-shaded views by splatting surface voxels,
    with the plain torch passes.

    band: surface band half-width in voxels; it must exceed the largest
    distance from the zero crossing to the nearest voxel centre (~0.87
    voxels on the diagonal), else surface sheets fall between layers.
    surf_cap: keep at most this many surface blocks (None: splat every
    visible block, without the surface filter)."""
    zbuf, pbuf, overflow, _ = splat_buffers(vol, cam, cam_T_world, max_depth,
                                            band, surf_cap)
    return images_from_buffers(zbuf, pbuf, cam, surf_overflow=overflow)


def pack_payload(rgb: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    """(rgb [N, 3] f32 0..255, prob [N] f32 0..1) -> packed u32 words as
    int64 [N], prob in the top byte (u32 order makes the max tie-break
    deterministic)."""
    c8 = torch.clamp(rgb, 0, 255).long()
    p8 = torch.clamp(prob * 255.0, 0, 255).long()
    return (p8 << 24) | (c8[:, 0] << 16) | (c8[:, 1] << 8) | c8[:, 2]


def pack_payload_rgbw(rgbw: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    """The same word straight from the stored RGBW word (int32 bits,
    r | g << 8 | b << 16 | w << 24), by byte shuffles; any shape."""
    r8 = rgbw.long() & 0xFF
    g8 = (rgbw.long() >> 8) & 0xFF
    b8 = (rgbw.long() >> 16) & 0xFF
    p8 = torch.clamp(prob * 255.0, 0, 255).long()
    return (p8 << 24) | (r8 << 16) | (g8 << 8) | b8


@functools.lru_cache(maxsize=None)
def _divisor_255(device: torch.device) -> torch.Tensor:
    """255 as a 0-d float32 tensor on `device`, made once a device (a
    captured render reads it): torch on CUDA multiplies by the reciprocal
    of a Python scalar divisor, which is not the correctly rounded
    quotient.  Read-only."""
    return torch.full((), 255.0, dtype=torch.float32, device=device)


def images_from_buffers(
    zbuf: torch.Tensor, pbuf: torch.Tensor, cam: CameraParams, surf_overflow=None
) -> RaycastResult:
    """z-buffer i32 [H*W] + payload buffer (u32 bits as i32 [H*W]) -> the
    reference's rgba and normal-shaded images (voxel_tsdf.cu:292-299);
    depth is camera z."""
    hgt, wid = cam.img_h, cam.img_w
    dev = zbuf.device
    f32 = dict(dtype=torch.float32, device=dev)
    hit = (zbuf < BIG).reshape(hgt, wid)
    depth = torch.where(hit, zbuf.reshape(hgt, wid).float() / 4096.0, 0.0)

    # screen-space normals from depth gradients (camera space)
    ki = cam.intrinsics_inv
    ug, vg = torch.meshgrid(torch.arange(wid, **f32), torch.arange(hgt, **f32),
                            indexing="xy")
    dirx = ki.fx * ug + ki.cx  # back-projected ray at depth 1 (dirz = 1)
    diry = ki.fy * vg + ki.cy
    ptsx, ptsy, ptsz = dirx * depth, diry * depth, depth
    # torch.roll wraps around, as jnp.roll does
    dxx = torch.roll(ptsx, -1, 1) - ptsx
    dxy = torch.roll(ptsy, -1, 1) - ptsy
    dxz = torch.roll(ptsz, -1, 1) - ptsz
    dyx = torch.roll(ptsx, -1, 0) - ptsx
    dyy = torch.roll(ptsy, -1, 0) - ptsy
    dyz = torch.roll(ptsz, -1, 0) - ptsz
    ncx = dxy * dyz - dxz * dyy  # cross(d/du, d/dv)
    ncy = dxz * dyx - dxx * dyz
    ncz = dxx * dyy - dxy * dyx
    nn = torch.sqrt((ncx * ncx + ncy * ncy + ncz * ncz).double()).float()
    nnw = torch.where(nn == 0, 1.0, nn)
    rn = torch.sqrt((dirx * dirx + diry * diry + 1.0).double()).float()
    # diffusivity = |dot(normal, -ray)| (voxel_tsdf.cu:292)
    diffusivity = torch.abs(
        (ncx / nnw) * (dirx / rn) + (ncy / nnw) * (diry / rn) + (ncz / nnw) / rn)

    pb = pbuf.reshape(hgt, wid)
    prob = ((pb >> 24) & 0xFF).float() / _divisor_255(dev)
    rgb = torch.stack([((pb >> 16) & 0xFF).float(), ((pb >> 8) & 0xFF).float(),
                       (pb & 0xFF).float()], -1)
    rgba, normal = _shade(rgb.reshape(-1, 3), prob.reshape(-1),
                          diffusivity.reshape(-1), hit.reshape(-1), (hgt, wid))
    return RaycastResult(rgba=rgba, normal=normal, depth=depth, hit=hit,
                         surf_overflow=surf_overflow)


def render_fingerprint(hit, depth, rgba, normal, surf_overflow, surf_blocks) -> dict:
    """Summary of a rendered view for comparing two implementations
    at scale, from numpy-convertible images (either package's): hit
    count, float64 sums of depth over hits and of each rgba and normal
    channel, the surface blocks dropped and the surface blocks found."""
    hit = np.asarray(hit)
    return {
        "hits": int(hit.sum()),
        "sum_depth": float(np.asarray(depth, np.float64)[hit].sum()),
        "sum_rgba": [float(v) for v in np.asarray(rgba, np.float64).sum((0, 1))],
        "sum_normal": [float(v) for v in np.asarray(normal, np.float64).sum((0, 1))],
        "surf_overflow": int(np.asarray(surf_overflow)),
        "surf_blocks": int(np.asarray(surf_blocks)),
    }


def render_divergence(ray: RaycastResult, spl: RaycastResult, intrinsics,
                      voxel_size: float) -> dict:
    """How far a splat render strays from the parity raycaster's on the
    same view (tests/test_render_divergence.py's measures): holes (ray
    hits the splat misses, share of ray hits), |depth error| over pixels
    both hit (camera z, as an array), the share of pixels where both hit
    and disagree by more than 2 voxels, the share of those on the ray
    image's depth discontinuities (dilated 3 px), and the per-channel
    median rgba difference where both hit."""
    hit_r = ray.hit.cpu().numpy()
    hit_s = spl.hit.cpu().numpy()
    both = hit_r & hit_s
    hgt, wid = hit_r.shape
    fx, fy, cx, cy = intrinsics
    uu, vv = np.meshgrid(np.arange(wid), np.arange(hgt))
    dirs = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1)
    # raycast depth is range along the ray; splat depth is camera z
    z_ray = ray.depth.cpu().numpy() / np.linalg.norm(dirs, axis=-1)
    derr = np.abs(z_ray - spl.depth.cpu().numpy())
    gx = np.abs(np.diff(z_ray, axis=1, prepend=z_ray[:, :1]))
    gy = np.abs(np.diff(z_ray, axis=0, prepend=z_ray[:1, :]))
    disc = (gx > 5 * voxel_size) | (gy > 5 * voxel_size) | ~hit_r
    for _ in range(3):
        disc = (disc | np.roll(disc, 1, 0) | np.roll(disc, -1, 0)
                | np.roll(disc, 1, 1) | np.roll(disc, -1, 1))
    bad = both & (derr > 2 * voxel_size)
    a = ray.rgba.cpu().numpy().astype(np.int32)[both]
    b = spl.rgba.cpu().numpy().astype(np.int32)[both]
    return {
        "holes": float((hit_r & ~hit_s).sum() / max(hit_r.sum(), 1)),
        "depth_err": derr[both],
        "bad": float(bad.mean()),
        "on_edge": float((bad & disc).sum() / max(bad.sum(), 1)),
        "rgba_median": np.median(np.abs(a - b).reshape(-1, 4), axis=0),
    }
