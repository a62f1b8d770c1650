"""Voxel export: full-volume and bounding-box gathers, the binary dump,
its loader, and a volume fingerprint (counterpart of
disinfect_slam_tpu/ops/gather.py; reference TSDFGrid::GatherValid /
GatherVoxels, voxel_tsdf.cu:399-472).

Exports go through the same fixed-capacity compaction as the per-frame
visible set, so like the JAX package they cover at most max_visible
blocks.  The dump layout is the reference's VoxelSpatialTSDF: little-endian
float32 records (x, y, z, tsdf) in world metres (offline.cc:184-190).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..config import TSDFConfig
from ..core import voxel as vx
from ..core.state import TSDFVolume
from . import hash as h
from .integrate import VisibleSet, compact_mask


class BoundingCube(NamedTuple):
    """Axis-aligned bounds in world metres (voxel_tsdf.cuh:12-27)."""

    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: float
    zmax: float


class SpatialTSDF(NamedTuple):
    """Fixed-capacity export: [max_visible * 512] records + live count."""

    position: torch.Tensor  # f32 [N, 3] world metres
    tsdf: torch.Tensor  # f32 [N]
    weight: torch.Tensor  # f32 [N]
    prob: torch.Tensor  # f32 [N]
    mask: torch.Tensor  # bool [N]
    count: torch.Tensor  # i32 [] valid records


def _download(vol: TSDFVolume, vis: VisibleSet) -> SpatialTSDF:
    """download_tsdf_kernel (voxel_tsdf.cu:34-46): expand blocks to
    per-voxel world positions + payloads."""
    cfg = vol.cfg
    bv = cfg.block_volume
    offs = vx.index_to_offset(
        torch.arange(bv, dtype=torch.int32, device=vol.device), cfg
    )
    pos_grid = vx.block_to_point(vis.block_pos, cfg)[:, None, :] + offs[None, :, :]
    pos_world = pos_grid.float() * cfg.voxel_size
    pool = vis.pool_idx.clamp(0, cfg.num_blocks - 1).long()
    tsdf = vol.tsdf[pool]
    weight = ((vol.rgbw[pool] >> 24) & 0xFF).float()
    prob = vol.prob[pool]
    mask = vis.mask[:, None].expand(tsdf.shape)
    return SpatialTSDF(
        position=pos_world.reshape(-1, 3),
        tsdf=tsdf.reshape(-1),
        weight=weight.reshape(-1),
        prob=prob.reshape(-1),
        mask=mask.reshape(-1),
        count=vis.count * bv,
    )


def gather_valid(vol: TSDFVolume) -> SpatialTSDF:
    """All live blocks, up to max_visible of them (GatherValid,
    voxel_tsdf.cu:399-425)."""
    return _download(vol, compact_mask(vol, vol.entry_block >= 0))


def gather_voxels(vol: TSDFVolume, volume: BoundingCube) -> SpatialTSDF:
    """Blocks fully inside a world-space bbox (GatherVoxels +
    check_bound_kernel, voxel_tsdf.cu:14-25, 427-454); bounds scale to
    grid coords with the reference's truncating cast."""
    cfg = vol.cfg
    scale = 1.0 / cfg.voxel_size
    xmin, xmax, ymin, ymax, zmin, zmax = (int(v * scale) for v in volume)
    bl = cfg.block_len
    first = vx.block_to_point(vol.entry_pos, cfg)
    inside = (
        (vol.entry_block >= 0)
        & (first[:, 0] >= xmin) & (first[:, 1] >= ymin) & (first[:, 2] >= zmin)
        & (first[:, 0] + bl - 1 <= xmax)
        & (first[:, 1] + bl - 1 <= ymax)
        & (first[:, 2] + bl - 1 <= zmax)
    )
    return _download(vol, compact_mask(vol, inside))


def to_numpy_records(st: SpatialTSDF) -> np.ndarray:
    """Compact to a [count, 4] float32 (x, y, z, tsdf) array on the host."""
    n = int(st.count)
    mask = st.mask
    pos = st.position[mask][:n]
    tsdf = st.tsdf[mask][:n]
    rec = torch.cat([pos, tsdf[:, None]], dim=1)
    return rec.cpu().numpy().astype("<f4")


def dump_spatial_tsdf(st: SpatialTSDF, path: str) -> int:
    """Write the VoxelSpatialTSDF binary (offline.cc:184-190 format).
    Returns the number of records written."""
    rec = to_numpy_records(st)
    rec.tofile(path)
    return rec.shape[0]


def load_spatial_tsdf(path: str) -> np.ndarray:
    """Read a VoxelSpatialTSDF binary -> [N, 4] float32."""
    return np.fromfile(path, dtype="<f4").reshape(-1, 4)


def infer_voxel_size(records: np.ndarray) -> float:
    """The voxel size of dump records: every block dumps all 512 voxels,
    so neighbours one voxel apart exist, and the smallest positive gap
    between distinct coordinates along an axis is the voxel size (the
    records carry no header; the reference's TSDF2Mesh consumer is told
    the size out of band)."""
    best = np.inf
    for a in range(3):
        u = np.unique(records[:, a].astype(np.float64))
        if u.size > 1:
            d = np.diff(u)
            best = min(best, float(d[d > 1e-9].min()))
    if not np.isfinite(best):
        raise ValueError("cannot infer voxel size from a single-voxel dump")
    return best


def unique_rows(a: np.ndarray):
    """np.unique(a, axis=0, return_inverse=True) for integer rows [N, 3],
    with the inverse flat.  When every value fits 21 bits around 0, the
    rows become one int64 key each, offset so that the keys sort as the
    rows do lexicographically (x, then y, then z): the same rows, order
    and inverse from a 1-D unique, many times faster on the 16.5 M records
    of a benchmark dump or the 25 M vertices of its mesh; else the row
    unique itself."""
    off = 1 << 20
    if a.size and (a.min() < -off or a.max() >= off):
        rows, inv = np.unique(a, axis=0, return_inverse=True)
        return rows, inv.reshape(-1)
    b = a.astype(np.int64) + off
    keys, inv = np.unique((b[:, 0] << 42) | (b[:, 1] << 21) | b[:, 2], return_inverse=True)
    mask = (1 << 21) - 1
    rows = np.stack([keys >> 42, (keys >> 21) & mask, keys & mask], axis=1) - off
    return rows.astype(a.dtype), inv.reshape(-1)


def volume_from_spatial_records(records: np.ndarray, voxel_size: float | None = None,
                                truncation: float | None = None,
                                device="cuda") -> TSDFVolume:
    """Rebuild a hash-backend volume on `device` (CUDA unless the caller
    asks for another) from VoxelSpatialTSDF dump records, so that the
    dump can be meshed, rendered and queried (the role the reference
    gives the external TSDF2Mesh tool, README.md:69, 91).

    The dump carries (position, tsdf) only: rebuilt voxels get weight 1
    (observed) and the reset probability, the information the reference's
    dump consumer also lives without.  gather_valid of the result gives
    the records back (in another order).  The block dedup (unique_rows) and
    the payload writes run on the host, as in the JAX package; the
    inserts and lookups run on the device."""
    rec = np.asarray(records, np.float32).reshape(-1, 4)
    if voxel_size is None:
        voxel_size = infer_voxel_size(rec)
    coords = np.rint(rec[:, :3].astype(np.float64) / voxel_size).astype(np.int32)
    blocks = coords >> 3
    offs = coords - (blocks << 3)
    vidx = offs[:, 0] + 8 * offs[:, 1] + 64 * offs[:, 2]
    ublocks, inv = unique_rows(blocks)
    nb = ublocks.shape[0]

    blog = max(6, int(np.ceil(np.log2(2 * nb))))
    cbits = int(np.abs(ublocks).max(initial=1)).bit_length() + 1
    cfg = TSDFConfig(
        voxel_size=float(voxel_size),
        truncation=float(truncation) if truncation else 6.0 * voxel_size,
        backend="hash",
        num_blocks_log2=blog,
        num_buckets_log2=blog + 2,
        coord_bits=max(10, cbits),
        max_candidates=1 << blog,
        max_new_per_round=1 << blog,
        max_visible=1 << blog,
    )
    vol = TSDFVolume.create(cfg, device)
    dev = vol.device
    cand = torch.from_numpy(np.pad(ublocks, ((0, (1 << blog) - nb), (0, 0)))).to(dev)
    pending = torch.arange(1 << blog, device=dev) < nb
    # the claim rounds fail open (a dropped block retries next frame in
    # the live engine, voxel_hash.cu:83-89); a one-shot rebuild retries
    # here, at most 16 times
    for _ in range(16):
        if not bool(pending.any()):
            break
        vol, pending = h.insert(vol, cand, pending)
    else:
        raise RuntimeError("the hash insert kept dropping blocks at 50% load")

    pool = h.lookup(vol, cand[:nb]).cpu().numpy()
    if not (pool >= 0).all():
        raise RuntimeError("an inserted block is missing on lookup")
    tsdf = vol.tsdf.cpu().numpy()
    rgbw = vol.rgbw.cpu().numpy()
    rows = pool[inv]
    tsdf[rows, vidx] = rec[:, 3]
    rgbw[rows, vidx] |= np.int32(1 << 24)  # weight 1: observed
    vol.tsdf = torch.from_numpy(tsdf).to(dev)
    vol.rgbw = torch.from_numpy(rgbw).to(dev)
    return vol


# a fused volume against the JAX reference's fingerprint (the reference
# on the CPU, with XLA's FMA contraction and its own exp/log): block and
# record counts within 0.1%, sums relative
TOL_COUNT, TOL_TSDF, TOL_WP = 1e-3, 1e-4, 1e-3


def fingerprint_gaps(fp: dict, ref: dict, prob_tol: float = TOL_WP) -> dict:
    """{key: (relative deviation of fp from ref, its limit)} for the
    counts and sums of two volume_fingerprints that carry a "records"
    count (gather_valid's); a key passes when its deviation is at most
    its limit.  prob_tol is the limit on sum_prob."""
    rel = lambda k: abs(fp[k] - ref[k]) / abs(ref[k])  # noqa: E731
    return {
        "active_blocks": (rel("active_blocks"), TOL_COUNT),
        "records": (rel("records"), TOL_COUNT),
        "sum_abs_tsdf": (rel("sum_abs_tsdf"), TOL_TSDF),
        "sum_weight": (rel("sum_weight"), TOL_WP),
        "sum_prob": (rel("sum_prob"), prob_tol),
    }


def volume_fingerprint(arrays: dict) -> dict:
    """Summary of a fused volume for comparing two implementations at
    scale: live-block count, oob count, a sha256 of the sorted packed keys
    of the live blocks, and float64 sums of |tsdf|, weight and prob over
    every voxel of every live block.

    `arrays` holds numpy arrays under the volume's field names (entry_key,
    entry_block, oob_count, tsdf, rgbw, prob), as io/checkpoint.py's
    volume_to_numpy gives them or as read from the JAX package; rgbw may
    be uint32 or the int32 bit pattern."""
    live = np.asarray(arrays["entry_block"]) >= 0
    keys = np.sort(np.asarray(arrays["entry_key"])[live].astype("<i4"))
    rows = np.asarray(arrays["entry_block"])[live]
    tsdf = np.asarray(arrays["tsdf"])[rows].astype(np.float64)
    weight = (np.asarray(arrays["rgbw"])[rows].view(np.uint32) >> 24) & 0xFF
    prob = np.asarray(arrays["prob"])[rows].astype(np.float64)
    return {
        "active_blocks": int(live.sum()),
        "oob_count": int(np.asarray(arrays["oob_count"])),
        "keys_sha256": hashlib.sha256(keys.tobytes()).hexdigest(),
        "sum_abs_tsdf": float(np.abs(tsdf).sum()),
        "sum_weight": float(weight.astype(np.float64).sum()),
        "sum_prob": float(prob.sum()),
    }
