"""Voxel export: full-volume and bounding-box gathers, the binary dump,
and a volume fingerprint (counterpart of disinfect_slam_tpu/ops/gather.py;
reference TSDFGrid::GatherValid / GatherVoxels, voxel_tsdf.cu:399-472).

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

from ..core import voxel as vx
from ..core.state import TSDFVolume
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
