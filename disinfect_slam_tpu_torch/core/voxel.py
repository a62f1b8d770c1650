"""Voxel / block coordinate helpers (counterpart of
disinfect_slam_tpu/core/voxel.py; reference voxel_mem.cuh:29-68).

Coordinates are int32 tensors with a trailing axis of 3; packed keys are
non-negative int32, `coord_bits` bits per axis.
"""

from __future__ import annotations

import torch

from ..config import TSDFConfig


def point_to_block(point: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """Voxel coord [..., 3] int32 -> block coord.  `>>` on a signed
    tensor is an arithmetic shift, i.e. floor division for negative
    coordinates (voxel_mem.cuh:29-32)."""
    return point >> cfg.block_len_log2


def block_to_point(block: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """Block coord [..., 3] -> voxel coord of its first voxel."""
    return block << cfg.block_len_log2


def point_to_offset(point: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """Voxel coord [..., 3] -> offset within its block, in [0, block_len)
    (two's complement `&`, so negative coordinates wrap like `>>`)."""
    return point & (cfg.block_len - 1)


def offset_to_index(offset: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """In-block offset [..., 3] -> flat index in [0, 512), x fastest
    (OffsetToIndex, voxel_mem.cuh:65-68)."""
    bl = cfg.block_len_log2
    return offset[..., 0] + (offset[..., 1] << bl) + (offset[..., 2] << (2 * bl))


def index_to_offset(index: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """Flat in-block index [...] -> offset [..., 3] (x fastest,
    OffsetToIndex layout of voxel_mem.cuh:65-68)."""
    bl = cfg.block_len_log2
    mask = cfg.block_len - 1
    return torch.stack(
        [index & mask, (index >> bl) & mask, (index >> (2 * bl)) & mask], dim=-1
    )


def pack_block_coord(block: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """Pack block coords [..., 3] (within [coord_min, coord_max]) into one
    non-negative int32 key."""
    b = cfg.coord_bits
    off = 1 << (b - 1)
    x = (block[..., 0] + off).to(torch.int32)
    y = (block[..., 1] + off).to(torch.int32)
    z = (block[..., 2] + off).to(torch.int32)
    return x | (y << b) | (z << (2 * b))


def unpack_block_coord(key: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """Inverse of pack_block_coord -> [..., 3] int32."""
    b = cfg.coord_bits
    off = 1 << (b - 1)
    mask = (1 << b) - 1
    return torch.stack(
        [(key & mask) - off, ((key >> b) & mask) - off,
         ((key >> (2 * b)) & mask) - off],
        dim=-1,
    )


def sentinel_key(cfg: TSDFConfig) -> int:
    """Pack key larger than any valid key (marks an empty candidate)."""
    return 1 << (3 * cfg.coord_bits)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """CUDA roundf semantics: round half away from zero.

    torch.round rounds half to even; the reference rounds voxel
    projections and fused rgb/weights with roundf (voxel_tsdf.cu:165-166,
    192-194)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
