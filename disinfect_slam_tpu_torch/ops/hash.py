"""Dense spatial index: block_table[grid cell] -> pool slot, entry i ==
pool slot i (counterpart of the dense backend of
disinfect_slam_tpu/ops/hash.py).

Allocation is the JAX package's batched, lock-free insert: candidates
claim their cell with a deterministic scatter-min of an encoded
candidate id, winners pop pool blocks off the free stack by prefix-sum
rank, and their payload rows reset (voxel_mem.cu:37-51).  Every update
is in place on the volume's tensors and needs no host sync.

The "hash" backend (open addressing, claim rounds, tombstones) is not
ported yet: its entry points raise NotImplementedError.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import TSDFConfig
from ..core import voxel as vx
from ..core.state import (
    DEFAULT_PROB,
    DEFAULT_TSDF,
    EMPTY,
    RESET_PROB,
    RESET_TSDF,
    TSDFVolume,
)

_I32_MAX = torch.iinfo(torch.int32).max


def _hash_backend_not_ported(cfg: TSDFConfig) -> None:
    if cfg.backend != "dense":
        raise NotImplementedError(
            f"backend={cfg.backend!r} is not ported; use backend='dense'"
        )


def cumsum_i32(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive running count of a boolean mask, as int32."""
    return torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)


def put_drop_(arr, idx, val, keep) -> None:
    """arr[idx[k]] = val[k] for every k where keep[k], in place, with no
    host sync.

    The JAX package writes `.at[idx].set(val, mode="drop")` with dropped
    writes pushed out of range.  Here the filter is explicit: each
    dropped write is redirected to repeat one kept write (same slot, same
    value), or, when nothing is kept, to rewrite arr[0] with its own
    value.  Kept indices are unique at every call site, so each slot
    receives a single value whatever order the writes land in."""
    # a [1] index tensor (a 0-d one would be read back as a Python int)
    first = torch.argmax(keep.to(torch.int32)).view(1)
    any_keep = keep.any()
    d_idx = torch.where(any_keep, idx[first], 0)
    d_val = torch.where(any_keep, val[first], arr[:1])
    idx = torch.where(keep, idx, d_idx).long()
    val = torch.where(keep.view(-1, *([1] * (val.dim() - 1))), val, d_val)
    arr[idx] = val


def table_index_xyz(bx, by, bz, cfg: TSDFConfig):
    """Block coord component tensors -> (grid cell int32, in-range mask).

    The grid spans [grid_origin, grid_origin + grid_side) blocks per axis
    (origin defaults to centered, -grid_side/2)."""
    g = cfg.grid_side
    org = cfg.grid_origin or (-(g >> 1),) * 3
    px = bx - org[0]
    py = by - org[1]
    pz = bz - org[2]
    in_range = (px >= 0) & (px < g) & (py >= 0) & (py < g) & (pz >= 0) & (pz < g)
    idx = (
        (px.clamp(0, g - 1) << (2 * cfg.grid_log2))
        | (py.clamp(0, g - 1) << cfg.grid_log2)
        | pz.clamp(0, g - 1)
    )
    return idx, in_range


def table_index(block: torch.Tensor, cfg: TSDFConfig):
    """Block coord [..., 3] -> (cell index [...], in-range mask [...])."""
    return table_index_xyz(block[..., 0], block[..., 1], block[..., 2], cfg)


def lookup(vol: TSDFVolume, block: torch.Tensor) -> torch.Tensor:
    """Block coords [N, 3] -> pool indices [N] (EMPTY on a miss)."""
    _hash_backend_not_ported(vol.cfg)
    idx, in_range = table_index(block, vol.cfg)
    pool = vol.block_table[idx.long()]
    return torch.where(in_range, pool, EMPTY)


def _voxel_rows(vol: TSDFVolume, point: torch.Tensor):
    """Voxel coords [..., 3] -> (hit, pool row, in-block index), each
    [...] with the row and index safe to gather on a miss."""
    cfg = vol.cfg
    pool = lookup(vol, vx.point_to_block(point, cfg))
    hit = pool >= 0
    row = torch.where(hit, pool, 0).long()
    vidx = vx.offset_to_index(vx.point_to_offset(point, cfg), cfg).long()
    return hit, row, vidx


def read_voxels(vol: TSDFVolume, point: torch.Tensor):
    """(tsdf, rgb [..., 3], weight, prob) at integer voxel coords
    [..., 3]; a miss reads the default voxel (+1, black, 0, 0), like
    Retrieve's default-on-miss (voxel_hash.cuh:104-112).  The packed
    RGBW word is gathered first and unpacked after."""
    hit, row, vidx = _voxel_rows(vol, point)
    tsdf = torch.where(hit, vol.tsdf[row, vidx], DEFAULT_TSDF)
    rw = vol.rgbw[row, vidx]
    rgb = torch.stack([rw & 0xFF, (rw >> 8) & 0xFF, (rw >> 16) & 0xFF], -1).float()
    rgb = torch.where(hit[..., None], rgb, 0.0)
    weight = torch.where(hit, ((rw >> 24) & 0xFF).float(), 0.0)
    prob = torch.where(hit, vol.prob[row, vidx], DEFAULT_PROB)
    return tsdf, rgb, weight, prob


def read_tsdf_miss(vol: TSDFVolume, point: torch.Tensor):
    """(tsdf, block missing) at integer voxel coords [..., 3]; an
    unallocated block reads the default +1 everywhere, which lets the
    raycaster skip it."""
    hit, row, vidx = _voxel_rows(vol, point)
    return torch.where(hit, vol.tsdf[row, vidx], DEFAULT_TSDF), ~hit


def read_tsdf(vol: TSDFVolume, point: torch.Tensor) -> torch.Tensor:
    """TSDF at integer voxel coords [..., 3] (miss -> +1)."""
    return read_tsdf_miss(vol, point)[0]


def _push_free(vol: TSDFVolume, mask: torch.Tensor, blk: torch.Tensor) -> None:
    """Push blk[i] where mask[i] onto the free stack (ReleaseBlock,
    voxel_mem.cu:57-61), in place."""
    rank = cumsum_i32(mask) - 1
    put_drop_(vol.heap, vol.num_free + rank, blk, mask)
    vol.num_free = vol.num_free + mask.sum(dtype=torch.int32)


def _insert_dense(
    vol: TSDFVolume, block: torch.Tensor, valid: torch.Tensor
) -> Tuple[TSDFVolume, torch.Tensor]:
    cfg = vol.cfg
    m = block.shape[0]
    b = cfg.num_blocks
    idx, in_range = table_index(block, cfg)
    cell = idx.long()
    exists = vol.block_table[cell] >= 0
    pending = valid & in_range & ~exists

    # Claim IN PLACE in block_table: pending candidates write -3 - id, so
    # the minimum picks the LARGEST candidate id per cell (the JAX
    # package's winner).  Free cells hold EMPTY (-1), above every code;
    # non-pending candidates write INT32_MAX, which leaves a cell as it is
    # (the one scatter with duplicate indices, hence a reduction).
    cand_id = torch.arange(m, dtype=torch.int32, device=block.device)
    enc = -3 - cand_id
    vol.block_table.scatter_reduce_(
        0, cell, torch.where(pending, enc, _I32_MAX), "amin", include_self=True
    )
    won = pending & (vol.block_table[cell] == enc)

    # Cap acquisitions at max_new_per_round, as the JAX package does
    # (overflow candidates drop and retry next frame, fail-open like the
    # reference's lock miss, voxel_hash.cu:83-89).
    w = cfg.max_new_per_round
    rank = cumsum_i32(won) - 1
    heap_idx = vol.num_free - 1 - rank
    ok = won & (heap_idx >= 0) & (rank < w)
    pool_idx = vol.heap[heap_idx.clamp(0, b - 1).long()]

    # each claimed cell has exactly one winner: approved winners write
    # their pool idx, capacity-dropped winners restore EMPTY
    put_drop_(vol.block_table, idx, torch.where(ok, pool_idx, EMPTY), won)
    put_drop_(vol.entry_block, pool_idx, pool_idx, ok)
    put_drop_(vol.entry_key, pool_idx, vx.pack_block_coord(block, cfg), ok)
    vol.num_free = vol.num_free - ok.sum(dtype=torch.int32)

    # payload reset (voxel_mem.cu:43-51) of the acquired rows, compacted
    # into max_new_per_round rows first (slot w is a scratch slot for the
    # rest); resets the pool rows in place
    slot = torch.where(ok, rank, w).long()
    compact = torch.full((w + 1,), b, dtype=torch.int32, device=block.device)
    compact[slot] = pool_idx
    compact = compact[:w]
    acquired = compact < b
    v = cfg.block_volume
    f32 = dict(dtype=torch.float32, device=block.device)
    put_drop_(vol.tsdf, compact, torch.full((w, v), RESET_TSDF, **f32), acquired)
    put_drop_(vol.rgbw, compact, torch.zeros((w, v), dtype=torch.int32,
                                              device=block.device), acquired)
    put_drop_(vol.prob, compact, torch.full((w, v), RESET_PROB, **f32), acquired)
    return vol, valid & in_range & ~exists & ~ok


def _delete_entries_dense(
    vol: TSDFVolume, entry_idx: torch.Tensor, valid: torch.Tensor
) -> TSDFVolume:
    cfg = vol.cfg
    safe_idx = entry_idx.clamp(0, cfg.num_blocks - 1)
    blk = vol.entry_block[safe_idx.long()]
    valid = valid & (entry_idx >= 0) & (blk >= 0)
    pos = vx.unpack_block_coord(vol.entry_key[safe_idx.long()], cfg)
    cell, _ = table_index(pos, cfg)
    empty = torch.full_like(cell, EMPTY)
    put_drop_(vol.block_table, cell, empty, valid)
    put_drop_(vol.entry_block, safe_idx, empty, valid)
    _push_free(vol, valid, blk)
    return vol


def insert(
    vol: TSDFVolume, block: torch.Tensor, valid: torch.Tensor
) -> Tuple[TSDFVolume, torch.Tensor]:
    """Batch-insert block coords [M, 3] where valid [M], in place.
    Returns (volume, dropped mask)."""
    _hash_backend_not_ported(vol.cfg)
    return _insert_dense(vol, block, valid)


def delete_entries(
    vol: TSDFVolume, entry_idx: torch.Tensor, valid: torch.Tensor
) -> TSDFVolume:
    """Batch-delete by entry index [N], releasing the pool blocks, in
    place (Delete, voxel_hash.cu:122-171; ReleaseBlock,
    voxel_mem.cu:57-61)."""
    _hash_backend_not_ported(vol.cfg)
    return _delete_entries_dense(vol, entry_idx, valid)
