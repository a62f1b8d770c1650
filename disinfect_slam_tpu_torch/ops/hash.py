"""Spatial index of the volume (counterpart of
disinfect_slam_tpu/ops/hash.py), both backends:

  dense  block_table[grid cell] -> pool slot, entry i == pool slot i;
  hash   open addressing over num_entries slots, probed in a window of
         max_probe slots from the bucket of the reference's 3-prime hash
         (voxel_hash.cu:31-35); deletes leave a TOMBSTONE that probes walk
         through (the list splice of Delete, voxel_hash.cu:122-171).

Allocation is the JAX package's batched, lock-free insert: candidates
claim their cell (dense: a scatter-min of an encoded candidate id) or
their first free probe slot (hash: a scatter-max of the candidate id, in
insert_rounds claim rounds), winners pop pool blocks off the free stack by
prefix-sum rank, and their payload rows reset (voxel_mem.cu:37-51).
Every update is in place on the volume's tensors and needs no host sync.

The dense window moves with recenter_dense, a rebuild of the directory
that leaves the payloads where they are.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import TSDFConfig
from ..core import voxel as vx
from ..core.state import (
    DEFAULT_PROB,
    DEFAULT_TSDF,
    EMPTY,
    RESET_PROB,
    RESET_TSDF,
    TOMBSTONE,
    TSDFVolume,
)

# the reference's hash primes (voxel_hash.cu:31-35)
_P1, _P2, _P3 = 73856093, 19349669, 83492791
_I32_MAX = torch.iinfo(torch.int32).max


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


def hash_block(block: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """Block coord [..., 3] -> bucket index [...] int32: the reference's
    (x*73856093 ^ y*19349669 ^ z*83492791) & mask in uint32 arithmetic,
    taken exactly in int64 (each product reduced mod 2^32) so that no
    signed overflow is relied on."""
    b = block.long()
    m32 = 0xFFFFFFFF
    h = ((b[..., 0] * _P1) & m32) ^ ((b[..., 1] * _P2) & m32) ^ ((b[..., 2] * _P3) & m32)
    return (h & cfg.bucket_mask).to(torch.int32)


def probe_slots(block: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """Probe window [..., max_probe] of entry indices: from the bucket's
    first entry, linearly with wraparound (open addressing in place of
    the reference's 2-entry bucket and chained overflow list)."""
    base = hash_block(block, cfg) << cfg.entries_per_bucket_log2
    offs = torch.arange(cfg.max_probe, dtype=torch.int32, device=block.device)
    return (base[..., None] + offs) & cfg.entry_mask


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when there is none),
    as jnp.argmax of a bool array gives it: torch.argmax returns the first
    of equal maxima."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _probe_match(vol: TSDFVolume, block: torch.Tensor):
    """(found [N], the first matching entry slot [N]) of block coords
    [N, 3] among the live hash entries of their probe windows."""
    cfg = vol.cfg
    slots = probe_slots(block, cfg)
    flat = slots.long()
    match = (vol.entry_block[flat] >= 0) & (
        vol.entry_key[flat] == vx.pack_block_coord(block, cfg)[..., None])
    return match.any(dim=-1), slots.gather(-1, _first_true(match)[..., None])[..., 0]


def lookup(vol: TSDFVolume, block: torch.Tensor) -> torch.Tensor:
    """Block coords [N, 3] -> pool indices [N] (EMPTY on a miss);
    RetrieveMutable (voxel_hash.cuh:124-161) on the hash backend."""
    if vol.cfg.backend == "dense":
        idx, in_range = table_index(block, vol.cfg)
        return torch.where(in_range, vol.block_table[idx.long()], EMPTY)
    found, slot = _probe_match(vol, block)
    return torch.where(found, vol.entry_block[slot.long()], EMPTY)


def lookup_entry(vol: TSDFVolume, block: torch.Tensor) -> torch.Tensor:
    """Like lookup, but the entry index [N] (EMPTY on a miss); on the
    dense backend the entry index is the pool index."""
    if vol.cfg.backend == "dense":
        return lookup(vol, block)
    found, slot = _probe_match(vol, block)
    return torch.where(found, slot, EMPTY)


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


def trilinear_tsdf(vol: TSDFVolume, point: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolated TSDF at fractional voxel coords [N, 3],
    RetrieveTSDF (voxel_hash.cu:173-200) with its corner weighting:
    alpha = ceil corner - point, and corner i takes the floor along an
    axis where its bit is set."""
    pl = torch.floor(point)
    alpha = pl + 1.0 - point
    vals = []
    for i in range(8):
        cx = pl[..., 0] if (i >> 2) & 1 else pl[..., 0] + 1.0
        cy = pl[..., 1] if (i >> 1) & 1 else pl[..., 1] + 1.0
        cz = pl[..., 2] if (i >> 0) & 1 else pl[..., 2] + 1.0
        vals.append(read_tsdf(vol, torch.stack([cx, cy, cz], -1).to(torch.int32)))
    ax, ay, az = alpha[..., 0], alpha[..., 1], alpha[..., 2]
    t00 = vals[0b000] * az + vals[0b001] * (1 - az)
    t01 = vals[0b010] * az + vals[0b011] * (1 - az)
    t10 = vals[0b100] * az + vals[0b101] * (1 - az)
    t11 = vals[0b110] * az + vals[0b111] * (1 - az)
    t0 = t00 * ay + t01 * (1 - ay)
    t1 = t10 * ay + t11 * (1 - ay)
    return t0 * ax + t1 * (1 - ax)


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
    _acquire(vol, ok, rank, pool_idx)
    return vol, valid & in_range & ~exists & ~ok


def _acquire(vol: TSDFVolume, ok: torch.Tensor, rank: torch.Tensor,
             pool_idx: torch.Tensor) -> None:
    """Take the pool blocks of the approved winners off the free stack and
    reset their payload rows (voxel_mem.cu:43-51), in place: the rows are
    compacted into max_new_per_round rows first (slot w is a scratch slot
    for the rest; ok implies rank < w)."""
    cfg = vol.cfg
    w, b, dev = cfg.max_new_per_round, cfg.num_blocks, pool_idx.device
    vol.num_free = vol.num_free - ok.sum(dtype=torch.int32)
    slot = torch.where(ok, rank, w).long()
    compact = torch.full((w + 1,), b, dtype=torch.int32, device=dev)
    compact[slot] = pool_idx
    compact = compact[:w]
    acquired = compact < b
    v = cfg.block_volume
    f32 = dict(dtype=torch.float32, device=dev)
    put_drop_(vol.tsdf, compact, torch.full((w, v), RESET_TSDF, **f32), acquired)
    put_drop_(vol.rgbw, compact, torch.zeros((w, v), dtype=torch.int32, device=dev),
              acquired)
    put_drop_(vol.prob, compact, torch.full((w, v), RESET_PROB, **f32), acquired)


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


def _claim_round(
    vol: TSDFVolume, block: torch.Tensor, key: torch.Tensor, pending: torch.Tensor
) -> torch.Tensor:
    """One existence check + claim + allocate round of the hash insert
    over [M] candidates, in place.  Returns the candidates still
    pending."""
    cfg = vol.cfg
    m, e = block.shape[0], cfg.num_entries
    slots = probe_slots(block, cfg)
    flat = slots.long()
    eblk = vol.entry_block[flat]
    # existence: a live entry with our key anywhere in the window
    exists = ((eblk >= 0) & (vol.entry_key[flat] == key[:, None])).any(dim=-1)
    pending = pending & ~exists

    # the first free (EMPTY or TOMBSTONE) slot of the window
    free = eblk < 0
    target = slots.gather(-1, _first_true(free)[:, None])[:, 0]
    want = pending & free.any(dim=-1)

    # deterministic conflict resolution: the largest candidate id wins
    # the slot; slot e is a scratch slot that takes every other claim
    cand_id = torch.arange(m, dtype=torch.int32, device=block.device)
    claims = torch.full((e + 1,), -1, dtype=torch.int32, device=block.device)
    claims.scatter_reduce_(0, torch.where(want, target, e).long(), cand_id, "amax",
                           include_self=True)
    won = want & (claims[target.long()] == cand_id)

    # pool acquisition: winner i takes heap[num_free - 1 - rank_i] (the
    # stack pop of AquireBlock, voxel_mem.cu:37-42), capped at
    # max_new_per_round so that every acquired block gets its reset row;
    # capped-out candidates stay pending for the next round or frame
    rank = cumsum_i32(won) - 1
    heap_idx = vol.num_free - 1 - rank
    ok = won & (heap_idx >= 0) & (rank < cfg.max_new_per_round)
    pool_idx = vol.heap[heap_idx.clamp(0, cfg.num_blocks - 1).long()]
    # one winner per slot: the kept targets are unique
    put_drop_(vol.entry_block, target, pool_idx, ok)
    put_drop_(vol.entry_key, target, key, ok)
    _acquire(vol, ok, rank, pool_idx)
    return pending & ~ok


def insert(
    vol: TSDFVolume, block: torch.Tensor, valid: torch.Tensor
) -> Tuple[TSDFVolume, torch.Tensor]:
    """Batch-insert block coords [M, 3] where valid [M], in place.
    Returns (volume, dropped mask).  On the hash backend, coords outside
    the packed range drop (rather than alias another key), and candidates
    unresolved after cfg.insert_rounds claim rounds drop for this call
    (fail-open, like the reference's lock miss, voxel_hash.cu:83-89)."""
    if vol.cfg.backend == "dense":
        return _insert_dense(vol, block, valid)
    pending = valid & vx.in_coord_range(block, vol.cfg)
    key = vx.pack_block_coord(block, vol.cfg)
    for _ in range(vol.cfg.insert_rounds):
        pending = _claim_round(vol, block, key, pending)
    return vol, pending


def delete_entries(
    vol: TSDFVolume, entry_idx: torch.Tensor, valid: torch.Tensor
) -> TSDFVolume:
    """Batch-delete by entry index [N], releasing the pool blocks, in
    place (Delete, voxel_hash.cu:122-171; ReleaseBlock,
    voxel_mem.cu:57-61).  A hash entry becomes a TOMBSTONE, so probes of
    the entries past it still find them."""
    cfg = vol.cfg
    if cfg.backend == "dense":
        return _delete_entries_dense(vol, entry_idx, valid)
    safe_idx = entry_idx.clamp(0, cfg.num_entries - 1)
    blk = vol.entry_block[safe_idx.long()]
    valid = valid & (entry_idx >= 0) & (blk >= 0)
    put_drop_(vol.entry_block, safe_idx, torch.full_like(blk, TOMBSTONE), valid)
    _push_free(vol, valid, blk)
    return vol


# ----------------------------------------------------------------------
# moving the dense window
# ----------------------------------------------------------------------
def window_origin(cfg: TSDFConfig) -> tuple:
    """The dense window's low corner in block coords (centred by
    default)."""
    return cfg.grid_origin or (-(cfg.grid_side >> 1),) * 3


def recenter_origin_for(cfg: TSDFConfig, cam_pos_world_m) -> tuple:
    """Window origin (block coords, clipped into the packed-coord range)
    that centres the dense window on a world position (host arithmetic)."""
    bs = cfg.block_len * cfg.voxel_size
    g = cfg.grid_side
    lo, hi = cfg.coord_min, cfg.coord_max - g + 1
    return tuple(
        int(np.clip(int(np.floor(c / bs)) - (g >> 1), lo, hi))
        for c in np.asarray(cam_pos_world_m, np.float64)
    )


def needs_recenter(cfg: TSDFConfig, cam_pos_world_m, margin_blocks=None,
                   max_depth=None) -> bool:
    """True when the camera is within the margin of the dense window's
    edge.  max_depth gives a frustum-deep margin, else a quarter window;
    either is capped at 3/8 of the window so that a frustum larger than
    the window cannot retrigger every frame.  Always False on the hash
    backend, which has no window."""
    if cfg.backend != "dense":
        return False
    bs = cfg.block_len * cfg.voxel_size
    g = cfg.grid_side
    if margin_blocks is None:
        margin_blocks = int(np.ceil(max_depth / bs)) if max_depth else g >> 2
    margin_blocks = min(margin_blocks, 3 * g // 8)
    org = np.asarray(window_origin(cfg))
    b = np.floor(np.asarray(cam_pos_world_m, np.float64) / bs).astype(int)
    return bool(np.any((b - org < margin_blocks) | (org + g - b <= margin_blocks)))


def recenter_dense(vol: TSDFVolume, new_origin) -> TSDFVolume:
    """Move the dense directory's window to a new grid_origin, in place,
    without touching a voxel payload.

    Entries hold absolute block coordinates (the world frame never moves,
    only the window does, like the coverage of the reference's
    coordinate-unbounded hash, voxel_hash.cuh:13-25), so the move rebuilds
    the directory: every live block lands in its new cell, and blocks
    outside the new window go back on the free stack (their payloads
    reset on their next acquisition, voxel_mem.cu:43-51).  A new origin
    equal to the current one returns the volume unchanged.

    new_origin: (ox, oy, oz) block coords of the window's low corner, each
    within [coord_min, coord_max - grid_side + 1]."""
    cfg = vol.cfg
    if cfg.backend != "dense":
        raise ValueError("recenter_dense applies to the dense backend")
    new_cfg = dataclasses.replace(cfg, grid_origin=tuple(int(x) for x in new_origin))
    new_cfg.validate()
    if new_cfg.grid_origin == window_origin(cfg):
        return vol
    live = vol.entry_block >= 0
    cell, in_r = table_index(vol.entry_pos, new_cfg)
    keep, drop = live & in_r, live & ~in_r
    # distinct absolute coords fall in distinct cells, so one scatter of
    # the kept entries (distinct indices) rebuilds the table
    kept = keep.nonzero().flatten()
    vol.block_table = torch.full((cfg.grid_cells,), EMPTY, dtype=torch.int32,
                                 device=vol.device)
    vol.block_table[cell[kept].long()] = vol.entry_block[kept]
    _push_free(vol, drop, vol.entry_block)
    vol.entry_block.masked_fill_(drop, EMPTY)
    vol.cfg = new_cfg
    return vol
