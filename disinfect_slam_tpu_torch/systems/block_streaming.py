"""Host-RAM block streaming (counterpart of
disinfect_slam_tpu/systems/block_streaming.py): blocks that leave the
dense window on a recenter, or that pool pressure evicts, spill to host
memory and come back voxel for voxel when the camera returns.

The reference reserved this mode and never built it: voxel_mem.cuh:76-77
keeps `offset < 0` for "voxel block on CPU".  With a HostBlockStore on
TSDFGrid the card holds the active window and the host holds everything
mapped so far.

Cadence: spill and restore run inside recenter and maybe_page (host
coordinated, at waypoint cadence); the per-frame fusion is untouched.

Policies:
  - spill: every live block falling outside the new window is copied to
    the host (coordinate + tsdf/rgbw/prob rows) before recenter_dense
    releases its pool row.  A re-spill of a coordinate overwrites the
    stored copy (newest wins).
  - restore: stored blocks inside the window are batch-inserted and their
    payloads written back, then dropped from the store.  A coordinate
    that is live on the card again merges: the live row was re-fused from
    a reset after the eviction, so the two rows hold disjoint
    observations and the weight-proportional fusion of _merge_rows loses
    neither.  Blocks the insert drops (pool exhausted, claim rounds lost)
    stay in the store for the next pass, fail-open like the reference's
    lock miss (voxel_hash.cu:83-89).
  - checkpointing: save_npz / load_npz persist the store beside a volume
    checkpoint, with the JAX package's keys, so a store written by either
    package loads in the other.

The store holds numpy rows: tsdf f32, the RGBW word as uint32 (the JAX
layout; the card holds its int32 view) and prob f32.  Transfers take the
exact row counts; the JAX package pads them to bound XLA recompiles, which
eager torch has none of.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import voxel as vx
from ..core.state import TSDFVolume
from ..ops.hash import delete_entries, insert, lookup, recenter_dense, table_index

logger = logging.getLogger("disinfect_slam_tpu_torch.block_streaming")

_Key = Tuple[int, int, int]
# payload rows of a block: (tsdf f32 [V], rgbw u32 [V], prob f32 [V])
_Payload = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _merge_rows(t_l, c_l, p_l, t_s, c_s, p_s, max_weight, prob_eps=0.0):
    """Combine two independently fused payload rows with the engine's
    weight-proportional fusion formulas (ops/integrate.py fuse_visible,
    voxel_tsdf.cu:189-202), op for op as the JAX package in float64 on
    the host: round half away from zero, and log-odds with powf(0,0)=1.

    Used when a restore finds its coordinate live on the card again: the
    live row re-accumulated from a reset after the stored row was
    evicted, so the two rows fuse disjoint observations.  Voxels
    unobserved on one side (w == 0) take the other side's bits."""
    w_l = (c_l >> 24).astype(np.float64)
    w_s = (c_s >> 24).astype(np.float64)
    w_c = w_l + w_s
    w_safe = np.where(w_c == 0, 1.0, w_c)

    def ch(c, sh):
        return ((c >> sh) & 0xFF).astype(np.float64)

    def rha(x):  # round half away from zero, like the engine
        return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))

    t = (t_l.astype(np.float64) * w_l + t_s.astype(np.float64) * w_s) / w_safe
    r = rha((ch(c_l, 0) * w_l + ch(c_s, 0) * w_s) / w_safe)
    g = rha((ch(c_l, 8) * w_l + ch(c_s, 8) * w_s) / w_safe)
    b = rha((ch(c_l, 16) * w_l + ch(c_s, 16) * w_s) / w_safe)
    w = np.minimum(rha(w_c), max_weight)

    # log-odds geometric fusion with the powf(0,0) == 1 edge semantics
    def plog(x, e):
        # log(0) = -inf, and 0 * -inf = nan where e == 0 is masked
        with np.errstate(divide="ignore", invalid="ignore"):
            lg = np.log(x.astype(np.float64))
            return np.where(e == 0.0, 0.0, e * lg)

    e_l = w_l / w_safe
    e_s = w_s / w_safe
    pos = np.exp(plog(p_l, e_l) + plog(p_s, e_s))
    neg = np.exp(plog(1.0 - p_l, e_l) + plog(1.0 - p_s, e_s))
    den = pos + neg
    p = np.where(den > 0, pos / np.where(den > 0, den, 1.0), p_l)
    if prob_eps > 0.0:
        p = np.clip(p, prob_eps, 1.0 - prob_eps)

    word = (
        r.astype(np.uint32)
        | (g.astype(np.uint32) << 8)
        | (b.astype(np.uint32) << 16)
        | (w.astype(np.uint32) << 24)
    )
    # exact shortcuts: a voxel unobserved on one side takes the other
    # side's bits verbatim (the float64 forms are float-faithful only)
    t = np.where(w_s == 0, t_l, np.where(w_l == 0, t_s, t))
    word = np.where(w_s == 0, c_l, np.where(w_l == 0, c_s, word))
    p = np.where(w_s == 0, p_l, np.where(w_l == 0, p_s, p))
    return t.astype(np.float32), word.astype(np.uint32), p.astype(np.float32)


def _key(c) -> _Key:
    return tuple(int(x) for x in c)


def _rows_to_host(vol: TSDFVolume, rows) -> _Payload:
    """The tsdf, rgbw (as uint32) and prob rows [n, V] of pool rows."""
    idx = torch.as_tensor(np.asarray(rows), device=vol.device).long()
    return (vol.tsdf[idx].cpu().numpy(),
            vol.rgbw[idx].cpu().numpy().view(np.uint32),
            vol.prob[idx].cpu().numpy())


def _write_rows(vol: TSDFVolume, rows: np.ndarray, tsdf, rgbw, prob) -> None:
    """Write payload rows [n, V] into distinct pool rows, in place."""
    idx = torch.as_tensor(rows, device=vol.device).long()
    vol.tsdf[idx] = torch.from_numpy(np.ascontiguousarray(tsdf)).to(vol.device)
    vol.rgbw[idx] = torch.from_numpy(
        np.ascontiguousarray(rgbw).view(np.int32)).to(vol.device)
    vol.prob[idx] = torch.from_numpy(np.ascontiguousarray(prob)).to(vol.device)


class HostBlockStore:
    """Dict of spilled blocks, keyed by absolute block coordinate."""

    def __init__(self) -> None:
        self._store: Dict[_Key, _Payload] = {}

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key) -> bool:
        return _key(key) in self._store

    def nbytes(self) -> int:
        if not self._store:
            return 0
        v = next(iter(self._store.values()))
        per = sum(a.nbytes for a in v) + 3 * 4
        return per * len(self._store)

    def payload(self, key) -> _Payload:
        return self._store[_key(key)]

    # ------------------------------------------------------------------
    def _stash(self, vol: TSDFVolume, coords: np.ndarray, rows: np.ndarray) -> None:
        """Copy pool rows [n] to the host and store them under coords."""
        tsdf, rgbw, prob = _rows_to_host(vol, rows)
        for i in range(rows.shape[0]):
            self._store[_key(coords[i])] = (tsdf[i], rgbw[i], prob[i])

    def spill_out_of_window(self, vol: TSDFVolume, new_cfg) -> int:
        """Copy every live block outside new_cfg's dense window into the
        store.  Call before ops.hash.recenter_dense (which releases those
        pool rows).  Returns the blocks spilled."""
        pos = vol.entry_pos
        _, in_r = table_index(pos, new_cfg)
        drop = ((vol.entry_block >= 0) & ~in_r).nonzero().flatten()
        n = int(drop.numel())
        if n == 0:
            return 0
        self._stash(vol, pos[drop].cpu().numpy(), vol.entry_block[drop].cpu().numpy())
        logger.info("[spill] %d blocks -> host store (%d total, %.1f MB)",
                    n, len(self._store), self.nbytes() / 1e6)
        return n

    # ------------------------------------------------------------------
    def spill_cold(self, vol: TSDFVolume, cam_pos_m, n_evict: int,
                   keep_radius_m: float = 0.0) -> Tuple[TSDFVolume, int]:
        """Pool-pressure eviction: store and delete the n_evict live blocks
        farthest from cam_pos_m, never one within keep_radius_m (the
        reference simply stops allocating when its pool is exhausted,
        voxel_mem.cu AquireBlock).  Works on both index backends.
        Returns (volume, blocks evicted)."""
        cfg = vol.cfg
        entry_block = vol.entry_block.cpu().numpy()
        idx = np.nonzero(entry_block >= 0)[0]
        if idx.size == 0 or n_evict <= 0:
            return vol, 0
        entry_pos = vol.entry_pos.cpu().numpy()
        pos = entry_pos[idx].astype(np.float64)
        centers = (pos * cfg.block_len + cfg.block_len / 2.0) * cfg.voxel_size
        dist = np.linalg.norm(centers - np.asarray(cam_pos_m, np.float64), axis=1)
        order = np.argsort(-dist)  # farthest first
        if keep_radius_m > 0.0:
            # never evict inside the keep radius: those blocks may be in the
            # frustum, and evicting them would churn straight back in
            # through restore; under-evicting is safe (allocation stays
            # fail-open)
            far = order[dist[order] > keep_radius_m]
            if far.size < n_evict:
                logger.warning(
                    "[spill-cold] pool pressure inside keep radius: wanted %d "
                    "evictions, only %d blocks beyond %.1f m",
                    n_evict, far.size, keep_radius_m)
            pick = far[:n_evict]
        else:
            pick = order[:n_evict]
        if pick.size == 0:
            return vol, 0
        sel = idx[pick]
        self._stash(vol, entry_pos[sel], entry_block[sel])
        eidx = torch.as_tensor(sel.astype(np.int32), device=vol.device)
        vol = delete_entries(vol, eidx, torch.ones_like(eidx, dtype=torch.bool))
        logger.info("[spill-cold] evicted %d blocks beyond %.1f m (%d stored, %.1f MB)",
                    sel.size, keep_radius_m, len(self._store), self.nbytes() / 1e6)
        return vol, int(sel.size)

    # ------------------------------------------------------------------
    def restore_into_window(self, vol: TSDFVolume, center_m=None, radius_m: float = 0.0,
                            max_restore: Optional[int] = None) -> Tuple[TSDFVolume, int]:
        """Insert the stored blocks that vol.cfg covers (the dense window,
        or the packed-coordinate range on the hash backend) and write
        their payloads back.  Call after recenter_dense, or at paging
        cadence with (center_m, radius_m) to bring back only the blocks
        near the camera, nearest first, at most max_restore.  Returns
        (volume, blocks restored)."""
        cfg = vol.cfg
        if not self._store:
            return vol, 0
        keys = np.array(list(self._store.keys()), np.int32).reshape(-1, 3)
        kt = torch.from_numpy(keys)
        if cfg.backend == "dense":
            _, in_r = table_index(kt, cfg)
        else:
            in_r = vx.in_coord_range(kt, cfg)
        sel = in_r.numpy()
        if center_m is not None and radius_m > 0.0:
            centers = (keys.astype(np.float64) * cfg.block_len
                       + cfg.block_len / 2.0) * cfg.voxel_size
            dist = np.linalg.norm(centers - np.asarray(center_m, np.float64), axis=1)
            sel = sel & (dist <= radius_m)
            # nearest first, so that a max_restore cap keeps the closest
            order = np.argsort(dist)
            cand = keys[order][sel[order]]
        else:
            cand = keys[sel]
        if max_restore is not None:
            cand = cand[:max_restore]
        if cand.shape[0] == 0:
            return vol, 0

        restored = 0
        chunk_rows = min(cfg.max_new_per_round, 4096)
        for lo in range(0, cand.shape[0], chunk_rows):
            chunk = cand[lo:lo + chunk_rows]
            cj = torch.from_numpy(chunk).to(vol.device)
            before = lookup(vol, cj).cpu().numpy()
            fresh = before < 0
            vol, _ = insert(vol, cj, torch.from_numpy(fresh).to(vol.device))
            after = lookup(vol, cj).cpu().numpy()
            ok = fresh & (after >= 0)
            payloads = [self._store[_key(c)] for c in chunk]

            # coordinates live again on the card: the live row re-fused from
            # a reset after the eviction, so merge the stored history in
            conflicts = np.nonzero(~fresh)[0]
            if conflicts.size:
                rows = before[conflicts]
                live = _rows_to_host(vol, rows)
                stored = [np.stack([payloads[i][k] for i in conflicts]) for k in range(3)]
                merged = _merge_rows(*live, *stored, max_weight=cfg.max_weight,
                                     prob_eps=cfg.prob_eps)
                _write_rows(vol, rows, *merged)

            placed = np.nonzero(ok)[0]
            if placed.size:
                # the stored payloads over the freshly reset rows
                _write_rows(vol, after[placed],
                            *(np.stack([payloads[i][k] for i in placed]) for k in range(3)))
            # consumed: restored blocks and merged conflicts; blocks the
            # insert dropped stay for the next pass
            for i in np.nonzero(ok | ~fresh)[0]:
                del self._store[_key(chunk[i])]
            restored += int(placed.size + conflicts.size)

        logger.info("[restore] %d blocks <- host store (%d in-window unplaced, "
                    "%d still stored)", restored, int(cand.shape[0]) - restored,
                    len(self._store))
        return vol, restored

    # ------------------------------------------------------------------
    def spatial_records(self, cfg) -> np.ndarray:
        """[N, 4] (x, y, z, tsdf) world-metre records of every stored
        voxel in the VoxelSpatialTSDF dump layout (voxel_types.cuh:33-41,
        ops/gather.py), so that a --save export covers spilled blocks."""
        if not self._store:
            return np.zeros((0, 4), np.float32)
        bl = cfg.block_len
        idx = np.arange(cfg.block_volume)
        mask = bl - 1
        offs = np.stack(
            [idx & mask, (idx >> cfg.block_len_log2) & mask,
             (idx >> (2 * cfg.block_len_log2)) & mask], axis=-1
        )  # core/voxel.py index_to_offset's in-block order
        keys = np.array(list(self._store.keys()), np.int64)  # [M, 3]
        t = np.stack([v[0] for v in self._store.values()])  # [M, V]
        # float32 before the metre scale, as ops/gather.py's dump does
        pos = (keys[:, None, :] * bl + offs[None, :, :]).astype(
            np.float32) * np.float32(cfg.voxel_size)
        rec = np.concatenate([pos.reshape(-1, 3), t.reshape(-1, 1)], axis=1)
        return rec.astype(np.float32)

    def save_npz(self, path: str) -> None:
        """Persist the store beside a volume checkpoint."""
        if self._store:
            keys = np.array(list(self._store.keys()), np.int32)
            t, c, p = (np.stack([v[k] for v in self._store.values()]) for k in range(3))
        else:
            keys = np.zeros((0, 3), np.int32)
            t = np.zeros((0, 0), np.float32)
            c = np.zeros((0, 0), np.uint32)
            p = np.zeros((0, 0), np.float32)
        np.savez_compressed(path, keys=keys, tsdf=t, rgbw=c, prob=p)

    @classmethod
    def load_npz(cls, path: str) -> "HostBlockStore":
        z = np.load(path)
        store = cls()
        keys, t, c, p = z["keys"], z["tsdf"], z["rgbw"], z["prob"]
        for i in range(keys.shape[0]):
            store._store[_key(keys[i])] = (t[i], c[i].view(np.uint32), p[i])
        return store


def recenter_through(store: Optional[HostBlockStore], vol: TSDFVolume,
                     new_origin) -> TSDFVolume:
    """ops.hash.recenter_dense through a host store (None: the plain
    move): the blocks leaving the window spill first, and after the move
    the stored blocks the new window covers come back, capped by the
    pool's headroom less 5% (an uncapped restore after a long paged drive
    would exhaust the pool again and undo maybe_page's evictions)."""
    if store is not None:
        store.spill_out_of_window(vol, dataclasses.replace(vol.cfg, grid_origin=new_origin))
    vol = recenter_dense(vol, new_origin)
    if store is not None:
        room = max(0, int(vol.num_free) - int(0.05 * vol.cfg.num_blocks))
        if room:
            vol, _ = store.restore_into_window(vol, max_restore=room)
    return vol
