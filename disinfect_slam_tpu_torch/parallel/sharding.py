"""The TSDF volume sharded by block ownership over several devices
(counterpart of disinfect_slam_tpu/parallel/sharding.py).

The reference is single-GPU with no distributed backend (SURVEY.md §2.5).
The JAX package's design is single-controller: one process, a mesh of
devices, every device owning the blocks whose coordinate hashes to its
index (a prime mix decorrelated from the bucket hash).  The port keeps
it, with one process and no torch.distributed:

  - a mesh is a list of torch devices (`make_mesh`); shard d is a
    TSDFVolume of `shard_config(cfg, n)` (1/n of the pool) on devices[d].
    A device may repeat: [cuda:0] * 4 holds four co-resident shards on
    one card, as the JAX tests hold eight on virtual CPU devices;
  - integrate uploads the frame once per distinct device and runs, per
    shard, allocation of the blocks it owns, the visible set (no
    occlusion cull, as the JAX step), fusion (fuse_rows, K2, on a CUDA
    shard) and carving.  No data crosses shards;
  - queries gather per shard and concatenate in shard order (the JAX
    all_gather's shard-major result); render splats per shard (K4 and K5
    on a CUDA shard) and merges the images on the first shard's device
    with the JAX rule (nearest depth wins, payloads max-merged);
  - save_distributed / load_distributed write and read the JAX package's
    mesh-agnostic npz, which restores onto any shard count in either
    package.

Left out: the JAX constructor's resolution of TPU-only knobs against the
mesh's platform (the Pallas sampler, scatter_window_log2): the port has
neither.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TSDFConfig
from ..core import voxel as vx
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..ops import hash as h
from ..ops import render_fast as rf
from ..ops.cuda.splat_kernel import splat_render_cuda
from ..ops.gather import (
    BoundingCube, gather_valid, gather_voxels, to_numpy_records, volume_fingerprint,
)
from ..ops.integrate import (
    FrameInput, block_visibility, compact_mask, depth_to_range, fuse_visible,
    generate_candidates, space_carve, unique_keys,
)
from ..ops.raycast import RaycastResult
from ..systems.block_streaming import HostBlockStore
from ..utils.device import resolve_device

_OWNER_P1 = 126271
_OWNER_P2 = 522133279
_OWNER_P3 = 96002369
_M32 = 0xFFFFFFFF


def _owner_xyz(bx, by, bz, n_devices: int) -> torch.Tensor:
    """abs(x*P1 ^ y*P2 ^ z*P3) % n in the JAX package's int32 arithmetic:
    products wrap mod 2^32, abs(INT32_MIN) stays negative and the modulo
    floors.  Taken exactly in int64, so no signed overflow is relied on."""
    mix = (((bx.long() * _OWNER_P1) & _M32) ^ ((by.long() * _OWNER_P2) & _M32)
           ^ ((bz.long() * _OWNER_P3) & _M32))
    mix = torch.where(mix >= 1 << 31, mix - (1 << 32), mix)  # the int32 value
    mix = torch.where(mix == -(1 << 31), mix, mix.abs())
    return torch.remainder(mix, n_devices).to(torch.int32)


def owner_of(block: torch.Tensor, n_devices: int) -> torch.Tensor:
    """Shard index owning a block coord [..., 3] (decorrelated from the
    bucket hash so each shard's buckets fill uniformly)."""
    return _owner_xyz(block[..., 0], block[..., 1], block[..., 2], n_devices)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None
              ) -> List[torch.device]:
    """The shards' devices: `devices` as given (a device may repeat), else
    every CUDA device (without CUDA this raises); the first n_devices of
    them when given."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} shards requested, {len(devs)} devices given")
        devs = devs[:n_devices]
    return devs


def shard_config(cfg: TSDFConfig, n_devices: int) -> TSDFConfig:
    """Per-shard sub-volume config: pool capacity divided by the shard
    count.  The dense block table keeps its full spatial extent on every
    shard (ownership scatters blocks across all of space); only the hash
    bucket count shrinks with the pool."""
    shrink = max(int(np.log2(n_devices)), 0)
    kwargs = dict(num_blocks_log2=cfg.num_blocks_log2 - shrink)
    if cfg.backend == "hash":
        kwargs["num_buckets_log2"] = cfg.num_buckets_log2 - shrink
    return dataclasses.replace(cfg, **kwargs)


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


class DistributedTSDF:
    """TSDF volume sharded over a list of devices (a 1-D mesh)."""

    def __init__(self, cfg: TSDFConfig, mesh: Optional[Sequence] = None):
        self.mesh = make_mesh(devices=mesh)
        self.n_devices = len(self.mesh)
        self.cfg = cfg
        self.sub_cfg = shard_config(cfg, self.n_devices)
        self.shards = [TSDFVolume.create(self.sub_cfg, d) for d in self.mesh]
        self.spill_stores = None

    # ------------------------------------------------------------------
    def integrate(self, frame: FrameInput, intrinsics: Tuple[float, float, float, float],
                  cam_T_world: np.ndarray, max_depth: float,
                  cuts: Optional[list] = None) -> None:
        """One frame into every shard.  The frame's fields are host arrays
        or tensors on any device; each distinct device receives them once.
        Allocation runs every frame (cfg.alloc_every is not read), as in
        the JAX package's sharded step.  With a `cuts` list, each shard
        appends (new candidates past max_candidates, visible blocks past
        max_visible) as 0-d device tensors (no host wait; the candidate
        count is the dense presence filter's, None on the sort path)."""
        img_h, img_w = frame.depth.shape[:2]
        cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), img_h, img_w)
        pose = SE3.from_matrix(cam_T_world)
        max_depth = float(max_depth)
        local = {}
        for d, dev in enumerate(self.mesh):
            if dev not in local:
                fr = FrameInput(*(_as_tensor(a, dev) for a in frame))
                local[dev] = (fr, depth_to_range(cam, dev))
            fr, d2r = local[dev]
            vol, cand_over = _allocate_owned(self.shards[d], fr.depth, d2r, cam, pose,
                                             max_depth, d, self.n_devices)
            # gather_visible without the occlusion cull, its mask kept
            mask = (vol.entry_block >= 0) & block_visibility(vol.entry_pos, pose, cam, vol.cfg,
                                                             full=False)
            vis = compact_mask(vol, mask)
            if cuts is not None:
                cuts.append((cand_over, torch.clamp(
                    mask.sum(dtype=torch.int32) - vol.cfg.max_visible, min=0)))
            vol, min_abs = fuse_visible(vol, vis, fr, d2r, cam, pose, max_depth)
            self.shards[d] = space_carve(vol, vis, min_abs)

    def block_until_ready(self) -> None:
        for dev in set(self.mesh):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------
    def enable_host_spill(self) -> None:
        """Attach one HostBlockStore per shard (systems/block_streaming.py).
        Ownership is stable, so each store only ever holds blocks its shard
        owns and a restore re-places them there."""
        self.spill_stores = [HostBlockStore() for _ in range(self.n_devices)]

    def spill_store_len(self) -> int:
        return sum(len(s) for s in self.spill_stores) if self.spill_stores else 0

    def maybe_page(self, cam_pos_world_m, radius_m: float, min_free_frac: float = 0.05,
                   target_free_frac: float = 0.15) -> Tuple[int, int]:
        """Pool-pressure paging per shard, TSDFGrid.maybe_page's policy:
        under low free-pool pressure evict the farthest owned blocks
        (beyond radius_m) to the shard's host store, then restore stored
        blocks within radius_m while the pool has room.  Reads each
        shard's free count (a sync): call at waypoint cadence.  Returns
        (restored, evicted) summed over shards."""
        if not self.spill_stores:
            return (0, 0)
        restored = evicted = 0
        b = self.sub_cfg.num_blocks
        for d, store in enumerate(self.spill_stores):
            sub = self.shards[d]
            free = int(sub.num_free)
            if free < min_free_frac * b:
                sub, ev = store.spill_cold(sub, cam_pos_world_m, int(target_free_frac * b) - free,
                                           keep_radius_m=radius_m)
                evicted += ev
                free = int(sub.num_free)
            room = free - int(min_free_frac * b)
            if room > 0 and len(store):
                sub, rs = store.restore_into_window(sub, center_m=cam_pos_world_m,
                                                    radius_m=radius_m, max_restore=room)
                restored += rs
            self.shards[d] = sub
        return (restored, evicted)

    # ------------------------------------------------------------------
    def active_blocks_per_shard(self) -> List[int]:
        return [int(self.sub_cfg.num_blocks - s.num_free) for s in self.shards]

    def num_active_blocks(self) -> int:
        return sum(self.active_blocks_per_shard())

    def fingerprint(self) -> dict:
        """shards_fingerprint of this volume's shards."""
        return shards_fingerprint([{f: getattr(s, f).cpu().numpy() for f in FINGERPRINT_FIELDS}
                                   for s in self.shards])

    def gather_all_tsdf(self) -> np.ndarray:
        """Every shard's gather_valid records (x, y, z, tsdf), host [N, 4],
        in shard order."""
        return np.concatenate([to_numpy_records(gather_valid(s)) for s in self.shards])

    def query_bbox(self, bbox: BoundingCube) -> np.ndarray:
        """Distributed bbox query: every shard's in-bound voxels, host
        [N, 4] (x, y, z, tsdf) records in shard order."""
        return np.concatenate([to_numpy_records(gather_voxels(s, bbox)) for s in self.shards])

    def render(self, cam: CameraParams, cam_T_world: np.ndarray, max_depth: float
               ) -> RaycastResult:
        """Distributed splat render: each shard splats its own blocks (K4
        and K5 on a CUDA shard) and the images merge on the first shard's
        device: the nearest hit depth wins, the winners' rgba and normal
        are max-merged channel by channel with the losers at zero (shards
        tied at a pixel's depth all win it), hit is any winner.  As in
        the JAX package, each shard shades its normals from its own depth
        image, so normals (and rgba at ties) need not equal a one-shard
        render's; hit and depth do."""
        pose = SE3.from_matrix(cam_T_world)
        dev0 = self.mesh[0]
        parts = []
        for s in self.shards:
            fn = splat_render_cuda if s.device.type == "cuda" else rf.splat_render
            res = fn(s, cam, pose, float(max_depth))
            parts.append([t.to(dev0) for t in (res.hit, res.depth, res.rgba, res.normal)])
        hits, depths, rgbas, normals = (torch.stack(x) for x in zip(*parts))  # [D, H, W(, 4)]
        local_d = torch.where(hits, depths, torch.inf)
        best = local_d.amin(0)
        win = hits & (local_d <= best)
        rgba = torch.where(win[..., None], rgbas, 0).amax(0)
        normal = torch.where(win[..., None], normals, 0).amax(0)
        hit = win.any(0)
        depth = torch.where(torch.isfinite(best), best, 0.0)
        return RaycastResult(rgba=rgba, normal=normal, depth=depth, hit=hit)


# ----------------------------------------------------------------------
# fingerprint (held against the JAX package's by chip_smoke.py)
# ----------------------------------------------------------------------
FINGERPRINT_FIELDS = ("entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")


def shards_fingerprint(shard_arrays: Sequence[dict]) -> dict:
    """ops/gather.py:volume_fingerprint of the union of the shards: their
    live blocks (keys hashed in one sorted list, sums over all of them),
    the oob counts summed, and each shard's active blocks.  Each item holds
    numpy arrays under FINGERPRINT_FIELDS, from either package."""
    keys, tsdf, rgbw, prob, oob, per_shard = [], [], [], [], 0, []
    for a in shard_arrays:
        live = np.asarray(a["entry_block"]) >= 0
        rows = np.asarray(a["entry_block"])[live]
        keys.append(np.asarray(a["entry_key"])[live])
        tsdf.append(np.asarray(a["tsdf"])[rows])
        rgbw.append(np.asarray(a["rgbw"])[rows].view(np.uint32))
        prob.append(np.asarray(a["prob"])[rows])
        oob += int(np.asarray(a["oob_count"]))
        per_shard.append(int(live.sum()))
    n = sum(per_shard)
    fp = volume_fingerprint({
        "entry_key": np.concatenate(keys), "entry_block": np.arange(n, dtype=np.int32),
        "oob_count": np.asarray(oob), "tsdf": np.concatenate(tsdf),
        "rgbw": np.concatenate(rgbw), "prob": np.concatenate(prob)})
    fp["per_shard_active_blocks"] = per_shard
    return fp


# ----------------------------------------------------------------------
# elastic checkpoints
# ----------------------------------------------------------------------
def save_distributed(path: str, dist: DistributedTSDF) -> int:
    """Elastic checkpoint of a sharded volume: a mesh-agnostic dump of
    every live block (absolute coords and payload rows) plus the
    top-level config, in the JAX package's npz keys (format, cfg_json,
    pos, tsdf, rgbw as uint32, prob).  load_distributed of either package
    restores it onto any shard count.  Returns the blocks saved."""
    pos_all, tsdf_all, rgbw_all, prob_all = [], [], [], []
    for s in dist.shards:
        live = s.entry_block >= 0
        pool = s.entry_block[live].long()
        pos_all.append(s.entry_pos[live].cpu().numpy())
        tsdf_all.append(s.tsdf[pool].cpu().numpy())
        rgbw_all.append(s.rgbw[pool].cpu().numpy().view(np.uint32))
        prob_all.append(s.prob[pool].cpu().numpy())
    pos = np.concatenate(pos_all).astype(np.int32)
    cfg_json = np.frombuffer(json.dumps(dataclasses.asdict(dist.cfg)).encode(), dtype=np.uint8)
    np.savez_compressed(path, format=np.asarray(1, np.int32), cfg_json=cfg_json, pos=pos,
                        tsdf=np.concatenate(tsdf_all), rgbw=np.concatenate(rgbw_all),
                        prob=np.concatenate(prob_all))
    return int(pos.shape[0])


def load_distributed(path: str, mesh: Optional[Sequence] = None,
                     cfg: Optional[TSDFConfig] = None) -> DistributedTSDF:
    """Restore an elastic checkpoint onto `mesh` (any shard count,
    including another than it was saved from).  Blocks re-insert shard by
    shard in chunks of min(max_new_per_round, max_candidates); payload
    rows land by lookup.  Raises when a shard's pool cannot hold its
    blocks."""
    mesh = make_mesh(devices=mesh)
    with np.load(path) as data:
        if cfg is None:
            fields = json.loads(bytes(data["cfg_json"]).decode())
            fields["grid_origin"] = (tuple(fields["grid_origin"])
                                     if fields.get("grid_origin") else None)
            cfg = TSDFConfig(**fields)
        pos = np.asarray(data["pos"], np.int32)
        tsdf, prob = data["tsdf"], data["prob"]
        rgbw = np.asarray(data["rgbw"]).view(np.int32)
    dist = DistributedTSDF(cfg, mesh)
    owners = owner_of(torch.from_numpy(pos), dist.n_devices).numpy()
    sub_cfg = dist.sub_cfg
    step = min(sub_cfg.max_new_per_round, sub_cfg.max_candidates)
    for d, sub in enumerate(dist.shards):
        sel = owners == d
        p = torch.from_numpy(pos[sel]).to(sub.device)
        for lo in range(0, p.shape[0], step):
            chunk = p[lo:lo + step]
            sub, dropped = h.insert(sub, chunk, torch.ones(chunk.shape[0], dtype=torch.bool,
                                                           device=sub.device))
            n_drop = int(dropped.sum())
            if n_drop:
                raise ValueError(
                    f"shard {d}: {n_drop} blocks did not fit the sub-volume (capacity "
                    f"2^{sub_cfg.num_blocks_log2}); restore onto more devices or a larger "
                    "pool")
        if p.shape[0]:
            rows = h.lookup(sub, p).long()
            for name, arr in (("tsdf", tsdf), ("rgbw", rgbw), ("prob", prob)):
                getattr(sub, name)[rows] = torch.from_numpy(
                    np.ascontiguousarray(arr[sel])).to(sub.device)
        dist.shards[d] = sub
    return dist


# ----------------------------------------------------------------------
# allocation of the owned blocks
# ----------------------------------------------------------------------
def _allocate_owned(vol: TSDFVolume, frame_depth: torch.Tensor, d2r: torch.Tensor,
                    cam: CameraParams, cam_T_world: SE3, max_depth: float, my_idx: int,
                    n_devices: int) -> Tuple[TSDFVolume, Optional[torch.Tensor]]:
    """allocate_blocks with an ownership filter on the candidates, in
    place: each shard allocates only its own blocks.  Returns the volume
    and the new candidates the max_candidates compaction dropped (0-d;
    None on the sort path, whose cut this does not count).  On the dense
    backend with alloc_dedup="filter" the ownership test joins the
    presence filter BEFORE the compaction into max_candidates slots; on
    the sort path it gates the sorted distinct keys AFTER the cut.  The
    order is the JAX package's (it decides what a max_candidates cut
    keeps).  As there, candidates off the dense grid drop uncounted."""
    cfg = vol.cfg
    keys, oob = generate_candidates(frame_depth, d2r, cam, cam_T_world, cam_T_world.inverse(),
                                    max_depth, cfg)
    sent = vx.sentinel_key(cfg)
    left = torch.cat([keys.new_full((1,), -1), keys[:-1]])
    keys = torch.where(keys == left, sent, keys)

    if cfg.alloc_dedup == "filter" and cfg.backend == "dense":
        ks = torch.where(keys < sent, keys, 0)
        cb = cfg.coord_bits
        koff = 1 << (cb - 1)
        kmask = (1 << cb) - 1
        kx = (ks & kmask) - koff
        ky = ((ks >> cb) & kmask) - koff
        kz = ((ks >> (2 * cb)) & kmask) - koff
        cell, in_range = h.table_index_xyz(kx, ky, kz, cfg)
        exists = vol.block_table[cell.long()] >= 0
        owned = _owner_xyz(kx, ky, kz, n_devices) == my_idx
        new = (keys < sent) & in_range & ~exists & owned
        rank = h.cumsum_i32(new) - 1
        cap = cfg.max_candidates
        # slot `cap` is a scratch slot that takes every dropped key
        slot = torch.where(new & (rank < cap), rank, cap).long()
        compact = keys.new_full((cap + 1,), sent)
        compact[slot] = keys
        compact = compact[:cap]
        valid = compact < sent
        coords = vx.unpack_block_coord(torch.where(valid, compact, 0), cfg)
        dropped = torch.clamp(rank[-1] + 1 - cap, min=0)
    else:
        uniq = unique_keys(keys, cfg.max_candidates, sent)
        coords = vx.unpack_block_coord(uniq, cfg)
        valid = (uniq < sent) & (owner_of(coords, n_devices) == my_idx)
        dropped = None
    valid = valid & block_visibility(coords, cam_T_world, cam, cfg, full=True)
    vol, _ = h.insert(vol, coords, valid)
    vol.oob_count = vol.oob_count + oob
    return vol, dropped
