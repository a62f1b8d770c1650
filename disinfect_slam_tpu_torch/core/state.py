"""The TSDF volume as a dataclass of device tensors (counterpart of
disinfect_slam_tpu/core/state.py; reference VoxelMemPool
voxel_mem.cuh:95-174 and VoxelHashTable voxel_hash.cuh:47-183).

Unlike the JAX pytree, the port's volume is mutable: ops update its
tensors in place where that saves a copy of a pool-sized array, and say
so where they do.

Entry states in `entry_block`: >= 0 pool index, EMPTY (-1) free,
TOMBSTONE (-2) a deleted hash entry that probes walk through; every
liveness test is `entry_block >= 0`.

Payloads: tsdf f32, prob f32 and the packed VoxelRGBW word
r | g << 8 | b << 16 | weight << 24 (voxel_types.cuh:10-19).  torch has
no full uint32 arithmetic, so the word is held as int32 carrying the u32
bit pattern; the weight is at most 40, so the sign bit never sets and
arithmetic shifts equal logical ones.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import TSDFConfig
from ..utils.device import resolve_device
from .voxel import unpack_block_coord

EMPTY = -1
TOMBSTONE = -2

# unallocated voxels read as tsdf=+1, prob=0 (voxel_types.cu:8-12)
DEFAULT_TSDF = 1.0
DEFAULT_PROB = 0.0

# freshly acquired blocks reset to tsdf=-1, prob=0.5 (voxel_mem.cu:43-51);
# the packed rgbw word resets to 0 (weight 0, rgb 0)
RESET_TSDF = -1.0
RESET_PROB = 0.5


@dataclasses.dataclass
class TSDFVolume:
    """Mutable TSDF volume state; every tensor lives on one device."""

    entry_key: torch.Tensor  # int32 [E] packed block coordinate
    entry_block: torch.Tensor  # int32 [E] pool idx / EMPTY / TOMBSTONE
    block_table: torch.Tensor  # int32 [G^3] grid cell -> pool idx (dense); [1] (hash)
    heap: torch.Tensor  # int32 [B] stack of free pool indices
    num_free: torch.Tensor  # int32 [] stack top (= number of free blocks)
    oob_count: torch.Tensor  # int32 [] dropped out-of-coverage candidates
    tsdf: torch.Tensor  # f32 [B, 512]
    rgbw: torch.Tensor  # int32 [B, 512] packed u32 RGBW bit pattern
    prob: torch.Tensor  # f32 [B, 512] high-touch probability
    cfg: TSDFConfig

    @classmethod
    def create(cls, cfg: TSDFConfig, device="cuda") -> "TSDFVolume":
        """A fresh volume on `device` (CUDA unless the caller asks for
        another; without CUDA the default raises)."""
        device = resolve_device(device)
        cfg.validate()
        e, b, v = cfg.num_entries, cfg.num_blocks, cfg.block_volume
        table_size = cfg.grid_cells if cfg.backend == "dense" else 1
        # key of coordinate (0, 0, 0), as in the JAX package
        off = 1 << (cfg.coord_bits - 1)
        key0 = off | (off << cfg.coord_bits) | (off << (2 * cfg.coord_bits))
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            entry_key=torch.full((e,), key0, **i32),
            entry_block=torch.full((e,), EMPTY, **i32),
            block_table=torch.full((table_size,), EMPTY, **i32),
            # the stack pops from the top, heap[num_free - 1] first
            # (AquireBlock, voxel_mem.cu:37-42)
            heap=torch.arange(b, **i32),
            num_free=torch.tensor(b, **i32),
            oob_count=torch.zeros((), **i32),
            tsdf=torch.full((b, v), DEFAULT_TSDF, **f32),
            rgbw=torch.zeros((b, v), **i32),
            prob=torch.full((b, v), DEFAULT_PROB, **f32),
            cfg=cfg,
        )

    @property
    def device(self) -> torch.device:
        return self.tsdf.device

    @property
    def entry_pos(self) -> torch.Tensor:
        """Unpacked [E, 3] block-coordinate view of entry_key."""
        return unpack_block_coord(self.entry_key, self.cfg)

    @property
    def num_active_blocks(self) -> torch.Tensor:
        """NumActiveBlock (voxel_hash.cu:207), a 0-d device tensor."""
        return self.cfg.num_blocks - self.num_free

    # unpacked payload views (the engine reads .rgbw directly; these are
    # for exports, tests and tooling)
    @property
    def weight(self) -> torch.Tensor:
        """u8 [B, V] fusion weight (VoxelRGBW.weight view)."""
        return ((self.rgbw >> 24) & 0xFF).to(torch.uint8)

    @property
    def rgb(self) -> torch.Tensor:
        """u8 [B, V, 3] color (VoxelRGBW.rgb view)."""
        return torch.stack([((self.rgbw >> s) & 0xFF).to(torch.uint8) for s in (0, 8, 16)],
                           dim=-1)

    def nbytes(self) -> int:
        """Bytes of the hash table, the free-block stack and the payload
        pools (the JAX package's count: the scalars are left out)."""
        return sum(t.numel() * t.element_size() for t in (
            self.entry_key, self.entry_block, self.block_table, self.heap,
            self.tsdf, self.rgbw, self.prob))

    def clone(self) -> "TSDFVolume":
        """Deep copy of every tensor (a consistent snapshot)."""
        return dataclasses.replace(
            self,
            **{f.name: getattr(self, f.name).clone()
               for f in dataclasses.fields(self) if f.name != "cfg"},
        )
