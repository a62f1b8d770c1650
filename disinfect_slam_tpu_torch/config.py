"""Engine configuration of the PyTorch/CUDA port.

The fields, defaults and presets are those of `disinfect_slam_tpu.config`
(field for field; tests/test_torch_core.py pins the two together).  The
class is declared here rather than imported so that the port, and the
GPU smoke run that drives it, load nothing of the JAX package.

Knobs that only steer how the TPU program is laid out, and provably do
not change results, are accepted and ignored by the port:
`scatter_window_log2`, `fuse_ladder`, `index_hints`, `sample_tile`,
`patch_h` / `patch_w`.  `sampler_splits` is ignored too: the port loads
every sample exactly, which equals `sampler_splits=3`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """Static configuration of a TSDF volume (see the JAX package's
    config.py for the rationale of every field)."""

    voxel_size: float = 0.01
    truncation: float = 0.06
    num_buckets_log2: int = 18
    entries_per_bucket_log2: int = 1
    num_blocks_log2: int = 16
    block_len_log2: int = 3
    max_probe: int = 16
    max_candidates: int = 16384
    insert_rounds: int = 3
    max_new_per_round: int = 4096
    max_visible: int = 16384
    max_weight: float = 40.0
    carve_threshold: float = 0.9
    prob_eps: float = 0.0
    coord_bits: int = 10
    backend: str = "dense"
    grid_log2: int = 8
    grid_origin: tuple | None = None
    # "gather" / "pallas": sample kernel + torch fusion math (two stages);
    # "auto" / "pallas_fused": the fused sample+fusion kernel
    sampler: str = "auto"
    # drop the visible blocks the frame's nearer surface occludes
    # (integrate.occluded_blocks); fusion's outcome stays the same
    cull_occluded: bool = False
    raycast_skip: bool = True
    # "filter" applies to the dense backend; the hash backend, and
    # "sort" on either, dedup the candidates by sorting them
    alloc_dedup: str = "filter"
    index_hints: bool = True  # TPU-only, ignored
    scatter_window_log2: int = -1  # TPU-only, ignored
    patch_h: int = 24  # TPU-only, ignored
    patch_w: int = 32  # TPU-only, ignored
    sample_tile: int = 64  # TPU-only, ignored
    sampler_splits: int = 3  # ignored: samples are always exact (= 3)
    alloc_stride: int = 1
    fuse_ladder: int = 1  # TPU-only, ignored
    alloc_every: int = 1

    @property
    def block_len(self) -> int:
        return 1 << self.block_len_log2

    @property
    def block_volume(self) -> int:
        return 1 << (3 * self.block_len_log2)

    @property
    def num_buckets(self) -> int:
        return 1 << self.num_buckets_log2

    @property
    def entries_per_bucket(self) -> int:
        return 1 << self.entries_per_bucket_log2

    @property
    def num_entries(self) -> int:
        # dense backend: the pool IS the entry list (slot i <-> pool i)
        if self.backend == "dense":
            return 1 << self.num_blocks_log2
        return 1 << (self.num_buckets_log2 + self.entries_per_bucket_log2)

    @property
    def entry_mask(self) -> int:
        return self.num_entries - 1

    @property
    def bucket_mask(self) -> int:
        return self.num_buckets - 1

    @property
    def num_blocks(self) -> int:
        return 1 << self.num_blocks_log2

    @property
    def coord_min(self) -> int:
        return -(1 << (self.coord_bits - 1))

    @property
    def coord_max(self) -> int:
        return (1 << (self.coord_bits - 1)) - 1

    @property
    def grid_side(self) -> int:
        return 1 << self.grid_log2

    @property
    def grid_cells(self) -> int:
        return 1 << (3 * self.grid_log2)

    def refine_iters(self, step_size: float) -> int:
        """Static iteration count of the raycaster's binary refinement:
        the reference refines while the squared endpoint gap in voxels
        exceeds 0.1 (voxel_tsdf.cu:265), and the gap quarters per
        iteration."""
        gap_sq = (step_size / self.voxel_size) ** 2
        iters = 0
        while gap_sq > 0.1 and iters < 16:
            gap_sq /= 4.0
            iters += 1
        return max(iters, 1)

    def validate(self) -> None:
        if self.truncation <= self.voxel_size:
            raise ValueError("truncation must exceed voxel_size")
        if 3 * self.coord_bits > 30:
            raise ValueError("packed block coord must fit int32")
        if self.backend not in ("hash", "dense"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.alloc_stride < 1 or self.alloc_every < 1:
            raise ValueError("alloc_stride and alloc_every must be >= 1")
        if self.backend == "hash":
            if self.max_probe < self.entries_per_bucket:
                raise ValueError("max_probe must cover a bucket's entries")
            if self.num_blocks > self.num_entries:
                raise ValueError("the hash table needs an entry per pool block")
        else:
            if self.grid_log2 > self.coord_bits:
                raise ValueError("grid_log2 must not exceed coord_bits")
            if self.grid_origin is not None:
                if len(self.grid_origin) != 3:
                    raise ValueError("grid_origin needs 3 coordinates")
                for o in self.grid_origin:
                    if not (self.coord_min <= o
                            and o + self.grid_side - 1 <= self.coord_max):
                        raise ValueError(
                            "grid [origin, origin+side) must fit the packed "
                            "coord range")


# small configs for the tests (the JAX package's TINY and TINY_DENSE)
TINY = TSDFConfig(
    num_buckets_log2=8,
    num_blocks_log2=8,
    max_probe=8,
    max_candidates=512,
    max_visible=256,
    max_new_per_round=256,
    backend="hash",
)

TINY_DENSE = TSDFConfig(
    num_blocks_log2=8,
    max_candidates=512,
    max_visible=256,
    max_new_per_round=256,
    backend="dense",
    grid_log2=5,
)

# The offline benchmark's capacity config (bench.py, accelerator branch):
# 4 mm voxels, 2^18-block pool, 32k visible blocks, DDA pixel stride 4,
# allocation every 3rd frame.  Replayed with max_depth 4.0.
BENCH = TSDFConfig(
    voxel_size=0.004,
    truncation=0.024,
    num_buckets_log2=19,
    num_blocks_log2=18,
    max_candidates=32768,
    max_visible=32768,
    max_new_per_round=8192,
    max_probe=16,
    sampler_splits=2,
    alloc_stride=4,
    alloc_every=3,
)
BENCH_MAX_DEPTH = 4.0

# the default single-card config, the reference's offline example
# (examples/tsdf/offline.cc:90: voxel 0.01 m, truncation 0.06 m)
DEFAULT = TSDFConfig()
