"""PyTorch port, dense spatial index: insert (claims, duplicate
candidates, the max_new_per_round cap), delete and lookup against the
JAX package, with equal tables."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu import config as jconfig
from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.ops import hash as jh
from disinfect_slam_tpu_torch import config as tconfig
from disinfect_slam_tpu_torch.io.checkpoint import volume_from_numpy
from disinfect_slam_tpu_torch.ops import hash as th

torch.set_num_threads(1)

FIELDS = ("entry_key", "entry_block", "block_table", "heap", "num_free",
          "oob_count", "tsdf", "rgbw", "prob")


def port_cfg(cfg_j) -> tconfig.TSDFConfig:
    return tconfig.TSDFConfig(**dataclasses.asdict(cfg_j))


def jax_arrays(vol) -> dict:
    return {f: np.asarray(getattr(vol, f)) for f in FIELDS}


def port_from_jax(vol_j):
    return volume_from_numpy(jax_arrays(vol_j), port_cfg(vol_j.cfg), device="cpu")


def port_arrays(vol) -> dict:
    out = {f: getattr(vol, f).numpy() for f in FIELDS}
    out["rgbw"] = out["rgbw"].view(np.uint32)
    return out


def assert_index_equal(vol_t, vol_j):
    """Index, free list and payloads equal bit for bit."""
    a, b = port_arrays(vol_t), jax_arrays(vol_j)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


CFG = dataclasses.replace(jconfig.TINY_DENSE, max_new_per_round=16)


def _candidates(seed, n=96):
    """Block coords with duplicates, cells outside the 32^3 grid, and
    invalid rows."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-6, 6, (n, 3)).astype(np.int32)
    blocks[n // 4: n // 2] = blocks[: n // 4]  # duplicates
    blocks[-4:] = [[40, 0, 0], [0, -17, 0], [0, 0, 16], [-16, 15, 15]]
    valid = rng.uniform(size=n) < 0.9
    return blocks, valid


@pytest.mark.parametrize("rounds", [1, 3])
def test_dense_insert_matches_jax(rounds):
    vol_j = JVolume.create(CFG)
    vol_t = port_from_jax(vol_j)
    ins = jax.jit(jh.insert)
    for r in range(rounds):
        blocks, valid = _candidates(r)
        vol_j, drop_j = ins(vol_j, jnp.asarray(blocks), jnp.asarray(valid))
        vol_t, drop_t = th.insert(vol_t, torch.from_numpy(blocks),
                                  torch.from_numpy(valid))
        np.testing.assert_array_equal(drop_t.numpy(), np.asarray(drop_j))
        assert_index_equal(vol_t, vol_j)
    # the cap bit: more new blocks than max_new_per_round came in
    assert np.asarray(drop_j).any()
    np.testing.assert_array_equal(
        th.lookup(vol_t, torch.from_numpy(blocks)).numpy(),
        np.asarray(jh.lookup(vol_j, jnp.asarray(blocks))),
    )


def test_duplicate_claim_picks_the_largest_candidate_id():
    vol_t = port_from_jax(JVolume.create(CFG))
    blocks = np.zeros((5, 3), np.int32)  # five claims on one cell
    valid = np.array([True, True, False, True, False])
    vol_t, dropped = th.insert(vol_t, torch.from_numpy(blocks), torch.from_numpy(valid))
    assert int(vol_t.num_free) == CFG.num_blocks - 1
    # candidate 3 wins the cell; the other valid claims report dropped
    assert dropped.tolist() == [True, True, False, False, False]
    pool = int(th.lookup(vol_t, torch.zeros((1, 3), dtype=torch.int32))[0])
    # the first pop is the top of the stack, heap[num_free - 1]
    assert pool == CFG.num_blocks - 1
    assert (vol_t.tsdf[pool] == -1.0).all() and (vol_t.prob[pool] == 0.5).all()


def test_dense_delete_then_reinsert_matches_jax():
    vol_j = JVolume.create(CFG)
    blocks, valid = _candidates(7)
    vol_j, _ = jax.jit(jh.insert)(vol_j, jnp.asarray(blocks), jnp.asarray(valid))
    vol_t = port_from_jax(vol_j)
    rng = np.random.default_rng(8)
    entry = rng.integers(-2, CFG.num_blocks + 2, 40).astype(np.int32)
    keep = rng.uniform(size=40) < 0.7
    # entries may repeat: keep only the first of each, as carving does
    _, first = np.unique(entry, return_index=True)
    keep &= np.isin(np.arange(40), first)
    vol_j = jax.jit(jh.delete_entries)(vol_j, jnp.asarray(entry), jnp.asarray(keep))
    vol_t = th.delete_entries(vol_t, torch.from_numpy(entry), torch.from_numpy(keep))
    assert_index_equal(vol_t, vol_j)
    blocks, valid = _candidates(9)
    vol_j, _ = jax.jit(jh.insert)(vol_j, jnp.asarray(blocks), jnp.asarray(valid))
    vol_t, _ = th.insert(vol_t, torch.from_numpy(blocks), torch.from_numpy(valid))
    assert_index_equal(vol_t, vol_j)


def test_voxel_reads_match_jax():
    """read_voxels / read_tsdf / read_tsdf_miss at voxel coords inside
    allocated blocks, in free cells, at negative coordinates and beyond
    the dense grid (misses read the default voxel)."""
    vol_j = JVolume.create(CFG)
    blocks, valid = _candidates(11)
    vol_j, _ = jax.jit(jh.insert)(vol_j, jnp.asarray(blocks), jnp.asarray(valid))
    rng = np.random.default_rng(12)
    shape = vol_j.tsdf.shape
    vol_j = vol_j.replace(
        tsdf=jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32)),
        rgbw=jnp.asarray(rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
                         & np.uint32(0x28FFFFFF)),
        prob=jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32)))
    vol_t = port_from_jax(vol_j)
    cand = blocks[valid]
    pts = np.concatenate([
        cand * 8 + rng.integers(0, 8, cand.shape),  # allocated or free cells
        rng.integers(-40 * 8, 40 * 8, (400, 3)),  # free cells, negative, off-grid
    ]).astype(np.int32)
    ours = th.read_voxels(vol_t, torch.from_numpy(pts))
    ref = jh.read_voxels(vol_j, jnp.asarray(pts))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t, miss = th.read_tsdf_miss(vol_t, torch.from_numpy(pts))
    t_j, miss_j = jh.read_tsdf_miss(vol_j, jnp.asarray(pts))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(miss.numpy(), np.asarray(miss_j))
    np.testing.assert_array_equal(th.read_tsdf(vol_t, torch.from_numpy(pts)).numpy(),
                                  np.asarray(t_j))
    assert 0 < miss.float().mean() < 1 and (ours[0][miss] == 1.0).all()


def test_hash_backend_is_not_ported():
    """The hash backend is ported (tests/test_torch_hash_backend.py), and
    so is its occlusion cull (tests/test_torch_cull.py): without a depth
    frame the visible set is the plain one, and a frame whose surface
    lies behind the block culls nothing."""
    cfg = tconfig.TSDFConfig(backend="hash", num_blocks_log2=6, num_buckets_log2=6)
    vol = th.TSDFVolume.create(cfg, device="cpu")
    vol, dropped = th.insert(vol, torch.zeros((1, 3), dtype=torch.int32),
                             torch.ones(1, dtype=torch.bool))
    assert not dropped.any() and int(vol.num_active_blocks) == 1
    from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
    from disinfect_slam_tpu_torch.ops.integrate import gather_visible

    vol.cfg = dataclasses.replace(cfg, cull_occluded=True)
    cam = CameraParams.create(CameraIntrinsics.create(50.0, 50.0, 31.5, 23.5), 48, 64)
    from disinfect_slam_tpu_torch.ops.integrate import depth_to_range

    pose = SE3.from_matrix(np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.0],
                                     [0, 0, 0, 1]], np.float32))
    plain = gather_visible(vol, cam, pose)
    far = gather_visible(vol, cam, pose, torch.full((48, 64), 3.0),
                         depth_to_range(cam, "cpu"))
    assert int(plain.count) == int(far.count) == 1
