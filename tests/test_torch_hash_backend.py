"""PyTorch port, the hash backend: the 3-prime hash, claim rounds,
tombstones and heap pops against the JAX package bit for bit (the
collision fixture and the insert, delete and exhaustion cases of
tests/test_hash.py, and random insert/delete sequences after
tests/test_hash_fuzz.py); the sort dedup; fusion and rendering of a
hash-backend volume; the dense window's recenter (tests/test_extent.py's
corridor, through TSDFGrid and DISINFSystem)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu import config as jconfig
from disinfect_slam_tpu.config import TSDFConfig as JConfig
from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.ops import hash as jh
from disinfect_slam_tpu.ops import render_fast as jrf
from disinfect_slam_tpu.ops.raycast import raycast as j_raycast
from disinfect_slam_tpu_torch import config as tconfig
from disinfect_slam_tpu_torch.core.geometry import SE3
from disinfect_slam_tpu_torch.ops import hash as th
from disinfect_slam_tpu_torch.ops import render_fast as rf
from disinfect_slam_tpu_torch.ops.integrate import unique_keys
from disinfect_slam_tpu_torch.ops.raycast import raycast
from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

from . import test_extent as ext
from .scenes import look_at, render_sphere, render_wall
from .test_integrate import CFG as J_HASH_CFG
from .test_integrate import H, K, W, make_frame
from .test_raycast import fuse_frames
from .test_torch_hash import assert_index_equal, port_cfg, port_from_jax
from .test_torch_integrate import _run_jax, _run_port, _scene, assert_matches_jax
from .test_torch_render import CAM, JCAM

torch.set_num_threads(1)

TINY = jconfig.TINY
_insert = jax.jit(jh.insert)
_delete = jax.jit(jh.delete_entries)


def _both(cfg_j=TINY):
    vol_j = JVolume.create(cfg_j)
    return vol_j, port_from_jax(vol_j)


def _ins(vols, coords, valid=None):
    vol_j, vol_t = vols
    coords = np.asarray(coords, np.int32)
    valid = np.ones(len(coords), bool) if valid is None else valid
    vol_j, drop_j = _insert(vol_j, jnp.asarray(coords), jnp.asarray(valid))
    vol_t, drop_t = th.insert(vol_t, torch.from_numpy(coords), torch.from_numpy(valid))
    np.testing.assert_array_equal(drop_t.numpy(), np.asarray(drop_j))
    assert_index_equal(vol_t, vol_j)
    return (vol_j, vol_t), np.asarray(drop_j)


def _lookups_equal(vols, coords):
    vol_j, vol_t = vols
    c = np.asarray(coords, np.int32)
    for fj, ft in ((jh.lookup, th.lookup), (jh.lookup_entry, th.lookup_entry)):
        np.testing.assert_array_equal(ft(vol_t, torch.from_numpy(c)).numpy(),
                                      np.asarray(fj(vol_j, jnp.asarray(c))))


def test_tiny_config_is_the_jax_one():
    assert dataclasses.asdict(tconfig.TINY) == dataclasses.asdict(jconfig.TINY)
    for p in ("num_buckets", "entries_per_bucket", "num_entries", "entry_mask",
              "bucket_mask", "num_blocks"):
        assert getattr(tconfig.TINY, p) == getattr(jconfig.TINY, p), p


def test_hash_block_matches_jax_and_the_uint32_formula():
    """voxel_hash.cu:31-35 in uint32 arithmetic, on coords whose products
    overflow 32 bits (and the packed-range extremes)."""
    rng = np.random.default_rng(0)
    coords = np.concatenate([
        rng.integers(-(1 << 20), 1 << 20, (500, 3)),
        [[0, 0, 0], [-512, 511, -1], [1000, -500, 77], [2**31 - 1, -2**31, 12345]],
    ]).astype(np.int32)
    cfg = port_cfg(dataclasses.replace(TINY, num_buckets_log2=19))
    ours = th.hash_block(torch.from_numpy(coords), cfg).numpy()
    ref = np.asarray(jh.hash_block(jnp.asarray(coords), dataclasses.replace(
        TINY, num_buckets_log2=19)))
    np.testing.assert_array_equal(ours, ref)
    u = coords.astype(np.int64).astype(np.uint64)
    expect = (((u[:, 0] * 73856093) & 0xFFFFFFFF) ^ ((u[:, 1] * 19349669) & 0xFFFFFFFF)
              ^ ((u[:, 2] * 83492791) & 0xFFFFFFFF)) & np.uint64(cfg.bucket_mask)
    np.testing.assert_array_equal(ours, expect.astype(np.int32))
    np.testing.assert_array_equal(
        th.probe_slots(torch.from_numpy(coords), cfg).numpy(),
        np.asarray(jh.probe_slots(jnp.asarray(coords), dataclasses.replace(
            TINY, num_buckets_log2=19))))


def test_first_match_of_a_window_with_two_matches():
    """jnp.argmax over a bool window returns the first True; so does the
    port's choice (torch.argmax of the int cast)."""
    m = torch.tensor([[False, True, False, True], [False, False, False, False],
                      [True, True, True, True]])
    assert th._first_true(m).tolist() == [1, 0, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(m.numpy()), axis=-1)).tolist() == [1, 0, 0]


def _colliding_coords(cfg, n, seed):
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(-200, 200, (20000, 3)).astype(np.int32), axis=0)
    buckets = np.asarray(jh.hash_block(jnp.asarray(coords), cfg))
    vals, counts = np.unique(buckets, return_counts=True)
    return coords[buckets == vals[np.argmax(counts)]][:n]


def test_collision_fixture_matches_jax():
    """tests/test_hash.py's collision fixture (voxel_hash_test.cu:128-180):
    coords hashing to one bucket land in one batch insert, in the same
    slots and pool blocks, with the same heap."""
    vols = _both()
    coords = _colliding_coords(TINY, 3, seed=1)
    vols, drop = _ins(vols, coords)
    assert not drop.any()
    _lookups_equal(vols, coords)
    assert len(np.unique(th.lookup(vols[1], torch.from_numpy(coords)).numpy())) == 3
    # six in one bucket: one claim wins a round, so three rounds place three
    vols, drop = _ins(_both(), _colliding_coords(TINY, 6, seed=1))
    assert drop.tolist().count(True) == 3


def test_idempotent_duplicate_and_batch_inserts_match_jax():
    vols = _both()
    vols, _ = _ins(vols, [[1, 2, 3]])
    vols, drop = _ins(vols, [[1, 2, 3]] + [[7, 7, 7]] * 10)
    assert not drop.any() and int(vols[1].num_active_blocks) == 2
    coords = np.unique(np.random.default_rng(0).integers(-100, 100, (128, 3)), axis=0)
    for _ in range(5):
        vols, drop = _ins(vols, coords)
    assert not drop.any()
    _lookups_equal(vols, np.concatenate([coords, [[4, 5, 6], [600, 0, 0]]]))


def test_delete_tombstone_and_reuse_match_jax():
    """Deleting the first of two colliding coords leaves a TOMBSTONE that
    the second's probe walks through; a re-insert reuses the slot."""
    vols = _both()
    a, b = _colliding_coords(TINY, 2, seed=2)
    vols, _ = _ins(vols, np.stack([a, b]))
    entry_j = jh.lookup_entry(vols[0], jnp.asarray(a[None]))
    entry_t = th.lookup_entry(vols[1], torch.from_numpy(a[None]))
    assert entry_t.tolist() == np.asarray(entry_j).tolist()
    vol_j = _delete(vols[0], entry_j, jnp.ones(1, bool))
    vol_t = th.delete_entries(vols[1], entry_t, torch.ones(1, dtype=torch.bool))
    assert_index_equal(vol_t, vol_j)
    assert int(vol_t.entry_block[int(entry_t[0])]) == -2  # TOMBSTONE: dead
    vols = (vol_j, vol_t)
    _lookups_equal(vols, np.stack([a, b]))
    assert th.lookup(vol_t, torch.from_numpy(a[None])).tolist() == [-1]
    vols, drop = _ins(vols, a[None])
    assert not drop.any()
    _lookups_equal(vols, np.stack([a, b]))


def test_heap_exhaustion_and_the_round_cap_match_jax():
    cfg = JConfig(num_buckets_log2=8, num_blocks_log2=2, max_probe=8, max_candidates=512,
                  max_visible=16, max_new_per_round=16)
    vols = _both(cfg)
    coords = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(2)), -1).reshape(-1, 3)
    vols, drop = _ins(vols, coords)
    assert drop.sum() == 4 and int(vols[1].num_free) == 0
    # more winners than max_new_per_round: only the capped ones reset
    cfg = dataclasses.replace(TINY, num_blocks_log2=10, num_buckets_log2=11,
                              max_new_per_round=64)
    vols = _both(cfg)
    ii = np.arange(300)
    coords = np.stack([ii % 32, ii // 32, np.zeros(300)], 1).astype(np.int32)
    valid = np.ones(300, bool)
    valid[::7] = False
    vols, drop = _ins(vols, coords, valid)
    assert int(vols[1].num_active_blocks) == 64 * cfg.insert_rounds and drop.any()
    # out-of-coord-range candidates are never inserted (no aliased key)
    n0 = int(vols[1].num_active_blocks)
    vols, drop = _ins(vols, [[600, 0, 0], [0, -513, 0], [3, 3, 40]])
    assert int(vols[1].num_active_blocks) == n0 + 1


def test_trilinear_tsdf_matches_jax():
    vols = _both()
    vols, _ = _ins(vols, [[0, 0, 0], [1, 0, 0], [0, 1, 1]])
    rng = np.random.default_rng(3)
    tsdf = rng.uniform(-1, 1, vols[0].tsdf.shape).astype(np.float32)
    vol_j = vols[0].replace(tsdf=jnp.asarray(tsdf))
    vol_t = port_from_jax(vol_j)
    pts = rng.uniform(-3, 20, (400, 3)).astype(np.float32)
    ours = th.trilinear_tsdf(vol_t, torch.from_numpy(pts)).numpy()
    ref = np.asarray(jh.trilinear_tsdf(vol_j, jnp.asarray(pts)))
    # tests/test_hash.py:270's limit (XLA may contract the blend into FMAs)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert (ours != 1.0).any()


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_random_insert_delete_sequence_matches_jax(seed):
    """tests/test_hash_fuzz.py's sequence: bit-equal index, heap and
    payload after every batch, and the contents of a dict model."""
    rng = np.random.default_rng(seed)
    vols = _both()
    model = set()
    universe = np.unique(rng.integers(-12, 12, (64, 3)).astype(np.int32), axis=0)
    for round_i in range(12):
        coords = universe[rng.integers(0, len(universe), 16)]
        vols, drop = _ins(vols, coords)
        model |= {tuple(c) for c, d in zip(coords.tolist(), drop) if not d}
        if model and round_i % 2 == 1:
            present = sorted(model)[: rng.integers(1, 6)]
            q = np.asarray(present, np.int32)
            entry_j = jh.lookup_entry(vols[0], jnp.asarray(q))
            vol_j = _delete(vols[0], entry_j, jnp.ones(len(q), bool))
            vol_t = th.delete_entries(vols[1], th.lookup_entry(vols[1], torch.from_numpy(q)),
                                      torch.ones(len(q), dtype=torch.bool))
            assert_index_equal(vol_t, vol_j)
            vols = (vol_j, vol_t)
            model -= set(present)
        _lookups_equal(vols, universe)
        hit = th.lookup(vols[1], torch.from_numpy(universe)).numpy() >= 0
        assert {tuple(c) for c in universe[hit].tolist()} == model
        assert int(vols[1].num_active_blocks) == len(model)


@pytest.mark.parametrize("size", [5, 40])
def test_unique_keys_is_jnp_unique_with_size(size):
    rng = np.random.default_rng(size)
    keys = rng.integers(0, 30, 200).astype(np.int32)
    keys[::3] = 1 << 30
    ours = unique_keys(torch.from_numpy(keys), size, 1 << 30).numpy()
    ref = np.asarray(jnp.unique(jnp.asarray(keys), size=size, fill_value=1 << 30))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("backend", ["hash", "dense"])
@pytest.mark.parametrize("scene", ["wall", "sphere"])
def test_sort_dedup_fusion_matches_jax(scene, backend):
    """The golden scenes fused with alloc_dedup="sort" (the hash backend's
    only dedup): the same live keys in the same slots and pool rows, the
    payloads within tests/test_torch_integrate.py's limits."""
    frames = _scene(scene, 4)
    base = J_HASH_CFG if backend == "hash" else dataclasses.replace(
        J_HASH_CFG, backend="dense", grid_log2=6)
    cfg = dataclasses.replace(base, sampler="gather", alloc_dedup="sort", max_visible=256)
    vol_t = _run_port(frames, port_cfg(cfg), alloc_every=2)
    vol_j = _run_jax(frames, cfg, alloc_every=2)
    assert_matches_jax(vol_t, vol_j)


@pytest.fixture(scope="module")
def hash_scene():
    """tests/test_splat_kernel.py's sphere-before-a-wall scene fused twice
    by the JAX package on the hash backend: (JAX volume, port volume,
    pose)."""
    pose = look_at((0.21, -0.33, -0.27), (0.05, 0.08, 1.4))
    depth = render_sphere(W, H, K, pose, center=(0.05, 0.08, 1.4), radius=0.37)
    depth = np.where(depth > 0, depth, render_wall(W, H, K, pose, wall_z=2.6))
    vol_j, _ = fuse_frames([(make_frame(depth.astype(np.float32)), pose)] * 2,
                           cfg=J_HASH_CFG)
    return vol_j, port_from_jax(vol_j), pose


def test_raycast_and_splat_of_a_hash_volume_match_jax(hash_scene):
    """tests/test_torch_render.py's limits on a hash-backend volume: the
    raycaster's hit and rgba equal, depth within 1e-6 relative, normals
    equal on all but 0.5% of pixels; the splat equal."""
    vol_j, vol_t, pose = hash_scene
    ours = raycast(vol_t, CAM, SE3.from_matrix(pose), 4.0)
    ref = j_raycast(vol_j, JCAM, JSE3.from_matrix(pose), 4.0)
    for f in ("hit", "rgba"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(ours.depth.numpy(), np.asarray(ref.depth), rtol=1e-6, atol=0)
    assert (ours.normal.numpy() != np.asarray(ref.normal)).any(-1).mean() <= 0.005
    assert ours.hit.float().mean() > 0.5
    spl = rf.splat_render(vol_t, CAM, SE3.from_matrix(pose), 4.0)
    spl_j = jrf.splat_render(vol_j, JCAM, JSE3.from_matrix(pose), 4.0)
    for f in ("hit", "depth", "rgba", "normal"):
        np.testing.assert_array_equal(getattr(spl, f).numpy(), np.asarray(getattr(spl_j, f)))


# ----------------------------------------------------------------------
# the dense window's recenter
# ----------------------------------------------------------------------
CORRIDOR = dict(voxel_size=ext.VOXEL, truncation=ext.TRUNC, num_blocks_log2=12,
                max_candidates=8192, max_visible=2048, max_new_per_round=1024,
                backend="dense", grid_log2=5)


def test_recenter_dense_matches_jax_and_same_origin_is_a_no_op():
    vol_j = JVolume.create(JConfig(**CORRIDOR))
    rng = np.random.default_rng(5)
    coords = rng.integers(-16, 16, (300, 3)).astype(np.int32)
    vol_j, _ = _insert(vol_j, jnp.asarray(coords), jnp.ones(300, bool))
    vol_t = port_from_jax(vol_j)
    for origin in ((-16, -16, -8), (-10, -20, -3)):
        vol_j = jh.recenter_dense(vol_j, origin)
        vol_t = th.recenter_dense(vol_t, origin)
        assert vol_t.cfg == port_cfg(vol_j.cfg)
        assert_index_equal(vol_t, vol_j)
    assert int(vol_t.num_free) > 4096 - 300  # blocks left the window
    before = {f: getattr(vol_t, f).clone() for f in ("block_table", "entry_block", "heap")}
    assert th.recenter_dense(vol_t, (-10, -20, -3)) is vol_t
    for f, v in before.items():
        assert torch.equal(getattr(vol_t, f), v), f


def test_needs_recenter_and_origin_match_jax():
    rng = np.random.default_rng(6)
    for cfg_j in (JConfig(**CORRIDOR),
                  JConfig(**dict(CORRIDOR, grid_origin=(-16, -16, -4))),
                  dataclasses.replace(TINY, voxel_size=0.05, truncation=0.2)):
        cfg_t = port_cfg(cfg_j)
        for pos in rng.uniform(-40, 40, (60, 3)):
            for kw in ({}, {"max_depth": 4.0}, {"margin_blocks": 3}):
                assert th.needs_recenter(cfg_t, pos, **kw) == jh.needs_recenter(
                    cfg_j, pos, **kw)
            if cfg_j.backend == "dense":
                assert th.recenter_origin_for(cfg_t, pos) == jh.recenter_origin_for(cfg_j, pos)


def _grid():
    return TSDFGrid(ext.VOXEL, ext.TRUNC, cfg=tconfig.TSDFConfig(**CORRIDOR), device="cpu")


def _gathered(grid):
    st = grid.gather_valid()
    return st.position[st.mask].numpy(), st.tsdf[st.mask].numpy()


def test_recenter_follows_the_corridor():
    """tests/test_extent.py:135: with TSDFGrid.recenter the centred window
    maps the corridor past its +6.4 m edge."""
    grid = _grid()
    moved = 0
    for pose, rgb, depth in ext._corridor_frames(20, spacing=0.5):
        moved += int(grid.recenter(np.linalg.inv(pose)[:3, 3]))
        grid.integrate(rgb, depth, None, None, 4.0, ext.K, pose)
    assert moved >= 2
    assert _gathered(grid)[0][:, 2].max() > 9.5
    assert not grid.recenter(np.linalg.inv(pose)[:3, 3])  # already centred


def test_recenter_keeps_covered_voxels_and_releases_the_rest():
    """tests/test_extent.py:161: the move leaves every payload as it was,
    every still-covered voxel gathers as before, and nothing in the new
    window is lost."""
    grid = _grid()
    for pose, rgb, depth in ext._corridor_frames(6, spacing=0.5):
        grid.integrate(rgb, depth, None, None, 4.0, ext.K, pose)
    pos0, t0 = _gathered(grid)
    rec0 = dict(zip(map(tuple, pos0), t0))
    tsdf0, active0 = grid.volume.tsdf.clone(), int(grid.volume.num_active_blocks)
    vol = th.recenter_dense(grid.volume, (-16, -16, -8))
    assert torch.equal(vol.tsdf, tsdf0)
    live = vol.entry_block >= 0
    assert (th.lookup(vol, vol.entry_pos[live]) >= 0).all()
    assert int(vol.num_active_blocks) <= active0
    pos1, t1 = _gathered(grid)
    rec1 = dict(zip(map(tuple, pos1), t1))
    assert all(p in rec0 and rec0[p] == t for p, t in rec1.items())
    org, g = vol.cfg.grid_origin, vol.cfg.grid_side
    for p in rec0:
        bp = np.rint(np.asarray(p) / ext.VOXEL).astype(int) >> 3
        if all(org[i] <= bp[i] < org[i] + g for i in range(3)):
            assert p in rec1


def test_disinf_system_auto_recenter_follows_the_corridor():
    """tests/test_extent.py:231 through the facade on the port."""
    with DISINFSystem(ext.K, depth_factor=1.0, voxel_size=ext.VOXEL, truncation=ext.TRUNC,
                      max_depth=4.0, cfg=tconfig.TSDFConfig(**CORRIDOR), half_scale=False,
                      auto_recenter=True, device="cpu") as s:
        for i, (pose, rgb, depth) in enumerate(ext._corridor_frames(20, 0.5)):
            s.feed_pose(i * 100, pose)
            s.feed_rgbd_frame(rgb, depth, i * 100)
        s.tsdf.flush()
        assert s.tsdf.dropped_frames == 0
        assert _gathered(s.tsdf.tsdf)[0][:, 2].max() > 9.5
