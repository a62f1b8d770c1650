"""PyTorch port, host block streaming (systems/block_streaming.py): the
merge of two fused rows against the JAX package's, bit for bit; the
spill / restore of a recenter, the conflict merge and the paged drive
against the JAX package from the same volume; the store's npz crossing
between the packages both ways; the store's dump records; DenseSLAM's
spill."""

import dataclasses

import numpy as np
import pytest
import torch

from disinfect_slam_tpu.systems import block_streaming as jbs
from disinfect_slam_tpu.systems.tsdf_grid import TSDFGrid as JGrid
from disinfect_slam_tpu_torch.ops.gather import gather_valid, to_numpy_records
from disinfect_slam_tpu_torch.ops.hash import lookup
from disinfect_slam_tpu_torch.systems import block_streaming as tbs
from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

from .scenes import checker_rgb, look_at, render_wall
from .test_block_streaming import TRUNC, VOXEL, H, K, W, _cfg, _fuse_wall
from .test_torch_hash import jax_arrays, port_arrays, port_cfg, port_from_jax

torch.set_num_threads(1)


def _word(r, g, b, w):
    return (r | (g << 8) | (b << 16) | (w << 24)).astype(np.uint32)


def _random_rows(rng, n, v):
    """Two sides of payload rows: weights 0-255 with a share of zeros on
    each side and of 255s, probabilities including 0 and 1."""
    out = []
    for _ in range(2):
        w = rng.integers(0, 256, (n, v))
        w = np.where(rng.uniform(size=(n, v)) < 0.25, 0, w)
        w = np.where(rng.uniform(size=(n, v)) < 0.1, 255, w)
        c = _word(*(rng.integers(0, 256, (n, v)) for _ in range(3)), w)
        t = rng.uniform(-1, 1, (n, v)).astype(np.float32)
        p = rng.uniform(0, 1, (n, v)).astype(np.float32)
        p = np.where(rng.uniform(size=(n, v)) < 0.05, 0.0, p)
        p = np.where(rng.uniform(size=(n, v)) < 0.05, 1.0, p).astype(np.float32)
        out.append((t, c, p))
    return out


@pytest.mark.parametrize("max_weight,prob_eps", [(255.0, 0.0), (40.0, 1e-3)])
def test_merge_rows_matches_jax(max_weight, prob_eps):
    """Random rows with w = 0 on either side and the weight at its cap:
    the port's merge gives the JAX merge's bits."""
    (t_l, c_l, p_l), (t_s, c_s, p_s) = _random_rows(np.random.default_rng(3), 16, 512)
    ours = tbs._merge_rows(t_l, c_l, p_l, t_s, c_s, p_s, max_weight, prob_eps)
    ref = jbs._merge_rows(t_l, c_l, p_l, t_s, c_s, p_s, max_weight=max_weight,
                          prob_eps=prob_eps)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    # the cap binds, and one-sided voxels pass through
    assert ((ours[1] >> 24) == min(255, int(max_weight))).any()
    one_sided = (c_s >> 24) == 0
    np.testing.assert_array_equal(ours[1][one_sided], c_l[one_sided])


def _pair(cfg=None):
    """A JAX grid with host_spill after two wall frames, and a port grid
    with host_spill holding the same volume."""
    jg = JGrid(VOXEL, TRUNC, cfg=cfg or _cfg(), host_spill=True)
    _fuse_wall(jg)
    tg = TSDFGrid(VOXEL, TRUNC, cfg=port_cfg(jg.cfg), device="cpu", host_spill=True)
    tg.volume = port_from_jax(jg.volume)
    return jg, tg


def _assert_stores_equal(ts, js):
    assert list(ts._store) == list(js._store)
    for k, (t, c, p) in js._store.items():
        for a, b in zip(ts.payload(k), (t, c, p)):
            np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                          np.asarray(b).view(np.uint32))


def _assert_volumes_equal(vol_t, vol_j):
    a, b = port_arrays(vol_t), jax_arrays(vol_j)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_spill_restore_roundtrip_matches_jax():
    """Recenter away (blocks spill), then back (they restore): the port's
    store and volume equal the JAX package's at each step, and the volume
    comes back voxel for voxel, the store empty."""
    jg, tg = _pair()
    before = port_arrays(tg.volume)
    n0 = tg.num_active_blocks()
    assert n0 > 8
    for center in ((0.0, 0.0, 8.0), (0.0, 0.0, 0.0)):
        assert tg.recenter(center) and jg.recenter(center)
        _assert_stores_equal(tg.spill_store, jg.spill_store)
        _assert_volumes_equal(tg.volume, jg.volume)
        if center[2]:
            assert 0 < len(tg.spill_store) and tg.num_active_blocks() == n0 - len(
                tg.spill_store)
    assert len(tg.spill_store) == 0 and tg.num_active_blocks() == n0
    after = port_arrays(tg.volume)
    live = before["entry_block"] >= 0
    assert (after["entry_block"] >= 0).sum() == live.sum()
    # the same coordinates hold the same payload rows
    for arrays in (before, after):
        arrays["order"] = np.argsort(arrays["entry_key"][arrays["entry_block"] >= 0])
    for f in ("tsdf", "rgbw", "prob"):
        rows_b = before[f][before["entry_block"][live]][before["order"]]
        live_a = after["entry_block"] >= 0
        rows_a = after[f][after["entry_block"][live_a]][after["order"]]
        np.testing.assert_array_equal(rows_a.view(np.uint32), rows_b.view(np.uint32))


def test_restore_conflict_merges_as_jax():
    """Stored copies of live coordinates (weights 0-40, some unobserved)
    merge into the live rows as the JAX package merges them; the store
    empties."""
    jg, tg = _pair()
    live = np.asarray(jg.volume.entry_block) >= 0
    coords = np.asarray(jg.volume.entry_pos)[live][:5]
    rng = np.random.default_rng(11)
    v = jg.cfg.block_volume
    for c in coords:
        w = np.where(rng.uniform(size=v) < 0.3, 0, rng.integers(0, 41, v))
        row = (rng.uniform(-1, 1, v).astype(np.float32),
               _word(*(rng.integers(0, 256, v) for _ in range(3)), w),
               rng.uniform(0, 1, v).astype(np.float32))
        jg.spill_store._store[tuple(int(x) for x in c)] = row
        tg.spill_store._store[tuple(int(x) for x in c)] = tuple(a.copy() for a in row)
    jg.volume, n_j = jg.spill_store.restore_into_window(jg.volume)
    tg.volume, n_t = tg.spill_store.restore_into_window(tg.volume)
    assert n_t == n_j == 5 and len(tg.spill_store) == 0
    _assert_volumes_equal(tg.volume, jg.volume)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_store_npz_crosses_packages(tmp_path, direction):
    """A store saved by one package loads in the other with the same keys,
    order and payload bits; a restore from it then gives equal volumes."""
    jg, tg = _pair()
    jg.recenter((0.0, 0.0, 8.0))
    tg.recenter((0.0, 0.0, 8.0))
    path = str(tmp_path / "store.npz")
    if direction == "jax_to_port":
        jg.spill_store.save_npz(path)
        tg.spill_store = tbs.HostBlockStore.load_npz(path)
    else:
        tg.spill_store.save_npz(path)
        jg.spill_store = jbs.HostBlockStore.load_npz(path)
    assert len(tg.spill_store) > 0
    _assert_stores_equal(tg.spill_store, jg.spill_store)
    assert tg.spill_store.nbytes() == jg.spill_store.nbytes()
    jg.recenter((0.0, 0.0, 0.0))
    tg.recenter((0.0, 0.0, 0.0))
    _assert_volumes_equal(tg.volume, jg.volume)


def test_store_spatial_records_match_device_dump():
    """The store's records of the blocks a recenter spills equal the
    device dump's records of those blocks before the spill, and the JAX
    store's records."""
    jg, tg = _pair()
    before = to_numpy_records(gather_valid(tg.volume))
    n_blocks = tg.num_active_blocks()
    tg.recenter((0.0, 0.0, 8.0))
    jg.recenter((0.0, 0.0, 8.0))
    store = tg.spill_store
    assert 0 < len(store) < n_blocks
    rec = store.spatial_records(tg.cfg)
    assert rec.shape == (len(store) * tg.cfg.block_volume, 4)
    np.testing.assert_array_equal(rec, jg.spill_store.spatial_records(jg.cfg))
    blk = np.floor(np.round(before[:, :3] / VOXEL) / tg.cfg.block_len).astype(int)
    expect = before[np.array([tuple(b) in store for b in blk])]

    def sort(a):
        return a[np.lexsort(a[:, :3].T[::-1])]

    np.testing.assert_array_equal(sort(expect), sort(rec))


def test_paged_drive_matches_jax():
    """A 128-block hash pool sweeping along a wall with maybe_page, then a
    revisit of the start: the port pages at the same frames with the same
    restored and evicted counts as the JAX package, stores the same blocks
    in the same order and ends with the same index and free list; the
    revisit restores the nearest stored block bit for bit.  (Payloads are
    compared within the package: on this centred camera the two packages'
    fusion differs at pixel ties, as test_torch_integrate.py avoids.)"""
    cfg = _cfg(num_buckets_log2=12, num_blocks_log2=7, max_probe=16, max_candidates=4096,
               max_visible=512, max_new_per_round=128, insert_rounds=4, backend="hash")
    jg = JGrid(VOXEL, TRUNC, cfg=cfg, host_spill=True)
    tg = TSDFGrid(VOXEL, TRUNC, cfg=port_cfg(jg.cfg), device="cpu", host_spill=True)
    rgb = checker_rgb(W, H)
    evicted = 0
    for x in np.arange(0.0, 8.5, 1.0):
        cam = (float(x), 0.0, 0.0)
        pt = tg.maybe_page(cam, radius_m=3.0)
        assert pt == jg.maybe_page(cam, radius_m=3.0), x
        evicted += pt[1]
        pose = look_at((x, 0.0, 0.0), (x, 0.0, 2.0)).astype(np.float32)
        depth = render_wall(W, H, K, pose, wall_z=2.0)
        jg.integrate(rgb, depth, None, None, 4.0, K, pose)
        tg.integrate(rgb, depth, None, None, 4.0, K, pose)
    assert evicted > 0
    assert list(tg.spill_store._store) == list(jg.spill_store._store)
    # the revisit: the nearest stored block comes back with its stored bits
    key = min(tg.spill_store._store, key=lambda k: sum(((c * 8 + 4) * VOXEL) ** 2 for c in k))
    stored = [a.copy() for a in tg.spill_store.payload(key)]
    pt = tg.maybe_page((0.0, 0.0, 0.0), radius_m=3.0)
    assert pt == jg.maybe_page((0.0, 0.0, 0.0), radius_m=3.0) and pt[0] > 0
    assert key not in tg.spill_store
    assert list(tg.spill_store._store) == list(jg.spill_store._store)
    a, b = port_arrays(tg.volume), jax_arrays(jg.volume)
    for f in ("entry_key", "entry_block", "heap", "num_free"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    row = int(lookup(tg.volume, torch.tensor([key], dtype=torch.int32))[0])
    assert row >= 0
    for got, want in zip((a["tsdf"][row], a["rgbw"][row], a["prob"][row]), stored):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_dense_slam_recenter_spills_and_restores():
    """DenseSLAM(host_spill=True): maybe_recenter moves the leaving blocks
    to the store and brings them back when the tracked camera returns."""
    cfg = port_cfg(_cfg(grid_log2=4))
    slam = DenseSLAM(K, H, W, voxel_size=VOXEL, truncation=TRUNC, cfg=cfg, host_spill=True,
                     device="cpu")
    pose = look_at((0.0, 0.0, 0.0), (0.0, 0.0, 2.0)).astype(np.float32)
    slam.process_frame(checker_rgb(W, H), render_wall(W, H, K, pose, wall_z=1.5))
    before = port_arrays(slam.volume)
    n0 = int(slam.volume.num_active_blocks)
    assert n0 > 4
    slam.world_T_cam = np.linalg.inv(look_at((0.0, 0.0, 6.0), (0.0, 0.0, 8.0))).astype(
        np.float32)
    assert slam.maybe_recenter() and len(slam.spill_store) > 0
    slam.world_T_cam = np.eye(4, dtype=np.float32)
    assert slam.maybe_recenter() and len(slam.spill_store) == 0
    assert int(slam.volume.num_active_blocks) == n0
    after = port_arrays(slam.volume)
    key = lambda a: np.sort(a["entry_key"][a["entry_block"] >= 0])  # noqa: E731
    np.testing.assert_array_equal(key(after), key(before))
