"""PyTorch port, the block-ownership-sharded volume: owner_of and
shard_config against the JAX package's; DistributedTSDF over 4 and 8 CPU
shards against the JAX DistributedTSDF over as many virtual CPU devices
on tests/test_parallel.py's scenes (a single frame on the hash backend,
seven frames with carving, the dense backend); its bbox query and
distributed render; elastic checkpoints crossing both ways onto 1, 2
and 8 shards; host paging; and apps.offline --devices / --save-dist.

Tolerances: block counts equal; sorted (x, y, z, tsdf) records within
1e-5 (XLA:CPU contracts multiply-adds into FMAs inside the jitted step,
the port does not; the same limit as tests/test_parallel.py); records
read back from a checkpoint equal bit for bit; renders within
tests/test_parallel.py's limits (hit on >= 99.5% of pixels, depth 2e-3
where both hit).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.config import TSDFConfig as JConfig
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.io.dataset import LoggedReplay as JReplay
from disinfect_slam_tpu.ops.gather import BoundingCube as JBox
from disinfect_slam_tpu.ops.integrate import FrameInput as JFrame
from disinfect_slam_tpu.parallel import sharding as js
from disinfect_slam_tpu_torch.apps import offline
from disinfect_slam_tpu_torch.config import BENCH, TSDFConfig
from disinfect_slam_tpu_torch.core.geometry import CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.ops.gather import BoundingCube
from disinfect_slam_tpu_torch.ops.integrate import FrameInput
from disinfect_slam_tpu_torch.parallel import sharding as ts

from .scenes import look_at, render_wall
from .test_integrate import CFG, CFG_DENSE, H, K, MAX_DEPTH, W, make_frame
from .test_torch_offline import tiny_dataset  # noqa: F401  (the fixture)

torch.set_num_threads(1)

POSE = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
WALL = make_frame(render_wall(W, H, K, POSE, wall_z=2.0131))


def _port_cfg(cfg: JConfig) -> TSDFConfig:
    return TSDFConfig(**dataclasses.asdict(cfg))


def _port_frame(frame) -> FrameInput:
    return FrameInput(*(np.asarray(a) for a in frame))


def _sort(rec: np.ndarray) -> np.ndarray:
    return rec[np.lexsort((rec[:, 2], rec[:, 1], rec[:, 0]))]


def _pair(cfg: JConfig, n: int, frames, pose=POSE):
    """The JAX and the port's volume over n shards after `frames`."""
    jd = js.DistributedTSDF(cfg, js.make_mesh(n))
    td = ts.DistributedTSDF(_port_cfg(cfg), ["cpu"] * n)
    for f in frames:
        jd.integrate(f, K, pose, MAX_DEPTH)
        td.integrate(_port_frame(f), K, pose, MAX_DEPTH)
    return jd, td


def _assert_same_volume(jd, td):
    assert td.num_active_blocks() == jd.num_active_blocks() > 0
    a, b = _sort(td.gather_all_tsdf()), _sort(jd.gather_all_tsdf())
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :3], b[:, :3])
    np.testing.assert_allclose(a[:, 3], b[:, 3], rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# ownership and the sub-volume config
# ----------------------------------------------------------------------
def _mix_int32_min(x: int, y: int) -> int:
    """z with x*P1 ^ y*P2 ^ z*P3 == INT32_MIN in int32 arithmetic."""
    m = (1 << 32) - 1
    rest = ((x * 126271) & m) ^ ((y * 522133279) & m)
    z = (((1 << 31) ^ rest) * pow(96002369, -1, 1 << 32)) & m
    return z - (1 << 32) if z >= 1 << 31 else z


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_owner_of_equals_jax(n):
    rng = np.random.default_rng(n)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    blocks = np.concatenate([
        rng.integers(-600, 600, (5000, 3)),
        rng.integers(lo, hi, (5000, 3), endpoint=True),
        [[lo, lo, lo], [hi, hi, hi], [lo, hi, 0], [0, 0, 0], [-1, -1, -1]],
        [[x, y, _mix_int32_min(x, y)] for x, y in ((0, 0), (3, -7), (-512, 511), (lo, hi))],
    ]).astype(np.int32)
    ours = ts.owner_of(torch.from_numpy(blocks), n).numpy()
    ref = np.asarray(js.owner_of(jnp.asarray(blocks), n))
    np.testing.assert_array_equal(ours, ref)
    # the INT32_MIN mixes stay negative through abs and floor into [0, n)
    assert ((ours >= 0) & (ours < n)).all()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["hash", "dense", "bench"])
def test_shard_config_equals_jax(name, n):
    cfg = {"hash": CFG, "dense": CFG_DENSE,
           "bench": JConfig(**dataclasses.asdict(BENCH))}[name]
    assert dataclasses.asdict(ts.shard_config(_port_cfg(cfg), n)) == dataclasses.asdict(
        js.shard_config(cfg, n))


def test_mesh_repeats_a_device_and_checks_the_count():
    assert ts.make_mesh(devices=["cpu"] * 4) == [torch.device("cpu")] * 4
    assert ts.make_mesh(2, devices=["cpu"] * 4) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="5 shards requested"):
        ts.make_mesh(5, devices=["cpu"] * 4)


# ----------------------------------------------------------------------
# integrate against the JAX DistributedTSDF
# ----------------------------------------------------------------------
def test_single_frame_on_8_hash_shards_matches_jax():
    jd, td = _pair(CFG, 8, [WALL])
    _assert_same_volume(jd, td)
    assert ts.owner_of(torch.from_numpy(np.concatenate(
        [s.entry_pos[s.entry_block >= 0].numpy() for s in td.shards])), 8).numpy().tolist() == [
        d for d, s in enumerate(td.shards) for _ in range(int((s.entry_block >= 0).sum()))]


def test_multi_frame_with_carving_on_4_shards_matches_jax():
    pose = look_at((0.021, -0.017, 0.009), (0.05, 0.08, 2.0))
    d1 = render_wall(W, H, K, pose, wall_z=1.0137)
    d2 = render_wall(W, H, K, pose, wall_z=3.0219)
    jd, td = _pair(CFG, 4, [make_frame(d1)] + [make_frame(d2)] * 6, pose)
    _assert_same_volume(jd, td)


@pytest.fixture(scope="module")
def dense_pair():
    """CFG_DENSE over 4 shards: one frame (held against JAX), then the
    same frame again (the query and render cases)."""
    jd, td = _pair(CFG_DENSE, 4, [WALL])
    one = (jd.num_active_blocks(), _sort(jd.gather_all_tsdf()), td.num_active_blocks(),
           _sort(td.gather_all_tsdf()))
    jd.integrate(WALL, K, POSE, MAX_DEPTH)
    td.integrate(_port_frame(WALL), K, POSE, MAX_DEPTH)
    return jd, td, one


def test_dense_backend_on_4_shards_matches_jax(dense_pair):
    _, _, (jn, jrec, tn, trec) = dense_pair
    assert tn == jn > 0
    assert trec.shape == jrec.shape
    np.testing.assert_array_equal(trec[:, :3], jrec[:, :3])
    np.testing.assert_allclose(trec[:, 3], jrec[:, 3], rtol=0, atol=1e-5)


def test_bbox_query_matches_jax(dense_pair):
    jd, td, _ = dense_pair
    ours = td.query_bbox(BoundingCube(-2, 2, -2, 2, 0, 3))
    ref = jd.query_bbox(JBox(-2, 2, -2, 2, 0, 3))
    assert ours.shape == ref.shape and ours.shape[0] > 0
    # shard-major order, as the JAX all_gather
    np.testing.assert_array_equal(ours[:, :3], ref[:, :3])
    np.testing.assert_allclose(ours[:, 3], ref[:, 3], rtol=0, atol=1e-5)
    # a cube that holds nothing
    assert td.query_bbox(BoundingCube(5, 6, 5, 6, 5, 6)).shape == (0, 4)


def test_distributed_render_matches_jax(dense_pair):
    jd, td, _ = dense_pair
    ours = td.render(CameraParams.create(CameraIntrinsics.create(*K), H, W), POSE, MAX_DEPTH)
    ref = jd.render(JCam.create(JIntr.create(*K), H, W), POSE, MAX_DEPTH)
    hit, jhit = ours.hit.numpy(), np.asarray(ref.hit)
    assert hit.sum() > 0.5 * hit.size
    assert (hit == jhit).mean() >= 0.995
    both = hit & jhit
    np.testing.assert_allclose(ours.depth.numpy()[both], np.asarray(ref.depth)[both], atol=2e-3)
    assert (ours.depth.numpy()[~hit] == 0).all()
    # the images equal on 99.5% of the pixels both hit (measured: rgba on
    # all, normal on all but 3 of 1760): each shard shades normals from
    # its own depth image, so a pixel beside another shard's surface
    # follows the shards' per-pixel depths, which need not agree to the bit
    for a, b in ((ours.rgba, ref.rgba), (ours.normal, ref.normal)):
        same = (a.numpy() == np.asarray(b)).all(-1)
        assert same[both].mean() >= 0.995


def test_render_merge_takes_the_nearest_shard_and_max_merges_ties(monkeypatch):
    """The merge rule on two hand-made shard images: the nearer depth
    wins a pixel; at equal depth the payloads max-merge."""
    from disinfect_slam_tpu_torch.ops.raycast import RaycastResult

    td = ts.DistributedTSDF(_port_cfg(CFG_DENSE), ["cpu"] * 2)
    hit = torch.tensor([[True, True, False, True]])
    depth = [torch.tensor([[1.0, 2.0, 0.0, 3.0]]), torch.tensor([[1.5, 2.0, 0.0, 0.0]])]
    hits = [hit, torch.tensor([[True, True, False, False]])]
    rgba = [torch.full((1, 4, 4), 10, dtype=torch.uint8), torch.full((1, 4, 4), 20,
                                                                    dtype=torch.uint8)]
    renders = iter(RaycastResult(rgba=r, normal=r, depth=d, hit=h_)
                   for r, d, h_ in zip(rgba, depth, hits))
    monkeypatch.setattr(ts.rf, "splat_render", lambda *a, **k: next(renders))
    res = td.render(CameraParams.create(CameraIntrinsics.create(*K), 1, 4), POSE, 4.0)
    assert res.hit.tolist() == [[True, True, False, True]]
    assert res.depth.tolist() == [[1.0, 2.0, 0.0, 3.0]]
    assert res.rgba[0, :, 0].tolist() == [10, 20, 0, 10]


def test_integrate_counts_the_capacity_cuts():
    """With a cuts list each shard reports the new candidates past
    max_candidates and the visible blocks past max_visible: positive when
    the caps bind, 0 when they do not; None for the candidates on the
    sort path, which does not count its cut."""
    tight = dataclasses.replace(_port_cfg(CFG_DENSE), max_candidates=64, max_visible=4)
    for cfg, bind in ((tight, True), (_port_cfg(CFG_DENSE), False)):
        td = ts.DistributedTSDF(cfg, ["cpu"] * 2)
        for _ in range(2):
            cuts = []
            td.integrate(_port_frame(WALL), K, POSE, MAX_DEPTH, cuts=cuts)
        assert len(cuts) == 2
        assert all((int(c) > 0) == bind and (int(v) > 0) == bind for c, v in cuts), cuts
    cuts = []
    ts.DistributedTSDF(_port_cfg(CFG), ["cpu"] * 2).integrate(_port_frame(WALL), K, POSE,
                                                               MAX_DEPTH, cuts=cuts)
    assert [c for c, _ in cuts] == [None, None] and all(int(v) == 0 for _, v in cuts)


# ----------------------------------------------------------------------
# elastic checkpoints
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """tests/test_parallel.py's elastic scene on 4 shards in both
    packages, each saved."""
    pose = look_at((0.05, -0.04, -1.45), (0.0, 0.0, 2.0131))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    d2 = render_wall(W, H, K, pose, wall_z=1.4137)
    frames = [make_frame(depth), make_frame(np.where(d2 > 0, d2, depth))]
    jd, td = _pair(CFG, 4, frames, pose)
    d = tmp_path_factory.mktemp("elastic")
    paths = {"port": str(d / "port.npz"), "jax": str(d / "jax.npz")}
    n_port = ts.save_distributed(paths["port"], td)
    n_jax = js.save_distributed(paths["jax"], jd)
    return jd, td, paths, n_port, n_jax, pose


def _records(dist) -> np.ndarray:
    rec = dist.gather_all_tsdf()
    return rec[np.lexsort(rec[:, :3].T)]


def test_elastic_checkpoint_holds_the_jax_keys(elastic):
    jd, td, paths, n_port, n_jax, _ = elastic
    assert n_port == n_jax == td.num_active_blocks() > 50
    with np.load(paths["port"]) as a, np.load(paths["jax"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
        cfg_a, cfg_b = (json.loads(bytes(f["cfg_json"]).decode()) for f in (a, b))
    # the JAX constructor resolves its TPU-only knobs against the CPU mesh
    # (the gather sampler, no scatter window) before it saves; the port
    # keeps the config as given
    assert (cfg_b["sampler"], cfg_b["scatter_window_log2"]) == ("gather", 0)
    assert cfg_a == {**cfg_b, "sampler": "auto", "scatter_window_log2": -1}


@pytest.mark.parametrize("n", [1, 2, 8])
def test_elastic_checkpoints_cross_both_ways(elastic, n):
    jd, td, paths, _, _, _ = elastic
    port_ref, jax_ref = _records(td), _records(jd)
    # the port's file onto n JAX devices and n port shards
    np.testing.assert_array_equal(_records(js.load_distributed(paths["port"],
                                                               js.make_mesh(n))), port_ref)
    np.testing.assert_array_equal(_records(ts.load_distributed(paths["port"], ["cpu"] * n)),
                                  port_ref)
    # the JAX file onto n port shards
    restored = ts.load_distributed(paths["jax"], ["cpu"] * n)
    assert restored.n_devices == n and restored.cfg == dataclasses.replace(
        _port_cfg(CFG), sampler="gather", scatter_window_log2=0)
    np.testing.assert_array_equal(_records(restored), jax_ref)


def test_restored_volume_keeps_integrating(elastic):
    """One more frame on the 8-shard restore equals the same frame on the
    4-shard original, as tests/test_parallel.py checks in JAX."""
    _, _, paths, _, _, pose = elastic
    src = ts.load_distributed(paths["port"], ["cpu"] * 4)
    r8 = ts.load_distributed(paths["port"], ["cpu"] * 8)
    more = _port_frame(make_frame(render_wall(W, H, K, pose, wall_z=2.6139)))
    src.integrate(more, K, pose, MAX_DEPTH)
    r8.integrate(more, K, pose, MAX_DEPTH)
    np.testing.assert_array_equal(_records(r8), _records(src))


def test_restore_raises_when_a_shard_overflows(elastic):
    _, _, paths, n, _, _ = elastic
    small = dataclasses.replace(_port_cfg(CFG), num_blocks_log2=4)
    with pytest.raises(ValueError, match="did not fit the sub-volume"):
        ts.load_distributed(paths["port"], ["cpu"], cfg=small)
    assert n > 16


# ----------------------------------------------------------------------
# paging
# ----------------------------------------------------------------------
def test_maybe_page_gives_jax_counts():
    """tests/test_parallel.py's spill scenario: every block evicts to the
    per-shard stores, then restores voxel for voxel, with JAX's counts."""
    jd, td = _pair(CFG, 4, [WALL])
    rec0 = _records(td)
    counts = []
    for d in (jd, td):
        got = [d.maybe_page((0.0, 0.0, 0.0), radius_m=0.5)]
        d.enable_host_spill()
        got.append(d.maybe_page((0.0, 0.0, 0.0), radius_m=0.5, min_free_frac=1.1,
                                target_free_frac=1.0))
        got.append((d.num_active_blocks(), d.spill_store_len()))
        got.append(d.maybe_page((0.0, 0.0, 2.0), radius_m=50.0, min_free_frac=0.0))
        got.append((d.num_active_blocks(), d.spill_store_len()))
        counts.append(got)
    assert counts[0] == counts[1]
    n = td.num_active_blocks()
    assert counts[1] == [(0, 0), (0, n), (0, n), (n, 0), (n, 0)]
    np.testing.assert_array_equal(_records(td), rec0)


# ----------------------------------------------------------------------
# the offline app
# ----------------------------------------------------------------------
def test_offline_app_shards_and_saves(tiny_dataset, tmp_path, capsys):  # noqa: F811
    save, dist_path = str(tmp_path / "dist.bin"), str(tmp_path / "dist.npz")
    res = offline.main([
        "--logdir", tiny_dataset, "--config", os.path.join(tiny_dataset, "cam.yaml"),
        "--preset", "small", "--voxel", "0.05", "--trunc", "0.15", "--max-depth", "4.0",
        "--device", "cpu", "--devices", "4", "--save", save, "--save-dist", dist_path,
    ])
    text = capsys.readouterr().out
    for line in ("[offline] distributed: 4 shards, 1024 blocks/shard",
                 "[offline] shard | active blocks | share", "[offline] elastic checkpoint: "):
        assert line in text, text
    assert res["frames"] == 4 and len(res["per_shard"]) == 4 and sum(res["per_shard"]) > 8
    assert res["dist_blocks"] == sum(res["per_shard"])

    # the JAX DistributedTSDF over the same frames
    cfg = JConfig(num_blocks_log2=12, max_candidates=8192, max_visible=4096,
                  max_new_per_round=2048, grid_log2=7, voxel_size=0.05, truncation=0.15)
    jd = js.DistributedTSDF(cfg, js.make_mesh(4))
    kk = (121.3, 119.7, 79.21, 59.63)
    for fr in JReplay(tiny_dataset, 5000.0):
        jd.integrate(JFrame(*(jnp.asarray(a, jnp.float32) for a in (fr.rgb, fr.depth, fr.ht,
                                                                      fr.lt))),
                     kk, fr.cam_T_world, 4.0)
    ours = _sort(np.fromfile(save, "<f4").reshape(-1, 4))
    ref = _sort(jd.gather_all_tsdf())
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours[:, :3], ref[:, :3])
    np.testing.assert_allclose(ours[:, 3], ref[:, 3], rtol=0, atol=1e-5)
    # the elastic checkpoint restores in JAX onto 2 devices
    np.testing.assert_array_equal(_records(js.load_distributed(dist_path, js.make_mesh(2))),
                                  _records(res["dist"]))


def test_offline_app_exits_2_when_too_few_cards(tiny_dataset, monkeypatch, capsys):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        offline.main(["--logdir", tiny_dataset, "--devices", "2", "--prefetch", "0"])
    assert e.value.code == 2
    assert "[offline] ERROR: 2 devices requested, 1 available" in capsys.readouterr().out
