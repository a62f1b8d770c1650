"""PyTorch port on the card: each CUDA kernel against its plain torch
version on the same CUDA tensors, at small shapes, with the edge cases
of fuse_rows' projection and fusion formulas (rows behind the camera, off
the image and at camera z = 0, zero weights, probabilities of 0 and 1,
depth at max_depth, prob_eps, rows past the live count, no live row) and
of the splat kernels' projection and merges (depth ties, payload words
with the top bit set, rows behind the camera, off the image and at camera
z = 0, rows past the live count, no live row, rows near the camera on
both branches of each kernel, voxels one float32 ulp either side of the
band and depth thresholds), the probes (splat_zbuf_blocks' tile, the
feature probe, the sampler's and fuse_rows' stage probes), the renders
through TSDFGrid.ray_cast on the card, the online slice (the segmentation
nets and FusedOnlineStep on the card against the port on the CPU), and
the export slice: the hash backend's inserts, fusion and renders, mesh
chunks, and a splat clipped at its surface cap (surf_overflow > 0), and
the tracking slice: K4 at the tracking resolutions, the model depth's
smoothing, DenseSLAM on the card against the CPU (no pose read, no sync
once captured, every pose bit for bit), the ICP kernel on the pyramids
against its plain version on the card and the CPU, the tracker, the
pose graph and the match on the card against the CPU, the lockstep
parting walk, its captured tracked frame against the
eager one and under the sync debug mode, the sharded step captured
against eager, and loop closure on the card, the
kernels' self-check (utils/kernel_verify.py), the segmentation net
over a mesh of the one card (parallel/seg_parallel.py), and the seg net's
train, eval, sharded train and sharded inference steps captured against
their eager forms and under the sync debug mode.

Needs a CUDA device and nvcc; skipped without a card.  This file imports
no JAX, so it runs on a GPU host without it:

  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

from disinfect_slam_tpu_torch.config import TSDFConfig
from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
from disinfect_slam_tpu_torch.io.png_io import read_image
from disinfect_slam_tpu_torch.models import segmentation as seg
from disinfect_slam_tpu_torch.ops import render_fast
from disinfect_slam_tpu_torch.ops.cuda import fuse_kernel, sample_kernel, splat_kernel
from disinfect_slam_tpu_torch.systems.online_step import FusedOnlineStep
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

from .scenes import checker_rgb, look_at, render_sphere, render_wall
from .torch_cases import block_case, splat_block_case, splat_edge_cases

pytestmark = pytest.mark.gpu

ROWS, COUNT, POOL = 64, 50, 256
TRUNC, MAX_DEPTH, MAX_W = 0.06, 4.0, 40.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(dev, seed=0, img_h=48, img_w=64):
    """sample_rows inputs: a random 8-channel frame and pixels spilling
    past every image edge."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 4.4, (img_h, img_w, 8)).astype(np.float32)
    u = rng.integers(-4, img_w + 4, (ROWS, 512)).astype(np.int32)
    v = rng.integers(-4, img_h + 4, (ROWS, 512)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(img=t(img), u=t(u), v=t(v),
                count=torch.tensor(COUNT, dtype=torch.int32, device=dev))


def _block_case(dev, seed, img_h, img_w, about_z=False, count=COUNT):
    c = block_case(seed, img_h, img_w, ROWS, count, POOL, about_z=about_z)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {k: t(c[k]) for k in ("img", "block_pos", "pool_idx", "tsdf", "rgbw", "prob")}
    out["count"] = torch.tensor(count, dtype=torch.int32, device=dev)
    out["geometry"] = dict(cam_T_world=c["pose"], intrinsics=c["intrinsics"],
                           voxel_size=c["voxel_size"])
    return out


@pytest.mark.parametrize("about_z", [False, True])
@pytest.mark.parametrize("prob_eps", [0.0, 1e-6])
@pytest.mark.parametrize("img_hw", [(48, 64), (1080, 1920)])
def test_fuse_rows_kernel_matches_plain_version(cuda, prob_eps, img_hw, about_z):
    """The kernel projects, samples and fuses as its plain version does
    on the card: rows behind the camera, off the image and (about_z)
    voxels at camera z = 0 included."""
    c = _block_case(cuda, seed=1, img_h=img_hw[0], img_w=img_hw[1], about_z=about_z)
    pools = [c[k].clone() for k in ("tsdf", "rgbw", "prob")]
    refs = [c[k].clone() for k in ("tsdf", "rgbw", "prob")]
    args = [c[k] for k in ("img", "block_pos", "pool_idx", "count")]
    consts = dict(truncation=TRUNC, max_depth=MAX_DEPTH, max_weight=MAX_W,
                  prob_eps=prob_eps, **c["geometry"])
    before = fuse_kernel.fuse_rows.launches
    m = fuse_kernel.fuse_rows(*args, *pools, **consts)
    m_ref = fuse_kernel.fuse_rows_reference(*args, *refs, **consts)
    torch.cuda.synchronize()
    assert fuse_kernel.fuse_rows.launches == before + 1
    # same float32 operations without contraction: tsdf, rgbw and min|tsdf|
    # bit-equal; prob within 1e-6 (CUDA expf/logf against torch's exp/log)
    assert torch.equal(pools[0], refs[0])
    assert torch.equal(pools[1], refs[1])
    assert (pools[2] - refs[2]).abs().max().item() <= 1e-6
    assert torch.equal(m[:COUNT], m_ref[:COUNT])
    assert not torch.equal(pools[1], c["rgbw"])  # something fused


def test_fuse_rows_kernel_with_no_live_row(cuda):
    c = _block_case(cuda, seed=2, img_h=48, img_w=64, count=0)
    pools = [c[k].clone() for k in ("tsdf", "rgbw", "prob")]
    fuse_kernel.fuse_rows(c["img"], c["block_pos"], c["pool_idx"], c["count"], *pools,
                          truncation=TRUNC, max_depth=MAX_DEPTH, max_weight=MAX_W,
                          **c["geometry"])
    torch.cuda.synchronize()
    for a, k in zip(pools, ("tsdf", "rgbw", "prob")):
        assert torch.equal(a, c[k])


def test_sample_rows_kernel_matches_plain_version(cuda):
    c = _case(cuda, seed=2)
    before = sample_kernel.sample_rows.launches
    chans, valid = sample_kernel.sample_rows(c["img"], c["u"], c["v"], c["count"])
    ref, valid_ref = sample_kernel.sample_rows_reference(c["img"], c["u"], c["v"], c["count"])
    torch.cuda.synchronize()
    assert sample_kernel.sample_rows.launches == before + 1
    assert torch.equal(chans[:, :COUNT], ref[:, :COUNT])
    assert torch.equal(valid[:COUNT], valid_ref[:COUNT])
    assert not valid[:COUNT].all()  # some voxels were off-image


def test_kernels_reject_what_they_cannot_take(cuda):
    c = _case(cuda, seed=3)
    with pytest.raises(ValueError):
        sample_kernel.sample_rows(c["img"], c["u"].long(), c["v"], c["count"])
    b = _block_case(cuda, seed=3, img_h=48, img_w=64)
    with pytest.raises(ValueError):
        fuse_kernel.fuse_rows(b["img"][..., :4].contiguous(), b["block_pos"], b["pool_idx"],
                              b["count"], b["tsdf"], b["rgbw"], b["prob"], truncation=TRUNC,
                              max_depth=MAX_DEPTH, max_weight=MAX_W, **b["geometry"])
    with pytest.raises(ValueError):
        fuse_kernel.fuse_rows(b["img"], b["block_pos"].long(), b["pool_idx"],
                              b["count"], b["tsdf"], b["rgbw"], b["prob"], truncation=TRUNC,
                              max_depth=MAX_DEPTH, max_weight=MAX_W, **b["geometry"])
    (block_pos, pool_idx, count), (tsdf, rgbw, prob), geometry = _splat_case(
        cuda, 3, COUNT, 48, 64)
    with pytest.raises(ValueError):
        splat_kernel.splat_zbuf_blocks(block_pos.long(), pool_idx, count, tsdf, **geometry)
    with pytest.raises(ValueError):
        splat_kernel.splat_zbuf_blocks(block_pos, pool_idx, count, tsdf[:, :256].contiguous(),
                                       **geometry)
    with pytest.raises(ValueError):
        splat_kernel.splat_payload_blocks(block_pos, pool_idx, count, tsdf, rgbw,
                                          prob.double(),
                                          torch.zeros(48 * 64, dtype=torch.int32, device=cuda),
                                          **geometry)


@pytest.mark.parametrize("sampler", ["auto", "pallas"])
def test_integrate_on_the_card_equals_the_cpu_run(cuda, sampler):
    """Several frames of the golden sphere orbit through TSDFGrid on the
    card and on the CPU: the same volume (prob within 1e-6: CUDA expf/logf
    against torch's CPU exp/log, which drift apart over frames only at
    that level)."""
    cfg = TSDFConfig(num_blocks_log2=10, max_candidates=2048, max_visible=1024,
                     max_new_per_round=512, grid_log2=6, alloc_every=2,
                     sampler=sampler)
    k, w, h = (52.7, 53.3, 31.71, 23.43), 64, 48
    rng = np.random.default_rng(4)
    grids = [TSDFGrid(0.05, 0.15, cfg=cfg, device=d) for d in ("cpu", cuda)]
    for i in range(5):
        ang = 0.13 * i - 0.12
        pose = look_at((np.sin(ang) * 2.5 + 0.013, 0.1 * i - 0.027,
                        -2.5 * np.cos(ang) + 1.0), (0.013, -0.021, 1.007))
        depth = render_sphere(w, h, k, pose, (0.013, -0.021, 1.007), 0.613)
        ht, lt = rng.uniform(0.05, 0.95, (2, h, w)).astype(np.float32)
        for g in grids:
            g.integrate(checker_rgb(w, h), depth, ht, lt, 4.0, k, pose)
    a, b = (volume_to_numpy(g.volume) for g in grids)
    assert (a["entry_block"] >= 0).sum() > 10
    for f in a:
        if f != "prob":
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_allclose(a["prob"], b["prob"], rtol=0, atol=1e-6)


def _splat_case(dev, seed, count, img_h, img_w, about_z=False, voxel_size=0.008,
                truncation=0.024, near_share=0.05):
    """The splat kernels' block rows (tests/torch_cases.py): rows behind
    the camera and off the image, near_share of the live rows near the
    camera, with about_z voxels at camera z = 0 and depth ties along
    block layers; a pool with 60% of its voxels in the band and payload
    words with the top bit set.  -> (rows, pool, geometry) on `dev`."""
    c = splat_block_case(seed, img_h, img_w, ROWS, COUNT, POOL, voxel_size=voxel_size,
                         truncation=truncation, about_z=about_z, near_share=near_share)
    return _splat_tensors(c, dev, count, img_h, img_w)


def _splat_tensors(c, dev, count, img_h, img_w):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rows = (t(c["block_pos"]), t(c["pool_idx"]),
            torch.tensor(count, dtype=torch.int32, device=dev))
    pool = (t(c["tsdf"]), t(c["rgbw"]), t(c["prob"]))
    geometry = dict(cam_T_world=c["pose"], cam=CameraParams.create(c["intrinsics"], img_h, img_w),
                    voxel_size=c["voxel_size"], truncation=c["truncation"],
                    max_depth=c["max_depth"], band=c["band"])
    return rows, pool, geometry


def _splat_both(rows, pool, geometry, branches=None):
    """Both kernels and both plain versions on the same rows -> (zbuf,
    pbuf, zref, pref); branches: two i32 [2] counters, K4's and K5's."""
    tsdf, rgbw, prob = pool
    kz = {} if branches is None else {"branch_counts": branches[0]}
    kp = {} if branches is None else {"branch_counts": branches[1]}
    zbuf = splat_kernel.splat_zbuf_blocks(*rows, tsdf, **geometry, **kz)
    pbuf = splat_kernel.splat_payload_blocks(*rows, tsdf, rgbw, prob, zbuf, **geometry, **kp)
    zref = splat_kernel.splat_zbuf_blocks_reference(*rows, tsdf, **geometry)
    pref = splat_kernel.splat_payload_blocks_reference(*rows, tsdf, rgbw, prob, zref,
                                                       **geometry)
    torch.cuda.synchronize()
    return zbuf, pbuf, zref, pref


@pytest.mark.parametrize("about_z", [False, True])
@pytest.mark.parametrize("count", [0, COUNT, ROWS])
@pytest.mark.parametrize("img_hw", [(48, 64), (1080, 1920)])
def test_splat_kernels_match_plain_versions(cuda, count, img_hw, about_z):
    """K4 and K5 project the block rows in registers and merge exactly as
    their plain versions do on the card: both buffers bit-equal, one
    launch each; no live row merges nothing; u32 words with the top bit
    set win."""
    img_h, img_w = img_hw
    rows, pool, geometry = _splat_case(cuda, 5, count, img_h, img_w, about_z=about_z)
    before = (splat_kernel.splat_zbuf_blocks.launches,
              splat_kernel.splat_payload_blocks.launches)
    zbuf, pbuf, zref, pref = _splat_both(rows, pool, geometry)
    assert (splat_kernel.splat_zbuf_blocks.launches,
            splat_kernel.splat_payload_blocks.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(zbuf, zref) and torch.equal(pbuf, pref)
    if count == 0:
        assert (zbuf == splat_kernel.BIG).all() and (pbuf == 0).all()
    else:
        assert (zbuf < splat_kernel.BIG).any() and (pbuf < 0).any()


@pytest.mark.parametrize("img_hw", [(48, 64), (1080, 1920)])
def test_splat_tile_and_atomic_branches_match_plain_version(cuda, img_hw):
    """Rows whose footprints fit the kernels' shared tile and rows near
    the camera spread wider than it: both branches of each kernel taken,
    counted, and both buffers bit-equal to the plain versions."""
    img_h, img_w = img_hw
    # blocks of 0.8 m fill a 64x48 view; blocks of 16 mm fit the tile at 1080p
    voxel = 0.1 if img_h == 48 else 0.002
    rows, pool, geometry = _splat_case(cuda, 8, COUNT, img_h, img_w, voxel_size=voxel,
                                       truncation=3 * voxel, near_share=0.25)
    branches = [torch.zeros(2, dtype=torch.int32, device=cuda) for _ in range(2)]
    zbuf, pbuf, zref, pref = _splat_both(rows, pool, geometry, branches)
    assert torch.equal(zbuf, zref) and torch.equal(pbuf, pref)
    for b in branches:
        tile_rows, atomic_rows = b.tolist()
        assert tile_rows > 0 and atomic_rows > 0 and tile_rows + atomic_rows <= COUNT
    assert torch.equal(branches[0], branches[1])  # one footprint box per row


@pytest.mark.parametrize("case", splat_edge_cases(), ids=lambda c: c[0] if isinstance(c, tuple) else "")
def test_splat_kernels_at_the_float32_thresholds(cuda, case):
    """A voxel one float32 ulp either side of max_depth and of the band
    edge: the plain projection on the card puts it where the CPU does, and
    both kernels equal their plain versions bit for bit."""
    label, c, (row, vox), in_band = case
    rows, pool, geometry = _splat_tensors(c, cuda, c["count"], 48, 64)
    _, _, _, surf = render_fast.project_splat_rows(
        *rows, pool[0], geometry["cam_T_world"], geometry["cam"], c["voxel_size"],
        c["truncation"], c["max_depth"], c["band"])
    assert bool(surf[row, vox]) == in_band, label
    zbuf, pbuf, zref, pref = _splat_both(rows, pool, geometry)
    assert torch.equal(zbuf, zref) and torch.equal(pbuf, pref), label


def test_splat_probes_agree(cuda):
    """P8's A/B and P9's tile-shape sweep run on block rows, project as K4
    does and agree with the plain scatter-min (each raises otherwise);
    the smaller the tile, the more wide rows take the atomic branch."""
    from disinfect_slam_tpu_torch.ops.cuda import splat_probe

    cases = {"narrow": _splat_case(cuda, 5, COUNT, 48, 64),
             "wide": _splat_case(cuda, 8, COUNT, 48, 64, voxel_size=0.1, truncation=0.3,
                                 near_share=0.25)}
    calls = []
    before = (splat_probe.zbuf_atomic.launches, splat_probe.zbuf_tile.launches)
    res = splat_probe.run(cuda, lambda fn, name, nbytes=0: calls.append(name) or 0.0, cases)
    assert len(calls) == 2 + 2 * len(splat_probe.TILE_SHAPES)
    assert splat_probe.zbuf_atomic.launches > before[0]
    assert splat_probe.zbuf_tile.launches > before[1]
    assert res["p8"]["max_abs_err"] == 0 and res["p8"]["count"] == COUNT
    assert [r["tile"] for r in res["p9"]] == [list(s) for s in splat_probe.TILE_SHAPES]
    atomic_rows = [r["wide"]["branches"][1] for r in res["p9"]]
    assert atomic_rows[0] > 0 and atomic_rows == sorted(atomic_rows, reverse=True)
    assert all(r[k]["max_abs_err"] == 0 for r in res["p9"] for k in cases)


def test_feature_probe_passes_every_check(cuda):
    """P7's Hopper counterpart: every primitive compiles, launches and
    gives the numerics its check expects (run raises otherwise)."""
    from disinfect_slam_tpu_torch.ops.cuda import feature_probe

    before = feature_probe.launch.launches
    res = feature_probe.run(cuda)
    assert set(res) == {fn.__name__ for fn in feature_probe.CHECKS}
    assert all(r["ok"] and r["max_abs_err"] == 0 for r in res.values())
    assert feature_probe.launch.launches == before + len(feature_probe.CHECKS)


def test_sample_probe_modes_agree(cuda):
    """P1-P6's Hopper counterparts: every direct, patch and mma mode and
    every stripped stage of fuse_rows launches and agrees with its plain
    version (run raises otherwise); pixels scattered over the frame leave
    voxels outside the patches, skipped and counted."""
    from disinfect_slam_tpu_torch.ops.cuda import sample_probe

    c = _case(cuda, seed=9)
    b = _block_case(cuda, seed=9, img_h=48, img_w=64)
    consts = dict(truncation=TRUNC, max_depth=MAX_DEPTH, max_weight=MAX_W, **b["geometry"])
    calls = []
    res = sample_probe.run(
        cuda, lambda fn, name, nbytes: calls.append(name) or 0.0,
        (c["img"], c["u"], c["v"], c["count"]),
        (b["img"], b["block_pos"], b["pool_idx"], b["count"],
         (b["tsdf"], b["rgbw"], b["prob"]), consts), fuse_kernel.fuse_rows)
    n_patch = len(sample_probe.PATCH_SHAPES) * len(sample_probe.ROWS_PER_CTA) + 1
    assert len(res["p4"]) == len(sample_probe.DIRECT_MODES) + 1
    assert len(res["patch"]) == n_patch and len(res["p5"]) == len(sample_probe.FUSE_STAGES) + 1
    assert len(calls) == len(res["p4"]) + n_patch + len(res["p5"])
    assert all(r["max_abs_err"] == 0 for g in ("p4", "patch", "p5") for r in res[g]
               if "max_abs_err" in r)
    through = [r["voxels_through"] for r in res["p5"][:-1]]
    assert through[0] == 512 * int(b["count"]) and through == sorted(through, reverse=True)
    # the 48x64 patch covers this 48x64 frame; the 24x32 one does not
    assert all((r["skipped_voxels"] > 0 and r["skipped_rows"] > 0) == ("24x32" in r["mode"])
               for r in res["patch"])


def _fused_grid(device):
    cfg = TSDFConfig(num_blocks_log2=10, max_candidates=2048, max_visible=1024,
                     max_new_per_round=512, grid_log2=6)
    k, w, h = (52.7, 53.3, 31.71, 23.43), 64, 48
    grid = TSDFGrid(0.05, 0.15, cfg=cfg, device=device)
    rng = np.random.default_rng(4)
    poses = []
    for i in range(4):
        ang = 0.13 * i - 0.12
        pose = look_at((np.sin(ang) * 2.5 + 0.013, 0.1 * i - 0.027,
                        -2.5 * np.cos(ang) + 1.0), (0.013, -0.021, 1.007))
        depth = render_sphere(w, h, k, pose, (0.013, -0.021, 1.007), 0.613)
        ht, lt = rng.uniform(0.05, 0.95, (2, h, w)).astype(np.float32)
        grid.integrate(checker_rgb(w, h), depth, ht, lt, 4.0, k, pose)
        poses.append(pose)
    return grid, poses, (k, h, w)


def test_ray_cast_auto_on_the_card_equals_the_plain_path(cuda):
    """renderer="auto" on the card launches each splat kernel once and
    gives the bits of the plain splat on the same CUDA volume."""
    grid, poses, (k, h, w) = _fused_grid(cuda)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    for pose in poses[:2]:
        before = (splat_kernel.splat_zbuf_blocks.launches,
                  splat_kernel.splat_payload_blocks.launches)
        res = grid.ray_cast(4.0, (k, h, w), pose, renderer="auto")
        assert (splat_kernel.splat_zbuf_blocks.launches,
                splat_kernel.splat_payload_blocks.launches) == (before[0] + 1, before[1] + 1)
        ref = render_fast.splat_render(grid.volume, cam, SE3.from_matrix(pose), 4.0)
        for f in ("hit", "depth", "rgba", "normal"):
            assert torch.equal(getattr(res, f), getattr(ref, f)), f
        assert int(res.surf_overflow) == 0 and res.hit.float().mean() > 0.1
        bufs = splat_kernel.splat_buffers_cuda(grid.volume, cam, SE3.from_matrix(pose), 4.0)
        ref_bufs = render_fast.splat_buffers(grid.volume, cam, SE3.from_matrix(pose), 4.0)
        for a, b in zip(bufs, ref_bufs):
            assert torch.equal(a, b)


def test_card_path_writes_no_plane(cuda, monkeypatch):
    """On the card, the splat buffers, the depth and the render come from
    the two kernels alone: the torch projection that writes [S, 512]
    planes (render_fast.project_splat_rows, _project_for_splat) is never
    called."""
    grid, poses, (k, h, w) = _fused_grid(cuda)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    pose = SE3.from_matrix(poses[0])
    ref = render_fast.splat_buffers(grid.volume, cam, pose, 4.0)

    def planes(*args, **kwargs):
        raise AssertionError("the card path projected in torch")

    monkeypatch.setattr(render_fast, "project_splat_rows", planes)
    monkeypatch.setattr(render_fast, "_project_for_splat", planes)
    bufs = splat_kernel.splat_buffers_cuda(grid.volume, cam, pose, 4.0)
    depth, hit = splat_kernel.splat_depth(grid.volume, cam, pose, 4.0)
    res = grid.ray_cast(4.0, (k, h, w), poses[0], renderer="auto")
    for a, b in zip(bufs, ref):
        assert torch.equal(a, b)
    assert torch.equal(hit, res.hit) and torch.equal(depth, res.depth)


def test_raycast_on_the_card_agrees_with_the_cpu(cuda):
    """The parity raycaster on the card (the raycast kernel, captured)
    against the CPU (the plain version): on the dense volume fused on
    each device, and on a host copy of the card's hash volume (two hash
    fusions' prob may differ in the last bit); all four images bit for
    bit, at every pose (the plain version's three-term sums are written
    out left to right, so both devices add them alike)."""
    import dataclasses

    from disinfect_slam_tpu_torch.ops import raycast as rc

    grid, poses, (k, h, w) = _fused_grid(cuda)
    cpu, _, _ = _fused_grid("cpu")
    hgrid, hposes, _ = _hash_grid(cuda)
    hvol = hgrid.volume
    host = dataclasses.replace(hvol, **{f.name: getattr(hvol, f.name).cpu()
                                        for f in dataclasses.fields(hvol) if f.name != "cfg"})
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    cases = [(grid, lambda p: cpu.ray_cast(4.0, (k, h, w), p, renderer="raycast"), poses),
             (hgrid, lambda p: rc.raycast_reference(host, cam, SE3.from_matrix(p), 4.0), hposes)]
    for on_card, on_cpu, views in cases:
        for pose in views:
            a = on_card.ray_cast(4.0, (k, h, w), pose, renderer="raycast")
            b = on_cpu(pose)
            assert a.hit.device.type == "cuda" and b.hit.any()
            for f in ("hit", "depth", "rgba", "normal"):
                assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), (on_card.volume.cfg.backend, f)


def _raycast_volumes(cuda):
    """(name, volume, poses, (k, h, w)) of the raycast kernel's cases: the
    dense orbit (the march skips blocks and superblocks), the same volume
    without the skip, and the hash orbit (blocks only)."""
    import dataclasses

    grid, poses, cam = _fused_grid(cuda)
    hgrid, hposes, _ = _hash_grid(cuda)
    vol = grid.volume
    no_skip = dataclasses.replace(vol, cfg=dataclasses.replace(vol.cfg, raycast_skip=False))
    return [("dense", vol, poses, cam), ("dense_no_skip", no_skip, poses, cam),
            ("hash", hgrid.volume, hposes, cam)]


def test_raycast_kernel_equals_its_plain_version(cuda):
    """The raycast kernel (one launch a render, after one superblock_bits
    launch on the dense superblock path) against raycast_reference on the
    card, on the dense volume (superblocks: the bits in shared memory and,
    forced, in device memory), without the skip and on the hash volume, at
    every pose and at a max_depth cut short of the surface: hit, depth,
    rgba and normal bit for bit, one launch each."""
    from disinfect_slam_tpu_torch.ops import raycast as rc
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel

    for name, vol, poses, (k, h, w) in _raycast_volumes(cuda):
        cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
        layouts = raycast_kernel.LAYOUTS if rc.uses_superblocks(vol.cfg) else (None,)
        for pose in poses:
            for max_depth in (4.0, 2.2):
                want = rc.raycast_reference(vol, cam, SE3.from_matrix(pose), max_depth)
                for layout in layouts:
                    before = (raycast_kernel.raycast.launches,
                              raycast_kernel.superblock_bits.launches)
                    got = raycast_kernel.raycast(vol, cam, SE3.from_matrix(pose), max_depth,
                                                 layout=layout)
                    assert (raycast_kernel.raycast.launches,
                            raycast_kernel.superblock_bits.launches) == (
                                before[0] + 1, before[1] + (layout is not None))
                    for f in ("hit", "depth", "rgba", "normal"):
                        assert torch.equal(getattr(got, f), getattr(want, f)), (
                            name, layout, f, max_depth)
                if max_depth == 4.0:
                    assert want.hit.float().mean() > 0.1, name


def test_superblock_bits_equals_its_plain_version(cuda):
    """The superblock_bits kernel against superblock_bits_reference word
    for word, one launch each: the fused orbit's 2^6 grid, the 2^3 window
    (one word and three of padding) and a 2^8 grid (the bench's) holding a
    random 0.1% of its cells, its first and last cell and claim codes;
    then the same 2^8 table's bits on the CPU."""
    from types import SimpleNamespace

    from disinfect_slam_tpu_torch.ops import raycast as rc
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel

    grid, _, _ = _fused_grid(cuda)
    cfg3 = TSDFConfig(grid_log2=3, num_blocks_log2=6)
    small = torch.full((cfg3.grid_cells,), -1, dtype=torch.int32)
    small[[0, 100, 511]] = torch.tensor([3, -5, 4], dtype=torch.int32)
    cfg8 = TSDFConfig(grid_log2=8, num_blocks_log2=12)
    rng = np.random.default_rng(11)
    table = np.full(cfg8.grid_cells, -1, np.int32)
    held = rng.choice(cfg8.grid_cells, cfg8.grid_cells // 1000, replace=False)
    table[held] = rng.integers(-20, 1 << 12, held.size)
    table[[0, cfg8.grid_cells - 1]] = (5, 6)
    vols = [grid.volume,
            SimpleNamespace(cfg=cfg3, device=cuda, block_table=small.to(cuda)),
            SimpleNamespace(cfg=cfg8, device=cuda, block_table=torch.from_numpy(table).to(cuda))]
    for vol in vols:
        before = raycast_kernel.superblock_bits.launches
        got = raycast_kernel.superblock_bits(vol)
        assert raycast_kernel.superblock_bits.launches == before + 1
        want = rc.superblock_bits_reference(vol)
        assert got.dtype == torch.int32 and torch.equal(got, want), vol.cfg.grid_log2
        assert got.numel() == rc.superblock_words(vol.cfg) and got.any()
    host = SimpleNamespace(cfg=cfg8, device=torch.device("cpu"),
                           block_table=torch.from_numpy(table))
    assert torch.equal(got.cpu(), rc.superblock_bits_reference(host))


def test_a_captured_raycast_replayed_after_new_allocations_reads_fresh_bits(cuda):
    """A RaycastStep captured at a view of empty space, then a wall fused
    there (blocks in superblocks whose bits were clear), then a replay (the
    same key: the volume keeps its storage): the replay gives the plain
    raycast of the new volume, not the empty render the graph first
    made, so the graph rebuilds the bits every render."""
    from disinfect_slam_tpu_torch.ops import raycast as rc
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel
    from disinfect_slam_tpu_torch.utils import graphs

    grid, _, (k, h, w) = _fused_grid(cuda)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    pose = look_at((6.0, 0.1, -1.5), (6.0, 0.1, 2.0))
    step = raycast_kernel.RaycastStep(cuda)
    key = grid.volume.storage_key()
    bits_before = rc.superblock_bits_reference(grid.volume)
    empty = step(grid.volume, cam, SE3.from_matrix(pose), 4.0)  # the capture
    assert not empty.hit.any()
    depth = render_wall(w, h, k, pose, wall_z=1.0).astype(np.float32)
    rng = np.random.default_rng(5)
    ht, lt = rng.uniform(0.05, 0.95, (2, h, w)).astype(np.float32)
    grid.integrate(checker_rgb(w, h), depth, ht, lt, 4.0, k, pose)
    torch.cuda.synchronize()
    assert grid.volume.storage_key() == key
    bits_after = rc.superblock_bits_reference(grid.volume)
    assert ((bits_before ^ bits_after) & bits_after).any()  # superblocks newly held
    replays = graphs.REPLAYS["graph"]
    res = step(grid.volume, cam, SE3.from_matrix(pose), 4.0)
    assert graphs.REPLAYS["graph"] == replays + 1
    want = rc.raycast_reference(grid.volume, cam, SE3.from_matrix(pose), 4.0)
    assert want.hit.float().mean() > 0.5
    for f in ("hit", "depth", "rgba", "normal"):
        assert torch.equal(getattr(res, f), getattr(want, f)), f


def test_a_captured_raycast_graph_holds_only_its_two_kernels(cuda):
    """A RaycastStep's graph, read from the graph itself (its DOT dump):
    one superblock_bits kernel and one raycast kernel, and no other kernel
    (no torch op of the superblock table)."""
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel
    from disinfect_slam_tpu_torch.utils.graphs import StepGraphs

    grid, poses, (k, h, w) = _fused_grid(cuda)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    step = raycast_kernel.RaycastStep(cuda, graphs=StepGraphs(cuda, keep_structure=True))
    step(grid.volume, cam, SE3.from_matrix(poses[0]), 4.0)
    nodes = step.graphs.nodes(step.graphs.keys()[0])
    kernels = [k for k in nodes.elements() if k.startswith("KERNEL")]
    assert len(kernels) == 2, dict(nodes)
    assert sum("superblock_bits_kernel" in k for k in kernels) == 1, kernels
    assert sum("raycast_kernel" in k for k in kernels) == 1, kernels


def test_a_captured_raycast_is_one_graph_launch_and_never_syncs(cuda):
    """TSDFGrid.ray_cast(renderer="raycast") on the card: the first call
    captures a RaycastStep, later calls replay it as one graph launch with
    no kernel launch of its own and no sync (set_sync_debug_mode("error")),
    one raycast launch counted a render; each render's images are fresh
    tensors equal to the eager kernel's (capture off)."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel
    from disinfect_slam_tpu_torch.utils import graphs

    grid, poses, cam = _fused_grid(cuda)
    first = grid.ray_cast(4.0, cam, poses[0], renderer="raycast")
    torch.cuda.synchronize()
    launches, replays = raycast_kernel.raycast.launches, graphs.REPLAYS["graph"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = [grid.ray_cast(4.0, cam, p, renderer="raycast") for p in poses[1:3]]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    names = [e.name for e in prof.events()]
    assert sum(n in ("cudaGraphLaunch", "cuGraphLaunch") for n in names) == 2
    assert not any(n in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernelEx") for n in names)
    assert raycast_kernel.raycast.launches - launches == 2
    assert graphs.REPLAYS["graph"] - replays == 2
    assert res[0].rgba.data_ptr() != res[1].rgba.data_ptr() != first.rgba.data_ptr()
    grid.capture = False
    for pose, r in zip(poses[1:3], res):
        eager = grid.ray_cast(4.0, cam, pose, renderer="raycast")
        for f in ("hit", "depth", "rgba", "normal"):
            assert torch.equal(getattr(eager, f), getattr(r, f)), f


# ----------------------------------------------------------------------
# the online slice: segmentation feeding fuse_rows
# ----------------------------------------------------------------------
ORBIT_RGB = os.path.join(os.path.dirname(__file__), "..", "datasets", "orbit_vga",
                         "0_rgb.png")
# the shipped nets in bfloat16: the limits tests/test_torch_seg.py holds
# the port on the CPU to against JAX (max, mean |dp|), and thresholded
# labels differing on at most 0.5% of pixels
SHIPPED_TOL = {"unet": (0.1, 5e-3), "fast": (0.05, 2e-3)}


@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_shipped_seg_on_the_card_matches_the_cpu(cuda, arch):
    rgb = read_image(ORBIT_RGB)
    ref = seg.InferenceEngine(seg.load_model(arch, device="cpu")).infer_one(rgb)
    ours = seg.InferenceEngine(seg.load_model(arch, device=cuda)).infer_one(rgb)
    for a, b in zip(ref, ours):
        assert b.shape == (360, 640) and b.dtype == np.float32
        err = np.abs(a - b)
        max_tol, mean_tol = SHIPPED_TOL[arch]
        assert err.max() <= max_tol and err.mean() <= mean_tol, (err.max(), err.mean())
        assert ((a > 0.5) != (b > 0.5)).mean() <= 0.005


@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_float32_seg_on_the_card_runs_without_tf32(cuda, arch):
    """A float32 net through `segment` on the card equals the CPU within
    1e-4: TF32 (10-bit mantissas) in the convs or the resize matmuls
    would move the maps by about 1e-3."""
    net = seg.create_model((8, 16, 32, 32), dtype=torch.float32, arch=arch,
                           generator=torch.Generator().manual_seed(5))
    rgb = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (96, 128, 3),
                                                            dtype=np.uint8))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    ref = seg.segment(net, rgb, 96, 128)
    ours = seg.segment(copy.deepcopy(net).to(cuda), rgb.to(cuda), 96, 128).cpu()
    assert ours.shape == (2, 96, 128)
    assert (ours - ref).abs().max().item() <= 1e-4
    # the global flags are left as they were
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags


ONLINE_CFG = TSDFConfig(voxel_size=0.05, truncation=0.15, num_blocks_log2=10,
                        max_candidates=2048, max_visible=1024, max_new_per_round=512,
                        grid_log2=6, alloc_every=2)
ONLINE_K, ONLINE_W, ONLINE_H, DEPTH_FACTOR = (52.7, 53.3, 31.71, 23.43), 64, 48, 5000.0
# prob on the card against the CPU: the maps reach fusion only through
# prob; float32 nets differ by conv summation order only, bfloat16 ones by
# single bf16 roundings as well (the limits of tests/test_torch_online.py)
ONLINE_PROB_TOL = {"none": 1e-6, "float32": 1e-4, "bfloat16": 0.05}


def _online_frames(n=4):
    """The golden scene of tests/test_online_step.py: a sphere before a
    wall, u8 rgb and u16 depth counts."""
    k, w, h = ONLINE_K, ONLINE_W, ONLINE_H
    rgb = checker_rgb(w, h).astype(np.uint8)
    out = []
    for i in range(n):
        pose = look_at((0.03 * i, -0.02, -1.5), (0.1, 0.0, 1.5))
        d1 = render_sphere(w, h, k, pose, center=(0.1, 0.0, 1.5), radius=0.45)
        d2 = render_wall(w, h, k, pose, wall_z=2.4131)
        depth = np.where(d1 > 0, d1, d2).astype(np.float32)
        out.append((rgb, np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16),
                    np.asarray(pose, np.float32)))
    return out


@pytest.mark.parametrize("dtype", ["none", "float32", "bfloat16"])
def test_online_step_on_the_card_equals_the_cpu(cuda, dtype):
    """FusedOnlineStep over 4 frames (allocation every 2nd) on the card
    and on the CPU: fuse_rows launched once per frame on the card and
    sample_rows never; every field but prob equal; prob within
    ONLINE_PROB_TOL."""
    net = None
    if dtype != "none":
        net = seg.create_model((8, 16, 32, 32), dtype=getattr(torch, dtype),
                               generator=torch.Generator().manual_seed(6))
    steps = [FusedOnlineStep(ONLINE_CFG, ONLINE_K, ONLINE_H, ONLINE_W, 4.0,
                             seg_model=copy.deepcopy(net), depth_factor=DEPTH_FACTOR,
                             device=d) for d in ("cpu", cuda)]
    frames = _online_frames()
    before = (fuse_kernel.fuse_rows.launches, sample_kernel.sample_rows.launches)
    for f in frames:
        for s in steps:
            s.step(*f)
    steps[1].block_until_ready()
    assert (fuse_kernel.fuse_rows.launches - before[0],
            sample_kernel.sample_rows.launches - before[1]) == (len(frames), 0)
    a, b = (volume_to_numpy(s.volume) for s in steps)
    assert (a["entry_block"] >= 0).sum() > 10
    for f in a:
        if f != "prob":
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_allclose(a["prob"], b["prob"], rtol=0, atol=ONLINE_PROB_TOL[dtype])


def test_cuda_requests_raise_without_cuda(monkeypatch):
    """The model loader and the online step never drop to the CPU: a CUDA
    device without CUDA raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        seg.load_model("fast", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedOnlineStep(ONLINE_CFG, ONLINE_K, ONLINE_H, ONLINE_W, 4.0, device="cuda")


# ----------------------------------------------------------------------
# the export slice: the hash backend, meshing, a clipped splat
# ----------------------------------------------------------------------
def _to(vol, dev):
    """A copy of a volume on another device."""
    import dataclasses

    return dataclasses.replace(vol, **{f.name: getattr(vol, f.name).to(dev)
                                       for f in dataclasses.fields(vol) if f.name != "cfg"})


def test_hash_insert_and_lookup_on_the_card_equal_the_cpu(cuda):
    """Claim rounds, tombstones and heap pops of the hash backend on the
    card: the same tables as the port on the CPU, batch after batch."""
    from disinfect_slam_tpu_torch.config import TINY
    from disinfect_slam_tpu_torch.core.state import TSDFVolume
    from disinfect_slam_tpu_torch.ops import hash as th

    rng = np.random.default_rng(11)
    universe = np.unique(rng.integers(-12, 12, (96, 3)).astype(np.int32), axis=0)
    vols = [TSDFVolume.create(TINY, device=d) for d in ("cpu", cuda)]
    for r in range(10):
        coords = torch.from_numpy(universe[rng.integers(0, len(universe), 40)])
        valid = torch.from_numpy(rng.uniform(size=40) < 0.9)
        drops = [th.insert(v, coords.to(v.device), valid.to(v.device))[1].cpu() for v in vols]
        assert torch.equal(*drops)
        if r % 2:
            q = torch.from_numpy(universe[rng.integers(0, len(universe), 8)])
            for v in vols:
                entry = th.lookup_entry(v, q.to(v.device))
                # one delete per entry, as carving makes them
                first = torch.ones_like(entry, dtype=torch.bool)
                first[1:] = entry[1:] != entry[:-1]
                th.delete_entries(v, entry, first)
        a, b = (volume_to_numpy(v) for v in vols)
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    u = torch.from_numpy(universe)
    for fn in (th.lookup, th.lookup_entry):
        assert torch.equal(fn(vols[0], u), fn(vols[1], u.to(cuda)).cpu())
    assert (vols[0].entry_block == -2).any()  # tombstones were walked


def _hash_grid(device):
    """The golden sphere orbit of _fused_grid, fused on the hash backend
    with the sort dedup."""
    cfg = TSDFConfig(num_blocks_log2=10, num_buckets_log2=12, max_candidates=2048,
                     max_visible=1024, max_new_per_round=512, backend="hash",
                     alloc_dedup="sort", alloc_every=2)
    k, w, h = (52.7, 53.3, 31.71, 23.43), 64, 48
    grid = TSDFGrid(0.05, 0.15, cfg=cfg, device=device)
    rng = np.random.default_rng(4)
    poses = []
    for i in range(5):
        ang = 0.13 * i - 0.12
        pose = look_at((np.sin(ang) * 2.5 + 0.013, 0.1 * i - 0.027,
                        -2.5 * np.cos(ang) + 1.0), (0.013, -0.021, 1.007))
        depth = render_sphere(w, h, k, pose, (0.013, -0.021, 1.007), 0.613)
        ht, lt = rng.uniform(0.05, 0.95, (2, h, w)).astype(np.float32)
        grid.integrate(checker_rgb(w, h), depth, ht, lt, 4.0, k, pose)
        poses.append(pose)
    return grid, poses, (k, h, w)


def test_hash_backend_fuses_and_renders_on_the_card(cuda):
    """fuse_rows on hash-slot-ordered rows, then the splat kernels on the
    hash volume: the volume equals the CPU run's (prob within 1e-6, as
    test_integrate_on_the_card_equals_the_cpu_run), and renderer "auto"
    launches K4 and K5 once each, bit-equal to the plain splat."""
    before = fuse_kernel.fuse_rows.launches
    grid, poses, (k, h, w) = _hash_grid(cuda)
    assert fuse_kernel.fuse_rows.launches == before + len(poses)
    cpu, _, _ = _hash_grid("cpu")
    a, b = volume_to_numpy(cpu.volume), volume_to_numpy(grid.volume)
    assert (a["entry_block"] >= 0).sum() > 10
    for f in a:
        if f != "prob":
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_allclose(a["prob"], b["prob"], rtol=0, atol=1e-6)
    kernels = (splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks)
    n0 = [fn.launches for fn in kernels]
    res = grid.ray_cast(4.0, (k, h, w), poses[0], renderer="auto")
    assert [fn.launches - n for fn, n in zip(kernels, n0)] == [1, 1]
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    ref = render_fast.splat_render(grid.volume, cam, SE3.from_matrix(poses[0]), 4.0)
    for f in ("hit", "depth", "rgba", "normal"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert res.hit.float().mean() > 0.1
    assert grid.ray_cast(4.0, (k, h, w), poses[0], renderer="raycast").hit.any()


def test_mesh_chunks_on_the_card_equal_the_cpu(cuda):
    """extract_mesh_chunked on the card against the CPU on the same
    volume, f32 and q16: equal triangle counts, vertices within 1e-6 m,
    no triangle wound the other way."""
    from disinfect_slam_tpu_torch.ops import mesh as tmesh

    grid, _, _ = _fused_grid("cpu")
    vols = [grid.volume, _to(grid.volume, cuda)]
    for transfer in ("f32", "q16"):
        a, b = (tmesh.extract_mesh_chunked(v, chunk=16, transfer=transfer) for v in vols)
        assert a.shape == b.shape and a.shape[0] > 300
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        n_a = np.cross(a[:, 1] - a[:, 0], a[:, 2] - a[:, 0])
        n_b = np.cross(b[:, 1] - b[:, 0], b[:, 2] - b[:, 0])
        big = np.linalg.norm(n_a, axis=-1) > 1e-10
        assert ((n_a * n_b).sum(-1)[big] > 0).all()


def test_clipped_splat_on_the_card_equals_the_plain_splat(cuda):
    """surf_overflow > 0 on the card: a surface cap at half the surface
    blocks drops the same blocks from the kernels' render and from the
    plain splat, with the same count and the same images."""
    grid, poses, (k, h, w) = _fused_grid(cuda)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    pose = SE3.from_matrix(poses[0])
    n_surf = int(render_fast.splat_buffers(grid.volume, cam, pose, 4.0)[3])
    cap = n_surf // 2
    ours = splat_kernel.splat_render_cuda(grid.volume, cam, pose, 4.0, surf_cap=cap)
    ref = render_fast.splat_render(grid.volume, cam, pose, 4.0, surf_cap=cap)
    assert int(ours.surf_overflow) == int(ref.surf_overflow) == n_surf - cap > 0
    for f in ("hit", "depth", "rgba", "normal"):
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
    full = splat_kernel.splat_render_cuda(grid.volume, cam, pose, 4.0)
    assert ours.hit.sum() < full.hit.sum()


# ----------------------------------------------------------------------
# the tracking slice: K4 at the tracking resolution, DenseSLAM on the card
# ----------------------------------------------------------------------
SLAM_K, SLAM_W, SLAM_H = (131.7, 132.3, 79.7, 59.4), 160, 120
SLAM_CENTER = np.array([0.1, 0.0, 1.5])
SLAM_CFG = TSDFConfig(voxel_size=0.05, truncation=0.15, num_blocks_log2=12,
                      max_candidates=8192, max_visible=4096, max_new_per_round=2048,
                      grid_log2=6)
# card against CPU: every stage of the tracker (the pyramids, ICP's
# kernel, the gate, the splat, the smoothing and fusion) gives the same bits
# on both, so the tracked poses are equal bit for bit


def _slam_depth(pose):
    """tests/test_dense_slam.py's scene: two spheres before a wall."""
    d1 = render_sphere(SLAM_W, SLAM_H, SLAM_K, pose, center=SLAM_CENTER, radius=0.45)
    d2 = render_wall(SLAM_W, SLAM_H, SLAM_K, pose, wall_z=2.4131)
    d3 = render_sphere(SLAM_W, SLAM_H, SLAM_K, pose, center=(-0.5, 0.3, 1.9), radius=0.3)
    d = np.where(d1 > 0, d1, d2)
    return np.where(d3 > 0, d3, d).astype(np.float32)


def _slam_orbit():
    return [look_at((np.sin(a) * 1.8, 0.01 * a, -1.8 * np.cos(a) + 0.3), SLAM_CENTER)
            for a in np.linspace(0, 0.12, 6)]


@pytest.mark.parametrize("img_hw", [(240, 320), (480, 640)])
def test_splat_zbuf_at_the_tracking_resolutions(cuda, img_hw):
    """K4 alone, as DenseSLAM's model depth launches it, at 320x240
    (track_res_scale=2) and 640x480: bit-equal to its plain version on the
    block rows, both branches taken and counted."""
    img_h, img_w = img_hw
    rows, pool, geometry = _splat_case(cuda, 9, COUNT, img_h, img_w, voxel_size=0.02,
                                       truncation=0.06, near_share=0.25)
    branches = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = splat_kernel.splat_zbuf_blocks.launches
    zbuf = splat_kernel.splat_zbuf_blocks(*rows, pool[0], **geometry, branch_counts=branches)
    zref = splat_kernel.splat_zbuf_blocks_reference(*rows, pool[0], **geometry)
    assert splat_kernel.splat_zbuf_blocks.launches == before + 1
    assert torch.equal(zbuf, zref) and (zbuf < splat_kernel.BIG).any()
    tile_rows, atomic_rows = branches.tolist()
    assert tile_rows > 0 and atomic_rows > 0


def test_model_depth_smoothing_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """The validity-aware box smoothing (nine shifted adds, no cuDNN
    convolution and so no TF32) gives the CPU's bits."""
    from disinfect_slam_tpu_torch.systems.dense_slam import smooth_model_depth

    rng = np.random.default_rng(12)
    d = rng.uniform(0.5, 4.0, (240, 320)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = 0.0
    # the default: the smoothing must not care
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ref = smooth_model_depth(torch.from_numpy(d))
    ours = smooth_model_depth(torch.from_numpy(d).to(cuda)).cpu()
    assert torch.equal(ours, ref)


@pytest.mark.parametrize("scale", [1, 2])
def test_dense_slam_on_the_card_equals_the_cpu(cuda, monkeypatch, scale):
    """DenseSLAM over the 6-frame orbit on the card and on the CPU, with
    TF32 switched on globally beforehand: the same ok flags and every pose
    bit for bit; no pose read and, on the card, no stream sync on any frame
    (torch's sync debug mode counts them; frames 0-2 capture, and the
    capture's own device synchronisation is not one); K4 once per tracked
    frame at the tracking camera, K5 never, fuse_rows once per frame and
    the ICP kernel once an iteration (19 a tracked frame), graph replays
    included; the global flags are left as they were."""
    import warnings

    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel
    from disinfect_slam_tpu_torch.systems import dense_slam as tds
    from disinfect_slam_tpu_torch.systems import odometry

    rgb = checker_rgb(SLAM_W, SLAM_H)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    counted = (splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks,
               fuse_kernel.fuse_rows, icp_kernel.icp_step)
    runs = {}
    for dev in ("cpu", cuda):
        slam = tds.DenseSLAM(SLAM_K, SLAM_H, SLAM_W, voxel_size=0.02, truncation=0.06,
                             cfg=SLAM_CFG, track_res_scale=scale, device=dev)
        launches = [fn.launches for fn in counted]
        reads, syncs, poses, oks = [], [], [], []
        for pose in _slam_orbit():
            r0 = odometry.read_result.reads
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if dev != "cpu":
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    p, ok = slam.process_frame(rgb, _slam_depth(pose))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs.append(sum("synchronizing" in str(w.message) for w in caught))
            reads.append(odometry.read_result.reads - r0)
            assert p.device.type == torch.device(dev).type and p.shape == (4, 4)
            poses.append(p.cpu().numpy())
            oks.append(bool(ok))
        launches = [fn.launches - b for fn, b in zip(counted, launches)]
        runs[torch.device(dev).type] = (np.stack(poses), oks, reads, syncs, launches)
    (cp, cok, creads, _, clx), (gp, gok, greads, gsyncs, glx) = runs["cpu"], runs["cuda"]
    assert gok == cok == [True] * 6
    np.testing.assert_array_equal(gp, cp)
    assert greads == creads == [0] * 6
    assert gsyncs == [0] * 6, gsyncs
    assert glx == [5, 0, 6, 5 * 19] and clx == [0, 0, 0, 0]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def _icp_inputs(scale, frame):
    """ICP's inputs at every level of orbit_vga's frame `frame` tracked
    against frame `frame` - 1 at track_res_scale `scale`, made on the CPU:
    [(T0, src [N, 3], ref_pack [N, 8], ref_pose, intr, w, h)] coarse level
    first."""
    from disinfect_slam_tpu_torch.systems import odometry

    ds = os.path.join(os.path.dirname(__file__), "..", "datasets", "orbit_vga")
    depth = [torch.from_numpy(read_image(os.path.join(ds, f"{i}_depth.png"), unchanged=True)
                              .astype(np.float32)[::scale, ::scale] / 5000.0)
             for i in (frame - 1, frame)]
    k = tuple(v / scale for v in (525.1, 525.3, 319.6, 239.7))
    icp = odometry.ICPOdometry(k, 480 // scale, 640 // scale, device="cpu")
    pyr_ref, pyr_cur = icp._prep(depth[0]), icp._prep(depth[1])
    ref_pose = torch.eye(4)
    T0 = torch.eye(4)
    T0[:3, 3] = torch.tensor([0.004, -0.002, 0.003])
    out = []
    for lv in reversed(range(3)):
        v, n, valid = pyr_ref[lv]
        h, w = v.shape[:2]
        pack = torch.cat([v.reshape(-1, 3), n.reshape(-1, 3), valid.reshape(-1, 1).float(),
                          torch.zeros((h * w, 1))], 1)
        c = icp.cams[lv].intrinsics
        out.append((T0, pyr_cur[lv][0].reshape(-1, 3).contiguous(), pack, ref_pose,
                    (c.fx, c.fy, c.cx, c.cy), w, h))
    return out


@pytest.mark.parametrize("scale", [1, 2])
def test_icp_kernel_equals_its_plain_version_on_the_card_and_the_cpu(cuda, scale):
    """csrc/icp_step.cu on orbit_vga's pyramids at 640x480 and 320x240, all
    three levels, five iterations each: every iteration's T, rmse and
    inlier count bit-equal to icp_step_reference on the card and on the
    CPU, with more than 100 inliers at every level; one launch an
    iteration."""
    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel

    delta = torch.tensor(0.05)
    dist2 = float(np.float32(0.25 * 0.25))
    for T0, src, pack, ref_pose, intr, w, h in _icp_inputs(scale, 7):
        on = lambda t: t.to(cuda)  # noqa: E731
        t_gpu = t_ref_gpu = on(T0)
        t_cpu = T0
        for _ in range(5):
            before = icp_kernel.icp_step.launches
            kern = icp_kernel.icp_step(t_gpu, on(src), on(pack), on(ref_pose), on(delta), intr,
                                       w, h, dist2)
            assert icp_kernel.icp_step.launches == before + 1
            plain = icp_kernel.icp_step_reference(t_ref_gpu, on(src), on(pack), on(ref_pose),
                                                  on(delta), intr, w, h, dist2)
            host = icp_kernel.icp_step_reference(t_cpu, src, pack, ref_pose, delta, intr, w, h,
                                                 dist2)
            for a, b, c in zip(kern, plain, host):
                assert torch.equal(a.cpu(), b.cpu()) and torch.equal(a.cpu(), c), (w, a, b, c)
            assert float(kern[2]) > 100
            t_gpu, t_ref_gpu, t_cpu = kern[0], plain[0], host[0]


def _icp_ragged_case(n_or_hw, kind, seed=5):
    """ICP's inputs on a synthetic surface at w x h pixels (n alone: h
    its largest divisor up to its square root, w = n / h): the reference a bumpy tilted surface with 10% of its pixels
    invalid and random unit normals, the source its vertices with 3 mm of
    noise (5% at z = 0), the seed 4 mm off (in x and z only on one row, so
    that the row's pixels stay on it).  kind "invalid": every reference
    pixel invalid; "nan": 2% of the source points NaN.  Made on the CPU
    with numpy: (T0, src, ref_pack, ref_pose, intr, w, h)."""
    if isinstance(n_or_hw, int):
        h = max(d for d in range(1, int(n_or_hw ** 0.5) + 1) if n_or_hw % d == 0)
        n_or_hw = (h, n_or_hw // h)
    h, w = n_or_hw
    rng = np.random.default_rng(seed + w * 7 + h)
    f = np.float32(0.9 * max(w, h, 2))
    intr = (float(f), float(f), float(np.float32((w - 1) / 2)), float(np.float32((h - 1) / 2)))
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z = (1.5 + 0.2 * np.sin(3 * u / w) + 0.1 * v / h).astype(np.float32)
    verts = np.stack([(u - intr[2]) / f * z, (v - intr[3]) / f * z, z], -1).astype(np.float32)
    nrm = np.concatenate([rng.normal(0, 0.2, (h, w, 2)), -np.ones((h, w, 1))], -1)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    valid = rng.random((h, w)) > 0.1
    if kind == "invalid":
        valid[:] = False
    src = verts + rng.normal(0, 0.003, verts.shape).astype(np.float32)
    if h == 1:
        src[..., 1] = 0.0
    src[rng.random((h, w)) < 0.05] = 0.0
    if kind == "nan":
        src[rng.random((h, w)) < 0.02, 0] = np.nan
    pack = np.concatenate([verts, nrm, valid[..., None].astype(np.float32),
                           np.zeros((h, w, 1), np.float32)], -1).reshape(-1, 8)
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = (0.004, 0.0 if h == 1 else -0.002, 0.003)
    return (torch.from_numpy(T0), torch.from_numpy(src.reshape(-1, 3).copy()),
            torch.from_numpy(pack), torch.eye(4), intr, w, h)


def _bits_equal(a, b) -> bool:
    """Bit for bit, except that any NaN equals any NaN (the card's NaN is
    the canonical one, the CPU's keeps its operand's sign)."""
    a, b = a.cpu().reshape(-1), b.cpu().reshape(-1)
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _icp_ragged_sizes():
    """The sizes where the kernel's bookkeeping changes: fewer pixels than
    accumulators, one over a multiple of 8, one stage's rows (8 x
    STAGE_ROWS pixels) and the ring's (x STAGES) either side, the coarsest
    level at track_res_scale 2 and the soak's 96x72."""
    from disinfect_slam_tpu_torch.ops.cuda.icp_kernel import ACC, STAGE_ROWS, STAGES

    stage, ring = ACC * STAGE_ROWS, ACC * STAGE_ROWS * STAGES
    return [1, 7, 9, stage - 1, stage + 1, ring - 1, ring + 1, (60, 80), (72, 96)]


@pytest.mark.parametrize("kind", ["real", "invalid", "nan"])
@pytest.mark.parametrize("size", _icp_ragged_sizes(), ids=str)
def test_icp_kernel_at_ragged_sizes_equals_its_plain_version(cuda, size, kind):
    """csrc/icp_step.cu at ragged sizes, three iterations: T, rmse and
    inliers bit-equal to icp_step_reference on the card and on the CPU (a
    NaN equal to a NaN), one launch a call; with every reference pixel
    invalid (0 inliers, sums of signed zeros) and with NaN source points;
    inliers at every real case of two rows or more."""
    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel

    T0, src, pack, ref_pose, intr, w, h = _icp_ragged_case(size, kind)
    delta = torch.tensor(0.05)
    dist2 = float(np.float32(0.25 * 0.25))
    on = lambda t: t.to(cuda)  # noqa: E731
    t_gpu, t_cpu = on(T0), T0
    for it in range(3):
        before = icp_kernel.icp_step.launches
        kern = icp_kernel.icp_step(t_gpu, on(src), on(pack), on(ref_pose), on(delta), intr, w,
                                   h, dist2)
        assert icp_kernel.icp_step.launches == before + 1
        plain = icp_kernel.icp_step_reference(t_gpu, on(src), on(pack), on(ref_pose), on(delta),
                                              intr, w, h, dist2)
        host = icp_kernel.icp_step_reference(t_cpu, src, pack, ref_pose, delta, intr, w, h,
                                             dist2)
        for a, b, c in zip(kern, plain, host):
            assert _bits_equal(a, b) and _bits_equal(a, c), (size, kind, it, a, b, c)
        if kind == "invalid":
            assert float(kern[2]) == 0.0
        elif kind == "real" and it == 0 and h > 1:
            assert float(kern[2]) > 0
        t_gpu, t_cpu = kern[0], host[0]


def test_icp_kernel_replays_in_a_captured_graph(cuda):
    """icp_step captured in a CUDA graph at 80x60 and replayed twice with
    other inputs copied into the captured tensors (another seed pose, then
    other source points): each replay's T, rmse and inliers bit-equal to
    an eager call on the same inputs."""
    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel

    T0, src, pack, ref_pose, intr, w, h = (
        t.to(cuda) if isinstance(t, torch.Tensor) else t for t in _icp_ragged_case((60, 80),
                                                                                   "real"))
    delta = torch.tensor(0.05, device=cuda)
    dist2 = float(np.float32(0.25 * 0.25))
    args = lambda: (T0, src, pack, ref_pose, delta, intr, w, h, dist2)  # noqa: E731
    icp_kernel.icp_step(*args())  # the first call of a step runs eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = icp_kernel.icp_step(*args())
    moved = T0.clone()
    moved[:3, 3] += torch.tensor([0.003, 0.001, -0.002], device=cuda)
    noisy = src + torch.from_numpy(np.random.default_rng(9).normal(
        0, 0.001, tuple(src.shape)).astype(np.float32)).to(cuda)
    for new_T, new_src in ((moved, src.clone()), (moved, noisy)):
        T0.copy_(new_T)
        src.copy_(new_src)
        graph.replay()
        eager = icp_kernel.icp_step(*args())
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)
        assert float(eager[2]) > 100


@pytest.mark.parametrize("scale", [1, 2])
def test_icp_track_on_the_card_equals_the_cpu(cuda, scale):
    """ICPOdometry.track (captured) on the card against _track on the CPU
    on the same pyramids and seed: the pose, rmse and inliers bit for bit;
    then the captured step again (a replay), the same bits."""
    from disinfect_slam_tpu_torch.systems import odometry

    ds = os.path.join(os.path.dirname(__file__), "..", "datasets", "orbit_vga")
    k = tuple(v / scale for v in (525.1, 525.3, 319.6, 239.7))
    depth = [read_image(os.path.join(ds, f"{i}_depth.png"), unchanged=True)
             .astype(np.float32)[::scale, ::scale] / 5000.0 for i in (11, 12)]
    cpu = odometry.ICPOdometry(k, 480 // scale, 640 // scale, device="cpu")
    gpu = odometry.ICPOdometry(k, 480 // scale, 640 // scale, device=cuda)
    seed = np.eye(4, dtype=np.float32)
    seed[:3, 3] = [0.01, 0.0, -0.005]
    ref_pose = np.eye(4, dtype=np.float32)
    pc = [cpu.prep(d) for d in depth]
    want = cpu._track(torch.from_numpy(seed), pc[1], pc[0], torch.from_numpy(ref_pose))
    pg = [gpu.prep(d) for d in depth]
    for lc, lg in zip(pc[0] + pc[1], pg[0] + pg[1]):
        for a, b in zip(lc, lg):
            assert torch.equal(a, b.cpu())
    for _ in range(2):
        got = gpu.track(torch.from_numpy(seed).to(cuda), pg[1], pg[0],
                        torch.from_numpy(ref_pose).to(cuda))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    assert float(want[2]) > 100


def test_pose_graph_and_match_on_the_card_equal_the_cpu(cuda):
    """optimize_pose_graph on a drifted chain with a loop edge, and the
    descriptor and match_scores / _match_scores of the out-and-back
    keyframes, on the card against the CPU: bit for bit."""
    from disinfect_slam_tpu_torch.systems import loop_closure as lcm

    from .torch_cases import out_and_back_keyframes

    n = 8
    est = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
    rng = np.random.default_rng(5)
    for k in range(n):
        est[k, :3, 3] = [0.1 * k, 0.002 * k * k, 0.004 * k]
        est[k, :3, :3] = lcm._exp_se3_mat(torch.from_numpy(
            rng.normal(0, 0.02, 6).astype(np.float32))).numpy()[:3, :3]
    ei = np.asarray(list(range(n - 1)) + [0] + [0] * 8, np.int32)
    ej = np.asarray(list(range(1, n)) + [n - 1] + [0] * 8, np.int32)
    z = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    for k in range(n - 1):
        z[k] = np.linalg.inv(est[k]) @ est[k + 1]
    z[n - 1, :3, 3] = [0.7, 0.0, 0.0]
    w = np.asarray([1.0] * (n - 1) + [4.0] + [0.0] * 8, np.float32)
    args = [torch.from_numpy(a) for a in (est, ei, ej, z, w)]
    want = lcm.optimize_pose_graph(*args)
    got = lcm.optimize_pose_graph(*[a.to(cuda) for a in args])
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert float(want[1][-1]) < float(want[1][0])
    # the captured step (PoseGraphStep: its capture, then replays) and its
    # eager twin give the same bits
    for step in (lcm.PoseGraphStep(cuda), lcm.PoseGraphStep(cuda, capture=False)):
        for _ in range(3):
            for a, b in zip(step(est, ei, ej, z, w), want):
                assert torch.equal(a.cpu(), b)

    _, _, depths = out_and_back_keyframes()
    descs = {}
    for dev in ("cpu", cuda):
        descs[str(dev)] = torch.stack([lcm.depth_descriptor(
            torch.from_numpy(d[::2, ::2].copy()).to(dev),
            torch.from_numpy(d[::2, ::2].copy() * 0.3).to(dev)) for d in depths])
    assert torch.equal(descs[str(cuda)].cpu(), descs["cpu"])
    db, ids = descs["cpu"], torch.arange(len(depths), dtype=torch.int32) * 10
    for q in range(len(depths)):
        want = lcm._match_scores(db[q], db, ids, len(depths), 10 * q, 20)
        got = lcm._match_scores(db[q].to(cuda), db.to(cuda), ids.to(cuda), len(depths),
                                10 * q, 20)
        assert [t.item() for t in got] == [t.item() for t in want]
        assert torch.equal(lcm.match_scores(db.to(cuda), db[q].to(cuda)).cpu(),
                           lcm.match_scores(db, db[q]))


def _ints(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _pose_graph_shapes(m: int, n_pad: int, sms: int) -> list:
    """(ctas, shared) of every launch shape the pose graph's wrapper takes
    at m rows, the columns in shared memory and in device memory; above 64
    nodes only the device-memory layout's two widest (over a few CTAs it
    takes seconds a call)."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk

    out = [(c, True) for c in pk.shapes(m, sms, True)]
    wide = pk.shapes(m, sms, False)
    return out + [(c, False) for c in (wide if n_pad <= 64 else wide[-2:])]


@pytest.mark.parametrize("n_pad, e", [(8, 13), (32, 50), (64, 100), (128, 200), (256, 400),
                                      (512, 800), (1024, 1600)])
def test_pose_graph_kernel_equals_its_plain_version(cuda, n_pad, e):
    """pose_graph_solve on random graphs (a quarter of the edges padded, e
    not a power of two) at the launch shape grid_shape picks and at the
    other shapes the wrapper takes (the ctas and shared overrides; 512
    and 1024 nodes fit only in device memory, where a thread holds up to
    8 and up to 32 of a panel's rows): dx bit-equal to its plain version
    on the card, and up to 64 nodes to the CPU's."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
    from disinfect_slam_tpu_torch.utils.kernel_verify import pose_graph_inputs

    host = pose_graph_inputs(n_pad, e, seed=n_pad, device="cpu")
    args = [t.to(cuda) for t in host]
    want = pk.pose_graph_solve_reference(*args).cpu()
    if n_pad <= 64:
        assert torch.equal(want, pk.pose_graph_solve_reference(*host))
    before = pk.pose_graph_solve.launches
    assert torch.equal(pk.pose_graph_solve(*args).cpu(), want)
    assert pk.pose_graph_solve.launches == before + 1
    m = 6 * n_pad
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pk.grid_shape(m, sms)[1] == (n_pad <= 256)
    for ctas, shared in _pose_graph_shapes(m, n_pad, sms):
        got = pk.pose_graph_solve(*args, ctas=ctas, shared=shared)
        assert torch.equal(got.cpu(), want), (ctas, shared)
    assert torch.isfinite(want).all()


@pytest.mark.parametrize("n_pad, e_pad", [(8, 16), (32, 64), (128, 256), (256, 512),
                                          (512, 1024)])
def test_pose_graph_fused_equals_its_plain_version(cuda, n_pad, e_pad):
    """pose_graph_fused (the residuals and Jacobians in the kernel) on
    pose_graph_case's drifting graphs at the launch shapes of
    _pose_graph_shapes: dx and the
    residuals bit-equal to its plain version on the card, and up to 32
    nodes to the CPU's (whose Jacobians are torch's forward mode's bits);
    one launch counted on pose_graph_solve."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
    from disinfect_slam_tpu_torch.systems import loop_closure as lcm

    from .torch_cases import pose_graph_case

    poses, ei, ej, z, w = (torch.from_numpy(a) for a in pose_graph_case(n_pad, e_pad, seed=n_pad))
    host = [poses, ei.int(), ej.int(), lcm._inv_rigid(z).contiguous(), w,
            lcm._gauge_diag(n_pad, 1e-4, "cpu")]
    args = [t.to(cuda) for t in host]
    want = pk.pose_graph_fused_reference(*args)
    if n_pad <= 32:
        cpu = pk.pose_graph_fused_reference(*host)
        assert all(torch.equal(_ints(a), _ints(b)) for a, b in zip(want, cpu))
    before = pk.pose_graph_solve.launches
    got = pk.pose_graph_fused(*args)
    assert pk.pose_graph_solve.launches == before + 1
    assert all(torch.equal(_ints(a), _ints(b)) for a, b in zip(got, want))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for ctas, shared in _pose_graph_shapes(6 * n_pad, n_pad, sms):
        got = pk.pose_graph_fused(*args, ctas=ctas, shared=shared)
        assert all(torch.equal(_ints(a), _ints(b)) for a, b in zip(got, want)), (ctas, shared)
    assert torch.isfinite(want[0]).all()


@pytest.mark.parametrize("n_pad", [8, 32])
@pytest.mark.parametrize("nan", [False, True], ids=["ties", "nan"])
def test_pose_graph_kernel_on_ties_and_nan(cuda, n_pad, nan):
    """Integer Jacobians, so that equal |a| tie in the pivot columns, and a
    NaN in one edge's Jacobian (NaN columns): pose_graph_solve at every
    launch shape against its plain version on the card, as integer views
    (the NaNs' bits too), and the ties against the CPU's."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk

    from .torch_cases import pose_graph_ties

    host = pose_graph_ties(n_pad, 2 * n_pad, seed=3 + nan, nan=nan)
    args = [t.to(cuda) for t in host]
    want = pk.pose_graph_solve_reference(*args)
    if not nan:
        assert torch.equal(_ints(want), _ints(pk.pose_graph_solve_reference(*host)))
        assert torch.isfinite(want).all()
    else:
        assert torch.isnan(want).any()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for ctas, shared in _pose_graph_shapes(6 * n_pad, n_pad, sms):
        got = pk.pose_graph_solve(*args, ctas=ctas, shared=shared)
        assert torch.equal(_ints(got), _ints(want)), (ctas, shared)


def test_the_manager_takes_every_cap_the_kernel_takes(cuda):
    """LoopClosureManager on the card takes every max_keyframes whose
    padded graph's [H | g] and LU scratch fit in the card's memory (4096
    and 8192 keyframes, past the register layouts' 2730 nodes: the pass
    layout), and refuses a cap whose scratch cannot fit when it is built,
    not at a closure."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
    from disinfect_slam_tpu_torch.systems import loop_closure as lcm

    from .torch_cases import LC_ARGS, LC_H, LC_K, LC_W

    args = {k: v for k, v in LC_ARGS.items() if k != "max_keyframes"}
    total = torch.cuda.get_device_properties(cuda).total_memory
    for cap in (2048, 4096, 8192):
        if pk.scratch_bytes(6 * cap) <= total:
            lcm.LoopClosureManager(LC_K, LC_H, LC_W, device=cuda, max_keyframes=cap, **args)
    if total >= 80e9:
        assert pk.scratch_bytes(6 * 8192) <= total
    top = 1 << 20
    while pk.scratch_bytes(6 * top) > total:
        top >>= 1
    with pytest.raises(ValueError, match="max_keyframes"):
        lcm.LoopClosureManager(LC_K, LC_H, LC_W, device=cuda, max_keyframes=top + 1, **args)


@pytest.mark.parametrize("n_pad, e, forced", [(8, 13, True), (512, 800, True),
                                              (2736, 5472, False)])
def test_pose_graph_pass_layout_equals_its_plain_version(cuda, n_pad, e, forced):
    """The pass layout (the threads stride over a panel's rows, their state
    in device memory): forced at 48 and at 3072 rows, and taken by itself
    at m = 16416 (2736 nodes, past the register layouts' 16384 rows): dx
    bit-equal to the plain version (core/exact.solve_lu) on the card, and
    at 48 rows to the CPU's; at every CTA count the layout takes up to 3072
    rows."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
    from disinfect_slam_tpu_torch.utils.kernel_verify import pose_graph_inputs

    host = pose_graph_inputs(n_pad, e, seed=n_pad + 1, device="cpu")
    args = [t.to(cuda) for t in host]
    want = pk.pose_graph_solve_reference(*args).cpu()
    if n_pad <= 8:
        assert torch.equal(want, pk.pose_graph_solve_reference(*host))
    m = 6 * n_pad
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if not forced:
        assert pk.launch_layout(m, sms) == (False, True)
        before = pk.pose_graph_solve.launches
        assert torch.equal(pk.pose_graph_solve(*args).cpu(), want)
        assert pk.pose_graph_solve.launches == before + 1
    else:
        fit = pk.shapes(m, sms, False, passes=True)
        for ctas in (fit if m <= 48 else fit[-2:]):
            got = pk.pose_graph_solve(*args, ctas=ctas, passes=True)
            assert torch.equal(got.cpu(), want), ctas
    assert torch.isfinite(want).all()


@pytest.mark.parametrize("n_pad, e_pad", [(8, 16), (512, 1024)])
def test_pose_graph_fused_in_the_pass_layout(cuda, n_pad, e_pad):
    """pose_graph_fused forced into the pass layout: dx and the residuals
    bit-equal to its plain version on the card."""
    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
    from disinfect_slam_tpu_torch.systems import loop_closure as lcm

    from .torch_cases import pose_graph_case

    poses, ei, ej, z, w = (torch.from_numpy(a) for a in pose_graph_case(n_pad, e_pad, seed=n_pad))
    host = [poses, ei.int(), ej.int(), lcm._inv_rigid(z).contiguous(), w,
            lcm._gauge_diag(n_pad, 1e-4, "cpu")]
    args = [t.to(cuda) for t in host]
    want = pk.pose_graph_fused_reference(*args)
    got = pk.pose_graph_fused(*args, passes=True)
    assert all(torch.equal(_ints(a), _ints(b)) for a, b in zip(got, want))


def test_a_closure_is_one_graph_launch_and_never_syncs(cuda):
    """Once captured, the pose graph of a closure (the soak's size: 28 of
    32 nodes, 64 edges) is one graph launch holding 12 pose_graph_solve
    launches, makes no kernel launch of its own and no sync under
    set_sync_debug_mode("error"); the read of its result is the one sync.
    The same for the keyframe's query (no kernel of its own to count)."""
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
    from disinfect_slam_tpu_torch.systems import loop_closure as lcm
    from disinfect_slam_tpu_torch.utils import graphs

    from .torch_cases import LC_ARGS, LC_H, LC_K, LC_W, out_and_back_keyframes, pose_graph_case

    g = pose_graph_case(32, 64, seed=3)
    step = lcm.PoseGraphStep(cuda)
    want = [t.cpu() for t in step(*g)]
    _, _, depths = out_and_back_keyframes()
    lc = lcm.LoopClosureManager(LC_K, LC_H, LC_W, device=cuda, **LC_ARGS)
    inten = depths[0] * 0.3
    lc.query(depths[0], inten)
    torch.cuda.synchronize()
    launches, replays = pk.pose_graph_solve.launches, graphs.REPLAYS["graph"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = step(*g)
            q = lc.query(depths[0], inten)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    names = [e.name for e in prof.events()]
    assert sum(n in ("cudaGraphLaunch", "cuGraphLaunch") for n in names) == 2
    assert not any(n in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernelEx") for n in names)
    assert pk.pose_graph_solve.launches - launches == 12
    assert graphs.REPLAYS["graph"] - replays == 2
    assert all(torch.equal(a.cpu(), b) for a, b in zip(out, want))
    assert q.scores.shape == (LC_ARGS["max_keyframes"],)


def test_captured_query_equals_the_eager_query_and_the_cpu(cuda):
    """LoopClosureManager.query on the card, captured (its capture and
    replays) and eager, against the CPU's: the half-res depth, the
    descriptor and the scores bit for bit, with and without intensity, over
    a database of the out-and-back keyframes."""
    from disinfect_slam_tpu_torch.systems.loop_closure import LoopClosureManager

    from .torch_cases import LC_ARGS, LC_H, LC_K, LC_W, out_and_back_keyframes

    _, est, depths = out_and_back_keyframes()
    mgrs = [LoopClosureManager(LC_K, LC_H, LC_W, device=dev, capture=cap, **LC_ARGS)
            for dev, cap in ((cuda, True), (cuda, False), ("cpu", True))]
    for k in range(4):
        for lc in mgrs:
            lc.add_keyframe(depths[k], est[k], frame_id=10 * k)
    for k in range(4, 8):
        for inten in (None, depths[k] * 0.3):
            for _ in range(2):
                got = [tuple(t.cpu() for t in lc.query(depths[k], inten)) for lc in mgrs]
                for a, b in ((got[0], got[2]), (got[1], got[2])):
                    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_jax_database_closes_the_same_loops_on_the_card(cuda):
    """A keyframe database saved by the JAX manager
    (disinfect_slam_tpu_torch/data/lc_jax_database.npz: the first six
    out-and-back keyframes) loaded into the port on the card and on the
    CPU: the return leg's six keyframes each close a loop, and every
    optimized keyframe pose, descriptor and edge is the CPU's bit for bit."""
    from disinfect_slam_tpu_torch.systems.loop_closure import LoopClosureManager

    from .torch_cases import LC_ARGS, LC_H, LC_K, LC_W, out_and_back_keyframes

    path = os.path.join(os.path.dirname(__file__), "..", "disinfect_slam_tpu_torch", "data",
                        "lc_jax_database.npz")
    _, est, depths = out_and_back_keyframes()
    runs = []
    for dev in (cuda, "cpu"):
        lc = LoopClosureManager(LC_K, LC_H, LC_W, device=dev, **LC_ARGS)
        lc.load(path)
        corr = [lc.add_keyframe(depths[k], est[k], frame_id=10 * k) for k in range(6, 12)]
        runs.append((lc, corr))
    (card, card_corr), (cpu, cpu_corr) = runs
    assert card.closures == cpu.closures == 6 and all(c is not None for c in card_corr)
    np.testing.assert_array_equal(np.stack(card.kf_pose_opt), np.stack(cpu.kf_pose_opt))
    np.testing.assert_array_equal(np.stack(card_corr), np.stack(cpu_corr))
    assert torch.equal(card.db_desc.cpu(), cpu.db_desc)
    assert [(i, j, w) for i, j, _, w in card.edges] == [(i, j, w) for i, j, _, w in cpu.edges]


@pytest.mark.parametrize("scale", [1, 2])
def test_dense_slam_parts_nowhere_between_the_card_and_the_cpu(cuda, scale):
    """utils/parting.lockstep over the 20-frame out-and-back orbit with loop
    closure every 5th frame, eager on the card and on the CPU: no stage of
    any frame (the pyramids, each ICP iteration, the gate, the model depth,
    the volume, the descriptors, the match scores, the keyframe poses)
    differs by a bit, and neither does any tracker stage the card
    recomputes from the CPU's inputs."""
    from disinfect_slam_tpu_torch.utils import parting

    frames = _slam_frames(20)
    slams = [_new_slam(dev, False, scale, loop_closure=True, kf_every=5)
             for dev in (cuda, torch.device("cpu"))]
    res = parting.lockstep(slams, lambda i, slam: slam.process_frame(*frames[i]), len(frames))
    assert res["parted"] is None and not res["isolated"], parting.describe(res)
    assert res["frames_run"] == 20


def test_loop_closure_on_the_card_closes_the_drifted_chain(cuda):
    """LoopClosureManager on the card over tests/test_loop_closure.py's
    out-and-back keyframes: a loop closes (first at keyframe 5 or later),
    each verification reads once, and the optimised keyframes fall below
    60% of the drifted estimates' error (the CPU test's limits)."""
    from disinfect_slam_tpu_torch.systems.loop_closure import LoopClosureManager

    from .torch_cases import LC_ARGS, LC_H, LC_K, LC_W, out_and_back_keyframes

    true_poses, est_poses, depths = out_and_back_keyframes()
    lc = LoopClosureManager(LC_K, LC_H, LC_W, device=cuda, **LC_ARGS)
    firsts = [k for k, (d, e) in enumerate(zip(depths, est_poses))
              if lc.add_keyframe(d, e, frame_id=10 * k) is not None]
    assert lc.closures >= 1 and firsts[0] >= 5 and lc.db_desc.device.type == "cuda"
    err = lambda poses: np.mean([np.linalg.norm(p[:3, 3] - g[:3, 3])  # noqa: E731
                                 for p, g in zip(poses, true_poses)])
    assert err(lc.kf_pose_opt) < 0.6 * err(est_poses)


# ----------------------------------------------------------------------
# the served-map slice: the service's render, the host store, the cull
# ----------------------------------------------------------------------
def test_service_render_on_the_card_equals_ray_cast(cuda):
    """ReconstructionService.render of a CUDA volume launches each splat
    kernel once and gives ray_cast(renderer="auto")'s bits, numpy out."""
    from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem
    from disinfect_slam_tpu_torch.systems.server import ReconstructionService

    k, w, h = (52.7, 53.3, 31.71, 23.43), 64, 48
    cfg = TSDFConfig(num_blocks_log2=10, max_candidates=2048, max_visible=1024,
                     max_new_per_round=512, grid_log2=6)
    pose = look_at((0.05, 0.02, -1.5), (0.013, -0.021, 1.007)).astype(np.float32)
    depth = render_sphere(w, h, k, pose, (0.013, -0.021, 1.007), 0.613)
    with DISINFSystem(k, depth_factor=1.0, voxel_size=0.05, truncation=0.15, cfg=cfg,
                      half_scale=False, device=cuda) as system:
        svc = ReconstructionService(system)
        svc.process_frame(checker_rgb(w, h), depth, 0, pose=pose)
        before = (splat_kernel.splat_zbuf_blocks.launches,
                  splat_kernel.splat_payload_blocks.launches)
        rgba, normal, dep = svc.render(52.7, h, w, pose=pose)
        assert (splat_kernel.splat_zbuf_blocks.launches,
                splat_kernel.splat_payload_blocks.launches) == (before[0] + 1, before[1] + 1)
        ref = system.tsdf.tsdf.ray_cast(10.0, ((52.7, 52.7, (w - 1) / 2, (h - 1) / 2), h, w),
                                        pose, renderer="auto")
    for ours, want in ((rgba, ref.rgba), (normal, ref.normal), (dep, ref.depth)):
        np.testing.assert_array_equal(ours, want.cpu().numpy())
    assert (dep > 0).mean() > 0.1


def _wall_grid(device, host_spill=True, cull=False):
    cfg = TSDFConfig(num_blocks_log2=12, max_candidates=8192, max_visible=2048,
                     max_new_per_round=1024, grid_log2=5, cull_occluded=cull)
    return TSDFGrid(0.05, 0.2, cfg=cfg, device=device, host_spill=host_spill)


def _block_rows(grid):
    """Each live block's (key, tsdf, rgbw, prob) rows in key order."""
    a = volume_to_numpy(grid.volume)
    live = a["entry_block"] >= 0
    order = np.argsort(a["entry_key"][live])
    rows = a["entry_block"][live][order]
    return [a["entry_key"][live][order]] + [a[f][rows] for f in ("tsdf", "rgbw", "prob")]


def test_spill_roundtrip_on_the_card(cuda):
    """Recenter away (every block of the wall band spills) and back on the
    card: each block's rows come back bit for bit, the store empties, and
    the card's store and volume equal the CPU run's at each step (prob
    within 1e-6, as the fusion leaves it: CUDA expf/logf against the
    CPU's)."""
    k, w, h = (60.0, 60.0, 39.5, 29.5), 80, 60
    pose = look_at((0.0, 0.0, 0.0), (0.0, 0.0, 2.0)).astype(np.float32)
    depth = render_wall(w, h, k, pose, wall_z=1.5)
    grids = [_wall_grid(d) for d in ("cpu", cuda)]
    for g in grids:
        for _ in range(2):
            g.integrate(checker_rgb(w, h), depth, None, None, 4.0, k, pose)
    before = _block_rows(grids[1])
    assert before[0].size > 8
    for center in ((0.0, 0.0, 8.0), (0.0, 0.0, 0.0)):
        for g in grids:
            assert g.recenter(center)
        stores = [g.spill_store._store for g in grids]
        assert list(stores[0]) == list(stores[1])
        for key in stores[0]:
            (t0, c0, p0), (t1, c1, p1) = stores[0][key], stores[1][key]
            np.testing.assert_array_equal(t0, t1)
            np.testing.assert_array_equal(c0, c1)
            np.testing.assert_allclose(p0, p1, rtol=0, atol=1e-6)
        a, b = (volume_to_numpy(g.volume) for g in grids)
        for f in a:
            if f != "prob":
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        np.testing.assert_allclose(a["prob"], b["prob"], rtol=0, atol=1e-6)
    assert len(grids[1].spill_store) == 0
    for x, y in zip(_block_rows(grids[1]), before):
        np.testing.assert_array_equal(x, y)


def test_cull_on_the_card_leaves_the_volume_bit_equal(cuda):
    """A sphere in front of a wall from two viewpoints, twice: with the
    occlusion cull the card's volume equals its volume without it and the
    CPU's with it; the culled visible set is smaller."""
    from disinfect_slam_tpu_torch.ops import integrate as tint

    k, w, h = (52.7, 53.3, 31.71, 23.43), 64, 48
    frames = []
    for eye in [(-0.6, 0.0, -1.3), (0.6, 0.05, -1.3)] * 2:
        pose = look_at(eye, (0.013, -0.021, 1.2)).astype(np.float32)
        sphere = render_sphere(w, h, k, pose, (0.013, -0.021, 0.8), 0.55)
        wall = render_wall(w, h, k, pose, wall_z=2.4131)
        frames.append((pose, np.where(sphere > 0, sphere, wall).astype(np.float32)))
    grids = [_wall_grid(cuda, False, True), _wall_grid(cuda, False, False),
             _wall_grid("cpu", False, True)]
    for pose, depth in frames:
        for g in grids:
            g.integrate(checker_rgb(w, h), depth, None, None, 4.0, k, pose)
    on, off, cpu = (volume_to_numpy(g.volume) for g in grids)
    assert (on["entry_block"] >= 0).sum() > 20
    for f in on:
        np.testing.assert_array_equal(on[f], off[f], err_msg=f)
        if f != "prob":
            np.testing.assert_array_equal(on[f], cpu[f], err_msg=f)
    np.testing.assert_allclose(on["prob"], cpu["prob"], rtol=0, atol=1e-6)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    pose, depth = frames[-1]
    se3, d = SE3.from_matrix(pose), torch.from_numpy(depth).to(cuda)
    vol = grids[0].volume
    culled = tint.gather_visible(vol, cam, se3, d, tint.depth_to_range(cam, cuda))
    assert int(culled.count) < int(tint.gather_visible(vol, cam, se3).count)


def _train_case(device, dtype, seed=7):
    """A narrow UNetSeg's first train step at 48x64, batch 2, from the
    same parameters on `device`: (loss, gradients, parameters after)."""
    from disinfect_slam_tpu_torch.models import synth_data, train

    net = seg.create_model((8, 16, 16, 16), dtype=dtype,
                           generator=torch.Generator().manual_seed(seed))
    state = train.create_train_state(net, lr=1e-3, device=device)
    imgs, labs = (torch.from_numpy(a).to(device) for a in
                  synth_data.make_batch(np.random.default_rng(seed), 2, 48, 64))
    step = train.make_train_step(state.model, state.opt)
    state, loss = step(state, imgs, labs)
    grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    return float(loss), grads, params


def test_train_step_on_the_card_runs_without_tf32(cuda):
    """A float32 train step on the card equals the CPU's: loss within 1e-5
    and every gradient within 1e-4 relative by norm (TF32's 10-bit
    mantissas in the convs would move them by about 1e-3); the global
    flags come back as they were."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    loss_c, grads_c, _ = _train_case("cpu", torch.float32)
    loss_g, grads_g, params_g = _train_case(cuda, torch.float32)
    assert abs(loss_g - loss_c) <= 1e-5
    for n, g in grads_c.items():
        assert ((grads_g[n] - g).norm() / g.norm().clamp(min=1e-30)).item() <= 1e-4, n
    assert all(torch.isfinite(p).all() for p in params_g.values())
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags


def test_bfloat16_train_step_on_the_card_matches_the_cpu(cuda):
    """The working dtype's step: loss within 5e-4 and the gradients
    together within 0.1 relative by norm, the CPU tests' bfloat16 limits
    against JAX (tests/test_torch_train.py)."""
    loss_c, grads_c, _ = _train_case("cpu", torch.bfloat16)
    loss_g, grads_g, _ = _train_case(cuda, torch.bfloat16)
    assert abs(loss_g - loss_c) <= 5e-4
    a = torch.cat([grads_g[n].flatten() for n in grads_c])
    b = torch.cat([grads_c[n].flatten() for n in grads_c])
    assert ((a - b).norm() / b.norm()).item() <= 0.1


def test_four_coresident_shards_equal_one_shard_on_the_card(cuda):
    """DistributedTSDF over [cuda:0] * 4 and over [cuda:0] on a few frames
    of a sphere before a wall: the same records bit for bit, fuse_rows
    launched once per shard per frame, and the same hits and depths in the
    render through K4 and K5 (once per shard); equal to the same shards on
    the CPU."""
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput
    from disinfect_slam_tpu_torch.parallel.sharding import DistributedTSDF

    k, w, h = (52.7, 53.3, 31.71, 23.43), 64, 48
    cfg = TSDFConfig(voxel_size=0.05, truncation=0.15, num_blocks_log2=10,
                     max_candidates=2048, max_visible=1024, max_new_per_round=512,
                     grid_log2=6)
    dists = [DistributedTSDF(cfg, [cuda] * 4), DistributedTSDF(cfg, [cuda]),
             DistributedTSDF(cfg, ["cpu"] * 4)]
    fuse_kernel.fuse_rows.launches = 0
    n = 0
    for eye in [(-0.6, 0.0, -1.3), (0.6, 0.05, -1.3), (0.0, 0.1, -1.0)]:
        pose = look_at(eye, (0.013, -0.021, 1.2)).astype(np.float32)
        sphere = render_sphere(w, h, k, pose, (0.013, -0.021, 0.8), 0.55)
        depth = np.where(sphere > 0, sphere, render_wall(w, h, k, pose, wall_z=2.4131))
        frame = FrameInput(checker_rgb(w, h), depth.astype(np.float32),
                           np.full((h, w), 0.7, np.float32), np.full((h, w), 0.3, np.float32))
        for d in dists:
            d.integrate(frame, k, pose, 4.0)
        n += 1
    assert fuse_kernel.fuse_rows.launches == 5 * n

    def records(d):
        r = d.gather_all_tsdf()
        return r[np.lexsort(r[:, :3].T)]

    four, one, cpu = (records(d) for d in dists)
    assert four.shape[0] > 20 * 512
    np.testing.assert_array_equal(four, one)
    np.testing.assert_array_equal(four[:, :3], cpu[:, :3])
    np.testing.assert_allclose(four[:, 3], cpu[:, 3], rtol=0, atol=1e-6)

    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    splat_kernel.splat_zbuf_blocks.launches = splat_kernel.splat_payload_blocks.launches = 0
    r4 = dists[0].render(cam, pose, 4.0)
    assert (splat_kernel.splat_zbuf_blocks.launches,
            splat_kernel.splat_payload_blocks.launches) == (4, 4)
    r1 = dists[1].render(cam, pose, 4.0)
    assert r4.hit.sum().item() > 0
    torch.testing.assert_close(r4.hit, r1.hit, rtol=0, atol=0)
    torch.testing.assert_close(r4.depth, r1.depth, rtol=0, atol=0)
    # the JAX merge max-merges the shaded rgba of shards tied at a pixel's
    # depth channel by channel (equal on 99.86% of the hit pixels on the
    # CPU); normals shade from each shard's own depth image and differ
    # along shard borders
    same = (r4.rgba == r1.rgba).all(-1)[r4.hit].float().mean().item()
    assert same >= 0.99


# ----------------------------------------------------------------------
# the stereo slice: block matching and the remap on the card
# ----------------------------------------------------------------------
def _stereo_frame0():
    """Frame 0 of tests/torch_cases.py's stereo orbit at 640x480."""
    from .torch_cases import (
        ORBIT_VGA_K, STEREO_SEED, _noise_tables, orbit_vga_poses, stereo_pair,
    )

    root = os.path.join(os.path.dirname(__file__), "..", "datasets", "orbit_vga")
    left, right = stereo_pair(orbit_vga_poses(root)[0], 640, 480, ORBIT_VGA_K,
                              _noise_tables(STEREO_SEED))
    return left.astype(np.float32), right.astype(np.float32), ORBIT_VGA_K[0]


@pytest.mark.parametrize("method", ["flat", "pyramid"])
def test_stereo_on_the_card_equals_the_cpu(cuda, method):
    """640x480, 64 disparities, the 7x9 patch: disparity, depth and the
    valid mask on the card equal the CPU's bit for bit (every op is
    elementwise, a gather, a min or an argmin; the sums run in a fixed
    order and the fused multiply-adds in float64)."""
    from disinfect_slam_tpu_torch.ops.stereo import stereo_depth

    left, right, fx = _stereo_frame0()
    out = []
    for dev in (cuda, torch.device("cpu")):
        res = stereo_depth(torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev),
                           fx=fx, baseline_m=0.12, max_disp=64, max_depth=4.0, method=method)
        assert res.depth.device.type == dev.type
        out.append([t.cpu() for t in res])
    assert out[1][2].float().mean() > 0.8
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("channels", [1, 3])
def test_remap_on_the_card_equals_the_cpu(cuda, channels, tmp_path):
    """The factory calibration's rectifier (its maps on the card) against
    the same remap on the CPU, bit for bit, gray and RGB."""
    from disinfect_slam_tpu_torch.io.zed_calib import rectifier_from_factory_conf
    from disinfect_slam_tpu_torch.ops.image_ops import bilinear_remap

    from .torch_cases import ZED_FACTORY_CONF

    conf = tmp_path / "SN1.conf"
    conf.write_text(ZED_FACTORY_CONF)
    rect = rectifier_from_factory_conf(str(conf), "VGA")
    assert all(m.device.type == "cuda" for m in rect.maps_device)
    rng = np.random.default_rng(channels)
    shape = (376, 672) if channels == 1 else (376, 672, 3)
    left, right = (rng.uniform(0, 255, shape).astype(np.float32) for _ in range(2))
    l_card, r_card = rect.rectify(left, right)
    for img, out, maps in ((left, l_card, rect.maps[:2]), (right, r_card, rect.maps[2:4])):
        cpu = bilinear_remap(torch.from_numpy(img), *(torch.from_numpy(m) for m in maps))
        np.testing.assert_array_equal(out, cpu.numpy())


def test_stereo_estimator_runs_on_the_card_by_default(cuda):
    from disinfect_slam_tpu_torch.ops.stereo import StereoDepthEstimator

    left, right, fx = _stereo_frame0()
    est = StereoDepthEstimator(fx, 0.12, max_depth=4.0)
    assert est.device.type == "cuda"
    dev = est.depth_device(left.astype(np.uint8), right.astype(np.uint8))
    assert dev.device.type == "cuda" and dev.dtype == torch.float32
    host = est(left.astype(np.uint8), right.astype(np.uint8))
    np.testing.assert_array_equal(host, dev.cpu().numpy())
    assert (host > 0).mean() > 0.8


def test_kernel_self_check_passes_on_the_card(cuda):
    from disinfect_slam_tpu_torch.utils import kernel_verify

    assert kernel_verify.verify_all(verbose=False, device=cuda)
    for name, fn in kernel_verify.CHECKS:
        ok, _, _ = fn(device=cuda, perturb=True)
        assert not ok, name


@pytest.mark.parametrize("n", [1, 4])
def test_seg_parallel_on_the_card(cuda, n):
    """A narrow UNet over [cuda:0] * n: the 1x1 step bit-equal to
    make_train_step, the 2x2 loss within tests/test_torch_seg_parallel.py's
    limit; the sharded inference within its float32 limit."""
    from disinfect_slam_tpu_torch.models import train
    from disinfect_slam_tpu_torch.parallel import seg_parallel as sp
    from disinfect_slam_tpu_torch.utils.device import exact_fp32

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (8, 32, 48, 3)).astype(np.float32)).to(cuda)
    labs = (torch.from_numpy(rng.uniform(0, 1, (8, 32, 48, 2))) > 0.5).float().to(cuda)
    net = seg.create_model(widths=(8, 16, 32, 64), dtype=torch.float32).to(cuda)
    sd = copy.deepcopy(net.state_dict())
    ref = train.create_train_state(seg.create_model(widths=(8, 16, 32, 64),
                                                    dtype=torch.float32), lr=1e-3, device=cuda)
    ref.model.load_state_dict(sd)
    mesh = sp.make_mesh_2d(devices=[cuda] * n)
    state = sp.ShardedTrainState(sp.shard_params(net, mesh, tp_min_width=16))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, ref_loss = train.make_train_step(ref.model, ref.opt)(ref, imgs, labs)
        state, loss = sp.make_sharded_train_step(net, dict(lr=1e-3), mesh)(state, imgs, labs)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if n == 1:
        assert torch.equal(loss, ref_loss)
        full = state.params.full()
        for k, p in ref.model.named_parameters():
            assert torch.equal(p, full[k]), k
    else:
        assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    with torch.no_grad(), exact_fp32():  # TF32 off, as in the sharded inference
        want = torch.sigmoid(net(imgs.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    got = sp.make_sharded_infer(net, mesh)(imgs)
    assert float((got - want).abs().max()) <= 1e-4


def _port_bench_script(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_bench_dense_slam_on_the_card(cuda):
    """scripts/port_bench_dense_slam.py at its full size (40 orbit frames,
    640x480, 1 cm): every frame tracked."""
    res = _port_bench_script("port_bench_dense_slam").run(cuda)
    assert res["frames"] == 37 and res["lost"] == 0 and res["ms_per_frame"] > 0
    assert np.isfinite(res["final_pose_err_m"])


def test_port_bench_mesh_on_the_card(cuda, tmp_path):
    """scripts/port_bench_mesh.py at the bench configuration over 5
    frames: both transfers, the OBJ (written, then removed) and the 2 m
    query, which finds voxels."""
    res = _port_bench_script("port_bench_mesh").run(cuda, n_frames=5,
                                                    obj_path=str(tmp_path / "mesh.obj"))
    assert all(res[k] > 0 for k in ("f32", "q16", "obj", "query", "query_voxels"))
    assert not (tmp_path / "mesh.obj").exists()


def test_port_bench_stereo_on_the_card(cuda):
    """scripts/port_bench_stereo.py at VGA/64 and HD/128: the flat matcher
    and the four pyramids timed, eager and captured."""
    res = _port_bench_script("port_bench_stereo").run(cuda, iters=3)
    assert set(res) == {(480, 640, 64), (720, 1280, 128)}
    assert all(len(r) == 5 and min(t for v in r.values() for t in v.values()) > 0
               for r in res.values())


# ----------------------------------------------------------------------
# the captured steps (utils/graphs.py): CUDA graphs of integrate, the
# splat render and the online step, the pose in device memory
# ----------------------------------------------------------------------
def _sphere_frames(n, seed=4):
    k, w, h = (52.7, 53.3, 31.71, 23.43), 64, 48
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        ang = 0.13 * i - 0.12
        pose = look_at((np.sin(ang) * 2.5 + 0.013, 0.1 * i - 0.027,
                        -2.5 * np.cos(ang) + 1.0), (0.013, -0.021, 1.007)).astype(np.float32)
        depth = render_sphere(w, h, k, pose, (0.013, -0.021, 1.007), 0.613)
        ht, lt = rng.uniform(0.05, 0.95, (2, h, w)).astype(np.float32)
        frames.append((checker_rgb(w, h), depth, ht, lt, pose))
    return k, h, w, frames


def _graph_cfg(alloc_every, **kw):
    return TSDFConfig(**{**dict(num_blocks_log2=10, max_candidates=2048, max_visible=1024,
                                max_new_per_round=512, grid_log2=6), **kw},
                      alloc_every=alloc_every)


def _assert_volumes_equal(a, b):
    a, b = volume_to_numpy(a), volume_to_numpy(b)
    assert (a["entry_block"] >= 0).sum() > 10
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("alloc_every", [1, 3])
def test_captured_grid_equals_the_eager_grid(cuda, alloc_every, cull):
    """TSDFGrid's captured integrate and splat render (CUDA graphs after
    each key's first call) against the same grid run eagerly, over eight
    frames on both cadences, with and without the occlusion cull: every
    volume array and every image bit-equal; the graphs were replayed."""
    k, h, w, frames = _sphere_frames(8)
    cfg = _graph_cfg(alloc_every, cull_occluded=cull)
    grids = [TSDFGrid(0.05, 0.15, cfg=cfg, device=cuda, capture=c) for c in (True, False)]
    for rgb, depth, ht, lt, pose in frames:
        for grid in grids:
            grid.integrate(rgb, depth, ht, lt, 4.0, k, pose)
    torch.cuda.synchronize()
    assert grids[0].graphs.replays >= 8 - 4 and grids[1].graphs.replays == 0
    _assert_volumes_equal(grids[0].volume, grids[1].volume)
    for pose in (frames[0][4], frames[-1][4], frames[0][4]):
        a, b = (grid.ray_cast(4.0, (k, h, w), pose, renderer="splat") for grid in grids)
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y)
    assert grids[0].graphs.replays >= 8 - 4 + 2


def test_captured_online_step_equals_the_eager_step(cuda):
    """FusedOnlineStep with the shipped FastSeg, u8 rgb and u16 depth from
    the host, captured against eager over seven frames: the same volume
    bit for bit (TF32 off in both)."""
    k, h, w, frames = _sphere_frames(7)
    model = seg.load_model("fast", device=cuda)
    steps = [FusedOnlineStep(_graph_cfg(3), k, h, w, 4.0, seg_model=model, depth_factor=1000.0,
                             device=cuda, capture=c) for c in (True, False)]
    for rgb, depth, _, _, pose in frames:
        for s in steps:
            s.step(rgb.astype(np.uint8), (depth * 1000.0).astype(np.uint16), pose)
    torch.cuda.synchronize()
    assert steps[0].graphs.replays == 7 - 4
    _assert_volumes_equal(steps[0].volume, steps[1].volume)


def test_eager_steps_never_sync(cuda):
    """integrate, the splat render and the online step's ops, the pose in
    device memory, raise nothing under set_sync_debug_mode("error") (after
    a warm-up that builds the kernels): the steps hold no host read, so
    they can be captured."""
    from disinfect_slam_tpu_torch.core.geometry import DevicePose
    from disinfect_slam_tpu_torch.core.state import TSDFVolume
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput, integrate

    k, h, w, frames = _sphere_frames(2)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    online = FusedOnlineStep(_graph_cfg(1), k, h, w, 4.0, seg_model=seg.load_model("fast", device=cuda),
                             depth_factor=1000.0, device=cuda, capture=False)
    for cull in (False, True):
        vol = TSDFVolume.create(_graph_cfg(1, cull_occluded=cull), cuda)
        for i, (rgb, depth, ht, lt, pose) in enumerate(frames):
            fr = FrameInput(t(rgb), t(depth), t(ht), t(lt))
            dpose = DevicePose.from_matrix(pose, cuda)
            rgb8, d16 = t(rgb.astype(np.uint8)), t((depth * 1000.0).astype(np.uint16))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if i else "default")
            try:
                integrate(vol, fr, cam, dpose, 4.0)
                splat_kernel.splat_render_cuda(vol, cam, dpose, 4.0)
                online._fuse(rgb8, d16, dpose, allocate=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_replays_count_their_kernel_launches(cuda):
    """N frames through the captured grid: fuse_rows counts N launches,
    eager first calls and replays alike; REPLAYS counts the replays and
    their launches; two renders count one launch of each splat kernel
    each."""
    from disinfect_slam_tpu_torch.utils.graphs import REPLAYS

    k, h, w, frames = _sphere_frames(9)
    grid = TSDFGrid(0.05, 0.15, cfg=_graph_cfg(3), device=cuda)
    before = (fuse_kernel.fuse_rows.launches, REPLAYS["graph"], REPLAYS["fuse_rows"])
    for rgb, depth, ht, lt, pose in frames:
        grid.integrate(rgb, depth, ht, lt, 4.0, k, pose)
    assert fuse_kernel.fuse_rows.launches - before[0] == 9
    assert REPLAYS["graph"] - before[1] == grid.graphs.replays == 9 - 4
    assert REPLAYS["fuse_rows"] - before[2] == 9 - 4
    zb, pb = (splat_kernel.splat_zbuf_blocks.launches, splat_kernel.splat_payload_blocks.launches)
    for _ in range(2):
        grid.ray_cast(4.0, (k, h, w), frames[0][4], renderer="splat")
    assert (splat_kernel.splat_zbuf_blocks.launches - zb,
            splat_kernel.splat_payload_blocks.launches - pb) == (2, 2)


def test_recenter_and_the_integrating_thread_capture_anew(cuda):
    """A recenter in the middle of a captured replay keys new captures and
    the volume still equals the eager grid's; DISINFSystem integrating on
    its own thread (thread-local capture) equals its eager twin."""
    from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem

    k, h, w, frames = _sphere_frames(8)
    cfg = _graph_cfg(1, grid_log2=5)
    grids = [TSDFGrid(0.05, 0.15, cfg=cfg, device=cuda, capture=c) for c in (True, False)]
    for i, (rgb, depth, ht, lt, pose) in enumerate(frames):
        if i == 4:
            for grid in grids:
                assert grid.recenter((0.3, 0.2, 0.9))
        for grid in grids:
            grid.integrate(rgb, depth, ht, lt, 4.0, k, pose)
    assert grids[0].graphs.captures == 4
    _assert_volumes_equal(grids[0].volume, grids[1].volume)

    kw = dict(depth_factor=1.0, voxel_size=0.05, truncation=0.15, half_scale=False,
              cfg=_graph_cfg(3), device=cuda)
    with DISINFSystem(k, **kw) as captured, DISINFSystem(k, **kw) as eager:
        eager.tsdf.tsdf.capture = False
        for i, (rgb, depth, _, _, pose) in enumerate(frames):
            for system in (captured, eager):
                system.feed_pose(i, pose)
                system.feed_rgbd_frame(rgb, depth, i)
        for system in (captured, eager):
            system.tsdf.flush()
        assert captured.tsdf.dropped_frames == eager.tsdf.dropped_frames == 0
        assert captured.tsdf.tsdf.graphs.replays == 8 - 4
        _assert_volumes_equal(captured.tsdf.tsdf.volume, eager.tsdf.tsdf.volume)


def test_kernels_read_a_device_pose(cuda):
    """K2, K4 and K5 with the pose in device memory (a DevicePose; for K2
    the second half of a buffer, so the pointer is offset) against their
    plain versions with the host pose: the same bits (K2's prob within
    1e-6: CUDA expf/logf)."""
    from disinfect_slam_tpu_torch.core.geometry import DevicePose, pose_floats

    c = _block_case(cuda, seed=3, img_h=48, img_w=64)
    pools = [c[k].clone() for k in ("tsdf", "rgbw", "prob")]
    refs = [c[k].clone() for k in ("tsdf", "rgbw", "prob")]
    args = [c[k] for k in ("img", "block_pos", "pool_idx", "count")]
    consts = dict(truncation=TRUNC, max_depth=MAX_DEPTH, max_weight=MAX_W, **c["geometry"])
    host = consts["cam_T_world"]
    # a buffer that holds the pose in its second half: the inverse's view
    dev = DevicePose(torch.from_numpy(np.roll(pose_floats(host), 16)).to(cuda), half=1)
    m = fuse_kernel.fuse_rows(*args, *pools, **{**consts, "cam_T_world": dev})
    m_ref = fuse_kernel.fuse_rows_reference(*args, *refs, **consts)
    torch.cuda.synchronize()
    assert torch.equal(pools[0], refs[0]) and torch.equal(pools[1], refs[1])
    assert (pools[2] - refs[2]).abs().max().item() <= 1e-6
    assert torch.equal(m[:COUNT], m_ref[:COUNT]) and not torch.equal(pools[1], c["rgbw"])

    rows, pool, geometry = _splat_case(cuda, 5, COUNT, 48, 64)
    tsdf, rgbw, prob = pool
    dgeo = {**geometry, "cam_T_world": DevicePose.from_se3(geometry["cam_T_world"], cuda)}
    zbuf = splat_kernel.splat_zbuf_blocks(*rows, tsdf, **dgeo)
    pbuf = splat_kernel.splat_payload_blocks(*rows, tsdf, rgbw, prob, zbuf, **dgeo)
    zref = splat_kernel.splat_zbuf_blocks_reference(*rows, tsdf, **geometry)
    pref = splat_kernel.splat_payload_blocks_reference(*rows, tsdf, rgbw, prob, zref, **geometry)
    torch.cuda.synchronize()
    assert torch.equal(zbuf, zref) and torch.equal(pbuf, pref)
    assert (zbuf < splat_kernel.BIG).any()


def test_a_capture_that_syncs_raises(cuda):
    """A step that reads the device on the host cannot be captured: the
    capture raises (it never drops to eager), after the key's first, eager
    call ran; nothing is cached."""
    from disinfect_slam_tpu_torch.utils.graphs import StepGraphs

    graphs = StepGraphs(cuda)
    x = torch.arange(4.0, device=cuda)
    with pytest.raises(RuntimeError):
        graphs.run("syncs", lambda: float(x.sum()))
    assert len(graphs) == 0 and graphs.captures == 0
    assert float(torch.arange(3.0, device=cuda).sum()) == 3.0


# ----------------------------------------------------------------------
# DenseSLAM's tracked frame and the sharded step as captured steps
# ----------------------------------------------------------------------
def _slam_frames(n):
    """An orbit out and back over the SLAM scene, n frames."""
    angles = np.concatenate([np.linspace(0, 0.3, n // 2), np.linspace(0.3, 0, n - n // 2)])
    return [(checker_rgb(SLAM_W, SLAM_H),
             _slam_depth(look_at((np.sin(a) * 1.8, 0.01 * a, -1.8 * np.cos(a) + 0.3),
                                 SLAM_CENTER))) for a in angles]


def _new_slam(cuda, capture, scale=1, **kw):
    from disinfect_slam_tpu_torch.systems import dense_slam as tds

    return tds.DenseSLAM(SLAM_K, SLAM_H, SLAM_W, voxel_size=0.02, truncation=0.06,
                         cfg=SLAM_CFG, track_res_scale=scale, device=cuda, capture=capture,
                         **kw)


@pytest.mark.parametrize("scale", [1, 2])
def test_captured_slam_equals_the_eager_slam(cuda, scale):
    """DenseSLAM's tracked frame as a CUDA graph against the same step run
    eagerly, 20 frames with loop closure every 5th: every pose and ok flag
    and every volume array bit-equal; a tracked frame is one replay, K4 and
    K2 once a frame through it, and a keyframe's query one replay after
    the first keyframe's capture."""
    from disinfect_slam_tpu_torch.utils.graphs import REPLAYS

    frames = _slam_frames(20)
    slams = [_new_slam(cuda, c, scale, loop_closure=True, kf_every=5) for c in (True, False)]
    before = (REPLAYS["graph"], REPLAYS["splat_zbuf_blocks"], REPLAYS["fuse_rows"])
    out = [[], []]
    for rgb, depth in frames:
        for o, slam in zip(out, slams):
            p, ok = slam.process_frame(rgb, depth)
            o.append((p.cpu().numpy(), bool(ok)))
    for (pa, oa), (pb, ob) in zip(*out):
        np.testing.assert_array_equal(pa, pb)
        assert oa == ob
    assert all(ok for _, ok in out[0])
    _assert_volumes_equal(slams[0].volume, slams[1].volume)
    replays = REPLAYS["graph"] - before[0]
    # frames 3-19 replay the tracked step (frame 0 integrates, 1 and 2
    # capture its two staging slots); the keyframes 0, 5, 10, 15 query, the
    # first capturing the query and the other three replaying it
    assert slams[0].graphs.replays == replays == (20 - 3) + (4 - 1)
    assert (REPLAYS["splat_zbuf_blocks"] - before[1], REPLAYS["fuse_rows"] - before[2]) == (
        20 - 3, 20 - 3)


def test_captured_slam_steady_frames_never_sync(cuda):
    """Once its keys are captured, a tracked frame that is not a keyframe
    raises nothing under set_sync_debug_mode("error"): no host read, no
    stream sync (the device is caught up before each frame, so the staging
    slot's wait has nothing to wait for)."""
    frames = _slam_frames(16)
    slam = _new_slam(cuda, True, loop_closure=True, kf_every=5)
    for i, (rgb, depth) in enumerate(frames):
        torch.cuda.synchronize()
        steady = i >= 3 and i % 5
        torch.cuda.set_sync_debug_mode("error" if steady else "default")
        try:
            slam.process_frame(rgb, depth)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert slam.lost_count == 0


@pytest.mark.parametrize("n", [4, 1])
def test_captured_sharded_step_equals_the_eager_step(cuda, n):
    """DistributedTSDF.integrate over [cuda:0] * n as one graph a frame
    against the same step run eagerly: every shard's arrays and the cuts
    of every frame bit-equal; then the render (one graph a view, K4 and
    K5 once a shard) equal to the eager one in all four images."""
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput
    from disinfect_slam_tpu_torch.parallel.sharding import DistributedTSDF

    k, h, w, frames = _sphere_frames(6)
    cfg = _graph_cfg(1)
    dists = [DistributedTSDF(cfg, [cuda] * n, capture=c) for c in (True, False)]
    for rgb, depth, ht, lt, pose in frames:
        cuts = [[], []]
        for c, d in zip(cuts, dists):
            d.integrate(FrameInput(rgb, depth, ht, lt), k, pose, 4.0, cuts=c)
        assert [[int(t) for t in x] for x in cuts[0]] == [[int(t) for t in x] for x in cuts[1]]
    assert dists[0].graphs[cuda].replays == 6 - 2
    for a, b in zip(dists[0].shards, dists[1].shards):
        _assert_volumes_equal(a, b)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    zb = splat_kernel.splat_zbuf_blocks.launches
    for pose in (frames[0][4], frames[-1][4], frames[0][4]):
        a, b = (d.render(cam, pose, 4.0) for d in dists)
        assert a.hit.any() and all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
    assert splat_kernel.splat_zbuf_blocks.launches - zb == 3 * 2 * n
    assert dists[0].graphs[cuda].replays == 6 - 2 + 2


# ----------------------------------------------------------------------
# the stereo matchers, the remap, the seg engine and chunked meshing as
# captured steps
# ----------------------------------------------------------------------
def _no_sync(fn):
    """fn() with the device caught up first and every synchronising call
    raising."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("method", ["flat", "pyramid"])
def test_captured_stereo_equals_the_eager_stereo(cuda, method):
    """StereoDepthEstimator at 640x480 / 64 disparities, three pairs from
    the host (pinned staging, slots 0, 1, 0) and from the device: the
    captured depth equals the eager one bit for bit; three captures, the
    other calls replays, which never synchronise."""
    from disinfect_slam_tpu_torch.ops.stereo import StereoDepthEstimator

    left, right, fx = _stereo_frame0()
    pairs = [tuple(np.roll(x, 7 * i, 0).astype(np.uint8) for x in (left, right))
             for i in range(3)]
    cap, eager = (StereoDepthEstimator(fx, 0.12, max_depth=4.0, method=method, capture=c)
                  for c in (True, False))
    for lh, rh in pairs:
        np.testing.assert_array_equal(cap(lh, rh), eager(lh, rh))
        ld, rd = (torch.from_numpy(x).to(cuda) for x in (lh, rh))
        assert torch.equal(cap.depth_device(ld, rd), eager.depth_device(ld, rd))
    assert cap.graphs.captures == 3 and cap.graphs.replays == 3
    lh, rh = pairs[1]
    ld, rd = (torch.from_numpy(x).to(cuda) for x in (lh, rh))
    for args in ((lh, rh), (ld, rd)):
        depth = _no_sync(lambda args=args: cap.depth_device(*args))
        np.testing.assert_array_equal(depth.cpu().numpy(), eager(lh, rh))
    assert torch.equal(cap.left_device(), ld)


def test_captured_remap_equals_the_eager_remap(cuda, tmp_path):
    """The factory calibration's rectifier, captured against capture=False:
    rectify (an RGB left and a gray right view from the host) and
    rectify_device over three pairs bit for bit; the replays never
    synchronise."""
    from disinfect_slam_tpu_torch.io.zed_calib import rectifier_from_factory_conf
    from disinfect_slam_tpu_torch.ops.image_ops import StereoRectifier

    from .torch_cases import ZED_FACTORY_CONF

    conf = tmp_path / "SN1.conf"
    conf.write_text(ZED_FACTORY_CONF)
    cap = rectifier_from_factory_conf(str(conf), "VGA")
    eager = StereoRectifier(cap.maps, device=cuda, capture=False)
    rng = np.random.default_rng(11)
    for _ in range(3):
        left = rng.uniform(0, 255, (376, 672, 3)).astype(np.float32)
        right = rng.uniform(0, 255, (376, 672)).astype(np.float32)
        for a, b in zip(cap.rectify(left, right), eager.rectify(left, right)):
            np.testing.assert_array_equal(a, b)
        ld, rd = (torch.from_numpy(x).to(cuda) for x in (left, right))
        for a, b in zip(cap.rectify_device(ld, rd), eager.rectify_device(ld, rd)):
            assert torch.equal(a, b)
    assert cap.graphs.captures == 3 and cap.graphs.replays == 3
    out = _no_sync(lambda: cap.rectify_device(ld, rd))
    assert all(torch.equal(a, b) for a, b in zip(out, eager.rectify_device(ld, rd)))


@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_captured_seg_engine_equals_the_eager_engine(cuda, arch):
    """InferenceEngine.infer_one on frame 0 of orbit_vga (480x640 u8) and
    two shifted copies, the shipped net captured against capture=False
    (cuDNN deterministic): the maps bit for bit; the replays never
    synchronise before the one copy to the host."""
    rgb = read_image(ORBIT_RGB)
    model = seg.load_model(arch, device=cuda)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cap, eager = (seg.InferenceEngine(model, capture=c) for c in (True, False))
        frames = [np.roll(rgb, 9 * i, 1) for i in range(3)]
        for f in frames:
            for a, b in zip(cap.infer_one(f), eager.infer_one(f)):
                np.testing.assert_array_equal(a, b)
        assert cap.graphs.captures == 2 and cap.graphs.replays == 1
        maps = _no_sync(lambda: cap._run(frames[2]).clone())
        np.testing.assert_array_equal(maps.cpu().numpy(), np.stack(eager.infer_one(frames[2])))
    finally:
        torch.backends.cudnn.deterministic = prev


def test_captured_mesh_equals_the_eager_mesh(cuda):
    """extract_mesh_chunked on the card, the candidate pass and the chunk
    body captured (the 29 candidate blocks in chunks of 8, the last one of
    5) against capture=False, f32 and q16: equal triangles; with a kept
    MeshGraphs a second call replays every step, and the replays never
    synchronise."""
    from disinfect_slam_tpu_torch.ops import mesh as tmesh

    grid, _, _ = _fused_grid("cpu")
    vol = _to(grid.volume, cuda)
    n = int(tmesh._candidates(vol).sum())
    assert n > 16 and n % 8, n
    for transfer in ("f32", "q16"):
        kept = tmesh.MeshGraphs(cuda)
        eager = tmesh.extract_mesh_chunked(vol, chunk=8, transfer=transfer, capture=False)
        first = tmesh.extract_mesh_chunked(vol, chunk=8, transfer=transfer, graphs=kept)
        again = tmesh.extract_mesh_chunked(vol, chunk=8, transfer=transfer, graphs=kept)
        assert eager.shape[0] > 300
        np.testing.assert_array_equal(first, eager)
        np.testing.assert_array_equal(again, eager)
        assert kept.graphs.captures == 2 and kept.graphs.replays == 2 * -(-n // 8)
        for key in kept.graphs.keys():
            _no_sync(lambda key=key: kept.graphs.run(key, None))


# ----------------------------------------------------------------------
# the seg net's training as captured steps: make_train_step and
# make_eval_step, seg_parallel's sharded step and inference
# ----------------------------------------------------------------------
TRAIN_NETS = {"unet": dict(arch="unet", widths=(8, 16, 16, 16)),
              "fast": dict(arch="fast", widths=(32, 64))}


def _train_batches(n, b=2, h=48, w=64):
    from disinfect_slam_tpu_torch.models.synth_data import make_batch

    rng = np.random.default_rng(0)
    return [make_batch(rng, b, h, w) for _ in range(n)]


def _deterministic(fn):
    """fn() with cuDNN on its deterministic algorithms (a weight gradient
    summed by atomics differs between two runs of one step)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = prev


def _train_twins(cuda, arch, dtype, lr):
    from disinfect_slam_tpu_torch.models import train

    states = [train.create_train_state(seg.create_model(
        dtype=dtype, generator=torch.Generator().manual_seed(0), **TRAIN_NETS[arch]), lr=lr,
        device=cuda) for _ in range(2)]
    return states, [train.make_train_step(s.model, s.opt, capture=c)
                    for s, c in zip(states, (True, False))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_captured_train_and_eval_steps_equal_eager(cuda, arch, dtype):
    """make_train_step of a narrow net, captured against capture=False from
    the same parameters, 8 steps while a warmup schedule moves the lr
    (steps 0-3 host batches, 4-7 the same kind on the card), cuDNN
    deterministic: every loss, parameter and Adam moment equal; four
    captures (two staging slots of each kind), one replay a step after
    them.  make_eval_step captured against eager: loss and IoU equal."""
    from disinfect_slam_tpu_torch.models import train

    sched = train.warmup_cosine_decay_schedule(0.0, 1e-2, warmup_steps=3, decay_steps=12)
    states, (cap, eager) = _train_twins(cuda, arch, dtype, sched)
    batches = _train_batches(8)

    def run():
        for i, (imgs, labs) in enumerate(batches):
            if i >= 4:
                imgs, labs = (torch.from_numpy(a).to(cuda) for a in (imgs, labs))
            _, a = cap(states[0], imgs, labs)
            _, b = eager(states[1], imgs, labs)
            assert torch.equal(a, b), (i, float(a), float(b))
        evals = [train.make_eval_step(states[0].model, capture=c) for c in (True, False)]
        for imgs, labs in batches[:3]:
            a, b = (e(imgs, labs) for e in evals)
            assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["iou"], b["iou"])
        assert evals[0].graphs.captures == 2 and evals[0].graphs.replays == 1

    _deterministic(run)
    assert cap.graphs.captures == 4 and cap.graphs.replays == 8 - 4
    assert states[0].opt.param_groups[0]["lr"] == states[1].opt.param_groups[0]["lr"] > 0
    for p, q in zip(states[0].model.parameters(), states[1].model.parameters()):
        assert torch.equal(p, q)
        for k in ("mu", "nu"):
            assert torch.equal(states[0].opt.state[p][k], states[1].opt.state[q][k])


@pytest.mark.parametrize("n", [1, 4])
def test_captured_sharded_steps_equal_eager(cuda, n):
    """seg_parallel over [cuda:0] * n, a narrow float32 UNet: the captured
    train step against capture=False over 4 steps of batches on the card
    (one capture, then a replay a step), loss and every parameter equal;
    the captured inference equal to the eager one, and again after the
    parameters change in place (a replay reads them where they live)."""
    from disinfect_slam_tpu_torch.parallel import seg_parallel as sp

    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.uniform(0, 1, (8, 32, 48, 3)).astype(np.float32)).to(cuda),
                (torch.from_numpy(rng.uniform(0, 1, (8, 32, 48, 2))) > 0.5).float().to(cuda))
               for _ in range(4)]
    mesh = sp.make_mesh_2d(devices=[cuda] * n)
    sd = seg.create_model(widths=(8, 16, 32, 64), dtype=torch.float32).state_dict()
    nets, states = [], []
    for _ in range(2):
        net = seg.create_model(widths=(8, 16, 32, 64), dtype=torch.float32)
        net.load_state_dict(sd)
        nets.append(net.to(cuda))
        states.append(sp.ShardedTrainState(sp.shard_params(nets[-1], mesh, tp_min_width=16)))
    steps = [sp.make_sharded_train_step(net, dict(lr=1e-3), mesh, capture=c)
             for net, c in zip(nets, (True, False))]
    infers = [sp.make_sharded_infer(nets[0], sp.make_mesh_2d(devices=[cuda] * 4), capture=c)
              for c in (True, False)]

    def run():
        for i, (imgs, labs) in enumerate(batches):
            (_, a), (_, b) = (s(st, imgs, labs) for s, st in zip(steps, states))
            assert torch.equal(a, b), i
        for _ in range(2):
            a, b = (f(batches[0][0]) for f in infers)
            assert torch.equal(a, b)
            with torch.no_grad():
                for p in nets[0].parameters():
                    p.mul_(0.9)

    _deterministic(run)
    assert steps[0].graphs.captures == 1 and steps[0].graphs.replays == 3
    assert infers[0].graphs.captures == 1 and infers[0].graphs.replays == 1
    full = [st.params.full() for st in states]
    for k in full[1]:
        assert torch.equal(full[0][k], full[1][k]), k


def test_captured_train_steps_never_sync(cuda):
    """Once captured, a replay of make_train_step (host and card batches),
    make_eval_step, the 2x2 sharded step and the sharded inference raises
    nothing under set_sync_debug_mode("error"), and counts one replay."""
    from disinfect_slam_tpu_torch.models import train
    from disinfect_slam_tpu_torch.parallel import seg_parallel as sp

    sched = train.warmup_cosine_decay_schedule(0.0, 1e-2, warmup_steps=3, decay_steps=12)
    (state, _), (step, _) = _train_twins(cuda, "unet", torch.float32, sched)
    evals = train.make_eval_step(state.model)
    host = _train_batches(1)[0]
    card = tuple(torch.from_numpy(a).to(cuda) for a in host)
    for batch in (host, host, card, card):
        step(state, *batch)
        evals(*batch)
    replays = step.graphs.replays
    for batch in (host, card):
        loss = _no_sync(lambda batch=batch: step(state, *batch)[1])
        m = _no_sync(lambda batch=batch: evals(*batch))
        assert bool(torch.isfinite(loss)) and m["iou"].shape == (2,)
    assert step.graphs.replays == replays + 2

    mesh = sp.make_mesh_2d(devices=[cuda] * 4)
    net = seg.create_model(widths=(8, 16, 32, 64), dtype=torch.float32).to(cuda)
    sstate = sp.ShardedTrainState(sp.shard_params(net, mesh, tp_min_width=16))
    sstep, infer = sp.make_sharded_train_step(net, {}, mesh), sp.make_sharded_infer(net, mesh)
    imgs = torch.rand(4, 32, 48, 3, device=cuda)
    labs = (torch.rand(4, 32, 48, 2, device=cuda) > 0.5).float()
    sstep(sstate, imgs, labs)
    infer(imgs)
    _no_sync(lambda: sstep(sstate, imgs, labs))
    _no_sync(lambda: infer(imgs))
    assert sstep.graphs.replays == 1 and infer.graphs.replays == 1
