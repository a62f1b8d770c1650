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
smoothing, DenseSLAM on the card against the CPU (one pose read and one
sync a tracked frame, TF32 off in ICP) and loop closure on the card, the
kernels' self-check (utils/kernel_verify.py) and the segmentation net
over a mesh of the one card (parallel/seg_parallel.py).

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
    """The parity raycaster on the card against the CPU on the same
    fused volume: the hit masks agree on all but 0.5% of pixels (a sum
    over three products may round differently on the two devices)."""
    grid, poses, cam = _fused_grid(cuda)
    cpu, _, _ = _fused_grid("cpu")
    a = grid.ray_cast(4.0, cam, poses[0], renderer="raycast")
    b = cpu.ray_cast(4.0, cam, poses[0], renderer="raycast")
    assert a.hit.device.type == "cuda" and b.hit.any()
    assert (a.hit.cpu() != b.hit).float().mean() <= 0.005


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
# card against CPU, per-frame cam_T_world over the 6-frame orbit: fusion,
# the splat and the smoothing give the same bits on both; ICP's reductions
# (the normal equations, the rmse) run in other orders, which moves the
# poses by ulps that the next frames' correspondences carry (the CPU tests'
# limit against the JAX tracker, tests/test_torch_dense_slam.py)
SLAM_POSE_TOL = 2e-4


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
    TF32 switched on globally beforehand: the same ok flags, poses within
    SLAM_POSE_TOL; on the card one pose read and one stream sync per
    tracked frame (torch's sync debug mode counts them), none on frame 0;
    K4 once per tracked frame at the tracking camera, K5 never, fuse_rows
    once per frame; ICP ran with TF32 off and the global flags are left as
    they were."""
    import warnings

    from disinfect_slam_tpu_torch.systems import dense_slam as tds
    from disinfect_slam_tpu_torch.systems import odometry

    rgb = checker_rgb(SLAM_W, SLAM_H)
    flags_in_icp = []
    real_level = odometry._icp_level

    def spy(*a, **k):
        flags_in_icp.append((torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32))
        return real_level(*a, **k)

    monkeypatch.setattr(odometry, "_icp_level", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    runs = {}
    for dev in ("cpu", cuda):
        slam = tds.DenseSLAM(SLAM_K, SLAM_H, SLAM_W, voxel_size=0.02, truncation=0.06,
                             cfg=SLAM_CFG, track_res_scale=scale, device=dev)
        launches = [splat_kernel.splat_zbuf_blocks.launches,
                    splat_kernel.splat_payload_blocks.launches, fuse_kernel.fuse_rows.launches]
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
        launches = [n - b for n, b in zip(
            [splat_kernel.splat_zbuf_blocks.launches,
             splat_kernel.splat_payload_blocks.launches, fuse_kernel.fuse_rows.launches],
            launches)]
        runs[torch.device(dev).type] = (np.stack(poses), oks, reads, syncs, launches)
    (cp, cok, creads, _, clx), (gp, gok, greads, gsyncs, glx) = runs["cpu"], runs["cuda"]
    assert gok == cok == [True] * 6
    np.testing.assert_allclose(gp, cp, rtol=0, atol=SLAM_POSE_TOL)
    assert greads == creads == [0, 1, 1, 1, 1, 1]
    assert gsyncs == [0, 1, 1, 1, 1, 1], gsyncs
    assert glx == [5, 0, 6] and clx == [0, 0, 0]
    assert flags_in_icp and all(f == (False, False) for f in flags_in_icp)
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


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
    and the four pyramids timed."""
    res = _port_bench_script("port_bench_stereo").run(cuda, iters=3)
    assert set(res) == {(480, 640, 64), (720, 1280, 128)}
    assert all(len(r) == 5 and min(r.values()) > 0 for r in res.values())
