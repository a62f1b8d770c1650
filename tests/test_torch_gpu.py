"""PyTorch port on the card: each CUDA kernel against its plain torch
version on the same CUDA tensors, at small shapes, with the edge cases
of the fusion formulas (zero weights, probabilities of 0 and 1, depth at
max_depth, prob_eps, off-image voxels, rows past the live count) and of
the splat merges (depth ties, payload words with the top bit set,
negative and off-image footprints, rows past the live count, no live
row), the renders through TSDFGrid.ray_cast on the card, and the online
slice: the segmentation nets and FusedOnlineStep on the card against the
port on the CPU.

Needs a CUDA device and nvcc; skipped without a card.  This file imports
no JAX, so it runs on a GPU host without it:

  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import copy
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

pytestmark = pytest.mark.gpu

ROWS, COUNT, POOL = 64, 50, 256
TRUNC, MAX_DEPTH, MAX_W = 0.06, 4.0, 40.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(dev, seed=0, img_h=48, img_w=64):
    rng = np.random.default_rng(seed)
    img = np.zeros((img_h, img_w, 8), np.float32)
    img[..., 0] = rng.uniform(0.3, 4.4, (img_h, img_w))
    img[..., 0][rng.uniform(size=(img_h, img_w)) < 0.1] = 0.0
    img[..., 0][rng.uniform(size=(img_h, img_w)) < 0.1] = MAX_DEPTH
    img[..., 1] = rng.uniform(1.0, 1.3, (img_h, img_w))
    img[..., 2:5] = rng.integers(0, 256, (img_h, img_w, 3))
    img[..., 5:7] = rng.uniform(0, 1, (img_h, img_w, 2))
    img[..., 5][rng.uniform(size=(img_h, img_w)) < 0.1] = 0.0
    img[..., 6][rng.uniform(size=(img_h, img_w)) < 0.1] = 1.0
    u = rng.integers(-4, img_w + 4, (ROWS, 512)).astype(np.int32)
    v = rng.integers(-4, img_h + 4, (ROWS, 512)).astype(np.int32)
    uc, vc = np.clip(u, 0, img_w - 1), np.clip(v, 0, img_h - 1)
    in_img = (u == uc) & (v == vc)
    z = img[vc, uc, 0] + rng.uniform(-0.08, 0.05, (ROWS, 512)).astype(np.float32)
    gate = in_img & (rng.uniform(size=(ROWS, 512)) < 0.9)
    gate[COUNT:] = False
    pool_idx = rng.permutation(POOL)[:ROWS].astype(np.int32)
    pool_idx[COUNT:] = POOL
    tsdf = rng.uniform(-1, 1, (POOL, 512)).astype(np.float32)
    w = rng.integers(0, 41, (POOL, 512))
    w[rng.uniform(size=w.shape) < 0.3] = 0
    rgbw = (rng.integers(0, 1 << 24, (POOL, 512)) | (w << 24)).astype(np.int32)
    prob = rng.uniform(0, 1, (POOL, 512)).astype(np.float32)
    prob[rng.uniform(size=prob.shape) < 0.1] = 0.0
    prob[rng.uniform(size=prob.shape) < 0.1] = 1.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(img=t(img), u=t(u), v=t(v), us=t(uc.astype(np.int32)),
                vs=t(vc.astype(np.int32)), z=t(z.astype(np.float32)), gate=t(gate),
                pool_idx=t(pool_idx), count=torch.tensor(COUNT, dtype=torch.int32, device=dev),
                tsdf=t(tsdf), rgbw=t(rgbw), prob=t(prob))


@pytest.mark.parametrize("prob_eps", [0.0, 1e-6])
@pytest.mark.parametrize("img_hw", [(48, 64), (1080, 1920)])
def test_fuse_rows_kernel_matches_plain_version(cuda, prob_eps, img_hw):
    c = _case(cuda, seed=1, img_h=img_hw[0], img_w=img_hw[1])
    pools = [c[k].clone() for k in ("tsdf", "rgbw", "prob")]
    refs = [c[k].clone() for k in ("tsdf", "rgbw", "prob")]
    args = [c[k] for k in ("img", "us", "vs", "z", "gate", "pool_idx", "count")]
    consts = dict(truncation=TRUNC, max_depth=MAX_DEPTH, max_weight=MAX_W,
                  prob_eps=prob_eps)
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
    with pytest.raises(ValueError):
        fuse_kernel.fuse_rows(c["img"][..., :4].contiguous(), c["us"], c["vs"], c["z"],
                              c["gate"], c["pool_idx"], c["count"], c["tsdf"],
                              c["rgbw"], c["prob"], truncation=TRUNC,
                              max_depth=MAX_DEPTH, max_weight=MAX_W)
    s = _splat_case(cuda, seed=3, count=COUNT, img_h=48, img_w=64)
    with pytest.raises(ValueError):
        splat_kernel.splat_zbuf_rows(s["u0"].long(), s["v0"], s["dq"], s["count"], 48, 64)
    with pytest.raises(ValueError):
        splat_kernel.splat_payload_rows(s["u0"], s["v0"], s["dq"], s["pool_idx"],
                                        s["rgbw"], s["prob"].double(), s["count"],
                                        torch.zeros(48 * 64, dtype=torch.int32,
                                                    device=cuda), 48, 64)


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


def _splat_case(dev, seed, count, img_h, img_w):
    """Splat kernel inputs: footprints spilling past every image edge
    (floor pixels from -3 to size + 2), depths from a set of three so
    that voxels tie at pixels, 30% of voxels outside the band (BIG), and
    rows past `count` given the smallest depth, so that they would win
    every pixel they touch if they were merged."""
    rng = np.random.default_rng(seed)
    u0 = rng.integers(-3, img_w + 3, (ROWS, 512)).astype(np.int32)
    v0 = rng.integers(-3, img_h + 3, (ROWS, 512)).astype(np.int32)
    dq = rng.choice([1000, 1001, 1002], (ROWS, 512)).astype(np.int32)
    dq[rng.uniform(size=dq.shape) < 0.3] = splat_kernel.BIG
    dq[count:] = 7
    pool_idx = rng.permutation(POOL)[:ROWS].astype(np.int32)
    pool_idx[count:] = POOL
    rgbw = (rng.integers(0, 1 << 24, (POOL, 512)) | (rng.integers(0, 41, (POOL, 512)) << 24))
    prob = rng.uniform(0, 1, (POOL, 512)).astype(np.float32)  # half >= 0.5: top bit
    prob[rng.uniform(size=prob.shape) < 0.1] = 0.0
    prob[rng.uniform(size=prob.shape) < 0.1] = 1.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(u0=t(u0), v0=t(v0), dq=t(dq), pool_idx=t(pool_idx),
                rgbw=t(rgbw.astype(np.int32)), prob=t(prob),
                count=torch.tensor(count, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("count", [0, COUNT, ROWS])
@pytest.mark.parametrize("img_hw", [(48, 64), (1080, 1920)])
def test_splat_kernels_match_plain_versions(cuda, count, img_hw):
    img_h, img_w = img_hw
    s = _splat_case(cuda, seed=5, count=count, img_h=img_h, img_w=img_w)
    rows = (s["u0"], s["v0"], s["dq"])
    before = (splat_kernel.splat_zbuf_rows.launches, splat_kernel.splat_payload_rows.launches)
    zbuf = splat_kernel.splat_zbuf_rows(*rows, s["count"], img_h, img_w)
    pbuf = splat_kernel.splat_payload_rows(*rows, s["pool_idx"], s["rgbw"], s["prob"],
                                           s["count"], zbuf, img_h, img_w)
    zref = splat_kernel.splat_zbuf_rows_reference(*rows, s["count"], img_h, img_w)
    pref = splat_kernel.splat_payload_rows_reference(*rows, s["pool_idx"], s["rgbw"],
                                                     s["prob"], s["count"], zref,
                                                     img_h, img_w)
    torch.cuda.synchronize()
    assert (splat_kernel.splat_zbuf_rows.launches,
            splat_kernel.splat_payload_rows.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(zbuf, zref) and torch.equal(pbuf, pref)
    if count == 0:
        assert (zbuf == splat_kernel.BIG).all() and (pbuf == 0).all()
    elif count == COUNT:
        assert not (zbuf == 7).any()  # rows past count merged nothing
        assert (pbuf < 0).any()  # u32 words with the top bit set won
        assert ((zbuf >= 1000) & (zbuf < splat_kernel.BIG)).any()
    # every footprint pixel of a live voxel in the image is covered
    if img_h == 48 and count:
        u0, v0 = s["u0"][:count], s["v0"][:count]
        live = s["dq"][:count] < splat_kernel.BIG
        inside = live & (u0 >= 0) & (u0 < img_w) & (v0 >= 0) & (v0 < img_h)
        assert (zbuf[(v0 * img_w + u0)[inside].long()] < splat_kernel.BIG).all()


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
        before = (splat_kernel.splat_zbuf_rows.launches,
                  splat_kernel.splat_payload_rows.launches)
        res = grid.ray_cast(4.0, (k, h, w), pose, renderer="auto")
        assert (splat_kernel.splat_zbuf_rows.launches,
                splat_kernel.splat_payload_rows.launches) == (before[0] + 1, before[1] + 1)
        ref = render_fast.splat_render(grid.volume, cam, SE3.from_matrix(pose), 4.0)
        for f in ("hit", "depth", "rgba", "normal"):
            assert torch.equal(getattr(res, f), getattr(ref, f)), f
        assert int(res.surf_overflow) == 0 and res.hit.float().mean() > 0.1
        bufs = splat_kernel.splat_buffers_cuda(grid.volume, cam, SE3.from_matrix(pose), 4.0)
        ref_bufs = render_fast.splat_buffers(grid.volume, cam, SE3.from_matrix(pose), 4.0)
        for a, b in zip(bufs, ref_bufs):
            assert torch.equal(a, b)


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
    ref = seg.InferenceEngine(seg.load_model(arch)).infer_one(rgb)
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
