"""PyTorch port on the card: each CUDA kernel against its plain torch
version on the same CUDA tensors, at small shapes, with the edge cases
of the fusion formulas (zero weights, probabilities of 0 and 1, depth at
max_depth, prob_eps, off-image voxels, rows past the live count).

Needs a CUDA device and nvcc; skipped without a card.  This file imports
no JAX, so it runs on a GPU host without it:

  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from disinfect_slam_tpu_torch.config import TSDFConfig
from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
from disinfect_slam_tpu_torch.ops.cuda import fuse_kernel, sample_kernel
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

from .scenes import checker_rgb, look_at, render_sphere

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
