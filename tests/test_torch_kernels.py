"""PyTorch port, kernels: the plain versions of sample_rows and fuse_rows
against the JAX package's Pallas kernels, run in interpret mode on the
same numpy inputs.  (The CUDA kernels themselves are checked against
these plain versions on the card: tests/test_torch_gpu.py and
chip_smoke.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.ops.pallas.fuse_kernel import fuse_rows as j_fuse_rows
from disinfect_slam_tpu.ops.pallas.fuse_kernel import fuse_rows_packed
from disinfect_slam_tpu.ops.pallas.sample_kernel import sample_patches
from disinfect_slam_tpu_torch.ops.cuda import fuse_kernel, sample_kernel

from .test_sample_kernel import make_case

torch.set_num_threads(1)

TRUNC, MAX_DEPTH, MAX_W = 0.06, 4.0, 40.0


def test_sample_rows_reference_matches_pallas_exactly():
    img, u0, v0, u, v = make_case(seed=11)
    chans_j, valid_j = sample_patches(
        jnp.asarray(img), jnp.asarray(u0), jnp.asarray(v0), jnp.asarray(u),
        jnp.asarray(v), interpret=True, as_channels=True,
    )
    count = torch.tensor(u.shape[0], dtype=torch.int32)
    chans_t, valid_t = sample_kernel.sample_rows(
        torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v), count
    )
    valid_j = np.asarray(valid_j)
    assert valid_j.mean() > 0.99
    # every voxel here lies in the image; the port has no patch limit
    assert valid_t.all()
    for c in range(8):
        np.testing.assert_array_equal(
            chans_t[c].numpy()[valid_j], np.asarray(chans_j[c])[valid_j]
        )
    assert sample_kernel.sample_rows.launches == 0  # CPU: no kernel launch


def _fuse_case(seed, img_h, img_w, rows=32, count=27, pool_rows=64):
    """Frame, per-voxel pixels (footprints within the Pallas 24x32 patch),
    camera z, gate and pool payloads, including zero-weight voxels,
    probabilities of exactly 0 and 1 and depths at max_depth (the
    powf(0, 0) corner)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((img_h, img_w, 8), np.float32)
    img[..., 0] = rng.uniform(0.3, 4.4, (img_h, img_w))
    img[..., 0][rng.uniform(size=(img_h, img_w)) < 0.05] = 0.0
    img[..., 0][rng.uniform(size=(img_h, img_w)) < 0.05] = MAX_DEPTH
    img[..., 1] = rng.uniform(1.0, 1.3, (img_h, img_w))
    img[..., 2:5] = rng.integers(0, 256, (img_h, img_w, 3))
    img[..., 5:7] = rng.uniform(0, 1, (img_h, img_w, 2))
    img[..., 5][rng.uniform(size=(img_h, img_w)) < 0.05] = 0.0
    img[..., 6][rng.uniform(size=(img_h, img_w)) < 0.05] = 1.0
    u0 = rng.integers(0, img_w - 32, rows).astype(np.int32)
    v0 = rng.integers(0, img_h - 24, rows).astype(np.int32)
    u = (u0[:, None] + rng.integers(0, 16, (rows, 512))).astype(np.int32)
    v = (v0[:, None] + rng.integers(0, 16, (rows, 512))).astype(np.int32)
    z = (img[v, u, 0] + rng.uniform(-0.08, 0.05, (rows, 512))).astype(np.float32)
    gate = rng.uniform(size=(rows, 512)) < 0.9
    pool_idx = rng.permutation(pool_rows)[:rows].astype(np.int32)
    tsdf = rng.uniform(-1, 1, (pool_rows, 512)).astype(np.float32)
    w = rng.integers(0, 41, (pool_rows, 512)).astype(np.uint32)
    w[rng.uniform(size=w.shape) < 0.2] = 0
    rgb = rng.integers(0, 256, (pool_rows, 512, 3)).astype(np.uint32)
    rgbw = rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) | (w << 24)
    prob = rng.uniform(0, 1, (pool_rows, 512)).astype(np.float32)
    prob[rng.uniform(size=prob.shape) < 0.05] = 0.0
    prob[rng.uniform(size=prob.shape) < 0.05] = 1.0
    return dict(img=img, u0=u0, v0=v0, u=u, v=v, z=z, gate=gate,
                pool_idx=pool_idx, count=count, tsdf=tsdf, rgbw=rgbw, prob=prob)


def _run_reference(c, prob_eps):
    """fuse_rows (CPU tensors: the plain version) on a copy of the pool."""
    tsdf = torch.from_numpy(c["tsdf"].copy())
    rgbw = torch.from_numpy(c["rgbw"].view(np.int32).copy())
    prob = torch.from_numpy(c["prob"].copy())
    minabs = fuse_kernel.fuse_rows(
        torch.from_numpy(c["img"]), torch.from_numpy(c["u"]),
        torch.from_numpy(c["v"]), torch.from_numpy(c["z"]),
        torch.from_numpy(c["gate"]), torch.from_numpy(c["pool_idx"]),
        torch.tensor(c["count"], dtype=torch.int32), tsdf, rgbw, prob,
        truncation=TRUNC, max_depth=MAX_DEPTH, max_weight=MAX_W,
        prob_eps=prob_eps,
    )
    assert fuse_kernel.fuse_rows.launches == 0  # CPU: no kernel launch
    rows = c["pool_idx"][: c["count"]]
    return (tsdf.numpy()[rows], rgbw.numpy().view(np.uint32)[rows],
            prob.numpy()[rows], minabs.numpy()[: c["count"]])


def _assert_close(ours, ref, count):
    """tsdf and prob within 1e-6: XLA contracts a*b + c into FMAs inside
    the interpreted kernel and approximates exp/log its own way, the port
    does neither; the integral rgbw words are equal."""
    t, w, p, m = ours
    t_j, w_j, p_j, m_j = (np.asarray(a)[:count] for a in ref)
    np.testing.assert_array_equal(w, w_j)
    np.testing.assert_allclose(t, t_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p, p_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m, np.abs(t).min(axis=1))
    np.testing.assert_allclose(m, m_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("prob_eps", [0.0, 1e-6])
def test_fuse_rows_reference_matches_packed_pallas(prob_eps):
    c = _fuse_case(seed=21, img_h=64, img_w=128)
    rows = np.clip(c["pool_idx"], 0, None)
    t_j, w_j, p_j, m_j = fuse_rows_packed(
        jnp.asarray(c["img"]), jnp.asarray(c["u0"]), jnp.asarray(c["v0"]),
        jnp.asarray(c["u"]), jnp.asarray(c["v"]), jnp.asarray(c["z"]),
        jnp.asarray(c["gate"].astype(np.float32)), jnp.asarray(c["tsdf"][rows]),
        jnp.asarray(c["rgbw"][rows]), jnp.asarray(c["prob"][rows]),
        truncation=TRUNC, max_depth=MAX_DEPTH, max_weight=MAX_W,
        prob_eps=prob_eps, interpret=True, count=jnp.asarray(c["count"]),
    )
    ours = _run_reference(c, prob_eps)
    _assert_close(ours, (t_j, w_j, p_j, np.asarray(m_j)[:, 0]), c["count"])
    # the case exercises what it claims to
    upd = ours[1] != c["rgbw"][c["pool_idx"][: c["count"]]]
    assert upd.mean() > 0.3
    if prob_eps:
        assert ours[2][upd].min() >= np.float32(prob_eps)


def test_fuse_rows_reference_matches_patch_dma_pallas_at_1080p():
    """Frames over the TPU's VMEM limit go through fuse_rows (K3); the
    port has one kernel for every frame size."""
    c = _fuse_case(seed=31, img_h=1080, img_w=1920, rows=16, count=13)
    rows = c["pool_idx"]
    rgbw = c["rgbw"][rows]
    planes = [((rgbw >> s) & 0xFF).astype(np.float32) for s in (24, 0, 8, 16)]
    t_j, w_j, p_j, r_j, g_j, b_j, m_j = j_fuse_rows(
        jnp.asarray(c["img"]), jnp.asarray(c["u0"]), jnp.asarray(c["v0"]),
        jnp.asarray(c["u"]), jnp.asarray(c["v"]), jnp.asarray(c["z"]),
        jnp.asarray(c["gate"].astype(np.float32)), jnp.asarray(c["tsdf"][rows]),
        jnp.asarray(planes[0]), jnp.asarray(c["prob"][rows]),
        *(jnp.asarray(p) for p in planes[1:]),
        truncation=TRUNC, max_depth=MAX_DEPTH, max_weight=MAX_W,
        interpret=True, count=jnp.asarray(c["count"]),
    )
    word = sum(np.asarray(a).astype(np.uint32) << s
               for a, s in ((r_j, 0), (g_j, 8), (b_j, 16), (w_j, 24)))
    ours = _run_reference(c, 0.0)
    _assert_close(ours, (t_j, word, p_j, np.asarray(m_j)[:, 0]), c["count"])
