"""PyTorch port, the Hopper probes' plain versions (ops/cuda/
sample_probe.py): the patch modes of P1/P2/P6 select, and skip, what the
JAX package's Pallas sampler sample_patches does in interpret mode on the
same rows; P4's direct modes and P5's stripped stages of fuse_rows agree
with the port's sampler and projection.  (The probe kernels are held
against these plain versions on the card: tests/test_torch_gpu.py and
chip_smoke.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.ops.pallas.sample_kernel import sample_patches
from disinfect_slam_tpu_torch.ops.cuda import sample_kernel
from disinfect_slam_tpu_torch.ops.cuda import sample_probe as sp

from .torch_cases import block_case

torch.set_num_threads(1)

H, W, V, COUNT = 64, 128, 16, 12


def _rows(seed):
    """A frame and V rows of pixels: half the rows spread over 12 px, half
    over 40 px (past the 24x32 patch), 5% of voxels off the image."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W, 8)).astype(np.float32)
    spread = np.where(np.arange(V) % 2 == 0, 12, 40)[:, None]
    u = rng.integers(0, W - 20, (V, 1)) + (rng.uniform(size=(V, 512)) * spread).astype(int)
    v = rng.integers(0, H - 20, (V, 1)) + (rng.uniform(size=(V, 512)) * spread).astype(int)
    off = rng.uniform(size=(V, 512)) < 0.05
    u[off] = np.where(rng.uniform(size=off.sum()) < 0.5, -3, W + 2)
    return img, u.astype(np.int32), v.astype(np.int32)


@pytest.mark.parametrize("shape", sp.PATCH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_patch_reference_skips_what_jax_sample_patches_skips(shape):
    ph, pw = shape
    img, u, v = _rows(3)
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    u0, v0 = sp.patch_origins(ut, vt, H, W)
    count = torch.tensor(COUNT, dtype=torch.int32)
    chans, valid, skipped = sp.patch_sample_reference(torch.from_numpy(img), ut, vt, count,
                                                      u0, v0, ph, pw)
    chans_j, valid_j = sample_patches(
        jnp.asarray(img), jnp.asarray(u0.numpy()), jnp.asarray(v0.numpy()), jnp.asarray(u),
        jnp.asarray(v), ph=ph, pw=pw, interpret=True, as_channels=True,
        count=jnp.asarray(COUNT, jnp.int32))
    valid_j = np.asarray(valid_j)[:COUNT]
    np.testing.assert_array_equal(valid.numpy()[:COUNT], valid_j)
    for c in range(8):
        np.testing.assert_array_equal(chans[c].numpy()[:COUNT], np.asarray(chans_j[c])[:COUNT])
    in_img = ((u >= 0) & (u < W) & (v >= 0) & (v < H))[:COUNT]
    skip = in_img & ~valid_j
    assert skipped.tolist() == [int(skip.sum()), int(skip.any(1).sum())]
    assert (skipped[0] > 0) == (ph == 24)  # the 48x64 patch holds every footprint


def test_direct_references():
    """P4: the full mode is sample_rows' plain version; loads-only the xor
    of the pixel's eight words; writes-only channel c's value c."""
    img, u, v = _rows(4)
    args = (torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v),
            torch.tensor(V, dtype=torch.int32))
    full = sp.sample_direct_reference(*args, 0)
    ref = sample_kernel.sample_rows_reference(*args)
    assert torch.equal(full[0], ref[0]) and torch.equal(full[1], ref[1])
    words = sp.sample_direct_reference(*args, 1).numpy()
    ok = ref[1].numpy()
    bits = img.view(np.int32)[np.clip(v, 0, H - 1), np.clip(u, 0, W - 1)]
    np.testing.assert_array_equal(words, np.where(ok, np.bitwise_xor.reduce(bits, -1), 0))
    chans, valid = sp.sample_direct_reference(*args, 2)
    assert torch.equal(valid, ref[1])
    assert torch.equal(chans[5], torch.where(ref[1], 5.0, 0.0))


def test_fuse_stage_references_narrow_stage_by_stage():
    """P5: the ring alone takes min |tsdf| over every voxel of the live
    rows; the projection and then the sampling let fewer voxels through,
    so the minimum only rises, and rows with voxels in the image have a
    finite one."""
    c = block_case(7, 48, 64, 40, 33, 64)
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("img", "block_pos", "pool_idx", "tsdf", "rgbw", "prob")}
    consts = dict(cam_T_world=c["pose"], intrinsics=c["intrinsics"], voxel_size=c["voxel_size"],
                  truncation=0.06, max_depth=4.0, max_weight=40.0)
    count = torch.tensor(33, dtype=torch.int32)
    out = [sp.fuse_stage_reference(s, t["img"], t["block_pos"], t["pool_idx"], count,
                                   t["tsdf"], t["rgbw"], t["prob"], **consts)[:33]
           for s in range(len(sp.FUSE_STAGES))]
    assert torch.equal(out[0], t["tsdf"][t["pool_idx"][:33].long()].abs().amin(-1))
    assert (out[1] >= out[0]).all() and (out[2] >= out[1]).all()
    assert torch.isfinite(out[1]).any() and torch.isinf(out[2]).any()


def test_fuse_stage_gate_holds_every_voxel_fuse_rows_changes():
    """P5: each stripped stage writes back the pool words of the voxels it
    lets through; the sampling stage lets through every voxel whose words
    the plain fuse_rows changes, so it moves the fusion's bytes; the
    stages let fewer voxels through, stage by stage."""
    from disinfect_slam_tpu_torch.ops.cuda import fuse_kernel

    c = block_case(7, 48, 64, 40, 33, 64)
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("img", "block_pos", "pool_idx", "tsdf", "rgbw", "prob")}
    gate = dict(cam_T_world=c["pose"], intrinsics=c["intrinsics"], voxel_size=c["voxel_size"],
                truncation=0.06, max_depth=4.0)
    count = torch.tensor(33, dtype=torch.int32)
    keep = [sp.stage_keep(s, t["img"], t["block_pos"], t["pool_idx"], count, **gate)
            for s in range(len(sp.FUSE_STAGES))]
    pool = [t[k].clone() for k in ("tsdf", "rgbw", "prob")]
    fuse_kernel.fuse_rows_reference(t["img"], t["block_pos"], t["pool_idx"], count, *pool,
                                    max_weight=40.0, **gate)
    live = t["pool_idx"][:33].long()
    changed = torch.zeros_like(keep[2])
    for a, a0 in zip(pool, (t["tsdf"], t["rgbw"], t["prob"])):
        changed |= a[live] != a0[live]
    assert changed.any() and not (changed & ~keep[2]).any()
    through = [int(k.sum()) for k in keep]
    assert through[0] == 33 * 512 and through[0] > through[1] > through[2] > 0
