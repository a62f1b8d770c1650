"""PyTorch port, the splat kernels' block contract: the plain versions of
splat_zbuf_blocks / splat_payload_blocks (block positions, pool indices,
the tsdf pool and the pose in; the projection the kernels repeat in
registers) against render_fast's plain splat and the JAX package's XLA
and Pallas (interpret mode) splats on the golden scenes, against a numpy
transcription of the same float32 steps on synthetic block rows (rows
behind the camera, voxels at camera z = 0, no live row, every row live),
and at the float32 thresholds of the surface band and the max depth.
(The CUDA kernels are held against these plain versions on the card:
tests/test_torch_gpu.py and chip_smoke.py.)"""

import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU in this process)
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.ops import render_fast as jrf
from disinfect_slam_tpu.ops.pallas.splat_kernel import splat_render_pallas
from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.ops import render_fast as rf
from disinfect_slam_tpu_torch.ops.cuda import splat_kernel as sk

from .test_integrate import H, K, MAX_DEPTH, W
from .test_splat_kernel import _fused_scene
from .test_torch_hash import port_from_jax
from .torch_cases import splat_block_case, splat_edge_cases

torch.set_num_threads(1)

CAM = CameraParams.create(CameraIntrinsics.create(*K), H, W)
EYES = {"normal": (0.21, -0.33, -0.27), "close": (0.05, 0.1, 0.55)}


def _block_args(vol, pose, surf_cap=rf.DEFAULT_SURF_CAP, max_depth=MAX_DEPTH):
    vis, _ = rf.splat_visible(vol, CAM, pose, 1.25, surf_cap)
    geometry = dict(cam_T_world=pose, cam=CAM, voxel_size=vol.cfg.voxel_size,
                    truncation=vol.cfg.truncation, max_depth=max_depth, band=1.25)
    return (vis.block_pos, vis.pool_idx, vis.count), geometry


def _block_buffers(vol, pose, **kw):
    rows, geometry = _block_args(vol, pose, **kw)
    zbuf = sk.splat_zbuf_blocks_reference(*rows, vol.tsdf, **geometry)
    pbuf = sk.splat_payload_blocks_reference(*rows, vol.tsdf, vol.rgbw, vol.prob, zbuf,
                                             **geometry)
    return zbuf, pbuf


@pytest.mark.parametrize("eye", list(EYES))
def test_block_references_give_render_fast_buffers(eye):
    """On the golden scenes, with the render's surface rows, with half of
    them and with none: both buffers equal render_fast.splat_buffers',
    and the wrappers on CPU tensors run the plain versions, launching
    nothing."""
    vol_j, _, pose_np = _fused_scene(EYES[eye])
    vol, pose = port_from_jax(vol_j), SE3.from_matrix(pose_np)
    kept = int(rf.splat_buffers(vol, CAM, pose, MAX_DEPTH)[3])
    assert kept > 4
    before = (sk.splat_zbuf_blocks.launches, sk.splat_payload_blocks.launches)
    for cap in (rf.DEFAULT_SURF_CAP, kept // 2, 0):
        zref, pref, _, _ = rf.splat_buffers(vol, CAM, pose, MAX_DEPTH, surf_cap=cap)
        zbuf, pbuf = _block_buffers(vol, pose, surf_cap=cap)
        assert torch.equal(zbuf, zref) and torch.equal(pbuf, pref)
        bufs = sk.splat_buffers_cuda(vol, CAM, pose, MAX_DEPTH, surf_cap=cap)
        assert torch.equal(bufs[0], zref) and torch.equal(bufs[1], pref)
        if cap == 0:
            assert (zbuf == sk.BIG).all() and (pbuf == 0).all()
        else:
            assert (zbuf < sk.BIG).any() and (pbuf != 0).any()
    assert (sk.splat_zbuf_blocks.launches, sk.splat_payload_blocks.launches) == before


def test_block_references_match_jax_xla_and_pallas():
    """The close view (block footprints past the TPU patch): the block
    references' buffers through images_from_buffers give the images of
    JAX's XLA splat and of its Pallas splat in interpret mode, bit for
    bit."""
    vol_j, _, pose_np = _fused_scene(EYES["close"])
    vol = port_from_jax(vol_j)
    ours = rf.images_from_buffers(*_block_buffers(vol, SE3.from_matrix(pose_np)), CAM)
    jcam = JCam.create(JIntr.create(*K), H, W)
    jpose = JSE3.from_matrix(pose_np)
    for ref in (jrf.splat_render(vol_j, jcam, jpose, MAX_DEPTH),
                splat_render_pallas(vol_j, jcam, jpose, MAX_DEPTH, interpret=True)):
        for f in ("hit", "depth", "rgba", "normal"):
            np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f)
    assert ours.hit.float().mean() > 0.05


def _numpy_splat(c, count, img_h, img_w):
    """The splat of the block rows in numpy float32, op for op as the
    docstring of csrc/splat_project.cuh states it, then the min and max
    merges with ufunc.at -> (zbuf i32, pbuf u32 bits as i32, surf)."""
    f32 = np.float32
    bp = c["block_pos"].astype(np.int64)
    t = np.arange(512)
    vs = f32(c["voxel_size"])
    p = [((bp[:, i:i + 1] << 3) + o).astype(f32) * vs
         for i, o in enumerate((t & 7, (t >> 3) & 7, t >> 6))]
    r = [f32(x) for x in c["pose"].rotation_entries()]
    tt = c["pose"].t.astype(f32)
    xc, yc, z = (((r[3 * i] * p[0] + r[3 * i + 1] * p[1]) + r[3 * i + 2] * p[2]) + tt[i]
                 for i in range(3))
    k = c["intrinsics"]
    with np.errstate(divide="ignore", invalid="ignore"):
        uf = (f32(k.fx) * xc + f32(k.cx) * z) / z
        vf = (f32(k.fy) * yc + f32(k.cy) * z) / z
    fin = np.isfinite(uf) & np.isfinite(vf)
    ru = np.where(uf >= 0, np.floor(uf + f32(0.5)), np.ceil(uf - f32(0.5)))
    rv = np.where(vf >= 0, np.floor(vf + f32(0.5)), np.ceil(vf - f32(0.5)))
    ru, rv = np.where(fin, ru, -1), np.where(fin, rv, -1)
    in_img = fin & (ru >= 0) & (ru < img_w) & (rv >= 0) & (rv < img_h)
    in_img &= (z > 0) & (z <= f32(c["max_depth"]))
    pool = np.clip(c["pool_idx"], 0, c["tsdf"].shape[0] - 1)
    tsdf = c["tsdf"][pool]
    band = f32(c["band"] * c["voxel_size"] / c["truncation"])
    surf = (np.arange(bp.shape[0]) < count)[:, None] & in_img & (np.abs(tsdf) < band)
    rng = np.sqrt(((xc * xc + yc * yc) + z * z).astype(np.float64)).astype(f32)
    rng = np.where(rng == 0, f32(1), rng)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        zc = z + ((tsdf * f32(c["truncation"])) * z) / rng
        dq = np.clip(zc * f32(4096), 0, f32(2**29))
    dq = np.where(surf, dq, 0).astype(np.int64)
    u0 = np.where(surf, np.floor(uf), 0).astype(np.int64)
    v0 = np.where(surf, np.floor(vf), 0).astype(np.int64)
    n = img_h * img_w
    pix = []
    for du in (0, 1):
        for dv in (0, 1):
            uu, vv = u0 + du, v0 + dv
            ok = surf & (uu >= 0) & (uu < img_w) & (vv >= 0) & (vv < img_h)
            pix.append(np.where(ok, vv * img_w + uu, n))
    pix = np.stack(pix)
    zbuf = np.full(n + 1, sk.BIG, np.int64)
    np.minimum.at(zbuf, pix.ravel(), np.broadcast_to(dq, pix.shape).ravel())
    w = c["rgbw"][pool].astype(np.int64) & 0xFFFFFFFF
    p8 = np.clip(c["prob"][pool] * f32(255), 0, 255).astype(np.int64)
    word = (p8 << 24) | ((w & 0xFF) << 16) | (((w >> 8) & 0xFF) << 8) | ((w >> 16) & 0xFF)
    won = (pix < n) & (dq == zbuf[np.minimum(pix, n - 1)])
    pbuf = np.zeros(n + 1, np.int64)
    np.maximum.at(pbuf, np.where(won, pix, n).ravel(),
                  np.broadcast_to(word, pix.shape).ravel())
    return (zbuf[:n].astype(np.int32), pbuf[:n].astype(np.uint32).view(np.int32), surf)


@pytest.mark.parametrize("count", [0, 50, 64], ids=["none", "some", "all"])
@pytest.mark.parametrize("about_z", [False, True], ids=["tilted", "about_z"])
def test_block_references_match_numpy_on_block_rows(about_z, count):
    """Synthetic block rows (tests/torch_cases.py): rows behind the
    camera and, about_z, voxels at camera z = 0 take no part; both
    buffers equal the numpy transcription bit for bit."""
    c = splat_block_case(5, 48, 64, 64, 50, 256, voxel_size=0.05, truncation=0.15,
                         about_z=about_z)
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("block_pos", "pool_idx", "tsdf", "rgbw", "prob")}
    n = torch.tensor(count, dtype=torch.int32)
    geometry = dict(cam_T_world=c["pose"],
                    cam=CameraParams.create(c["intrinsics"], 48, 64),
                    voxel_size=c["voxel_size"], truncation=c["truncation"],
                    max_depth=c["max_depth"], band=c["band"])
    zbuf = sk.splat_zbuf_blocks(t["block_pos"], t["pool_idx"], n, t["tsdf"], **geometry)
    pbuf = sk.splat_payload_blocks(t["block_pos"], t["pool_idx"], n, t["tsdf"], t["rgbw"],
                                   t["prob"], zbuf, **geometry)
    zref, pref, surf = _numpy_splat(c, count, 48, 64)
    np.testing.assert_array_equal(zbuf.numpy(), zref)
    np.testing.assert_array_equal(pbuf.numpy(), pref)
    _, _, _, surf_t = rf.project_splat_rows(
        t["block_pos"], t["pool_idx"], n, t["tsdf"], geometry["cam_T_world"],
        geometry["cam"], c["voxel_size"], c["truncation"], c["max_depth"], c["band"])
    np.testing.assert_array_equal(surf_t.numpy(), surf)
    if count == 0:
        assert (zbuf == sk.BIG).all() and (pbuf == 0).all()
        return
    # the corners the case claims, from the camera z of every voxel
    from disinfect_slam_tpu_torch.ops.cuda.fuse_kernel import project_rows

    _, _, z = project_rows(t["block_pos"], c["pose"], c["intrinsics"], c["voxel_size"])
    z = z.numpy()[:count]
    assert (z < 0).any() and not surf[:count][z <= 0].any()
    assert ((z == 0).any() == about_z)
    assert 0.1 < surf[:count].mean() < 0.9 and (pbuf < 0).any()


@pytest.mark.parametrize("case", splat_edge_cases(), ids=lambda c: c[0] if isinstance(c, tuple) else "")
def test_projection_at_the_float32_thresholds(case):
    """A voxel one float32 ulp either side of max_depth and of the band
    edge, and a max_depth that rounds to the voxel's z: the torch
    projection compares in float32, with the Python scalars rounded to
    float32, and the block references follow it."""
    label, c, (row, vox), in_band = case
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("block_pos", "pool_idx", "tsdf", "rgbw", "prob")}
    n = torch.tensor(c["count"], dtype=torch.int32)
    cam = CameraParams.create(c["intrinsics"], 48, 64)
    _, _, _, surf = rf.project_splat_rows(
        t["block_pos"], t["pool_idx"], n, t["tsdf"], c["pose"], cam, c["voxel_size"],
        c["truncation"], c["max_depth"], c["band"])
    assert bool(surf[row, vox]) == in_band, label
    zref, pref, surf_np = _numpy_splat(c, c["count"], 48, 64)
    assert bool(surf_np[row, vox]) == in_band, label
    geometry = dict(cam_T_world=c["pose"], cam=cam, voxel_size=c["voxel_size"],
                    truncation=c["truncation"], max_depth=c["max_depth"], band=c["band"])
    zbuf = sk.splat_zbuf_blocks_reference(t["block_pos"], t["pool_idx"], n, t["tsdf"],
                                          **geometry)
    np.testing.assert_array_equal(zbuf.numpy(), zref)
