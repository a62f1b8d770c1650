"""Seeded numpy inputs for the block-position contract of fuse_rows and
of the splat kernels, shared by the port's CPU and GPU tests and
chip_smoke.py (no JAX here: the GPU host has none).

A smooth synthetic frame and visible block rows placed about its surface
through a pinhole camera and a pose, so that most voxels project into the
image near their pixel's depth, plus the corners the kernel must place
where the torch path does: rows behind the camera, rows projecting off
the image and, with a pose that rotates about the optical axis, voxels at
camera z = 0 exactly (z = pz + t2 with t2 = -pz), and, for the splat
kernels, rows near the camera whose footprints outgrow the kernels' tile
and voxels one float32 ulp either side of the band and depth thresholds."""

import numpy as np

from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics

MAX_DEPTH = 4.0
SPLAT_BAND = 1.25  # the splat renderer's band half-width in voxels
Z0_INDEX = 40  # voxel z index (block 5, offset 0) that lands at camera z = 0


def _rotation(rng, about_z: bool) -> np.ndarray:
    if about_z:
        a = rng.uniform(-0.6, 0.6)
        return np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                         [0.0, 0.0, 1.0]])
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(0.2, 0.8)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def block_case(seed, img_h, img_w, rows, count, pool_rows, voxel_size=0.008,
               about_z=False, with_pool=True, near_share=0.0):
    """(dict of numpy arrays and Python values) for fuse_rows: img f32
    [H, W, 8]; block_pos i32 [rows, 3]; pool_idx i32 [rows] (padding past
    count); count; tsdf/rgbw/prob pools [pool_rows, 512] (left out
    without `with_pool`, for callers that fill a large pool on the
    device); pose (SE3), intrinsics (CameraIntrinsics), voxel_size.
    near_share: the share of the live rows placed 0.12-0.3 m from the
    camera instead of about the surface."""
    rng = np.random.default_rng(seed)
    f = 0.8 * img_w
    intr = CameraIntrinsics.create(f, f * 1.01, img_w / 2 - 0.37, img_h / 2 + 0.21)
    rot = _rotation(rng, about_z)
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    if about_z:
        # camera z = pz + t2 exactly (r20 = r21 = 0, r22 = 1): voxels of z
        # index Z0_INDEX sit at z = 0
        m[2, 3] = -(np.float32(Z0_INDEX) * np.float32(voxel_size))
    pose = SE3.from_matrix(m)
    if about_z:
        r = pose.rotation_entries()
        assert r[6] == 0.0 and r[7] == 0.0 and r[8] == 1.0, r

    uu, vv = np.meshgrid(np.arange(img_w), np.arange(img_h))
    surf = 1.0 + 1.5 * (0.5 + 0.5 * np.sin(uu / 37.0) * np.cos(vv / 23.0))
    img = np.zeros((img_h, img_w, 8), np.float32)
    img[..., 0] = surf + rng.uniform(-0.01, 0.01, (img_h, img_w))
    img[..., 0][rng.uniform(size=(img_h, img_w)) < 0.05] = 0.0
    img[..., 0][rng.uniform(size=(img_h, img_w)) < 0.03] = MAX_DEPTH
    img[..., 1] = rng.uniform(1.0, 1.3, (img_h, img_w))
    img[..., 2:5] = rng.integers(0, 256, (img_h, img_w, 3))
    img[..., 5:7] = rng.uniform(0, 1, (img_h, img_w, 2))
    img[..., 5][rng.uniform(size=(img_h, img_w)) < 0.03] = 0.0
    img[..., 6][rng.uniform(size=(img_h, img_w)) < 0.03] = 1.0

    # each row: a pixel (10% off the image), a depth about the surface
    # there (5% of the live rows behind the camera), back-projected and
    # moved to the world
    pu = rng.uniform(-0.15, 1.15, rows) * img_w
    pv = rng.uniform(-0.15, 1.15, rows) * img_h
    on = (pu >= 0) & (pu < img_w) & (pv >= 0) & (pv < img_h)
    d = np.where(on, surf[np.clip(pv.astype(int), 0, img_h - 1),
                          np.clip(pu.astype(int), 0, img_w - 1)], 2.0)
    d = d + rng.uniform(-0.03, 0.03, rows)
    behind = np.zeros(rows, bool)
    behind[rng.choice(count, max(2, count // 20) if count >= 2 else 0, replace=False)] = True
    d[behind] = -rng.uniform(0.2, 2.0, behind.sum())
    if near_share > 0:
        near = rng.choice(np.flatnonzero(~behind[:count]), int(near_share * count),
                          replace=False)
        pu[near] = rng.uniform(0.2, 0.8, near.size) * img_w
        pv[near] = rng.uniform(0.2, 0.8, near.size) * img_h
        d[near] = rng.uniform(0.12, 0.3, near.size)
    cam_pts = np.stack([(pu - intr.cx) / intr.fx * d, (pv - intr.cy) / intr.fy * d, d], -1)
    world = (cam_pts - m[:3, 3]) @ rot  # R^T (p - t)
    block_pos = np.floor(world / (8 * voxel_size) - 0.5).astype(np.int32)
    if about_z:
        block_pos[: max(1, rows // 20), 2] = Z0_INDEX // 8
    pool_idx = rng.permutation(pool_rows)[:rows].astype(np.int32)
    pool_idx[count:] = pool_rows  # padding rows, as compact_mask leaves them
    block_pos[count:] = 0
    case = dict(img=img, block_pos=block_pos, pool_idx=pool_idx, count=count, pose=pose,
                intrinsics=intr, voxel_size=voxel_size)
    if not with_pool:
        return case

    tsdf = rng.uniform(-1, 1, (pool_rows, 512)).astype(np.float32)
    w = rng.integers(0, 41, (pool_rows, 512))
    w[rng.uniform(size=w.shape) < 0.2] = 0
    rgbw = (rng.integers(0, 1 << 24, (pool_rows, 512)) | (w << 24)).astype(np.int32)
    prob = rng.uniform(0, 1, (pool_rows, 512)).astype(np.float32)
    prob[rng.uniform(size=prob.shape) < 0.05] = 0.0
    prob[rng.uniform(size=prob.shape) < 0.05] = 1.0
    return dict(case, tsdf=tsdf, rgbw=rgbw, prob=prob)


def splat_pool(rng, pool_rows, voxel_size, truncation, band=SPLAT_BAND):
    """tsdf f32, rgbw i32, prob f32 [pool_rows, 512] for the splat
    kernels: 60% of voxels inside the surface band, their tsdf from 8
    levels so that neighbouring voxels tie at a pixel; random payload
    words, half the probabilities at or above 0.5 (packed words with the
    top bit set), 10% of them 0 and 10% 1."""
    band_tsdf = band * voxel_size / truncation
    levels = (np.arange(-3.5, 4.0) / 4.0 * band_tsdf).astype(np.float32)
    outside = np.where(rng.uniform(size=(pool_rows, 512)) < 0.5, -1.0, 1.0) * rng.uniform(
        1.01 * band_tsdf, max(1.0, 1.02 * band_tsdf), (pool_rows, 512))
    tsdf = np.where(rng.uniform(size=(pool_rows, 512)) < 0.6,
                    rng.choice(levels, (pool_rows, 512)), outside).astype(np.float32)
    w = rng.integers(0, 41, (pool_rows, 512))
    rgbw = (rng.integers(0, 1 << 24, (pool_rows, 512)) | (w << 24)).astype(np.int32)
    prob = rng.uniform(0, 1, (pool_rows, 512)).astype(np.float32)
    prob[rng.uniform(size=prob.shape) < 0.1] = 0.0
    prob[rng.uniform(size=prob.shape) < 0.1] = 1.0
    return tsdf, rgbw, prob


def splat_block_case(seed, img_h, img_w, rows, count, pool_rows, voxel_size=0.008,
                     truncation=0.024, about_z=False, near_share=0.05, with_pool=True):
    """(dict) for the splat kernels' block contract: block_pos i32 [rows,
    3] and pool_idx i32 [rows] from block_case (rows behind the camera and
    off the image, with `about_z` voxels at camera z = 0 and, about the
    optical axis, every voxel of a block layer at one depth, so that more
    voxels tie), near_share of the live rows near the camera (footprints
    wider than the kernels' 32x32 tile), count; pose, intrinsics,
    voxel_size, truncation, max_depth, band; with `with_pool` the pool
    arrays of splat_pool."""
    c = block_case(seed, img_h, img_w, rows, count, pool_rows, voxel_size=voxel_size,
                   about_z=about_z, with_pool=False, near_share=near_share)
    del c["img"]
    case = dict(c, truncation=truncation, max_depth=MAX_DEPTH, band=SPLAT_BAND)
    if not with_pool:
        return case
    tsdf, rgbw, prob = splat_pool(np.random.default_rng(seed + 7919), pool_rows, voxel_size,
                                  truncation)
    return dict(case, tsdf=tsdf, rgbw=rgbw, prob=prob)


def _next32(x, toward):
    return float(np.nextafter(np.float32(x), np.float32(toward)))


def splat_edge_cases(seed=3, img_h=48, img_w=64, rows=16, count=12, pool_rows=64):
    """Variants of one splat_block_case that put one voxel (row 0's
    first voxel well inside the image) at the float32 thresholds the
    kernels share with the torch projection, with whether it must be in
    the surface band: -> [(label, case, (row, voxel), in_band)].

    Depth: max_depth equal to the voxel's camera z, one float32 ulp either
    side, and a Python float below z that rounds to z in float32 (torch
    compares in float32; a float64 comparison would leave the voxel out).
    Band: |tsdf| equal to band_tsdf rounded to float32 and one ulp below,
    of either sign, band_tsdf being a Python float that float32 rounds
    down (so a float64 comparison would take the voxel in)."""
    import torch

    from disinfect_slam_tpu_torch.ops.cuda.fuse_kernel import project_rows

    base = splat_block_case(seed, img_h, img_w, rows, count, pool_rows, near_share=0.0)
    u, v, z = (a.numpy() for a in project_rows(torch.from_numpy(base["block_pos"]),
                                                base["pose"], base["intrinsics"],
                                                base["voxel_size"]))
    ok = ((u >= 2) & (u < img_w - 2) & (v >= 2) & (v < img_h - 2) & (z > 0.5)
          & (z < MAX_DEPTH - 0.5))
    ok[count:] = False
    row, vox = (int(i) for i in np.argwhere(ok)[0])
    zv = float(z[row, vox])
    pool = int(base["pool_idx"][row])
    band_tsdf = base["band"] * base["voxel_size"] / base["truncation"]
    bt32 = float(np.float32(band_tsdf))
    assert bt32 < band_tsdf, (bt32, band_tsdf)

    def case(label, in_band, max_depth=MAX_DEPTH, tsdf=0.0):
        c = dict(base, max_depth=max_depth, tsdf=base["tsdf"].copy())
        c["tsdf"][pool, vox] = tsdf
        return (label, c, (row, vox), in_band)

    ulp = zv - _next32(zv, 0.0)
    return [
        case("z == max_depth", True, max_depth=zv),
        case("z one ulp above max_depth", False, max_depth=_next32(zv, 0.0)),
        case("z one ulp below max_depth", True, max_depth=_next32(zv, np.inf)),
        case("max_depth rounds up to z", True, max_depth=zv - 0.25 * ulp),
        case("tsdf == band", False, tsdf=bt32),
        case("tsdf == -band", False, tsdf=-bt32),
        case("tsdf one ulp inside the band", True, tsdf=_next32(bt32, 0.0)),
        case("-tsdf one ulp inside the band", True, tsdf=-_next32(bt32, 0.0)),
    ]


# the loop-closure fixture of tests/test_loop_closure.py (which imports
# JAX), restated for the GPU tests and chip_smoke.py; a CPU test pins the
# two copies together
LC_K, LC_W, LC_H = (131.7, 132.3, 79.7, 59.4), 160, 120
LC_CENTER = np.array([0.1, 0.0, 1.5])
LC_ARGS = dict(kf_every=1, min_gap_frames=50, sim_thresh=0.97, verify_max_rmse=0.05,
               verify_min_inliers=800, max_keyframes=64)


def lc_scene_depth(pose):
    """Two spheres before a wall at 160x120."""
    from .scenes import render_sphere, render_wall

    d1 = render_sphere(LC_W, LC_H, LC_K, pose, center=LC_CENTER, radius=0.45)
    d2 = render_wall(LC_W, LC_H, LC_K, pose, wall_z=2.4131)
    d3 = render_sphere(LC_W, LC_H, LC_K, pose, center=(-0.5, 0.3, 1.9), radius=0.3)
    d = np.where(d1 > 0, d1, d2)
    return np.where(d3 > 0, d3, d).astype(np.float32)


def out_and_back_keyframes():
    """12 keyframes out along +x and back to the start pose, with a
    growing injected world-frame drift on the estimates: (true world_T_cam,
    estimated world_T_cam, depth) lists."""
    from .scenes import look_at

    xs = [0.0, 0.06, 0.12, 0.18, 0.24, 0.30, 0.30, 0.24, 0.18, 0.12, 0.06, 0.0]
    true_poses, est_poses, depths = [], [], []
    for k, x in enumerate(xs):
        pose_cw = look_at((x, 0.0, -1.5), LC_CENTER + np.array([x * 0.3, 0, 0]))
        wc = np.linalg.inv(pose_cw).astype(np.float32)
        drift = np.eye(4, dtype=np.float32)
        drift[:3, 3] = [0.006 * k, 0.0, 0.003 * k]
        true_poses.append(wc)
        est_poses.append((drift @ wc).astype(np.float32))
        depths.append(lc_scene_depth(pose_cw))
    return true_poses, est_poses, depths
