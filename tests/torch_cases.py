"""Seeded numpy inputs for fuse_rows' block-position contract, shared by
the port's CPU and GPU tests and chip_smoke.py (no JAX here: the GPU host
has none).

A smooth synthetic frame and visible block rows placed about its surface
through a pinhole camera and a pose, so that most voxels project into the
image near their pixel's depth, plus the corners the kernel must place
where the torch path does: rows behind the camera, rows projecting off
the image and, with a pose that rotates about the optical axis, voxels at
camera z = 0 exactly (z = pz + t2 with t2 = -pz)."""

import numpy as np

from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics

MAX_DEPTH = 4.0
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
               about_z=False, with_pool=True):
    """(dict of numpy arrays and Python values) for fuse_rows: img f32
    [H, W, 8]; block_pos i32 [rows, 3]; pool_idx i32 [rows] (padding past
    count); count; tsdf/rgbw/prob pools [pool_rows, 512] (left out
    without `with_pool`, for callers that fill a large pool on the
    device); pose (SE3), intrinsics (CameraIntrinsics), voxel_size."""
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
