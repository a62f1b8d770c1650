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


# the soak of tests/test_soak.py (which imports JAX): its corridor, its
# configuration and its assertions, restated for tests/test_torch_soak.py
# and chip_smoke.py; tests/test_torch_soak.py pins the corridor to the JAX
# test's
SOAK_W, SOAK_H = 96, 72
SOAK_K = (80.0, 80.0, 47.5, 35.5)
SOAK_WALL_Z = 2.4
SOAK_CORRIDOR_M = 8.0  # beyond the 32-block (10.24 m) grid half-extent
SOAK_KF_CAP = 24
SOAK_START_BBOX = (-1.2, 1.6, -1.2, 1.2, 0.5, 2.6)


def soak_corridor_depth(x: float):
    """(depth f32 [72, 96], cam_T_world) of a camera at (x, 0, -0.5)
    looking +z: the back wall and spheres spaced along the corridor with
    varied offsets and radii (period 9.6 m, longer than the corridor)."""
    from .scenes import look_at, render_sphere, render_wall

    pose = look_at((x, 0.0, -0.5), (x, 0.0, 2.0))
    d = render_wall(SOAK_W, SOAK_H, SOAK_K, pose, wall_z=SOAK_WALL_Z)
    k0 = max(int((x - 1.6) / 0.8), -1)
    for k in range(k0, k0 + 6):
        c = (0.8 * k + 0.2, 0.25 * (-1) ** k, 1.25 + 0.15 * (k % 3))
        r = 0.16 + 0.03 * (k % 4)
        ds = render_sphere(SOAK_W, SOAK_H, SOAK_K, pose, center=c, radius=r)
        d = np.where(ds > 0, ds, d)
    return d.astype(np.float32), pose


def soak_x(i: int, n_frames: int) -> float:
    """The camera's x (m) at frame i of an n_frames soak: out along the
    corridor for the first half, back for the second."""
    half = n_frames // 2
    return (i if i < half else (n_frames - 1 - i)) * (SOAK_CORRIDOR_M / half)


def make_soak_slam(device, capture: bool = True):
    """The soak's DenseSLAM: loop closure, host spill and the keyframe cap
    on a 32^3-block dense window of 4 cm voxels."""
    from disinfect_slam_tpu_torch.config import TSDFConfig
    from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM

    cfg = TSDFConfig(voxel_size=0.04, truncation=0.12, num_blocks_log2=10,
                     max_candidates=4096, max_visible=1024, max_new_per_round=512,
                     backend="dense", grid_log2=5)
    return DenseSLAM(SOAK_K, SOAK_H, SOAK_W, voxel_size=0.04, truncation=0.12,
                     max_depth=4.0, cfg=cfg, host_spill=True, loop_closure=True,
                     kf_every=10, lc_kwargs=dict(max_keyframes=SOAK_KF_CAP,
                                                 min_gap_frames=200,
                                                 verify_min_inliers=400),
                     device=device, capture=capture)


def soak_feed(n_frames: int):
    """feed(i, slam) of the soak's corridor at n_frames, as run_soak feeds
    it: frame i's depth, then maybe_recenter every 25 frames."""
    from .scenes import checker_rgb

    rgb = checker_rgb(SOAK_W, SOAK_H)

    def feed(i, slam):
        depth, _ = soak_corridor_depth(soak_x(i, n_frames))
        slam.process_frame(rgb, depth)
        if i % 25 == 24:
            slam.maybe_recenter()

    return feed


def run_soak(n_frames: int, device, on_frame=None):
    """The corridor out and back through DenseSLAM with loop closure, host
    spill, maybe_recenter every 25 frames and the keyframe cap -> (the
    counts the soak asserts on and the wall time, the DenseSLAM after its
    last frame, x = 0).  on_frame(i, slam), when given, runs after each
    frame's step and recenter."""
    import time

    import torch

    from disinfect_slam_tpu_torch.ops.gather import BoundingCube, gather_voxels

    from .scenes import checker_rgb

    slam = make_soak_slam(device)
    rgb = checker_rgb(SOAK_W, SOAK_H)
    bbox = BoundingCube(*SOAK_START_BBOX)

    def observed():
        st = gather_voxels(slam.volume, bbox)
        return int((st.weight[st.mask] > 0).sum())

    recenters = spill_high = 0
    start_hist = None
    t0 = time.perf_counter()
    for i in range(n_frames):
        depth, _ = soak_corridor_depth(soak_x(i, n_frames))
        slam.process_frame(rgb, depth)
        if i % 25 == 24:
            if slam.maybe_recenter():
                recenters += 1
            spill_high = max(spill_high, len(slam.spill_store))
        if i == 100:  # history near the start, before it spills out
            start_hist = observed()
        if on_frame is not None:
            on_frame(i, slam)
    if slam.device.type == "cuda":
        torch.cuda.synchronize(slam.device)
    wall_s = time.perf_counter() - t0
    res = {"frames": n_frames, "wall_s": wall_s, "ms_per_frame": 1e3 * wall_s / n_frames,
           "lost": slam.lost_count, "recenters": recenters, "spill_high": spill_high,
           "keyframes": slam.lc.count, "evictions": slam.lc.evictions,
           "closures": slam.lc.closures, "start_hist": start_hist, "end_hist": observed(),
           "end_t": np.asarray(slam.world_T_cam, np.float64)[:3, 3].tolist()}
    return res, slam


def check_soak(res: dict) -> None:
    """tests/test_soak.py's assertions on run_soak's counts."""
    n = res["frames"]
    # tracking survived the whole corridor
    assert res["lost"] <= n // 100, f"lost {res['lost']} frames"
    # the corridor outruns the grid: recentering and spill ran
    assert res["recenters"] >= 2, res["recenters"]
    assert res["spill_high"] > 0, "host spill never engaged"
    # the keyframe database stayed bounded and kept operating past the cap
    assert res["keyframes"] <= SOAK_KF_CAP, res["keyframes"]
    assert res["evictions"] > 0, "cap eviction never exercised"
    # returning to the start closed a loop
    assert res["closures"] >= 1, "no loop closed on return"
    # history kept across spill and restore
    start, end = res["start_hist"], res["end_hist"]
    assert start and start > 500, start
    assert end >= 0.9 * start, (start, end)
    # the tracked end pose came back near the start
    end_t = np.asarray(res["end_t"])
    assert np.linalg.norm(end_t - np.array([0.0, 0.0, -0.5])) < 0.5, end_t


# the counts of data/soak_fingerprint.json (scripts/port_soak_fingerprint.py)
SOAK_FP_KEYS = ("lost", "recenters", "spill_high", "keyframes", "evictions", "closures",
                "start_hist", "end_hist", "end_t")


def soak_fingerprint() -> dict:
    """The JAX soak's counts at 1000 frames (data/soak_fingerprint.json)."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "disinfect_slam_tpu_torch", "data", "soak_fingerprint.json")
    with open(path) as f:
        return json.load(f)


def check_soak_fingerprint(res: dict, ref: dict) -> None:
    """run_soak's counts against the JAX soak's on the same corridor: the
    loss, recenter, keyframe, eviction and closure counts equal; the rest
    within about 3x the larger gap of the port on the CPU and on the card
    at 1000 frames (gaps: spill high 1 block, the start region 1 voxel,
    the end region 1536 of 31232 voxels, the end position 0.033 m;
    limits: 3 blocks, 8 voxels (0.1%), 15%, 0.1 m; measured with
    scripts/port_soak_fingerprint.py --port and chip_smoke.py), since the
    corridor's weakly constrained x direction amplifies ulps."""
    assert res["frames"] == ref["frames"], (res["frames"], ref["frames"])
    for key in ("lost", "recenters", "keyframes", "evictions", "closures"):
        assert res[key] == ref[key], (key, res[key], ref[key])
    for key, limit in (("spill_high", 3), ("start_hist", 8),
                       ("end_hist", 0.15 * ref["end_hist"])):
        assert abs(res[key] - ref[key]) <= limit, (key, res[key], ref[key], limit)
    gap = float(np.linalg.norm(np.asarray(res["end_t"]) - np.asarray(ref["end_t"])))
    assert gap < 0.1, ("end_t", res["end_t"], ref["end_t"], gap)


# ----------------------------------------------------------------------
# the stereo scene: io/orbit_scene.py's sphere before a wall seen from two
# cameras at datasets/orbit_vga's poses and intrinsics, shaded by one
# world-anchored texture, for the stereo tests, the JAX fingerprint
# (scripts/port_stereo_fingerprint.py) and chip_smoke.py.  Only numpy's
# elementwise float64 ops, floor and sqrt run (no BLAS, no reduction, no
# transcendental function), so every machine makes the same bytes.
# ----------------------------------------------------------------------
STEREO_BASELINE = 0.12  # m: the right camera sits this far along the left one's +x
STEREO_FRAMES = 60
STEREO_SEED = 11
ORBIT_VGA_K = (525.1, 525.3, 319.6, 239.7)  # datasets/orbit_vga/cam.yaml
ORBIT_SPHERE_C, ORBIT_SPHERE_R, ORBIT_WALL_Z = (0.013, -0.021, 1.007), 0.413, 2.213
# the texture: value noise on a lattice of these cell sizes (m), weighted
# (1.5 cm is 3-8 px at the scene's 1-3 m: finer than a 7x9 window, and a
# 256-cell lattice does not repeat within the image)
STEREO_CELLS, STEREO_WEIGHTS = (0.015, 0.045), (0.6, 0.4)


# tests/test_io.py:122-160's ZED factory calibration (VGA, t_x < 0)
ZED_FACTORY_CONF = (
    "[LEFT_CAM_VGA]\n"
    "fx=350.1\nfy=350.7\ncx=336.2\ncy=188.9\n"
    "k1=-0.17\nk2=0.025\n"
    "[RIGHT_CAM_VGA]\n"
    "fx=349.8\nfy=350.2\ncx=336.9\ncy=189.4\n"
    "k1=-0.171\nk2=0.026\np1=0.0002\n"
    "[STEREO]\n"
    "Baseline=119.887\nTY=0.05\nTZ=-0.21\n"
    "RX_VGA=0.001\nCV_VGA=0.003\nRZ_VGA=-0.0004\n"
)


def orbit_vga_poses(dataset_dir: str) -> list:
    """cam_T_world float64 [4, 4] of each row of the dataset's
    trajectory.txt, in file order."""
    poses = []
    with open(f"{dataset_dir}/trajectory.txt") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 13:
                m = np.eye(4)
                m[:3, :4] = np.array([float(x) for x in parts[1:]]).reshape(3, 4)
                poses.append(m)
    return poses


def _noise_tables(seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.permutation(256), rng.uniform(0.0, 1.0, (3, 256))) for _ in STEREO_CELLS]


def _value_noise(px, py, pz, cell, perm, vals):
    """Trilinear value noise of the world point, three channels."""
    gx, gy, gz = px / cell, py / cell, pz / cell
    ix, iy, iz = np.floor(gx), np.floor(gy), np.floor(gz)
    fx, fy, fz = gx - ix, gy - iy, gz - iz
    sx, sy, sz = (f * f * (3.0 - 2.0 * f) for f in (fx, fy, fz))
    ix, iy, iz = (a.astype(np.int64) for a in (ix, iy, iz))
    out = np.zeros((3,) + px.shape)
    for cx in (0, 1):
        wx = sx if cx else 1.0 - sx
        for cy in (0, 1):
            wy = sy if cy else 1.0 - sy
            for cz in (0, 1):
                wz = sz if cz else 1.0 - sz
                h = perm[(perm[(perm[(ix + cx) & 255] + iy + cy) & 255] + iz + cz) & 255]
                w = wx * wy * wz
                for c in range(3):
                    out[c] = out[c] + w * vals[c][h]
    return out


def stereo_view(cam_T_world, w, h, K, tables):
    """u8 [h, w, 3] of the scene from a camera: each pixel's ray hits the
    sphere or the wall, and the texture is read at that world point."""
    fx, fy, cx, cy = K
    R, t = cam_T_world[:3, :3], cam_T_world[:3, 3]
    # the camera centre in the world, -R^T t, written out
    c = [-(R[0, i] * t[0] + R[1, i] * t[1] + R[2, i] * t[2]) for i in range(3)]
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    dx, dy = (uu - cx) / fx, (vv - cy) / fy
    d = [R[0, i] * dx + R[1, i] * dy + R[2, i] for i in range(3)]  # z-depth 1 along the ray
    t_wall = (ORBIT_WALL_Z - c[2]) / d[2]
    oc = [c[i] - ORBIT_SPHERE_C[i] for i in range(3)]
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    b = 2.0 * (d[0] * oc[0] + d[1] * oc[1] + d[2] * oc[2])
    cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - ORBIT_SPHERE_R * ORBIT_SPHERE_R
    disc = b * b - 4.0 * a * cc
    t_sph = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
    hit = np.where((disc >= 0) & (t_sph > 0), t_sph, t_wall)
    p = [c[i] + hit * d[i] for i in range(3)]
    v = np.zeros((3, h, w))
    for (perm, vals), cell, wgt in zip(tables, STEREO_CELLS, STEREO_WEIGHTS):
        v = v + wgt * _value_noise(*p, cell, perm, vals)
    u8 = np.clip(np.floor(255.0 * v), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(u8.transpose(1, 2, 0))


def stereo_pair(cam_T_world_left, w, h, K, tables, baseline=STEREO_BASELINE):
    """(left, right) u8 views; the right camera sits `baseline` along the
    left one's +x: cam_T_world_right = T(-b, 0, 0) @ cam_T_world_left."""
    right_pose = np.array(cam_T_world_left, np.float64)
    right_pose[0, 3] -= baseline
    return (stereo_view(cam_T_world_left, w, h, K, tables),
            stereo_view(right_pose, w, h, K, tables))


def pair_checksum(left, right) -> dict:
    """crc32 and byte sums of a u8 pair (generator drift shows here)."""
    import zlib

    return {"crc32": zlib.crc32(right.tobytes(), zlib.crc32(left.tobytes())),
            "sum_left": int(left.sum(dtype=np.int64)), "sum_right": int(right.sum(dtype=np.int64))}


def write_stereo_logdir(logdir: str, dataset_dir: str, n_frames=STEREO_FRAMES, w=640, h=480,
                        K=ORBIT_VGA_K, seed=STEREO_SEED) -> list:
    """The scene's first n_frames pairs through the port's StereoFrameLogger
    (u8 PNGs, the left camera's trajectory) and a cam.yaml of K: returns
    each pair's checksum."""
    from concurrent.futures import ThreadPoolExecutor

    from disinfect_slam_tpu_torch.io.logger import StereoFrameLogger

    tables = _noise_tables(seed)
    poses = orbit_vga_poses(dataset_dir)[:n_frames]
    log = StereoFrameLogger(logdir, queue_depth=n_frames + 1)
    sums = []
    # numpy's elementwise ops release the interpreter lock: four threads
    # render the pairs in about 0.45 of one thread's time, in frame order
    with ThreadPoolExecutor(4) as pool:
        pairs = pool.map(lambda pose: stereo_pair(pose, w, h, K, tables), poses)
        for fid, (pose, (left, right)) in enumerate(zip(poses, pairs)):
            sums.append(pair_checksum(left, right))
            log.log_data((fid, left, right, pose))
    log.close()
    with open(f"{logdir}/cam.yaml", "w") as f:
        f.write("".join(f"Camera.{k}: {v}\n" for k, v in zip(("fx", "fy", "cx", "cy"), K)))
        # the RGB-D apps read a depth factor from every camera file
        f.write(f"Camera.rows: {h}\nCamera.cols: {w}\ndepthmap_factor: 5000.0\n")
    return sums


def stereo_depth_summary(res) -> dict:
    """Valid count and float64 sums of disparity and depth over the valid
    pixels of a StereoDepthResult (numpy or tensors)."""
    valid, disp, depth = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                          for x in (res.valid, res.disparity, res.depth))
    return {"valid": int(valid.sum()),
            "sum_disp": float(disp[valid].astype(np.float64).sum()),
            "sum_depth": float(depth[valid].astype(np.float64).sum())}


# ----------------------------------------------------------------------
# the pose graph at the sizes of a closure (PERF.md §6)
# ----------------------------------------------------------------------
def _axis_angle(omega: np.ndarray) -> np.ndarray:
    """Rodrigues' rotation of the axis-angle omega [3], float64."""
    theta = float(np.linalg.norm(omega))
    k = omega / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * kx + (1.0 - np.cos(theta)) * kx @ kx


def pose_graph_ties(n_pad: int, e_pad: int, seed: int, nan: bool = False) -> list:
    """pose_graph_solve's inputs (CPU tensors) with integer Jacobians and
    residuals in [-2, 2] on random edges (a quarter padded) and a diagonal
    of ones, so that pivot candidates tie; with nan, one NaN in an edge's
    Jacobian."""
    import torch

    rng = np.random.default_rng(seed)
    e = e_pad - e_pad // 4
    ei = np.zeros(e_pad, np.int32)
    ej = np.zeros(e_pad, np.int32)
    ends = np.stack([rng.choice(n_pad, 2, replace=False) for _ in range(e)])
    ei[:e], ej[:e] = ends[:, 0], ends[:, 1]
    jac = np.zeros((2, e_pad, 6, 6))
    rd = np.zeros((e_pad, 6))
    jac[:, :e] = rng.integers(-2, 3, (2, e, 6, 6))
    rd[:e] = rng.integers(-2, 3, (e, 6))
    if nan:
        jac[0, 1, 2, 3] = np.nan
    return [torch.from_numpy(a) for a in (jac[0], jac[1], rd, ei, ej, np.ones(6 * n_pad))]


def pose_graph_case(n_pad: int, e_pad: int, seed: int = 0) -> tuple:
    """A keyframe graph as LoopClosureManager pads it, host arrays: n_pad -
    n_pad // 8 real nodes along a drifting path (each pose turned by a
    seeded rotation of ~2 degrees), the odometry chain between them, n // 8
    loop edges (weight 4) from the last node back to earlier ones measured
    against the undrifted path, the rest of e_pad padded (weight 0, nodes
    0 -> 0) and the padded nodes at the identity.  Returns (poses f32
    [n_pad, 4, 4], ei, ej int32 [e_pad], z f32 [e_pad, 4, 4], w f32
    [e_pad])."""
    rng = np.random.default_rng(seed)
    n = n_pad - n_pad // 8
    loops = max(1, n // 8)
    if n - 1 + loops > e_pad:
        raise ValueError(f"{n - 1 + loops} edges exceed e_pad {e_pad}")
    poses = np.tile(np.eye(4, dtype=np.float32), (n_pad, 1, 1))
    true = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k in range(n):
        true[k, :3, :3] = _axis_angle(rng.normal(0, 0.02, 3))
        true[k, :3, 3] = [0.1 * k, 0.05 * np.sin(0.3 * k), 0.0]
        poses[k] = true[k]
        poses[k, :3, 3] += [0.0, 0.002 * k, 0.004 * k]
    ei = np.zeros(e_pad, np.int32)
    ej = np.zeros(e_pad, np.int32)
    z = np.tile(np.eye(4, dtype=np.float32), (e_pad, 1, 1))
    w = np.zeros(e_pad, np.float32)
    for k in range(n - 1):
        ei[k], ej[k], w[k] = k, k + 1, 1.0
        z[k] = np.linalg.inv(poses[k]) @ poses[k + 1]
    for q, i in enumerate(rng.choice(n - 1, loops, replace=False)):
        k = n - 1 + q
        ei[k], ej[k], w[k] = i, n - 1, 4.0
        z[k] = np.linalg.inv(true[i]) @ true[n - 1]
    return poses, ei, ej, z, w
