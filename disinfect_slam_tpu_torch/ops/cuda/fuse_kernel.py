"""fuse_rows: projection, frame sampling and semantic TSDF fusion of the
visible blocks, in place on the pool.

Counterpart of the TPU kernels `fuse_rows_packed` (K2) and `fuse_rows`
(K3) of disinfect_slam_tpu/ops/pallas/fuse_kernel.py, together with the
projection of the visible voxels that feeds them.  The CUDA kernel
(csrc/fuse_rows.cu) takes the visible blocks' coordinates and the pose
in device memory (a DevicePose: a captured step replays with each frame's
pose; an SE3 is uploaded first), projects each voxel in registers, loads its pixel directly (no patch, no
frame-size limit, so it covers K3's large frames too), reads the block's
pool rows through a TMA ring and writes the changed words back in place
through pool_idx, and reduces min |tsdf| per row for carving.  What
bounds it on an H100 is device memory traffic (see the source's header).

`fuse_rows` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors it runs `fuse_rows_reference`, the plain torch version
with the same signature: `project_rows` followed by
`fuse_rows_rows_reference`, the rows contract the TPU kernels compute
(pixel, depth and gate planes in).  `fuse_math` holds the fusion formulas
as torch ops; the rows reference and the two-stage sampler path share it,
and the two-stage path shares `project_rows`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...core.geometry import SE3, CameraIntrinsics, DevicePose, device_pose
from ...core.voxel import round_half_away
from ...utils.graphs import count_launch
from . import build

_C = ctypes


def _pow_log(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """log(x ** e) with C powf edge semantics: e == 0 -> 0
    (powf(0, 0) == 1), e > 0 with x == 0 -> -inf."""
    return torch.where(e == 0.0, 0.0, e * torch.log(x))


def fuse_math(
    s: torch.Tensor,
    z: torch.Tensor,
    gate: torch.Tensor,
    tsdf_old: torch.Tensor,
    rgbw_old: torch.Tensor,
    prob_old: torch.Tensor,
    *,
    truncation: float,
    max_depth: float,
    max_weight: float,
    prob_eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fusion formulas of tsdf_integrate_kernel (voxel_tsdf.cu:149-205)
    as the JAX package states them, on sampled channels s [8, ...] (depth,
    depth->range, r, g, b, ht, lt, pad), camera z, a gate (live row and
    valid sample), and the old payloads (rgbw as the int32 bit pattern).
    Returns the new (tsdf, rgbw, prob); voxels that do not update keep
    their old words bit for bit."""
    depth, d2r = s[0], s[1]
    r_new, g_new, b_new = s[2], s[3], s[4]
    ht, lt = s[5], s[6]

    # divisors as device tensors: on CUDA, torch turns a division by a
    # Python scalar into a multiplication by its reciprocal, which is not
    # the correctly rounded quotient the kernel and the JAX package take
    # (filled on the device: no host-to-device copy)
    trunc_t, max_depth_t = (
        torch.full((), c, dtype=torch.float32, device=depth.device)
        for c in (truncation, max_depth)
    )
    sdf = d2r * (depth - z)
    update = gate & (depth > 0) & (depth <= max_depth) & (sdf > -truncation)
    tsdf_new = torch.clamp(sdf / trunc_t, max=1.0)
    w_new = (1.0 - depth / max_depth_t) * 4.0

    w_old = ((rgbw_old >> 24) & 0xFF).float()
    r_old = (rgbw_old & 0xFF).float()
    g_old = ((rgbw_old >> 8) & 0xFF).float()
    b_old = ((rgbw_old >> 16) & 0xFF).float()
    w_comb = w_old + w_new
    w_safe = torch.where(w_comb == 0, 1.0, w_comb)
    tsdf_upd = (tsdf_old * w_old + tsdf_new * w_new) / w_safe
    r_upd = round_half_away((r_old * w_old + r_new * w_new) / w_safe)
    g_upd = round_half_away((g_old * w_old + g_new * w_new) / w_safe)
    b_upd = round_half_away((b_old * w_old + b_new * w_new) / w_safe)
    w_upd = torch.clamp(round_half_away(w_comb), max=max_weight)
    # log-space geometric fusion of ht/lt (voxel_tsdf.cu:196-202), with
    # the JAX package's guard: a zero exponent contributes nothing even at
    # base 0, and a zero denominator keeps the old probability
    e_old = w_old / w_safe
    e_new = w_new / w_safe
    positive = torch.exp(_pow_log(prob_old, e_old) + _pow_log(ht, e_new))
    negative = torch.exp(_pow_log(1.0 - prob_old, e_old) + _pow_log(lt, e_new))
    denom = positive + negative
    prob_upd = torch.where(
        denom > 0, positive / torch.where(denom > 0, denom, 1.0), prob_old
    )
    if prob_eps > 0.0:
        prob_upd = torch.clamp(prob_upd, prob_eps, 1.0 - prob_eps)

    word = (
        r_upd.to(torch.int32)
        | (g_upd.to(torch.int32) << 8)
        | (b_upd.to(torch.int32) << 16)
        | (w_upd.to(torch.int32) << 24)
    )
    return (
        torch.where(update, tsdf_upd, tsdf_old),
        torch.where(update, word, rgbw_old),
        torch.where(update, prob_upd, prob_old),
    )


def project_rows(
    block_pos: torch.Tensor,
    cam_T_world: SE3 | DevicePose,
    intrinsics: CameraIntrinsics,
    voxel_size: float,
    block_len_log2: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every voxel of every block row -> (u, v) i32 [V, N], the rounded
    pixel (roundf, not clipped), and camera z f32 [V, N].  block_pos i32
    [V, 3]; N = 8 ** block_len_log2 voxels per block, x fastest (512 for
    the kernels' 8x8x8 blocks).  The float32 ops in the JAX package's
    order (fuse_visible, disinfect_slam_tpu/ops/integrate.py)."""
    bl = block_len_log2
    lmask = (1 << bl) - 1
    vidx = torch.arange(1 << (3 * bl), dtype=torch.int32, device=block_pos.device)
    ox = (vidx & lmask)[None, :]
    oy = ((vidx >> bl) & lmask)[None, :]
    oz = ((vidx >> (2 * bl)) & lmask)[None, :]
    px = ((block_pos[:, 0:1] << bl) + ox).float() * voxel_size
    py = ((block_pos[:, 1:2] << bl) + oy).float() * voxel_size
    pz = ((block_pos[:, 2:3] << bl) + oz).float() * voxel_size
    xc, yc, z = cam_T_world.apply_xyz(px, py, pz)  # [V, 512] camera coords
    del px, py, pz
    u = round_half_away((intrinsics.fx * xc + intrinsics.cx * z) / z).to(torch.int32)
    v = round_half_away((intrinsics.fy * yc + intrinsics.cy * z) / z).to(torch.int32)
    return u, v, z


def fuse_rows_rows_reference(
    img: torch.Tensor,
    us: torch.Tensor,
    vs: torch.Tensor,
    z: torch.Tensor,
    gate: torch.Tensor,
    pool_idx: torch.Tensor,
    count: torch.Tensor,
    tsdf: torch.Tensor,
    rgbw: torch.Tensor,
    prob: torch.Tensor,
    *,
    truncation: float,
    max_depth: float,
    max_weight: float,
    prob_eps: float = 0.0,
) -> torch.Tensor:
    """The rows contract of the TPU kernels, in plain torch.  img f32
    [H, W, 8]; us, vs i32 [V, 512] clipped pixel coordinates; z f32
    [V, 512]; gate bool [V, 512] (live row and in-image voxel); pool_idx
    i32 [V]; count i32 [] live rows (each with a distinct pool row); tsdf
    f32, rgbw i32, prob f32 [B, 512] pool arrays.

    Fuses rows < count into their pool rows in place and returns min
    |tsdf| per row f32 [V] (0 for rows at or past count)."""
    n = int(count)
    img_h, img_w, _ = img.shape
    rows = pool_idx[:n].long()
    s = img[vs[:n].clamp(0, img_h - 1).long(), us[:n].clamp(0, img_w - 1).long()]
    t_fin, w_fin, p_fin = fuse_math(
        s.permute(2, 0, 1), z[:n], gate[:n], tsdf[rows], rgbw[rows], prob[rows],
        truncation=truncation, max_depth=max_depth, max_weight=max_weight,
        prob_eps=prob_eps,
    )
    tsdf[rows] = t_fin
    rgbw[rows] = w_fin
    prob[rows] = p_fin
    minabs = torch.zeros(us.shape[0], dtype=torch.float32, device=img.device)
    minabs[:n] = t_fin.abs().amin(dim=-1)
    return minabs


def fuse_rows_reference(
    img: torch.Tensor,
    block_pos: torch.Tensor,
    pool_idx: torch.Tensor,
    count: torch.Tensor,
    tsdf: torch.Tensor,
    rgbw: torch.Tensor,
    prob: torch.Tensor,
    *,
    cam_T_world: SE3 | DevicePose,
    intrinsics: CameraIntrinsics,
    voxel_size: float,
    truncation: float,
    max_depth: float,
    max_weight: float,
    prob_eps: float = 0.0,
) -> torch.Tensor:
    """Plain version.  img f32 [H, W, 8] (depth, depth->range, r, g, b,
    ht, lt, pad); block_pos i32 [V, 3] block coordinates of the visible
    rows; pool_idx i32 [V]; count i32 [] live rows (each with a distinct
    pool row); tsdf f32, rgbw i32, prob f32 [B, 512] pool arrays; the
    pose, pinhole intrinsics and voxel size of project_rows.

    Projects every voxel of the live rows, samples the frame at its pixel
    (voxels outside the image, behind the camera included wherever their
    pixel lands, take no update), fuses rows < count into their pool rows
    in place and returns min |tsdf| per row f32 [V] (rows at or past count
    are unspecified)."""
    img_h, img_w, _ = img.shape
    n = int(count)  # only the live rows are projected
    u, v, z = project_rows(block_pos[:n], cam_T_world, intrinsics, voxel_size)
    in_img = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    minabs = torch.zeros(block_pos.shape[0], dtype=torch.float32, device=img.device)
    minabs[:n] = fuse_rows_rows_reference(
        img, u.clamp_(0, img_w - 1), v.clamp_(0, img_h - 1), z, in_img, pool_idx[:n], count,
        tsdf, rgbw, prob, truncation=truncation, max_depth=max_depth, max_weight=max_weight,
        prob_eps=prob_eps,
    )
    return minabs


def _check_inputs(img, block_pos, pool_idx, count, tsdf, rgbw, prob):
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"fuse_rows takes CPU or CUDA tensors, got {dev}")
    if img.dtype != torch.float32 or img.dim() != 3 or img.shape[2] != 8:
        raise ValueError(f"img must be f32 [H, W, 8], got {img.dtype} {tuple(img.shape)}")
    rows, blocks = block_pos.shape[0], tsdf.shape[0]
    want = {
        "block_pos": (block_pos, torch.int32, (rows, 3)),
        "pool_idx": (pool_idx, torch.int32, (rows,)),
        "tsdf": (tsdf, torch.float32, (blocks, 512)),
        "rgbw": (rgbw, torch.int32, (blocks, 512)),
        "prob": (prob, torch.float32, (blocks, 512)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    if count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError("count must be a one-element i32 tensor")
    for t in (img, block_pos, pool_idx, count, tsdf, rgbw, prob):
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    # 16-byte pixel loads; 16-byte aligned bulk copies of the pool rows
    for name, t in (("img", img), ("tsdf", tsdf), ("rgbw", rgbw), ("prob", prob)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# dst_fuse_rows' arguments (and the tail of the stage probe's,
# csrc/sample_probe.cu); the pose is a device pointer
ARGTYPES = [
    _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    _C.c_void_p, _C.POINTER(_C.c_float), _C.c_float, _C.c_float,
    _C.c_float, _C.c_float, _C.c_float, _C.c_float, _C.c_void_p,
]


def c_args(img, block_pos, pool_idx, count, tsdf, rgbw, prob, minabs, *, cam_T_world,
           intrinsics, voxel_size, truncation, max_depth, max_weight,
           prob_eps=0.0) -> tuple:
    """(the C arguments of dst_fuse_rows (ARGTYPES) for fuse_rows' inputs
    and its min |tsdf| output, the DevicePose they point into: keep it
    until the launch is issued)."""
    pose = device_pose(cam_T_world, img.device)
    # the scalars the torch path multiplies by, rounded to float32 as torch
    # rounds a Python float against a float32 tensor
    intr = (_C.c_float * 4)(intrinsics.fx, intrinsics.fy, intrinsics.cx, intrinsics.cy)
    return (build.ptr(img), img.shape[0], img.shape[1], build.ptr(block_pos),
            build.ptr(pool_idx), build.ptr(count), block_pos.shape[0], tsdf.shape[0],
            build.ptr(tsdf), build.ptr(rgbw), build.ptr(prob), build.ptr(minabs),
            pose.kernel_ptr(), intr, voxel_size, truncation, max_depth, max_weight, prob_eps,
            # the upper clamp bound 1 - prob_eps, rounded to f32 from the
            # double as the torch version rounds it
            1.0 - prob_eps,
            build.stream_of(img)), pose


def fuse_rows(
    img: torch.Tensor,
    block_pos: torch.Tensor,
    pool_idx: torch.Tensor,
    count: torch.Tensor,
    tsdf: torch.Tensor,
    rgbw: torch.Tensor,
    prob: torch.Tensor,
    *,
    cam_T_world: SE3 | DevicePose,
    intrinsics: CameraIntrinsics,
    voxel_size: float,
    truncation: float,
    max_depth: float,
    max_weight: float,
    prob_eps: float = 0.0,
) -> torch.Tensor:
    """Project, sample and fuse the live rows into the pool in place; see
    fuse_rows_reference for the contract."""
    args = (img, block_pos, pool_idx, count, tsdf, rgbw, prob)
    consts = dict(cam_T_world=cam_T_world, intrinsics=intrinsics, voxel_size=voxel_size,
                  truncation=truncation, max_depth=max_depth, max_weight=max_weight,
                  prob_eps=prob_eps)
    if img.device.type == "cpu":
        return fuse_rows_reference(*args, **consts)
    _check_inputs(*args)
    minabs = torch.empty(block_pos.shape[0], dtype=torch.float32, device=img.device)
    fn = build.entry("fuse_rows", "dst_fuse_rows", ARGTYPES)
    c, _pose = c_args(*args, minabs, **consts)
    with torch.cuda.device(img.device):
        err = fn(*c)
    count_launch(fuse_rows)
    build.check(err, "fuse_rows")
    return minabs


fuse_rows.launches = 0
