"""icp_step: one iteration of point-to-plane ICP at one pyramid level.

Replaces no TPU kernel.  Its counterpart is the body of the JAX
`_icp_level` loop (disinfect_slam_tpu/systems/odometry.py:116), XLA ops
inside `jax.jit`, no Pallas.  The kernel (csrc/icp_step.cu) was added so
that the card gives the CPU's bits through the tracker, and to cut an
iteration's ~35 launches to one.  It computes, per source pixel, the
transform by T and by the reference pose (SE3.apply_xyz's order), the
projection with IEEE divisions, round half to even and clip, the packed
[N, 8] reference row, the distance gate, the residual, the Huber weight
and the Jacobian, and the pixel's 29 float32 products (`products`); then
29 float32 sums over the pixels, the 21 upper-triangle entries of
J^T W J, the 6 of J^T W r, sum r^2 over inliers and the inlier count,
each run by 8 interleaved accumulators (pixel p adds into p mod 8, in
pixel order, the first real pixel seeding, a padded one adding +0), then
the 8 added in order: XLA:CPU's 8-lane vector accumulation of the
reference's float32 dot; then the 1e-6 damping, the 6x6 solve in float64
(core/exact.solve_lu: LU with partial pivoting, as jnp.linalg.solve, in a
fixed order of operations), the se3 exp and the pose update in float64
(sine and cosine by core/exact.sincos's polynomial), rounded once to
float32: T, rmse and inliers.

What bounds it is that order: each accumulator is a chain of N / 8
dependent float32 adds (38400 at 640x480), whose latency is the order
floor (`chain`, timed by chip_smoke.py phase 7); the bytes take a
twentieth of it.  So the kernel is one launch of one 8-CTA cluster, CTA j
accumulator j: 12 producer warps run the per-pixel arithmetic for the
CTA's pixels j, j + 8, ... and write their products into a ring of
STAGES shared-memory stages of STAGE_ROWS rows, sum-major; one consumer
warp folds them, lane c sum c, four rows a 16-byte load; the cluster's
CTA 0 adds the 8 partials through distributed shared memory and solves.
Nothing goes through device memory between the pixels and the solve.
The consumer alone runs near the floor; the producers' arithmetic on 8
SMs and their stride-8 loads hold the kernel at ~1.4x it (PERF.md).

The sums stay float32 on purpose.  A float64 sum, a float32 pairwise tree
and float32 sums of contiguous chunks each move the soak test's corridor
(tests/test_torch_soak.py) off the JAX soak's counts, 3-4 recentres
against 6: the corridor's weakly constrained direction follows the
reference's own float32 accumulation, which one accumulator or eight in
pixel order keep (PERF.md, PR 17).

Every operation is an IEEE operation with one rounding (the kernel
contracts nothing, `-fmad=false`), so `icp_step_reference`, the plain
torch version below, repeats the same arithmetic in the same order and
gives the same bits on the CPU and on the card; it uses no matmul, no
linalg and no float32 sin, cos or sqrt, and takes its sequential sums
with numpy on the host.  `icp_step` launches the kernel for CUDA tensors
and raises if it cannot (a build that fails, a card that cannot schedule
the cluster); for CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from ...core.exact import INV_FACT, INV_TWO_PI, SIN_TERMS, TWO_PI
from ...utils.graphs import count_launch
from . import build

_C = ctypes
_F32, _F64 = torch.float32, torch.float64
ACC = 8  # the interleaved float32 accumulators a sum: pixel p adds into p mod 8
SUMS = 29  # 21 of J^T W J, 6 of J^T W r, sum r^2 over inliers, inliers
STAGE_ROWS = 256  # the kernel's rows of one accumulator a shared-memory stage
STAGES = 6  # the kernel's ring of stages
DAMPING = float(torch.tensor(1e-6, dtype=_F32))  # the JAX 1e-6, a float32


def _upper() -> list:
    return [(i, j) for i in range(6) for j in range(i, 6)]


def products(terms: torch.Tensor) -> torch.Tensor:
    """A pixel's 29 float32 products from its row [N, 16]: jw_i jac_j for
    the upper triangle (i <= j), jw_i r, (r r) inlier and the inlier."""
    jw, jac, r, inl = terms[:, 0:6], terms[:, 6:12], terms[:, 12], terms[:, 13]
    cols = [jw[:, i] * jac[:, j] for i, j in _upper()] + [jw[:, i] * r for i in range(6)]
    return torch.stack(cols + [(r * r) * inl, inl], 1)


def sequential_sums(prods: torch.Tensor) -> torch.Tensor:
    """The kernel's float32 sums of prods [N, 29] over N: pixel p adds into
    accumulator p mod 8 (the rows padded with zeros to a multiple of 8),
    each accumulator in index order, then the 8 added in order.  No torch
    op sums in a set order, so the running sums are numpy's
    add.accumulate (float32, in index order) on the host."""
    n = prods.shape[0]
    x = prods.detach().cpu().numpy()
    x = np.concatenate([x, np.zeros(((-n) % ACC, SUMS), np.float32)]).reshape(-1, ACC, SUMS)
    part = np.add.accumulate(x, axis=0, dtype=np.float32)[-1]
    total = part[0]
    for j in range(1, ACC):
        total = total + part[j]
    return torch.from_numpy(np.ascontiguousarray(total)).to(prods.device)


def _sincos(theta: float) -> Tuple[float, float]:
    """core/exact.sincos on one Python float (IEEE double arithmetic, the
    same operations in the same order; a NaN or an infinity gives NaNs,
    as the kernel's rint does)."""
    k = theta * INV_TWO_PI
    t = theta - (float(round(k)) if math.isfinite(k) else k) * TWO_PI
    t2 = t * t
    s = (-1) ** (SIN_TERMS - 1) * INV_FACT[2 * SIN_TERMS - 1]
    c = (-1) ** SIN_TERMS * INV_FACT[2 * SIN_TERMS]
    for m in range(SIN_TERMS - 2, -1, -1):
        s = (-1) ** m * INV_FACT[2 * m + 1] + t2 * s
    for m in range(SIN_TERMS - 1, -1, -1):
        c = (-1) ** m * INV_FACT[2 * m] + t2 * c
    return t * s, c


def _mat3(a, b) -> list:
    """a [3][3] @ b [3][n] (lists), each entry ((a0 b0 + a1 b1) + a2 b2)."""
    return [[(a[i][0] * b[0][j] + a[i][1] * b[1][j]) + a[i][2] * b[2][j]
             for j in range(len(b[0]))] for i in range(3)]


def exp_se3_64(xi) -> Tuple[list, list]:
    """The se3 exp of xi = (omega, v), six floats -> (R [3][3], t [3]) in
    float64, as the JAX _exp_se3 writes it, in the kernel's order and with
    its sine and cosine."""
    o0, o1, o2, v0, v1, v2 = (float(x) for x in xi)
    theta = math.sqrt((o0 * o0 + o1 * o1) + o2 * o2) + 1e-12
    k0, k1, k2 = o0 / theta, o1 / theta, o2 / theta
    kx = [[0.0, -k2, k1], [k2, 0.0, -k0], [-k1, k0, 0.0]]
    kx2 = _mat3(kx, kx)
    s, c = _sincos(theta)
    omc = 1.0 - c
    fv, fw = omc / theta, (theta - s) / theta
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    r_up = [[(eye[i][j] + s * kx[i][j]) + omc * kx2[i][j] for j in range(3)] for i in range(3)]
    vmat = [[(eye[i][j] + fv * kx[i][j]) + fw * kx2[i][j] for j in range(3)] for i in range(3)]
    return r_up, [row[0] for row in _mat3(vmat, [[v0], [v1], [v2]])]


def _solve6(m: list) -> list:
    """core/exact.solve_lu on the augmented 6x7 list m, in Python floats."""
    for k in range(5):
        p, best = k, abs(m[k][k])
        for i in range(k + 1, 6):
            a = abs(m[i][k])
            if best == best and (a != a or a > best):
                p, best = i, a
        m[k], m[p] = m[p], m[k]
        for i in range(k + 1, 6):
            lo = m[i][k] / m[k][k]
            for j in range(k + 1, 7):
                m[i][j] = m[i][j] - lo * m[k][j]
    x = [0.0] * 6
    for i in range(5, -1, -1):
        x[i] = m[i][6] / m[i][i]
        for r in range(i):
            m[r][6] = m[r][6] - m[r][i] * x[i]
    return x


def solve_update(sums: torch.Tensor, T: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Pass B after its sums, as the kernel's thread 0 does it: the 29
    float32 sums and the pose T f32 [4, 4] -> (the updated T f32 [4, 4],
    rmse f32 [], inliers f32 []), in float64 (Python floats, IEEE doubles)
    from the sums on, rounded once."""
    sm = [float(x) for x in sums.tolist()]
    m = [[0.0] * 7 for _ in range(6)]
    for idx, (i, j) in enumerate(_upper()):
        m[i][j] = m[j][i] = sm[idx] + DAMPING if i == j else sm[idx]
    for i in range(6):
        m[i][6] = -sm[21 + i]
    r_up, t_up = exp_se3_64(_solve6(m))
    td = T.tolist()
    rt = _mat3(r_up, [row[:4] for row in td[:3]])
    out = [[rt[i][0], rt[i][1], rt[i][2], rt[i][3] + t_up[i]] for i in range(3)]
    n_in = sm[28]
    rmse = math.sqrt(sm[27] / (1.0 if n_in < 1.0 else n_in))
    dev = T.device
    T_new = torch.tensor(out + [[0.0, 0.0, 0.0, 1.0]], dtype=_F64).to(_F32)
    return T_new.to(dev), torch.tensor(rmse, dtype=_F64).to(_F32).to(dev), \
        torch.tensor(n_in, dtype=_F32).to(dev)


def pixel_terms(T, src, ref_pack, ref_pose, delta, intr, img_w, img_h, dist2) -> torch.Tensor:
    """Pass A: each pixel's row [N, 16] float32 (see the module
    docstring): jw = jac * weight [6], jac [6], r, inlier, 1, 0."""
    fx, fy, cx, cy = intr
    x, y, zs = src[:, 0], src[:, 1], src[:, 2]
    px = ((T[0, 0] * x + T[0, 1] * y) + T[0, 2] * zs) + T[0, 3]
    py = ((T[1, 0] * x + T[1, 1] * y) + T[1, 2] * zs) + T[1, 3]
    pz = ((T[2, 0] * x + T[2, 1] * y) + T[2, 2] * zs) + T[2, 3]
    P = ref_pose
    qx = ((P[0, 0] * px + P[0, 1] * py) + P[0, 2] * pz) + P[0, 3]
    qy = ((P[1, 0] * px + P[1, 1] * py) + P[1, 2] * pz) + P[1, 3]
    qz = ((P[2, 0] * px + P[2, 1] * py) + P[2, 2] * pz) + P[2, 3]
    u = fx * qx / qz + cx
    v = fy * qy / qz + cy
    # clipped as floats (a NaN to 0), so the index never depends on the
    # device's float-to-int conversion of an out-of-range value
    uf, vf = torch.round(u), torch.round(v)
    ui = torch.where(uf >= 0, torch.where(uf <= img_w - 1, uf, float(img_w - 1)), 0.0)
    vi = torch.where(vf >= 0, torch.where(vf <= img_h - 1, vf, float(img_h - 1)), 0.0)
    idx = vi.to(torch.int64) * img_w + ui.to(torch.int64)
    in_img = (u >= 0) & (u <= img_w - 1) & (v >= 0) & (v <= img_h - 1) & (qz > 0)
    g = torch.index_select(ref_pack, 0, idx)
    dx, dy, dz = px - g[:, 0], py - g[:, 1], pz - g[:, 2]
    nx, ny, nz = g[:, 3], g[:, 4], g[:, 5]
    dist_ok = ((dx * dx + dy * dy) + dz * dz) < dist2
    valid = (zs > 0) & in_img & (g[:, 6] > 0) & dist_ok
    r = (nx * dx + ny * dy) + nz * dz
    r_abs = torch.abs(r)
    huber = torch.clamp(delta / torch.clamp(r_abs, min=1e-12), max=1.0)
    inl = valid.to(_F32)
    wgt = inl * huber
    jac = [py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx, nx, ny, nz]
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    return torch.stack([j * wgt for j in jac] + jac + [r, inl, one, zero], 1)


def icp_step_reference(T, src, ref_pack, ref_pose, delta, intr, img_w, img_h, dist2):
    """Plain version of one ICP iteration.  T f32 [4, 4] (world_T_cam of the
    current frame), src f32 [N, 3] (its camera-space points, N = img_h x
    img_w), ref_pack f32 [N, 8] (the reference's world-space vertex, normal
    and validity, a row a pixel), ref_pose f32 [4, 4] (the reference view's
    cam_T_world), delta f32 [] (the Huber delta), intr (fx, fy, cx, cy) as
    float32 values, dist2 the squared distance gate as a float32 value.
    Returns (T f32 [4, 4], rmse f32 [], inliers f32 [])."""
    terms = pixel_terms(T, src, ref_pack, ref_pose, delta, intr, img_w, img_h, dist2)
    return solve_update(sequential_sums(products(terms)), T)


def _check_inputs(T, src, ref_pack, ref_pose, delta, img_w, img_h) -> None:
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"icp_step takes CPU or CUDA tensors, got {dev}")
    n = img_w * img_h
    for name, t, shape in (("T", T, (4, 4)), ("src", src, (n, 3)), ("ref_pack", ref_pack, (n, 8)),
                           ("ref_pose", ref_pose, (4, 4)), ("delta", delta, ())):
        if t.dtype != _F32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if ref_pack.data_ptr() % 16:
        raise ValueError("ref_pack must be 16-byte aligned")


def _clusters(dev: torch.device) -> None:
    """At first use on a device: raise unless the card can hold one of the
    kernel's 8-CTA clusters (8 SMs of one GPC with a CTA's shared memory
    free each); there is no fallback."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key in _clusters.checked:
        return
    count = _C.c_int(0)
    fn = build.entry("icp_step", "dst_icp_clusters", [_C.c_void_p])
    with torch.cuda.device(dev):
        build.check(fn(_C.byref(count)), "icp_step (cluster occupancy)")
    if count.value < 1:
        raise RuntimeError(f"icp_step: {torch.cuda.get_device_name(dev)} cannot schedule an "
                           f"{ACC}-CTA cluster of the kernel")
    _clusters.checked.add(key)


_clusters.checked = set()


def icp_step(T, src, ref_pack, ref_pose, delta, intr, img_w: int, img_h: int, dist2: float):
    """One ICP iteration (one launch); see icp_step_reference for the
    contract."""
    if src.device.type == "cpu":
        return icp_step_reference(T, src, ref_pack, ref_pose, delta, intr, img_w, img_h, dist2)
    _check_inputs(T, src, ref_pack, ref_pose, delta, img_w, img_h)
    dev = src.device
    _clusters(dev)
    T_new = torch.empty((4, 4), dtype=_F32, device=dev)
    out = torch.empty((2,), dtype=_F32, device=dev)
    fx, fy, cx, cy = intr
    step = build.entry("icp_step", "dst_icp_step", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
        _C.c_int, _C.c_float, _C.c_float, _C.c_float, _C.c_float, _C.c_float,
        _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ])
    with torch.cuda.device(dev):
        err = step(build.ptr(T), build.ptr(src), build.ptr(ref_pack), build.ptr(ref_pose),
                   build.ptr(delta), img_w, img_h, fx, fy, cx, cy, dist2, build.ptr(T_new),
                   build.ptr(out), build.stream_of(src))
        count_launch(icp_step)
        build.check(err, "icp_step")
    return T_new, out[0], out[1]


icp_step.launches = 0


def chain(seed: torch.Tensor, rows: int, out: torch.Tensor) -> None:
    """The order floor's probe (not on any path, not counted): 29 chains of
    `rows` dependent float32 adds of seed[c] f32 [32] in registers, one
    warp, into out f32 [32] (CUDA tensors); its device time at rows = N / 8
    is the least an iteration over N pixels can take in the kernel's sum
    order."""
    fn = build.entry("icp_step", "dst_icp_chain", [_C.c_void_p, _C.c_int, _C.c_void_p,
                                                   _C.c_void_p])
    with torch.cuda.device(seed.device):
        build.check(fn(build.ptr(seed), rows, build.ptr(out), build.stream_of(seed)),
                    "icp_step (chain)")
