"""Loop closure, relocalization, and map persistence for the built-in
tracker (counterpart of disinfect_slam_tpu/systems/loop_closure.py).

The reference inherits all of this from ORB_SLAM3 / OpenVSLAM: the
external tracker runs bag-of-words place recognition, loop closing with
pose-graph optimization, relocalization after tracking loss, and map
database save/load (disinfect_slam.cc:89 `SLAM_->TrackStereo`,
modules/slam_module.cc:100-120, examples/visual_slam/run_zed_native.cc:88
`SLAM.save_map_database`).  The built-in DenseSLAM tracker
(systems/dense_slam.py) is frame-to-model only; this module closes the
gap:

  keyframes     every K-th tracked frame stores a compact descriptor +
                a half-res depth map + its pose estimate
  place recog   descriptor matching is ONE matvec over the whole
                keyframe database ([cap, D] @ [D]), built from
                valid-aware cell means of the depth image plus mean
                intensity cells
  verification  candidate matches are confirmed geometrically by the
                SAME multi-level projective ICP the tracker runs
                (systems/odometry.py), at half resolution; the converged
                transform IS the loop constraint (rmse/inlier gated)
  pose graph    keyframe poses + odometry edges + loop edges, relaxed
                by damped Gauss-Newton on the device: residuals are
                se3-log of edge misclosures, the Jacobian is forward-mode
                AD's (every edge and unit tangent; its formulas written
                out, ops/cuda/pose_graph_kernel.edge_jacobians_reference),
                and the normal equations are summed and solved in float64
                in a fixed order (core/exact.py), one kernel launch an
                iteration
  correction    the newest keyframe's optimized-vs-estimated delta is
                applied to the live tracker pose; already-fused drifted
                geometry stays, the trajectory is corrected retroactively
  reloc + map   after tracking loss the same match+verify pipeline
                re-seeds the pose; the database saves/loads as one npz
                with the JAX package's keys, so maps cross both ways.

The JAX package has no Pallas kernel here.  The Lie helpers take
batches ([..., 6], [..., 4, 4]), build their matrices by stacking (forward
AD and torch.func cannot trace a write into a fresh tensor) and keep the
JAX package's double-where guards; their per-sample scalars keep a
length-1 axis, because forward-mode AD promotes a 0-d float32 combined
with a Python float to float64.  No matmul, einsum,
linalg solve or float32 transcendental function runs here: the products
are core/exact.mm's, the sums its float64 trees, the solve its LU, and
sin, cos, atan2 and sqrt its float64 versions rounded once, so the CPU and
the card give the same bits (a pose graph moves its output centimetres
for one ulp of its input).
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..core.exact import atan2, mm, sincos, sqrt_rn, tree_sum
from ..ops.cuda import pose_graph_kernel
from ..utils.device import resolve_device, upload
from ..utils.graphs import StaticInputs, StepGraphs, keep
from .odometry import ICPOdometry, read_result

logger = logging.getLogger(__name__)

_F32 = torch.float32

# descriptor grid: 12x16 cells of (valid-aware mean depth, valid
# fraction, mean intensity) -> 576-dim, unit-norm (cosine similarity).
# The intensity cells are the appearance channel: two geometrically
# identical rooms differ only in texture, so without it the matcher would
# close a false loop.
DESC_GH, DESC_GW = 12, 16
DESC_DIM = DESC_GH * DESC_GW * 3
# geometry-only descriptor width of databases saved before the
# appearance channel existed (load() zero-pads them)
_DESC_DIM_V1 = DESC_GH * DESC_GW * 2
_NO_ID = -(10**9)


# ----------------------------------------------------------------------
# SE3 log / exp on 4x4 matrices (the pose-graph state)
# ----------------------------------------------------------------------
def _sin_cos(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin and cos in x's dtype from core/exact.sincos (float64, rounded
    once): the same bits on every device."""
    s, c = sincos(x.to(torch.float64))
    return s.to(x.dtype), c.to(x.dtype)


def _sq3(v: torch.Tensor) -> torch.Tensor:
    """((v0^2 + v1^2) + v2^2) of vectors [..., 3], as [..., 1]."""
    return ((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2])[..., None]


def _skew(k: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrices [..., 3, 3], by stacking."""
    z = torch.zeros_like(k[..., 0])
    return torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                        torch.stack([k[..., 2], z, -k[..., 0]], -1),
                        torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)


def _rigid(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotations [..., 3, 3] and translations [..., 3] -> 4x4s [..., 4, 4]."""
    bottom = torch.eye(4, dtype=r.dtype, device=r.device)[3:].expand(*r.shape[:-2], 1, 4)
    return torch.cat([torch.cat([r, t[..., None]], -1), bottom], -2)


def _exp_se3_mat(xi: torch.Tensor) -> torch.Tensor:
    """se3 exp of xi [..., 6] to 4x4s [..., 4, 4], differentiable at xi=0:
    the unnormalized-skew Rodrigues form with series coefficients below
    theta^2 = 1e-4 (double-where safe)."""
    omega, v = xi[..., :3], xi[..., 3:]
    t2 = _sq3(omega)
    ox = _skew(omega)
    small = t2 < 1e-4
    t2s = torch.where(small, 1.0, t2)
    theta = sqrt_rn(t2s)
    s, c = _sin_cos(theta)
    a = torch.where(small, 1.0 - t2 / 6.0, s / theta)[..., None]  # sin/theta
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - c) / t2s)[..., None]
    cc = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (theta - s) / (t2s * theta))[..., None]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    ox2 = mm(ox, ox)
    r = eye + a * ox + b * ox2
    t = mm(eye + b * ox + cc * ox2, v[..., None])[..., 0]
    return _rigid(r, t)


def _so3_log(r: torch.Tensor) -> torch.Tensor:
    """SO3 log: rotation matrices [..., 3, 3] -> axis-angle vectors
    [..., 3].

    Differentiable at theta=0: no arccos and no norm-of-zero; the small
    branch is a series in |vee|^2, and the large branch's inputs are
    swapped to safe values where untaken so NaN can't leak through the
    where (the double-where pattern).  Loop misclosures are small
    rotations, far from theta=pi."""
    vee = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                       r[..., 1, 0] - r[..., 0, 1]], -1)
    # = 2 sin(theta) * axis
    trace = (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2])[..., None]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    s2 = _sq3(vee)  # = 4 sin^2(theta)
    small = s2 < 4e-4  # sin(theta) < 0.01
    s2_safe = torch.where(small, 1.0, s2)
    sin_t = 0.5 * sqrt_rn(s2_safe)
    theta = atan2(sin_t.to(torch.float64), cos_t.to(torch.float64)).to(r.dtype)
    # theta/(2 sin) = 0.5 + theta^2/12 + ...; theta^2 ~= s2/4 near 0
    fac = torch.where(small, 0.5 + s2 / 48.0, theta / (2.0 * sin_t))
    return fac * vee


def _se3_log(m: torch.Tensor) -> torch.Tensor:
    """SE3 log: 4x4s [..., 4, 4] -> xi = (omega, v) [..., 6]; inverse of
    _exp_se3_mat, with V^-1 built from the unnormalized skew and its
    coefficient series-expanded below the float32 cancellation floor of
    1-cos."""
    omega = _so3_log(m[..., :3, :3])
    t2 = _sq3(omega)
    ox = _skew(omega)
    small = t2 < 1e-4
    t2_safe = torch.where(small, 1.0, t2)
    theta = sqrt_rn(t2_safe)
    s, c = _sin_cos(theta)
    # (1 - theta sin / (2 (1-cos))) / theta^2 -> 1/12 + theta^2/720 + ...
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       (1.0 - theta * s / (2.0 * (1.0 - c))) / t2_safe)[..., None]
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    v_inv = eye - 0.5 * ox + coef * mm(ox, ox)
    return torch.cat([omega, mm(v_inv, m[..., :3, 3:4])[..., 0]], -1)


def _inv_rigid(m: torch.Tensor) -> torch.Tensor:
    """Exact inverse of rigid 4x4s [..., 4, 4] (R^T | -R^T t)."""
    rt = m[..., :3, :3].transpose(-1, -2)
    t = mm(rt, -m[..., :3, 3:4])
    bottom = torch.eye(4, dtype=m.dtype, device=m.device)[3:].expand(*m.shape[:-2], 1, 4)
    return torch.cat([torch.cat([rt, t], -1), bottom], -2)


# ----------------------------------------------------------------------
# Place-recognition descriptor + matcher
# ----------------------------------------------------------------------
def _unit(v: torch.Tensor) -> torch.Tensor:
    n = sqrt_rn(tree_sum(v.double() * v.double()).float())
    return v / torch.where(n > 0, n, 1.0)


def _cell_sums(x: torch.Tensor) -> torch.Tensor:
    """[gh, ch, gw, cw] -> the float64 sum of each cell [gh, gw]
    (core/exact.tree_sum)."""
    gh, ch, gw, cw = x.shape
    return tree_sum(x.permute(0, 2, 1, 3).reshape(gh, gw, ch * cw))


def _mean(v: torch.Tensor) -> torch.Tensor:
    return (tree_sum(v) / v.shape[-1]).float()


def depth_descriptor(
    depth: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    gh: int = DESC_GH,
    gw: int = DESC_GW,
) -> torch.Tensor:
    """[H, W] depth (+ optional [H, W] intensity) -> unit-norm
    descriptor [gh*gw*3].

    Valid-aware cell means + valid fractions (geometry) plus mean
    intensity per cell (appearance).  The two halves are zero-meaned and
    unit-normed separately, then concatenated at weight 1/sqrt(2) each, so
    cosine similarity needs BOTH to agree.  intensity=None fills the
    appearance half with zeros (geometry-only legacy databases).  Every
    sum is core/exact.tree_sum's, rounded once: the same bits on every
    device."""
    h, w = depth.shape
    ch, cw = h // gh, w // gw
    d = depth[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
    valid = (d > 0).to(_F32)
    cnt = _cell_sums(valid).float()
    mean = _cell_sums(d).float() / torch.clamp(cnt, min=1.0)
    # a device-tensor divisor (torch divides by a Python scalar on the
    # card through its reciprocal)
    frac = cnt / torch.full((), float(ch * cw), dtype=_F32, device=depth.device)
    geo = torch.cat([mean.reshape(-1), frac.reshape(-1)])
    geo = _unit(geo - _mean(geo))
    if intensity is None:
        # keep the geometry half at full weight so legacy geometry-only
        # descriptors compare to each other with the old similarity
        return torch.cat([geo, torch.zeros(gh * gw, dtype=_F32, device=depth.device)])
    ii = intensity[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
    imean = (_cell_sums(ii) / (ch * cw)).float().reshape(-1)
    app = _unit(imean - _mean(imean))
    inv_s2 = 0.7071067811865476
    return torch.cat([geo * inv_s2, app * inv_s2])


def match_scores(db_desc: torch.Tensor, desc: torch.Tensor) -> torch.Tensor:
    """db_desc [cap, D] @ desc [D] as float64 sums of the exact products in
    core/exact.tree_sum's order, rounded once to float32."""
    return tree_sum(db_desc.double() * desc.double()).float()


def _match_scores(desc, db_desc, db_ids, count, cur_id, min_gap):
    """Cosine similarity of desc [D] vs the whole database db_desc
    [cap, D] (match_scores), masked to live slots (index < count) whose
    frame id db_ids [cap] lies at least min_gap before cur_id (<= 0
    disables the gap); returns (best_idx, score) as device tensors, the
    first maximum on ties."""
    scores = match_scores(db_desc, desc)
    idx = torch.arange(db_desc.shape[0], dtype=torch.int32, device=db_desc.device)
    ok = (idx < count) & ((cur_id - db_ids) >= min_gap)
    scores = torch.where(ok, scores, -2.0)
    best = torch.argmax(scores)
    return best, scores[best]


# ----------------------------------------------------------------------
# Pose-graph optimization (damped Gauss-Newton on the device)
# ----------------------------------------------------------------------
def _left_update(xi: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """exp(xi_k) @ T_k for every node."""
    return mm(_exp_se3_mat(xi), poses)


def _exp_se3_small(xi: torch.Tensor) -> torch.Tensor:
    """_exp_se3_mat where every theta^2 is below 1e-4 (its series branch
    alone): the same bits, primal and tangent, at the pose graph's
    linearisation point xi = 0, without the sine and cosine its other
    branch would compute and discard."""
    omega, v = xi[..., :3], xi[..., 3:]
    t2 = _sq3(omega)
    ox = _skew(omega)
    a = (1.0 - t2 / 6.0)[..., None]
    b = (0.5 - t2 / 24.0)[..., None]
    cc = (1.0 / 6.0 - t2 / 120.0)[..., None]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    ox2 = mm(ox, ox)
    r = eye + a * ox + b * ox2
    t = mm(eye + b * ox + cc * ox2, v[..., None])[..., 0]
    return _rigid(r, t)


def _edge_residual(xi_i, xi_j, t_i, t_j, z_inv, w):
    """The edges' residuals se3_log(Z^-1 inv(exp(xi_i) T_i) exp(xi_j) T_j) * w
    [..., 6] (w [..., 1]) at xi_i = xi_j = 0 (_exp_se3_small)."""
    a = mm(_exp_se3_small(xi_i), t_i)
    b = mm(_exp_se3_small(xi_j), t_j)
    return _se3_log(mm(z_inv, mm(_inv_rigid(a), b))) * w


def _edge_jacobians(t_i, t_j, z_inv, w) -> Tuple[torch.Tensor, ...]:
    """d residual / d xi_i and d xi_j at xi = 0, [E, 6, 6] each, by forward
    mode: the 12 unit tangents run as one batch [12, E] of dual numbers
    (the arithmetic jacfwd would do, in one pass); and the residuals
    [E, 6], the pass's primal (every tangent's primal is _edge_residual at
    xi = 0, the same elementwise operations on the same values)."""
    e = t_i.shape[0]
    zero = torch.zeros((12, e, 6), dtype=t_i.dtype, device=t_i.device)
    unit = torch.eye(12, dtype=t_i.dtype, device=t_i.device)[:, None, :].expand(12, e, 12)
    batch = lambda x: x.expand(12, *x.shape)  # noqa: E731
    with fwAD.dual_level():
        xi_i = fwAD.make_dual(zero, unit[..., :6].contiguous())
        xi_j = fwAD.make_dual(zero, unit[..., 6:].contiguous())
        r = _edge_residual(xi_i, xi_j, batch(t_i), batch(t_j), batch(z_inv), batch(w))
        primal, jt = fwAD.unpack_dual(r)  # [12, E, 6]: direction, edge, residual
    return jt[:6].permute(1, 2, 0), jt[6:].permute(1, 2, 0), primal[0]


_ANCHOR = 1e3  # the gauge prior's weight on node 0


def optimize_pose_graph(
    poses: torch.Tensor,  # [N, 4, 4] world_T_cam per node
    ei: torch.Tensor,  # [E] edge source node (integer)
    ej: torch.Tensor,  # [E] edge target node (integer)
    z: torch.Tensor,  # [E, 4, 4] measured inv(T_i) @ T_j
    w: torch.Tensor,  # [E] f32 edge weight (0 = padding)
    iters: int = 12,
    damping: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relax keyframe poses against relative-pose constraints.

    Per edge the residual is se3_log(Z^-1 inv(T_i) T_j).  Each iteration
    linearizes around xi=0 (left-multiplicative updates T <- exp(xi) T)
    with forward mode's bits, an edge's rows against its two nodes only
    (they depend on no other), then assembles the damped normal equations
    and solves them: all in one call of
    ops/cuda/pose_graph_kernel.pose_graph_fused (a kernel on the card, its
    plain version on the CPU; _edge_jacobians is the forward-mode
    reference the tests hold it to).  The residuals and
    their Jacobian are float32, as the JAX package's; J^T J and J^T r are
    float64 sums of the exact products in a fixed order (each edge's 6 rows
    in order, the edges added in edge order into the node blocks, then node
    0's gauge prior and the damping), and the [6n, 6n] solve is
    core/exact.solve_lu's LU in float64, rounded once: the same bits on
    every device.  Node 0 is gauge-anchored with a strong prior residual;
    padded nodes are held by the damping term.  Returns (optimized poses,
    per-iteration costs [iters]); nothing reads the device."""
    ei32, ej32 = ei.to(torch.int32).contiguous(), ej.to(torch.int32).contiguous()
    z_inv = _inv_rigid(z)
    diag = _gauge_diag(poses.shape[0], damping, poses.device)
    costs = []
    z_inv, w = z_inv.contiguous(), w.to(_F32).contiguous()
    for _ in range(iters):
        dx, rd = pose_graph_kernel.pose_graph_fused(poses.contiguous(), ei32, ej32, z_inv, w, diag)
        poses = _left_update(dx, poses)
        costs.append(tree_sum(rd.reshape(-1) * rd.reshape(-1)).to(_F32))
    return poses, torch.stack(costs)


def _gauge_diag(n: int, damping: float, dev) -> torch.Tensor:
    """H's added diagonal, f64 [6n]: node 0's gauge prior plus the damping
    (a float32, as the JAX package's)."""
    prior = torch.zeros((6 * n,), dtype=torch.float64, device=dev)
    prior[:6] = _ANCHOR * _ANCHOR
    return prior + float(np.float32(damping))


def _linearize(poses, ei, ej, z_inv, w) -> Tuple[torch.Tensor, ...]:
    """The edges' Jacobians and residuals at poses: (ja, jb f64 [E, 6, 6],
    rd f64 [E, 6]), contiguous, pose_graph_solve's inputs."""
    ei, ej = ei.long(), ej.long()
    t_i, t_j = poses[ei], poses[ej]
    ja, jb, r0 = _edge_jacobians(t_i, t_j, z_inv, w[:, None])  # [E, 6, 6] each, [E, 6]
    return tuple(x.double().contiguous() for x in (ja, jb, r0))


def pose_graph_system(poses, ei, ej, z, w, damping: float = 1e-4) -> tuple:
    """pose_graph_solve's inputs for optimize_pose_graph's first iteration
    on this graph: (ja, jb, rd, ei, ej as int32, diag)."""
    ja, jb, rd = _linearize(poses, ei, ej, _inv_rigid(z), w)
    return (ja, jb, rd, ei.to(torch.int32).contiguous(), ej.to(torch.int32).contiguous(),
            _gauge_diag(poses.shape[0], damping, poses.device))


class PoseGraphStep:
    """optimize_pose_graph as one captured step: the counterpart of the JAX
    `jax.jit(optimize_pose_graph)` (its lax.scan of iterations is one
    device program there).  The graph's host arrays go through pinned
    staging into static device buffers; the body uploads them, runs every
    iteration (one pose_graph_fused launch: the residuals, their Jacobians
    and the solve; then the update and the cost) and copies the poses and
    costs into buffers this step holds (utils/graphs.keep).  On a CUDA
    device the body is captured under a key (nodes, edges, iterations,
    damping, device, the static buffers' address) and replayed after; on
    the CPU, and with capture=False, it runs eagerly."""

    def __init__(self, device, capture: bool = True, graphs: Optional[StepGraphs] = None):
        self.device = torch.device(device)
        self.capture = capture
        self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._inputs = {}
        self._outputs = {}

    def __call__(self, poses: np.ndarray, ei: np.ndarray, ej: np.ndarray, z: np.ndarray,
                 w: np.ndarray, iters: int = 12, damping: float = 1e-4):
        """Host arrays (poses f32 [n, 4, 4], ei / ej int32 [e], z f32 [e, 4,
        4], w f32 [e]) -> (optimized poses f32 [n, 4, 4], costs f32 [iters])
        on the device: the step's own buffers, valid until its next call
        with the same sizes."""
        dev = self.device
        if not self.capture:
            return optimize_pose_graph(
                upload(poses, dev), torch.from_numpy(np.asarray(ei, np.int32)).to(dev),
                torch.from_numpy(np.asarray(ej, np.int32)).to(dev), upload(z, dev),
                upload(w, dev), iters, damping)
        n, e = poses.shape[0], ei.shape[0]
        inputs = self._inputs.get((n, e))
        if inputs is None:
            inputs = self._inputs[(n, e)] = StaticInputs({
                "poses": ((n, 4, 4), _F32), "ei": ((e,), torch.int32),
                "ej": ((e,), torch.int32), "z": ((e, 4, 4), _F32), "w": ((e,), _F32)},
                dev, slots=1)
        inputs.fill(0, poses=poses, ei=ei, ej=ej, z=z, w=w)
        key = (n, e, int(iters), float(damping))
        outputs = self._outputs

        def body():
            inputs.upload(0)
            d = inputs.dev
            keep(outputs, key, *optimize_pose_graph(d["poses"], d["ei"], d["ej"], d["z"],
                                                    d["w"], iters, damping))

        # the static buffers' address: another step's buffers are another graph
        self.graphs.run(("pose_graph",) + key + (str(dev), inputs.dev["poses"].data_ptr()), body)
        inputs.done(0)
        return outputs[key]


def _pad_pow2(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


# ----------------------------------------------------------------------
# Keyframe database + loop-closure manager
# ----------------------------------------------------------------------
class KeyframeQuery(NamedTuple):
    """LoopClosureManager.query's result."""

    depth_half: torch.Tensor  # f32 [H/2, W/2] on the device
    desc: torch.Tensor  # f32 [DESC_DIM] on the device
    scores: object  # f32 [cap]: match_scores on the device, or its host copy


def cap_graph_fits(cap: int, device) -> None:
    """Raise unless the pose graph of `cap` keyframes, padded to a power of
    two of nodes (6 rows each) as a closure pads it, fits in the card's
    memory: its [H | g] (8 m (m + 1) bytes at m rows) with the LU's
    multipliers (pose_graph_kernel.scratch_bytes, about 12 m^2 bytes in
    all; the edges' share is negligible).  The kernel takes any m; on an
    80 GB card the largest cap taken is 8192 keyframes (m = 49152, 29.6
    GB)."""
    n = _pad_pow2(cap)
    need = pose_graph_kernel.scratch_bytes(6 * n)
    total = torch.cuda.get_device_properties(device).total_memory
    if need > total:
        raise ValueError(
            f"max_keyframes={cap} pads to {n} nodes: the pose graph's [H | g] "
            f"({8 * 6 * n * (6 * n + 1) / 1e9:.1f} GB) and its LU's multipliers need "
            f"{need / 1e9:.1f} GB, more than the card's {total / 1e9:.1f} GB")


class LoopClosureManager:
    """Keyframe store, loop detection/verification, pose-graph state.

    Owned by DenseSLAM (loop_closure=True) but usable standalone.  The
    descriptors and ids live on `device`; keyframe depths are kept on the
    host at half resolution (f16) and move to the device only for the
    rare verification ICP (ICPOdometry's captured prep and track, in
    `graphs`).  Each verification reads its pose once
    (odometry.read_result) and counts itself in `verifications`.  A
    keyframe's match reads its best score once; a caller that has its own
    read to make at the keyframe (DenseSLAM: the gate and the pose) takes
    `query` first and reads its scores in the same copy.  The query (the
    descriptor and the match against the whole database, read in place)
    and the pose graph (PoseGraphStep) are captured steps in `graphs` on a
    CUDA device, keyed by their sizes, so a closure is one graph launch
    and one read of its poses; capture=False runs them eagerly.
    """

    def __init__(
        self,
        intrinsics: Tuple[float, float, float, float],
        img_h: int,
        img_w: int,
        kf_every: int = 10,
        min_gap_frames: int = 60,
        sim_thresh: float = 0.975,
        verify_max_rmse: float = 0.04,
        verify_min_inliers: int = 3000,
        max_keyframes: int = 256,
        device="cuda",
        capture: bool = True,
        graphs: Optional[StepGraphs] = None,
    ):
        self.device = resolve_device(device)
        self.capture = capture
        self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self.kf_every = int(kf_every)
        self.min_gap_frames = int(min_gap_frames)
        self.sim_thresh = float(sim_thresh)
        self.verify_max_rmse = float(verify_max_rmse)
        self.verify_min_inliers = int(verify_min_inliers)
        self.cap = int(max_keyframes)
        if self.device.type == "cuda":
            cap_graph_fits(self.cap, self.device)
        self.img_h, self.img_w = img_h, img_w

        # verification tracker at HALF resolution (stored kf depths are
        # decimated 2x: quarter the ICP work, same convergence basin)
        fx, fy, cx, cy = intrinsics
        self._vh, self._vw = img_h // 2, img_w // 2
        self._verify_icp = ICPOdometry(
            (fx / 2, fy / 2, cx / 2, cy / 2), self._vh, self._vw,
            max_rmse=verify_max_rmse, device=self.device, capture=capture, graphs=self.graphs,
        )
        self._pose_graph = PoseGraphStep(self.device, capture, self.graphs)
        self._query_inputs = {}
        self._query_outputs = {}

        # device-side database (descriptors + ids: tiny)
        self.db_desc = torch.zeros((self.cap, DESC_DIM), dtype=_F32, device=self.device)
        self.db_ids = torch.full((self.cap,), _NO_ID, dtype=torch.int32, device=self.device)
        self.count = 0
        # host-side per-keyframe state
        self.kf_frame_ids: List[int] = []
        self.kf_depth_half: List[np.ndarray] = []  # [H/2, W/2] f16
        self.kf_pose_est: List[np.ndarray] = []  # world_T_cam at creation
        self.kf_pose_opt: List[np.ndarray] = []  # current optimized pose
        # pose-graph edges: (i, j, Z 4x4, weight)
        self.edges: List[Tuple[int, int, np.ndarray, float]] = []
        self.closures = 0  # accepted loop constraints so far
        self.verifications = 0  # verification ICPs run (one pose read each)
        # frame-id offset applied to incoming ids: load() sets it past
        # the loaded timeline so a NEW session's frame 0 counts as long
        # after every loaded keyframe
        self.id_offset = 0
        # kf_every gate state (enforced HERE, not by the caller)
        self._last_kf_id: Optional[int] = None
        self.evictions = 0  # keyframes merged away at the cap
        self._cap_warned = False

    def _best_match(self, desc, cur_id: int, min_gap: int,
                    scores: Optional[np.ndarray] = None) -> Tuple[int, float]:
        """_match_scores against the live database, read to the host in
        one copy: (best index, score).  With `scores` (a query's, already
        on the host) the same mask and first maximum are taken there,
        from the host's copy of the ids, and nothing is read."""
        if scores is not None:
            ids = np.full(self.cap, _NO_ID, np.int64)
            ids[:self.count] = self.kf_frame_ids
            ok = (np.arange(self.cap) < self.count) & ((cur_id - ids) >= min_gap)
            masked = np.where(ok, np.asarray(scores, np.float32), np.float32(-2.0))
            best = int(np.argmax(masked))
            return best, float(masked[best])
        best, score = _match_scores(desc, self.db_desc, self.db_ids, self.count,
                                    cur_id, min_gap)
        best_f, score_f = torch.stack([best.to(_F32), score]).tolist()
        return int(best_f), score_f

    def query(self, depth: np.ndarray, intensity: Optional[np.ndarray] = None
              ) -> "KeyframeQuery":
        """A frame's half-res depth, descriptor and raw scores against the
        whole database, on the device and without a read: the caller reads
        `scores` together with what else it reads and passes the query,
        scores on the host, to add_keyframe or relocalize.  The counterpart
        of the JAX `depth_descriptor` and `_match_scores` jits as one
        captured step, keyed by the half-res size, whether there is an
        intensity, the cap, the database's storage and the staging
        buffers: the half-res images go through pinned staging (one slot:
        the caller reads the scores before the next query, so one capture
        serves every keyframe), the database is read in place, and the
        tensors returned are the step's own buffers, valid until its next
        query of that kind."""
        d_half = np.asarray(depth, np.float32)[::2, ::2]
        i_half = None if intensity is None else np.asarray(intensity)[::2, ::2]
        if not self.capture:
            d_half_dev = upload(d_half, self.device)
            inten = None if i_half is None else upload(i_half, self.device)
            desc = depth_descriptor(d_half_dev, inten)
            return KeyframeQuery(d_half_dev, desc, match_scores(self.db_desc, desc))
        shape = d_half.shape
        kind = (shape, i_half is not None)
        inputs = self._query_inputs.get(kind)
        if inputs is None:
            specs = {"depth": (shape, _F32)}
            if i_half is not None:
                specs["intensity"] = (shape, _F32)
            inputs = self._query_inputs[kind] = StaticInputs(specs, self.device, slots=1)
        inputs.fill(0, depth=d_half, **({} if i_half is None else {"intensity": i_half}))
        db, outputs = self.db_desc, self._query_outputs

        def body():
            inputs.upload(0)
            d = inputs.dev["depth"]
            desc = depth_descriptor(d, inputs.dev.get("intensity"))
            keep(outputs, kind, d, desc, match_scores(db, desc))

        self.graphs.run(("lc_query",) + kind + (self.cap, db.data_ptr(),
                                                inputs.dev["depth"].data_ptr()), body)
        inputs.done(0)
        return KeyframeQuery(*outputs[kind])

    def _query_or_descriptor(self, depth, intensity, query) -> tuple:
        """(half-res depth, descriptor, host scores or None): the query's,
        or a query run here (its scores left on the device)."""
        if query is None:
            query = self.query(depth, intensity)._replace(scores=None)
        return tuple(query)

    # ------------------------------------------------------------------
    def _verify(
        self, depth_half_cur: torch.Tensor, kf_idx: int, seed_world_T_cam: np.ndarray,
    ) -> Optional[np.ndarray]:
        """Geometric check of a candidate: multi-level ICP of the current
        half-res depth against the keyframe's.  Returns the converged
        world_T_cam of the CURRENT frame in the keyframe's frame, or
        None when the rmse/inlier gate rejects."""
        icp = self._verify_icp
        pyr_ref = icp.prep(self.kf_depth_half[kf_idx])
        pyr_cur = icp.prep(depth_half_cur)
        ref_pose = upload(np.linalg.inv(self.kf_pose_opt[kf_idx]), self.device)
        t, rmse, inl = read_result(*icp.track(
            upload(seed_world_T_cam, self.device), pyr_cur, pyr_ref, ref_pose))
        self.verifications += 1
        rmse_f, inl_f = float(rmse), float(inl)
        if not np.isfinite(rmse_f) or rmse_f >= self.verify_max_rmse:
            return None
        if inl_f <= self.verify_min_inliers:
            return None
        return np.asarray(t, np.float32)

    # ------------------------------------------------------------------
    def add_keyframe(
        self,
        depth: np.ndarray,
        world_T_cam_est: np.ndarray,
        frame_id: int,
        intensity: Optional[np.ndarray] = None,
        query: Optional["KeyframeQuery"] = None,
    ) -> Optional[np.ndarray]:
        """Store a keyframe; detect + close loops.

        Returns a 4x4 world-frame CORRECTION (apply as
        world_T_cam <- C @ world_T_cam to the live tracker) when a loop
        closed, else None.  depth: full-res [H, W] float metres;
        intensity: optional full-res [H, W] grayscale (any scale); query:
        self.query(depth, intensity) with its scores read to the host (a
        merge at the cap moves the database, and the match then reads
        again).

        The kf_every cadence is enforced HERE; at the max_keyframes cap
        the most redundant keyframe is merged away (see _evict_one)."""
        frame_id = int(frame_id) + self.id_offset
        if self._last_kf_id is not None and frame_id - self._last_kf_id < self.kf_every:
            return None  # cadence gate (kf_every)
        if self.count >= self.cap:
            if not self._cap_warned:
                logger.warning(
                    "loop-closure keyframe database hit its cap (%d); "
                    "merging the most redundant keyframes from here on "
                    "(raise max_keyframes to keep full history)", self.cap)
                self._cap_warned = True
            self._evict_one()
            if query is not None:
                query = query._replace(scores=None)
        depth = np.asarray(depth, np.float32)
        d_half = depth[::2, ::2]
        d_half_dev, desc, scores = self._query_or_descriptor(depth, intensity, query)

        # --- detection BEFORE insertion (never match self) ---
        correction = None
        best, score_f = self._best_match(desc, frame_id, self.min_gap_frames, scores)
        pose_est = np.asarray(world_T_cam_est, np.float32)

        j = self.count  # index of the node we are about to insert
        self.kf_frame_ids.append(int(frame_id))
        self.kf_depth_half.append(d_half.astype(np.float16))
        self.kf_pose_est.append(pose_est.copy())
        self.kf_pose_opt.append(pose_est.copy())
        self.db_desc[j] = desc
        self.db_ids[j] = frame_id
        self.count += 1
        self._last_kf_id = frame_id
        # odometry edge from the previous keyframe (in the pose_opt frame)
        if j > 0:
            z = np.linalg.inv(self.kf_pose_opt[j - 1]) @ pose_est
            self.edges.append((j - 1, j, z.astype(np.float32), 1.0))

        if score_f >= self.sim_thresh and j > 0:
            t_loop = self._verify(d_half_dev, best, self.kf_pose_opt[best])
            if t_loop is not None:
                z = np.linalg.inv(self.kf_pose_opt[best]) @ t_loop
                # loop edges weigh more than odometry: the ICP verify
                # measured them directly against old geometry
                self.edges.append((best, j, z.astype(np.float32), 4.0))
                self.closures += 1
                correction = self._optimize_and_correct(j)
        return correction

    # ------------------------------------------------------------------
    def _evict_one(self) -> None:
        """Merge away the most redundant keyframe to make room at the cap.

        Redundancy = smallest motion to the PREVIOUS keyframe.  Node 0
        (gauge anchor) and the newest node are never evicted; nodes
        holding loop edges are preferred KEPT, and only if every interior
        node carries a loop edge does the evictee drop its loop edges.
        The evictee's two odometry edges compose into one (z = z1 @ z2),
        so the chain stays connected."""
        n = self.count
        if n < 3:
            return
        has_loop = np.zeros(n, bool)
        for i, j, _z, _w in self.edges:
            if abs(i - j) != 1:
                has_loop[i] = has_loop[j] = True
        best_k, best_d = -1, np.inf
        for k in range(1, n - 1):
            if has_loop[k]:
                continue
            a, b = self.kf_pose_opt[k - 1], self.kf_pose_opt[k]
            dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
            cos_t = np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)
            d = dt + 2.0 * float(np.arccos(cos_t))
            if d < best_d:
                best_k, best_d = k, d
        dropped_loops = 0
        if best_k < 0:
            # every interior node anchors a loop: evict the one whose
            # loop edges we can best afford to lose (fewest of them)
            counts = np.zeros(n, np.int32)
            for i, j, _z, _w in self.edges:
                if abs(i - j) != 1:
                    counts[i] += 1
                    counts[j] += 1
            best_k = 1 + int(np.argmin(counts[1 : n - 1]))
        k = best_k
        # stitch odometry chain through k, remap indices, drop k's loops
        z1 = z2 = None
        w1 = w2 = 1.0
        new_edges = []
        for i, j, z, w in self.edges:
            if abs(i - j) == 1 and j == k:
                z1, w1 = z, w
                continue
            if abs(i - j) == 1 and i == k:
                z2, w2 = z, w
                continue
            if i == k or j == k:
                dropped_loops += 1
                continue
            new_edges.append((i - (i > k), j - (j > k), z, w))
        if z1 is not None and z2 is not None:
            new_edges.append((k - 1, k, (z1 @ z2).astype(np.float32), min(w1, w2)))
        self.edges = new_edges
        if dropped_loops:
            logger.warning(
                "keyframe eviction dropped %d loop edge(s) of node %d "
                "(every interior node anchored a loop)", dropped_loops, k)
        for lst in (self.kf_frame_ids, self.kf_depth_half, self.kf_pose_est,
                    self.kf_pose_opt):
            lst.pop(k)
        # shift the device rows down over k (clones: the slices overlap)
        self.db_desc[k : n - 1] = self.db_desc[k + 1 : n].clone()
        self.db_ids[k : n - 1] = self.db_ids[k + 1 : n].clone()
        self.db_desc[n - 1] = 0.0
        self.db_ids[n - 1] = _NO_ID
        self.count -= 1
        self.evictions += 1

    # ------------------------------------------------------------------
    def _optimize_and_correct(self, newest: int) -> np.ndarray:
        """Relax the graph; return the world correction for the newest
        node (optimized @ inv(estimated))."""
        n = self.count
        n_pad = _pad_pow2(n)
        e = len(self.edges)
        e_pad = _pad_pow2(max(e, 1))
        poses = np.stack(self.kf_pose_opt + [np.eye(4, dtype=np.float32)] * (n_pad - n))
        ei = np.zeros(e_pad, np.int32)
        ej = np.zeros(e_pad, np.int32)
        z = np.tile(np.eye(4, dtype=np.float32), (e_pad, 1, 1))
        w = np.zeros(e_pad, np.float32)
        for k, (i, j, zz, ww) in enumerate(self.edges):
            ei[k], ej[k], z[k], w[k] = i, j, zz, ww
        opt, _costs = self._pose_graph(poses, ei, ej, z, w)
        opt = opt.cpu().numpy().astype(np.float32)
        before = self.kf_pose_opt[newest].copy()
        for k in range(n):
            self.kf_pose_opt[k] = opt[k]
        return (opt[newest] @ np.linalg.inv(before)).astype(np.float32)

    # ------------------------------------------------------------------
    def relocalize(
        self, depth: np.ndarray, intensity: Optional[np.ndarray] = None,
        query: Optional["KeyframeQuery"] = None,
    ) -> Optional[np.ndarray]:
        """Recover a pose from the keyframe database after tracking
        loss: best descriptor match (no recency gap) + ICP verify, seeded
        at the matched keyframe's pose.  Returns world_T_cam or None.
        Pass the same intensity channel used for add_keyframe; query as
        add_keyframe takes it."""
        if self.count == 0:
            return None
        d_half_dev, desc, scores = self._query_or_descriptor(depth, intensity, query)
        best, score_f = self._best_match(desc, 0, _NO_ID, scores)
        if score_f < self.sim_thresh:
            return None
        return self._verify(d_half_dev, best, self.kf_pose_opt[best])

    # ------------------------------------------------------------------
    def correct_trajectory(
        self, frame_ids: np.ndarray, poses_cam_T_world: np.ndarray
    ) -> np.ndarray:
        """Retro-correct a per-frame trajectory: each frame gets the
        optimized-vs-estimated delta of its most recent keyframe."""
        if self.count == 0:
            return poses_cam_T_world
        kf_ids = np.asarray(self.kf_frame_ids)
        out = np.array(poses_cam_T_world, np.float32, copy=True)
        for n, fid in enumerate(np.asarray(frame_ids) + self.id_offset):
            k = int(np.searchsorted(kf_ids, fid, side="right")) - 1
            if k < 0:
                continue
            c = self.kf_pose_opt[k] @ np.linalg.inv(self.kf_pose_est[k])
            world_T_cam = np.linalg.inv(out[n])
            out[n] = np.linalg.inv(c @ world_T_cam)
        return out

    # ------------------------------------------------------------------
    # Map database persistence (run_zed_native.cc:88 save_map_database),
    # in the JAX package's npz keys
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            desc=self.db_desc[: self.count].cpu().numpy(),
            frame_ids=np.asarray(self.kf_frame_ids, np.int64),
            depth_half=np.stack(self.kf_depth_half)
            if self.kf_depth_half else np.zeros((0, 1, 1), np.float16),
            pose_est=np.stack(self.kf_pose_est)
            if self.kf_pose_est else np.zeros((0, 4, 4), np.float32),
            pose_opt=np.stack(self.kf_pose_opt)
            if self.kf_pose_opt else np.zeros((0, 4, 4), np.float32),
            edges_ij=np.asarray([(i, j) for i, j, _, _ in self.edges], np.int64).reshape(-1, 2),
            edges_z=np.stack([z for _, _, z, _ in self.edges])
            if self.edges else np.zeros((0, 4, 4), np.float32),
            edges_w=np.asarray([w for _, _, _, w in self.edges], np.float32),
            meta=np.asarray([self.img_h, self.img_w, self.kf_every], np.int64),
        )

    def load(self, path: str) -> None:
        d = np.load(path)
        n = int(d["frame_ids"].shape[0])
        if n > self.cap:
            raise ValueError(f"{path}: {n} keyframes exceed the cap {self.cap}")
        self.count = n
        self.kf_frame_ids = [int(x) for x in d["frame_ids"]]
        self.kf_depth_half = [x for x in d["depth_half"]]
        self.kf_pose_est = [x.astype(np.float32) for x in d["pose_est"]]
        self.kf_pose_opt = [x.astype(np.float32) for x in d["pose_opt"]]
        desc = np.zeros((self.cap, DESC_DIM), np.float32)
        loaded = np.asarray(d["desc"], np.float32)
        if loaded.shape[1] == _DESC_DIM_V1:
            # geometry-only database from before the appearance channel:
            # zero appearance cells match depth_descriptor(intensity=None)
            desc[:n, :_DESC_DIM_V1] = loaded
        else:
            desc[:n] = loaded
        ids = np.full((self.cap,), _NO_ID, np.int64)
        ids[:n] = d["frame_ids"]
        # in place: a captured query reads the database where it lies
        self.db_desc.copy_(upload(desc, self.device))
        self.db_ids.copy_(torch.as_tensor(ids.astype(np.int32)))
        self.edges = [
            (int(ij[0]), int(ij[1]), z.astype(np.float32), float(w))
            for ij, z, w in zip(d["edges_ij"], d["edges_z"], d["edges_w"])
        ]
        # place the NEW session's frame ids after the loaded timeline
        self.id_offset = max(self.kf_frame_ids) + self.min_gap_frames + 1 if n else 0
        # the id_offset already spaces new ids past the loaded timeline
        # by more than kf_every, so the cadence gate restarts cleanly
        self._last_kf_id = max(self.kf_frame_ids) if n else None
