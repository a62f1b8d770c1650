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
                se3-log of edge misclosures, the Jacobian comes from
                torch.func.jacfwd (vmap over the edges), and the normal
                equations solve with linalg.solve_ex
  correction    the newest keyframe's optimized-vs-estimated delta is
                applied to the live tracker pose; already-fused drifted
                geometry stays, the trajectory is corrected retroactively
  reloc + map   after tracking loss the same match+verify pipeline
                re-seeds the pose; the database saves/loads as one npz
                with the JAX package's keys, so maps cross both ways.

The JAX package has no Pallas kernel here.  The Lie helpers build their
matrices by stacking (torch.func cannot trace a write into a fresh
tensor) and keep the JAX package's double-where guards; their per-sample
scalars keep a length-1 axis, because forward-mode AD promotes a 0-d
float32 combined with a Python float to float64.  Everything runs with
TF32 off (`exact_fp32`).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..utils.device import exact_fp32, resolve_device, upload
from .odometry import ICPOdometry, read_result, rigid_4x4, skew

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
def _exp_se3_mat(xi: torch.Tensor) -> torch.Tensor:
    """se3 exp to a 4x4 matrix, differentiable at xi=0: the
    unnormalized-skew Rodrigues form with series coefficients below
    theta^2 = 1e-4 (double-where safe)."""
    omega, v = xi[:3], xi[3:]
    t2 = torch.sum(omega * omega, 0, keepdim=True)
    ox = skew(omega)
    small = t2 < 1e-4
    t2s = torch.where(small, 1.0, t2)
    theta = torch.sqrt(t2s)
    s, c = torch.sin(theta), torch.cos(theta)
    a = torch.where(small, 1.0 - t2 / 6.0, s / theta)  # sin/theta
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - c) / t2s)
    cc = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (theta - s) / (t2s * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    ox2 = ox @ ox
    r = eye + a * ox + b * ox2
    t = (eye + b * ox + cc * ox2) @ v
    return rigid_4x4(r, t)


def _so3_log(r: torch.Tensor) -> torch.Tensor:
    """SO3 log: rotation matrix -> axis-angle vector [3].

    Differentiable at theta=0: no arccos and no norm-of-zero; the small
    branch is a series in |vee|^2, and the large branch's inputs are
    swapped to safe values where untaken so NaN can't leak through the
    where (the double-where pattern).  Loop misclosures are small
    rotations, far from theta=pi."""
    vee = torch.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    # = 2 sin(theta) * axis
    trace = (r[0, 0] + r[1, 1] + r[2, 2]).reshape(1)
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    s2 = torch.sum(vee * vee, 0, keepdim=True)  # = 4 sin^2(theta)
    small = s2 < 4e-4  # sin(theta) < 0.01
    s2_safe = torch.where(small, 1.0, s2)
    sin_t = 0.5 * torch.sqrt(s2_safe)
    theta = torch.atan2(sin_t, cos_t)
    # theta/(2 sin) = 0.5 + theta^2/12 + ...; theta^2 ~= s2/4 near 0
    fac = torch.where(small, 0.5 + s2 / 48.0, theta / (2.0 * sin_t))
    return fac * vee


def _se3_log(m: torch.Tensor) -> torch.Tensor:
    """SE3 log: 4x4 -> xi = (omega[3], v[3]); inverse of _exp_se3_mat,
    with V^-1 built from the unnormalized skew and its coefficient
    series-expanded below the float32 cancellation floor of 1-cos."""
    omega = _so3_log(m[:3, :3])
    t2 = torch.sum(omega * omega, 0, keepdim=True)
    ox = skew(omega)
    small = t2 < 1e-4
    t2_safe = torch.where(small, 1.0, t2)
    theta = torch.sqrt(t2_safe)
    s, c = torch.sin(theta), torch.cos(theta)
    # (1 - theta sin / (2 (1-cos))) / theta^2 -> 1/12 + theta^2/720 + ...
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       (1.0 - theta * s / (2.0 * (1.0 - c))) / t2_safe)
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    v_inv = eye - 0.5 * ox + coef * (ox @ ox)
    return torch.cat([omega, v_inv @ m[:3, 3]])


def _inv_rigid(m: torch.Tensor) -> torch.Tensor:
    """Exact inverse of rigid 4x4s [..., 4, 4] (R^T | -R^T t)."""
    rt = m[..., :3, :3].transpose(-1, -2)
    t = torch.einsum("...ij,...j->...i", rt, -m[..., :3, 3])
    bottom = torch.eye(4, dtype=m.dtype, device=m.device)[3:].expand(*m.shape[:-2], 1, 4)
    return torch.cat([torch.cat([rt, t[..., None]], -1), bottom], -2)


# ----------------------------------------------------------------------
# Place-recognition descriptor + matcher
# ----------------------------------------------------------------------
def _unit(v: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(v)
    return v / torch.where(n > 0, n, 1.0)


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
    appearance half with zeros (geometry-only legacy databases)."""
    h, w = depth.shape
    ch, cw = h // gh, w // gw
    d = depth[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
    valid = (d > 0).to(_F32)
    cnt = valid.sum((1, 3))
    mean = d.sum((1, 3)) / torch.clamp(cnt, min=1.0)
    # a device-tensor divisor (torch divides by a Python scalar on the
    # card through its reciprocal)
    frac = cnt / torch.full((), float(ch * cw), dtype=_F32, device=depth.device)
    geo = torch.cat([mean.reshape(-1), frac.reshape(-1)])
    geo = _unit(geo - torch.mean(geo))
    if intensity is None:
        # keep the geometry half at full weight so legacy geometry-only
        # descriptors compare to each other with the old similarity
        return torch.cat([geo, torch.zeros(gh * gw, dtype=_F32, device=depth.device)])
    ii = intensity[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
    imean = ii.mean((1, 3)).reshape(-1)
    app = _unit(imean - torch.mean(imean))
    inv_s2 = 0.7071067811865476
    return torch.cat([geo * inv_s2, app * inv_s2])


def _match_scores(desc, db_desc, db_ids, count, cur_id, min_gap):
    """Cosine similarity of desc [D] vs the whole database db_desc
    [cap, D] (one matvec), masked to live slots (index < count) whose
    frame id db_ids [cap] lies at least min_gap before cur_id (<= 0
    disables the gap); returns (best_idx, score) as device tensors, the
    first maximum on ties."""
    with exact_fp32():
        scores = db_desc @ desc
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
    return vmap(lambda x, m: _exp_se3_mat(x) @ m)(xi, poses)


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
    linearizes with jacfwd around xi=0 (left-multiplicative updates
    T <- exp(xi) T), assembles the damped normal equations and solves
    them on the device (float32, as the JAX package).  Node 0 is
    gauge-anchored with a strong prior residual; padded nodes are held by
    the damping term.  Returns (optimized poses, per-iteration costs
    [iters]); nothing reads the device."""
    n = poses.shape[0]
    dev = poses.device
    ei, ej = ei.long(), ej.long()
    with exact_fp32():
        z_inv = _inv_rigid(z)

        def residuals(xi: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
            t = _left_update(xi, p)
            rel = torch.einsum("eab,ebc->eac", _inv_rigid(t[ei]), t[ej])
            mis = torch.einsum("eab,ebc->eac", z_inv, rel)
            r = vmap(_se3_log)(mis) * w[:, None]
            anchor = xi[0] * 1e3  # gauge fix: node 0 stays put
            return torch.cat([r.reshape(-1), anchor])

        xi0 = torch.zeros((n, 6), dtype=_F32, device=dev)
        damp = damping * torch.eye(n * 6, dtype=_F32, device=dev)
        costs = []
        for _ in range(iters):
            f = lambda xi: residuals(xi, poses)  # noqa: E731
            r0 = f(xi0)
            jac = jacfwd(f)(xi0).reshape(r0.shape[0], n * 6)
            h = jac.T @ jac + damp
            dx = -torch.linalg.solve_ex(h, jac.T @ r0, check_errors=False).result
            poses = _left_update(dx.reshape(n, 6), poses)
            costs.append(torch.sum(r0 * r0))
    return poses, torch.stack(costs)


def _pad_pow2(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


# ----------------------------------------------------------------------
# Keyframe database + loop-closure manager
# ----------------------------------------------------------------------
class LoopClosureManager:
    """Keyframe store, loop detection/verification, pose-graph state.

    Owned by DenseSLAM (loop_closure=True) but usable standalone.  The
    descriptors and ids live on `device`; keyframe depths are kept on the
    host at half resolution (f16) and move to the device only for the
    rare verification ICP.  Each verification reads its pose once
    (odometry.read_result) and counts itself in `verifications`.
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
    ):
        self.device = resolve_device(device)
        self.kf_every = int(kf_every)
        self.min_gap_frames = int(min_gap_frames)
        self.sim_thresh = float(sim_thresh)
        self.verify_max_rmse = float(verify_max_rmse)
        self.verify_min_inliers = int(verify_min_inliers)
        self.cap = int(max_keyframes)
        self.img_h, self.img_w = img_h, img_w

        # verification tracker at HALF resolution (stored kf depths are
        # decimated 2x: quarter the ICP work, same convergence basin)
        fx, fy, cx, cy = intrinsics
        self._vh, self._vw = img_h // 2, img_w // 2
        self._verify_icp = ICPOdometry(
            (fx / 2, fy / 2, cx / 2, cy / 2), self._vh, self._vw,
            max_rmse=verify_max_rmse, device=self.device,
        )

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

    def _best_match(self, desc, cur_id: int, min_gap: int) -> Tuple[int, float]:
        """_match_scores against the live database, read to the host in
        one copy: (best index, score)."""
        best, score = _match_scores(desc, self.db_desc, self.db_ids, self.count,
                                    cur_id, min_gap)
        best_f, score_f = torch.stack([best.to(_F32), score]).tolist()
        return int(best_f), score_f

    def _descriptor(self, depth: np.ndarray, intensity: Optional[np.ndarray]):
        """(half-res depth on the device, its descriptor)."""
        d_half_dev = upload(np.asarray(depth)[::2, ::2], self.device)
        inten_half = (upload(np.asarray(intensity)[::2, ::2], self.device)
                      if intensity is not None else None)
        return d_half_dev, depth_descriptor(d_half_dev, inten_half)

    # ------------------------------------------------------------------
    def _verify(
        self, depth_half_cur: torch.Tensor, kf_idx: int, seed_world_T_cam: np.ndarray,
    ) -> Optional[np.ndarray]:
        """Geometric check of a candidate: multi-level ICP of the current
        half-res depth against the keyframe's.  Returns the converged
        world_T_cam of the CURRENT frame in the keyframe's frame, or
        None when the rmse/inlier gate rejects."""
        icp = self._verify_icp
        kf_depth = upload(self.kf_depth_half[kf_idx], self.device)
        pyr_ref = icp._prep(kf_depth)
        pyr_cur = icp._prep(depth_half_cur)
        ref_pose = upload(np.linalg.inv(self.kf_pose_opt[kf_idx]), self.device)
        t, rmse, inl = read_result(*icp._track(
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
    ) -> Optional[np.ndarray]:
        """Store a keyframe; detect + close loops.

        Returns a 4x4 world-frame CORRECTION (apply as
        world_T_cam <- C @ world_T_cam to the live tracker) when a loop
        closed, else None.  depth: full-res [H, W] float metres;
        intensity: optional full-res [H, W] grayscale (any scale).

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
        depth = np.asarray(depth, np.float32)
        d_half = depth[::2, ::2]
        d_half_dev, desc = self._descriptor(depth, intensity)

        # --- detection BEFORE insertion (never match self) ---
        correction = None
        best, score_f = self._best_match(desc, frame_id, self.min_gap_frames)
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
        dev = self.device
        opt, _costs = optimize_pose_graph(
            upload(poses, dev), torch.from_numpy(ei).to(dev), torch.from_numpy(ej).to(dev),
            upload(z, dev), upload(w, dev))
        opt = opt.cpu().numpy().astype(np.float32)
        before = self.kf_pose_opt[newest].copy()
        for k in range(n):
            self.kf_pose_opt[k] = opt[k]
        return (opt[newest] @ np.linalg.inv(before)).astype(np.float32)

    # ------------------------------------------------------------------
    def relocalize(
        self, depth: np.ndarray, intensity: Optional[np.ndarray] = None
    ) -> Optional[np.ndarray]:
        """Recover a pose from the keyframe database after tracking
        loss: best descriptor match (no recency gap) + ICP verify, seeded
        at the matched keyframe's pose.  Returns world_T_cam or None.
        Pass the same intensity channel used for add_keyframe."""
        if self.count == 0:
            return None
        d_half_dev, desc = self._descriptor(depth, intensity)
        best, score_f = self._best_match(desc, 0, _NO_ID)
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
        self.db_desc = upload(desc, self.device)
        self.db_ids = torch.as_tensor(ids.astype(np.int32)).to(self.device)
        self.edges = [
            (int(ij[0]), int(ij[1]), z.astype(np.float32), float(w))
            for ij, z, w in zip(d["edges_ij"], d["edges_z"], d["edges_w"])
        ]
        # place the NEW session's frame ids after the loaded timeline
        self.id_offset = max(self.kf_frame_ids) + self.min_gap_frames + 1 if n else 0
        # the id_offset already spaces new ids past the loaded timeline
        # by more than kf_every, so the cadence gate restarts cleanly
        self._last_kf_id = max(self.kf_frame_ids) if n else None
