"""Trajectory evaluation: ATE and RPE in the TUM RGB-D convention
(counterpart of disinfect_slam_tpu/utils/trajectory_eval.py).

The reference exports matched trajectories for exactly this purpose —
`SaveMatchedTrajectory` writes one `id r00 r01 r02 t0 ... t2` row per
tracked frame (slam_module.cc:20-66) and the README points users at the
TUM RGB-D benchmark tooling to score them.  The reference repo itself
ships no evaluator; this module closes that loop so a reconstruction /
tracking run can be scored in-framework:

- **ATE** (absolute trajectory error): Umeyama/Horn-align the estimated
  camera centers to ground truth (rigid by default, optional scale),
  then report translational error stats.
- **RPE** (relative pose error): per-pair local drift
  ``E = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d})`` over a fixed frame delta,
  reported as translational drift and rotation angle stats.

Both accept trajectories in either on-disk format used here:
the reference's 13-field `trajectory.txt` rows (3x4 row-major
cam_T_world, io/dataset.py LoggedReplay) or TUM's 8-field
`ts tx ty tz qx qy qz qw` rows (world_T_cam).  Pure numpy — this is an
offline scoring tool, not a device path.

The JAX package's module is plain numpy; it is restated here, line for
line (tests/test_torch_slam_host.py pins the two together), so that the
port and the GPU smoke run load nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "load_trajectory",
    "associate",
    "umeyama_alignment",
    "apply_alignment",
    "ate",
    "rpe",
]


def _quat_to_rot(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    q = np.array([qw, qx, qy, qz], np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def load_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a trajectory file -> (stamps f64 [N], world_T_cam f64 [N,4,4]).

    Auto-detects the row format:
      - 13 fields: `id r00 r01 r02 t0 r10 .. t2` — 3x4 row-major
        cam_T_world (the reference's trajectory.txt,
        slam_module.cc:20-66); inverted here so every caller sees
        world_T_cam (camera centers in t).
      - 8 fields: TUM `ts tx ty tz qx qy qz qw` — world_T_cam directly.
    Lines starting with '#' and blank lines are skipped.
    """
    stamps: List[float] = []
    poses: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            vals = [float(p) for p in parts]
            if len(parts) == 13:
                m = np.eye(4, dtype=np.float64)
                m[:3, :4] = np.array(vals[1:], np.float64).reshape(3, 4)
                r, t = m[:3, :3], m[:3, 3]
                inv = np.eye(4, dtype=np.float64)
                inv[:3, :3] = r.T
                inv[:3, 3] = -r.T @ t
                stamps.append(vals[0])
                poses.append(inv)
            elif len(parts) == 8:
                m = np.eye(4, dtype=np.float64)
                m[:3, :3] = _quat_to_rot(vals[4], vals[5], vals[6], vals[7])
                m[:3, 3] = vals[1:4]
                stamps.append(vals[0])
                poses.append(m)
            else:
                raise ValueError(
                    f"{path}: unrecognized row with {len(parts)} fields "
                    "(expected 13 [id + 3x4 matrix] or 8 [TUM])"
                )
    if not poses:
        raise ValueError(f"{path}: no trajectory rows")
    return np.array(stamps, np.float64), np.stack(poses)


def associate(
    stamps_a: np.ndarray, stamps_b: np.ndarray, max_dt: float = 0.02
) -> List[Tuple[int, int]]:
    """Greedy nearest-stamp matching (the TUM associate.py algorithm):
    all candidate pairs within max_dt sorted by |dt|, taken greedily so
    each index appears at most once.  Returns index pairs sorted by the
    a-side stamp order."""
    sa = np.asarray(stamps_a, np.float64)
    sb = np.asarray(stamps_b, np.float64)
    cand = []
    for i, t in enumerate(sa):
        dt = np.abs(sb - t)
        for j in np.nonzero(dt <= max_dt)[0]:
            cand.append((dt[j], i, int(j)))
    cand.sort(key=lambda x: x[0])
    used_a, used_b = set(), set()
    pairs = []
    for _, i, j in cand:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        pairs.append((i, j))
    pairs.sort()
    return pairs


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Closed-form (s, R, t) minimizing ||dst - (s R src + t)||^2
    (Umeyama 1991).  src/dst are [N, 3] point sets; rigid (s=1) unless
    with_scale."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    assert src.shape == dst.shape and src.ndim == 2 and src.shape[1] == 3
    n = src.shape[0]
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / n
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1.0
    rot = u @ s_fix @ vt
    if with_scale:
        var_s = (xs * xs).sum() / n
        scale = float(np.trace(np.diag(d) @ s_fix) / var_s) if var_s > 0 else 1.0
    else:
        scale = 1.0
    t = mu_d - scale * rot @ mu_s
    return scale, rot, t


def apply_alignment(
    points: np.ndarray, s: float, rot: np.ndarray, t: np.ndarray
) -> np.ndarray:
    return s * np.asarray(points, np.float64) @ rot.T + t


def _stats(err: np.ndarray) -> Dict[str, float]:
    err = np.asarray(err, np.float64)
    return {
        "rmse": float(np.sqrt((err * err).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "n": int(err.size),
    }


def ate(
    gt_poses: np.ndarray,
    est_poses: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> Dict[str, object]:
    """Absolute trajectory error over pre-associated pose arrays
    ([N,4,4] world_T_cam each).  Aligns estimated camera centers to
    ground truth first (rigid Umeyama; with_scale for monocular-style
    scale-free estimates), then reports translational error stats plus
    the alignment used."""
    gt = np.asarray(gt_poses, np.float64)[:, :3, 3]
    est = np.asarray(est_poses, np.float64)[:, :3, 3]
    assert gt.shape == est.shape, (gt.shape, est.shape)
    if align:
        s, rot, t = umeyama_alignment(est, gt, with_scale=with_scale)
    else:
        s, rot, t = 1.0, np.eye(3), np.zeros(3)
    est_aligned = apply_alignment(est, s, rot, t)
    err = np.linalg.norm(gt - est_aligned, axis=1)
    out: Dict[str, object] = _stats(err)
    out["scale"] = float(s)
    out["rotation"] = rot
    out["translation"] = t
    return out


def rpe(
    gt_poses: np.ndarray, est_poses: np.ndarray, delta: int = 1
) -> Dict[str, object]:
    """Relative pose error at a fixed frame delta: for each i,
    E = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d}) with Q=gt, P=est;
    translational drift ||trans(E)|| and rotation angle of E."""
    gt = np.asarray(gt_poses, np.float64)
    est = np.asarray(est_poses, np.float64)
    assert gt.shape == est.shape and gt.ndim == 3
    n = gt.shape[0]
    if not (0 < delta < n):
        raise ValueError(f"delta {delta} out of range for {n} poses")
    terr, rerr = [], []
    for i in range(n - delta):
        dq = np.linalg.inv(gt[i]) @ gt[i + delta]
        dp = np.linalg.inv(est[i]) @ est[i + delta]
        e = np.linalg.inv(dq) @ dp
        terr.append(np.linalg.norm(e[:3, 3]))
        # rotation angle from the trace, clamped against fp drift
        c = (np.trace(e[:3, :3]) - 1.0) / 2.0
        rerr.append(float(np.arccos(np.clip(c, -1.0, 1.0))))
    return {
        "trans": _stats(np.array(terr)),
        "rot_rad": _stats(np.array(rerr)),
        "delta": int(delta),
    }
