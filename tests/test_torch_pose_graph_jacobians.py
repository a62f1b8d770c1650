"""PyTorch port, the pose graph's residuals and Jacobians written out
(ops/cuda/pose_graph_kernel.edge_jacobians_reference, the plain version of
the fused kernel entry) against torch's forward mode
(systems/loop_closure._edge_jacobians) on the CPU, bit for bit as integer
views so that the sign of zero counts: drifting graphs of 8 to 32 nodes,
the soak's first closure, padded edges only, and misclosures one float32
step either side of the logarithms' branch thresholds.  Then the fused
entry's plain side against the forward-mode Jacobians and the solve it
replaced, and its input checks.  Inputs come from numpy seeds."""

import os

import numpy as np
import pytest
import torch

from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
from disinfect_slam_tpu_torch.systems import loop_closure as tlc

from .torch_cases import pose_graph_case

torch.set_num_threads(1)

SOAK_GRAPH = os.path.join(os.path.dirname(__file__), "data", "soak_first_closure_graph.npz")
# the branch thresholds as the float32 comparisons take them: s2 < 4e-4 in
# _so3_log, t2 < 1e-4 in _se3_log
S2_SMALL, T2_SMALL = np.float32(4e-4), np.float32(1e-4)


def _ints(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _rotations(axis: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Rodrigues in float64, rounded to float32: [N, 3, 3]."""
    k = np.zeros((len(theta), 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    k[:, 1, 0], k[:, 2, 0], k[:, 2, 1] = axis[:, 2], -axis[:, 1], axis[:, 0]
    s, c = np.sin(theta)[:, None, None], np.cos(theta)[:, None, None]
    return (np.eye(3) + s * k + (1 - c) * k @ k).astype(np.float32)


def _branch_values(r: torch.Tensor):
    """(s2, t2) of rotations [N, 3, 3] as _so3_log and _se3_log compute them."""
    vee = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                       r[..., 1, 0] - r[..., 0, 1]], -1)
    return tlc._sq3(vee)[:, 0], tlc._sq3(tlc._so3_log(r))[:, 0]


def threshold_case(seed: int = 0) -> tuple:
    """A graph whose edges' misclosures sit one float32 step below, at and
    one step above each branch threshold: node 0 at the identity, nodes 1-6
    rotated by ~0.01 rad (s2 of the first three, t2 of the last three on
    those values), edges 0 -> k measured as the identity (so the misclosure
    is node k's rotation), weight 1, and padded edges to 16."""
    rng = np.random.default_rng(seed)
    n = 20000
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rots = _rotations(axis, 0.01 + rng.uniform(-2e-7, 2e-7, n))
    s2, t2 = (v.numpy() for v in _branch_values(torch.from_numpy(rots)))
    picks = []
    for values, at in ((s2, S2_SMALL), (t2, T2_SMALL)):
        for target in (np.nextafter(at, np.float32(0)), at, np.nextafter(at, np.float32(1))):
            hits = np.nonzero(values == target)[0]
            assert len(hits), f"no rotation at {target}"
            picks.append(int(hits[0]))
    poses = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    poses[1:7, :3, :3] = rots[picks]
    poses[1:7, :3, 3] = rng.normal(0, 0.3, (6, 3))
    ei, ej = np.zeros(16, np.int32), np.zeros(16, np.int32)
    ej[:6] = np.arange(1, 7)
    w = np.zeros(16, np.float32)
    w[:6] = 1.0
    z = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    z[:6, :3, 3] = poses[1:7, :3, 3]  # the translations measured: the residual's v is small too
    return poses, ei, ej, z, w


def padded_case() -> tuple:
    """Only padded edges (weight 0, nodes 0 -> 0, identity z) over 8 drifted
    nodes."""
    poses = pose_graph_case(8, 16, seed=4)[0]
    return (poses, np.zeros(16, np.int32), np.zeros(16, np.int32),
            np.tile(np.eye(4, dtype=np.float32), (16, 1, 1)), np.zeros(16, np.float32))


def _graph(kind: str) -> tuple:
    if kind.startswith("case"):
        n = int(kind[4:])
        return pose_graph_case(n, 2 * n, seed=n)
    if kind == "soak_first_closure":
        d = np.load(SOAK_GRAPH)
        return tuple(d[k] for k in ("poses", "ei", "ej", "z", "w"))
    return threshold_case() if kind == "thresholds" else padded_case()


def _edge_inputs(poses, ei, ej, z, w):
    poses, z, w = (torch.from_numpy(np.ascontiguousarray(a)) for a in (poses, z, w))
    ei, ej = torch.from_numpy(ei).long(), torch.from_numpy(ej).long()
    return poses[ei], poses[ej], tlc._inv_rigid(z), w[:, None]


@pytest.mark.parametrize("kind", ["case8", "case16", "case32", "soak_first_closure", "padded",
                                  "thresholds"])
def test_the_written_out_forward_mode_equals_torchs(kind):
    """ja, jb and the residuals of edge_jacobians_reference equal
    _edge_jacobians' bit for bit (the sign of zero included)."""
    args = _edge_inputs(*_graph(kind))
    want = tlc._edge_jacobians(*args)
    got = pk.edge_jacobians_reference(*args)
    for name, a, b in zip(("ja", "jb", "r"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_ints(a), _ints(b)), name
    if kind == "padded":
        assert not got[0].any() and not got[1].any() and not got[2].any()


def test_the_threshold_case_straddles_both_branches():
    """The threshold graph's misclosures: s2 one step below, at and above
    4e-4, and t2 one step below, at and above 1e-4, as the logarithms
    compute them from the chained products (each edge's misclosure is its
    node's rotation)."""
    poses, ei, ej, z, w = threshold_case()
    t_i, t_j, z_inv, _ = _edge_inputs(poses, ei, ej, z, w)
    m = tlc.mm(z_inv, tlc.mm(tlc._inv_rigid(t_i), t_j))[:6, :3, :3]
    s2, t2 = _branch_values(m)
    below = lambda at: np.nextafter(at, np.float32(0))  # noqa: E731
    above = lambda at: np.nextafter(at, np.float32(1))  # noqa: E731
    assert s2[:3].tolist() == [below(S2_SMALL), S2_SMALL, above(S2_SMALL)]
    assert t2[3:].tolist() == [below(T2_SMALL), T2_SMALL, above(T2_SMALL)]


@pytest.mark.parametrize("kind", ["case8", "soak_first_closure", "thresholds"])
def test_the_fused_plain_side_equals_forward_mode_and_the_solve(kind):
    """pose_graph_fused on CPU tensors (its plain version) gives the bits of
    the path it replaced in optimize_pose_graph: forward-mode Jacobians,
    then pose_graph_solve; dx and the residuals."""
    poses, ei, ej, z, w = (torch.from_numpy(np.ascontiguousarray(a)) for a in _graph(kind))
    ei32, ej32 = ei.int().contiguous(), ej.int().contiguous()
    z_inv = tlc._inv_rigid(z).contiguous()
    diag = tlc._gauge_diag(poses.shape[0], 1e-4, "cpu")
    ja, jb, rd = tlc._linearize(poses, ei, ej, z_inv, w)
    want = pk.pose_graph_solve(ja, jb, rd, ei32, ej32, diag)
    dx, got_rd = pk.pose_graph_fused(poses, ei32, ej32, z_inv, w, diag)
    assert torch.equal(_ints(dx), _ints(want)) and torch.equal(_ints(got_rd), _ints(rd))
    assert torch.isfinite(dx).all()


def test_the_fused_wrapper_rejects_what_the_kernel_cannot_take():
    poses, ei, ej, z, w = (torch.from_numpy(a) for a in pose_graph_case(8, 16, seed=0))
    args = [poses, ei.int(), ej.int(), tlc._inv_rigid(z).contiguous(), w,
            tlc._gauge_diag(8, 1e-4, "cpu")]
    bad = [(0, args[0].double()), (1, args[1].long()), (3, args[3][:15].contiguous()),
           (4, args[4][:, None]), (5, args[5][:47].contiguous()), (3, args[3].transpose(1, 2))]
    for i, value in bad:
        call = list(args)
        call[i] = value
        with pytest.raises(ValueError):
            pk.pose_graph_fused(*call)
