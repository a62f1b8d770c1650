"""pose_graph_solve: the loop closure's pose-graph normal equations and
their solve, one Gauss-Newton iteration after the Jacobians.

Replaces no TPU kernel.  Its counterpart is the body of the JAX
`optimize_pose_graph` scan (disinfect_slam_tpu/systems/loop_closure.py:243),
XLA ops inside `jax.jit` and `lax.scan`, no Pallas.  The kernel
(csrc/pose_graph.cu) was added because the plain version below is ~7000
eager ops an iteration at 32 nodes (an `index_add_` an edge, ~10 ops a
pivot step of core/exact.solve_lu) and ~55000 at 256, every one a launch
on the card while the tracker waits for the closure.

It computes, from each edge's float64 Jacobians ja, jb [E, 6, 6] and
residuals rd [E, 6]: the edge's blocks J_a^T J_a, J_a^T J_b, J_b^T J_a,
J_b^T J_b and J_a^T r, J_b^T r (core/exact.mm's index-order sums over the
6 residual rows), added edge by edge, padded edges too, into a dense
[6n, 6n] H and [6n] g that start at +0; H's diagonal plus `diag`; then
[H | g] solved by core/exact.solve_lu (LU with partial pivoting, the first
largest pivot, a NaN counting as largest, a multiply then a subtract, back
substitution column by column) in float64; dx = -x rounded once to
float32, [n, 6].  The kernel keeps every entry's operations and their
order (`-fmad=false`, the _rn intrinsics), so it gives the plain version's
bits on the card, and the plain version the same bits on the CPU.

What bounds it is the chain of 6n - 1 dependent pivot steps, each a
column maximum, a barrier and the trailing update: one launch of one
thread-block cluster (`cluster_shape`: 1 or 16 CTAs, the columns of [H | g]
dealt to the CTAs in turn and held in their shared memory where they fit,
in device memory (L2) otherwise), one cluster barrier a step, the next
pivot found while the rest of the step's update runs.

`pose_graph_solve` launches the kernel for CUDA tensors and raises if it
cannot (a build that fails, a launch refused, a cluster the card cannot
schedule); for CPU tensors it runs `pose_graph_solve_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...core.exact import mm, solve_lu
from ...utils.graphs import count_launch
from . import build

_C = ctypes
_F32, _F64 = torch.float32, torch.float64
THREADS = 512  # a CTA of the kernel
MAX_CLUSTER = 16  # the largest cluster the kernel takes (non-portable on the H100)
SMEM_LIMIT = 232448  # a CTA's shared memory on the H100
CLUSTERS = (1, 2, 4, 8, 16)  # the cluster sizes cluster_shape chooses from


def smem_bytes(m: int, ctas: int, shared: bool) -> int:
    """A CTA's shared memory at m rows (csrc/pose_graph.cu's smem_bytes):
    its columns of [H | g] if they live there, two buffers of multipliers
    and a copy of the current step's, the reduction's scratch."""
    cols = m // ctas + 1
    warps = THREADS // 32
    return 8 * ((cols * m if shared else 0) + 3 * m + warps) + 4 * (warps + 2)


def cluster_shape(m: int) -> Tuple[int, bool]:
    """(CTAs in the cluster, columns in shared memory) for m = 6n rows: one
    CTA where all of [H | g] fits in its shared memory (up to 16 nodes),
    else MAX_CLUSTER CTAs, their columns in shared memory where they fit
    (up to 64 nodes) and in device memory above.  On the H100 one CTA was
    the fastest shape at 8 nodes and 16 CTAs at 32 to 256 (PERF.md §6)."""
    if smem_bytes(m, 1, True) <= SMEM_LIMIT:
        return 1, True
    return MAX_CLUSTER, smem_bytes(m, MAX_CLUSTER, True) <= SMEM_LIMIT


def normal_equations(ja: torch.Tensor, jb: torch.Tensor, rd: torch.Tensor, ei: torch.Tensor,
                     ej: torch.Tensor, diag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's H f64 [6n, 6n] (diagonal added) and g f64 [6n]."""
    n = diag.shape[0] // 6
    e = ei.shape[0]
    dev = ja.device
    ei, ej = ei.long(), ej.long()
    # each edge's blocks of [H | g]: (i, i), (i, j), (j, i), (j, j), g_i, g_j
    slots = torch.stack([ei * n + ei, ei * n + ej, ej * n + ei, ej * n + ej,
                         n * n + ei, n * n + ej], 1)
    gram = lambda p, q: mm(p.transpose(1, 2), q)  # noqa: E731
    g_pad = torch.zeros((e, 30), dtype=_F64, device=dev)
    blocks = torch.stack([
        gram(ja, ja).reshape(e, 36), gram(ja, jb).reshape(e, 36),
        gram(jb, ja).reshape(e, 36), gram(jb, jb).reshape(e, 36),
        torch.cat([gram(ja, rd[:, :, None])[:, :, 0], g_pad], 1),
        torch.cat([gram(jb, rd[:, :, None])[:, :, 0], g_pad], 1)], 1)
    acc = torch.zeros((n * n + n, 36), dtype=_F64, device=dev)
    for k in range(e):
        # one edge at a time: its six slots are distinct (a padded edge
        # adds zeros), so each add is the same on every device
        acc.index_add_(0, slots[k], blocks[k])
    h = acc[:n * n].reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    h = h + torch.diag(diag)
    return h, acc[n * n:, :6].reshape(6 * n)


def pose_graph_solve_reference(ja: torch.Tensor, jb: torch.Tensor, rd: torch.Tensor,
                               ei: torch.Tensor, ej: torch.Tensor,
                               diag: torch.Tensor) -> torch.Tensor:
    """Plain version (see the module docstring): ja, jb f64 [E, 6, 6] (d
    residual / d xi of the edges' two nodes, [edge, residual, tangent]), rd
    f64 [E, 6], ei, ej integer [E] (nodes in [0, n)), diag f64 [6n] ->
    dx f32 [n, 6]."""
    h, g = normal_equations(ja, jb, rd, ei, ej, diag)
    return (-solve_lu(h, g).to(_F32)).reshape(-1, 6)


def _check_inputs(ja, jb, rd, ei, ej, diag) -> None:
    e = ei.shape[0] if ei.dim() == 1 else -1
    m = diag.shape[0] if diag.dim() == 1 else -1
    if e < 1 or m < 6 or m % 6:
        raise ValueError(f"pose_graph_solve takes E >= 1 edges and 6n rows, got ei "
                         f"{tuple(ei.shape)}, diag {tuple(diag.shape)}")
    for name, t, shape, dtype in (("ja", ja, (e, 6, 6), _F64), ("jb", jb, (e, 6, 6), _F64),
                                  ("rd", rd, (e, 6), _F64), ("ei", ei, (e,), torch.int32),
                                  ("ej", ej, (e,), torch.int32), ("diag", diag, (m,), _F64)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != ja.device:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")


def _clusters(dev: torch.device, m: int, ctas: int, shared: bool) -> None:
    """At first use of a shape on a device: raise unless the card can
    hold one of its clusters; there is no fallback."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), m, ctas, shared)
    if key in _clusters.checked:
        return
    if smem_bytes(m, ctas, shared) > SMEM_LIMIT:
        raise ValueError(f"pose_graph_solve: {ctas} CTAs cannot hold {m} rows in shared memory")
    count = _C.c_int(0)
    fn = build.entry("pose_graph", "dst_pose_graph_clusters",
                     [_C.c_int, _C.c_int, _C.c_int, _C.c_void_p])
    with torch.cuda.device(dev):
        build.check(fn(m, ctas, int(shared), _C.byref(count)), "pose_graph_solve (occupancy)")
    if count.value < 1:
        raise RuntimeError(f"pose_graph_solve: {torch.cuda.get_device_name(dev)} cannot schedule "
                           f"a {ctas}-CTA cluster of the kernel at {m} rows")
    _clusters.checked.add(key)


_clusters.checked = set()


def pose_graph_solve(ja: torch.Tensor, jb: torch.Tensor, rd: torch.Tensor, ei: torch.Tensor,
                     ej: torch.Tensor, diag: torch.Tensor, ctas: Optional[int] = None,
                     shared: Optional[bool] = None) -> torch.Tensor:
    """One launch (see pose_graph_solve_reference for the contract; ei, ej
    int32, every tensor contiguous).  ctas / shared override
    cluster_shape's choice of the launch (the same bits at every shape)."""
    _check_inputs(ja, jb, rd, ei, ej, diag)
    if ja.device.type == "cpu":
        return pose_graph_solve_reference(ja, jb, rd, ei, ej, diag)
    if ja.device.type != "cuda":
        raise ValueError(f"pose_graph_solve takes CPU or CUDA tensors, got {ja.device}")
    dev = ja.device
    m = diag.shape[0]
    auto_ctas, auto_shared = cluster_shape(m)
    ctas = auto_ctas if ctas is None else int(ctas)
    shared = auto_shared if shared is None else bool(shared)
    if ctas not in CLUSTERS:
        raise ValueError(f"pose_graph_solve: ctas must be one of {CLUSTERS}, got {ctas}")
    _clusters(dev, m, ctas, shared)
    dx = torch.empty((m // 6, 6), dtype=_F32, device=dev)
    slab = None if shared else torch.empty((ctas * (m // ctas + 1) * m,), dtype=_F64, device=dev)
    fn = build.entry("pose_graph", "dst_pose_graph_solve", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
        _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ])
    with torch.cuda.device(dev):
        err = fn(build.ptr(ja), build.ptr(jb), build.ptr(rd), build.ptr(ei), build.ptr(ej),
                 build.ptr(diag), ei.shape[0], m, ctas,
                 _C.c_void_p(None) if slab is None else build.ptr(slab), build.ptr(dx),
                 build.stream_of(ja))
        count_launch(pose_graph_solve)
        build.check(err, "pose_graph_solve")
    return dx


pose_graph_solve.launches = 0


def chain(col: torch.Tensor, ctas: int, out: torch.Tensor) -> None:
    """The order floor's probe (not on any path, not counted): the m - 1
    pivot steps of an m-row solve alone (a column maximum, the
    multipliers, a cluster barrier each) over col f64 [m] (CUDA), at
    `ctas` CTAs a cluster; out int32 [ctas]."""
    fn = build.entry("pose_graph", "dst_pose_graph_chain",
                     [_C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p])
    with torch.cuda.device(col.device):
        build.check(fn(build.ptr(col), col.shape[0], ctas, build.ptr(out),
                       build.stream_of(col)), "pose_graph_solve (chain)")
