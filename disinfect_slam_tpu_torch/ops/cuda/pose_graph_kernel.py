"""pose_graph_solve: one Gauss-Newton iteration of the loop closure's pose
graph, the normal equations and their solve; pose_graph_fused: the same
with the edges' residuals and Jacobians computed in the launch.

Replaces no TPU kernel.  Its counterpart is the body of the JAX
`optimize_pose_graph` scan (disinfect_slam_tpu/systems/loop_closure.py:243),
XLA ops inside `jax.jit` and `lax.scan`, no Pallas.  The kernel
(csrc/pose_graph.cu) was added because the plain versions below are
~7000 eager ops an iteration at 32 nodes (an `index_add_` an edge, ~10
ops a pivot step of core/exact.solve_lu) and ~55000 at 256, every one a
launch on the card while the tracker waits for the closure.

pose_graph_solve computes, from each edge's float64 Jacobians ja, jb [E,
6, 6] and residuals rd [E, 6]: the edge's blocks J_a^T J_a, J_a^T J_b,
J_b^T J_a, J_b^T J_b and J_a^T r, J_b^T r (core/exact.mm's index-order
sums over the 6 residual rows), added edge by edge into a dense [6n, 6n]
H and [6n] g that start at +0; H's diagonal plus `diag`; then [H | g]
solved by core/exact.solve_lu (LU with partial pivoting, the first
largest pivot, a NaN counting as largest, a multiply then a subtract, back
substitution column by column) in float64; dx = -x rounded once to
float32, [n, 6].  pose_graph_fused first computes ja, jb and rd from the
poses, the measurements' inverses and the weights as torch's forward mode
does (edge_jacobians_reference: `Dual`, each operation's forward-mode
formula written out).  The kernel keeps every entry's operations and
their order (`-fmad=false`, the _rn intrinsics), so it gives the plain
versions' bits on the card, and the plain versions the same bits on the
CPU.

The design (csrc/pose_graph.cu's header): a blocked LU, panels of NB
columns dealt to the CTAs in turn and held whole in their shared memory,
each panel factored by its owner at a CTA barrier a pivot step and handed
on through a flag in device memory, every trailing column taken through a
panel's NB steps at once, the next panel's owner bringing it up to date
first (look-ahead); then a blocked back substitution.  What bounds it is
the chain of 6n - 1 pivot steps (a column maximum, a barrier, the
divisions of the nonzero entries), the next panel's update and hand-over,
and the back substitution's chain of divisions.  One cooperative launch of
`grid_shape` CTAs: one an SM for each block of columns, up to the card's
SMs.  Where the columns do not fit the CTAs' shared memory (above 275
nodes on an H100) the same kernel keeps them in device memory (`shared`
False: the same operations in the same order).  Above WIDE_ROWS rows
(2730 nodes) the pass layout takes any m: the threads stride over a
panel's rows, the rows' state in device memory (`passes` forces the
layout at any m); the same bits again.  Its scratch
is [H | g] and the factorization's multipliers, about 12 m^2 bytes
(`scratch_bytes`).

Both entries launch the kernel for CUDA tensors and raise if they cannot
(a build that fails, a launch refused, a shape the card cannot hold at
once, a scratch the card's memory cannot hold); for CPU tensors they run
their plain versions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ...core.exact import (ATAN_TERMS, INV_FACT, INV_TWO_PI, SIN_TERMS, TAN_PI_8, TWO_PI, mm,
                           solve_lu)
from ...utils.graphs import count_launch
from . import build

_C = ctypes
_F32, _F64 = torch.float32, torch.float64
THREADS = 512  # a CTA of the kernel
NB = 8  # a panel's columns
SLOTS = 4  # a panel's rows a thread holds, the columns in shared memory
MID_SLOTS = 8  # the same, the columns in device memory, up to THREADS * MID_SLOTS rows
WIDE_SLOTS = 32  # the same above, up to WIDE_ROWS
WIDE_ROWS = THREADS * WIDE_SLOTS  # the largest m of the register layouts (2730 nodes)
SMEM_LIMIT = 232448  # a CTA's shared memory on the H100
EDGE_CHUNK = 256  # edges the assembly stages in shared memory at a time


def panels(m: int) -> int:
    return (m + NB - 1) // NB


def smem_bytes(m: int, ctas: int, shared: bool = True, passes: bool = False) -> int:
    """A CTA's shared memory at m rows over `ctas` CTAs (csrc/pose_graph.cu's
    smem_bytes): its blocks of columns of [H | g] (none where they live in
    device memory, shared False), the trailing update's pivot-row values,
    two panels' pivot multipliers, the back substitution's unknowns and its
    blocks of U, the reduction's keys, two panels' pivot rows and rows
    left (none in the pass layout, `passes`), and the staged edges."""
    nlb = (panels(m) + 1 + ctas - 1) // ctas  # the blocks of columns a CTA holds at most
    warps = THREADS // 32
    return (8 * ((nlb * NB * m if shared else 0) + NB * nlb * NB + 6 * NB * NB + 2 * NB)
            + 4 * ((8 if passes else 6) * warps + 2 * NB + (0 if passes else 2 * m)
                   + 3 * EDGE_CHUNK))


def passes_for(m: int, shared: bool) -> bool:
    """Whether a launch at m rows takes the pass layout unless forced: the
    columns in device memory and more rows than the register layouts
    hold."""
    return not shared and m > WIDE_ROWS


def shapes(m: int, sms: int, shared: bool = True, passes: Optional[bool] = None) -> list:
    """The CTA counts the kernel takes at m rows on a card of `sms` SMs, its
    columns in shared memory or (shared False) in device memory, in the
    pass layout above WIDE_ROWS rows or where `passes` asks for it: a
    power of two, two blocks of columns a CTA, or the most the card holds
    (one CTA an SM, no more than the blocks), each within the shared
    memory."""
    passes = passes_for(m, shared) if passes is None else bool(passes)
    if shared and (passes or m > THREADS * SLOTS):  # the rows a panel's threads hold
        return []
    blocks = panels(m) + 1
    most = min(blocks, sms)
    out = sorted({c for c in (1, 2, 4, 8, 16, 32, 64, (blocks + 1) // 2, most) if c <= most})
    return [c for c in out if smem_bytes(m, c, shared, passes) <= SMEM_LIMIT]


def grid_shape(m: int, sms: int) -> Tuple[int, bool]:
    """(CTAs, shared) of a launch at m = 6n rows on a card of `sms` SMs: one
    CTA an SM for every block of columns, up to the card's SMs (the fastest
    at every size measured, PERF.md §6), the columns in shared memory where
    they fit and in device memory above (in the pass layout above
    WIDE_ROWS rows)."""
    for shared in (True, False):
        fit = shapes(m, sms, shared)
        if fit:
            return fit[-1], shared
    raise ValueError(f"pose_graph_solve: {sms} SMs cannot hold {m} rows")


BLOCK_VALS = 156  # an edge's block entries: 4 blocks of 36, J_a^T r, J_b^T r


def _scratch_layout(m: int, e: int) -> dict:
    """Byte offsets of the kernel's device scratch: each edge's block
    entries gv f64 [e, BLOCK_VALS], the columns hg f64 [m + 1, m], the
    panels' multipliers lbuf f64 [rows, NB] and pivot multipliers lpiv f64
    [m, NB], each edge's flag eflag i32 [e], the rows left below each panel
    ibuf i32 [rows], the logical-to-physical map prow i32 [m] and (the pass
    layout) the panel rows' logical positions lpos i32 [m]."""
    # every panel but the last leaves m - (b + 1) NB rows
    nb = panels(m)
    rows = (nb - 1) * m - NB * (nb - 1) * nb // 2
    sizes = (("gv", 8 * e * BLOCK_VALS), ("hg", 8 * (m + 1) * m), ("lbuf", 8 * rows * NB),
             ("lpiv", 8 * m * NB), ("eflag", 4 * e), ("ibuf", 4 * rows), ("prow", 4 * m),
             ("lpos", 4 * m))
    out, at = {}, 0
    for name, nbytes in sizes:
        out[name] = at
        at += (nbytes + 15) // 16 * 16
    out["bytes"] = at
    return out


def scratch_bytes(m: int, e: int = 0) -> int:
    """The device scratch of a launch at m rows and e edges: [H | g] (8 m (m
    + 1) bytes) and the factorization's multipliers and row maps (about 4 m^2
    more)."""
    return _scratch_layout(m, e)["bytes"]


# ----------------------------------------------------------------------
# the edges' residuals and Jacobians: torch's forward mode, written out
# ----------------------------------------------------------------------
class Dual:
    """A tensor and its tangents as torch's forward mode carries them: p,
    the primal [...], and t, the tangents [12, ...] (one a direction of
    xi_i, xi_j) or None where the operand has no tangent.  Each operation
    below computes what the forward-mode formula of the torch operation it
    stands for computes (torchgen's derivatives.yaml): a term whose operand
    has no tangent is absent, not +0 (torch's zero tensors), and a tangent
    that an operation has to materialize (stack, cat, where) is +0."""

    __slots__ = ("p", "t")

    def __init__(self, p: torch.Tensor, t: Optional[torch.Tensor] = None):
        self.p, self.t = p, t

    def __getitem__(self, idx) -> "Dual":
        idx = idx if isinstance(idx, tuple) else (idx,)
        if idx[0] is not Ellipsis:
            raise IndexError("a Dual is indexed from the right, after an Ellipsis")
        return Dual(self.p[idx], None if self.t is None else self.t[idx])

    def __neg__(self) -> "Dual":
        return Dual(-self.p, None if self.t is None else -self.t)

    def __add__(self, o) -> "Dual":
        return _add(self, o)

    def __radd__(self, o) -> "Dual":
        return _add(o, self)

    def __sub__(self, o) -> "Dual":
        return _sub(self, o)

    def __rsub__(self, o) -> "Dual":
        # rsub: -self_t + other_t (other a number: -self_t)
        return Dual(o - self.p, None if self.t is None else -self.t)

    def __mul__(self, o) -> "Dual":
        return _mul(self, o)

    def __rmul__(self, o) -> "Dual":
        return _mul(o, self)

    def __truediv__(self, o) -> "Dual":
        return _div(self, o)

    def transpose(self, a: int, b: int) -> "Dual":
        return Dual(self.p.transpose(a, b), None if self.t is None else self.t.transpose(a, b))

    def to(self, dtype) -> "Dual":
        return Dual(self.p.to(dtype), None if self.t is None else self.t.to(dtype))


def _parts(x):
    return (x.p, x.t) if isinstance(x, Dual) else (x, None)


def _add(a, b) -> Dual:
    (ap, at), (bp, bt) = _parts(a), _parts(b)
    t = at + bt if at is not None and bt is not None else (at if at is not None else bt)
    return Dual(ap + bp, t)


def _sub(a, b) -> Dual:
    (ap, at), (bp, bt) = _parts(a), _parts(b)
    if at is not None and bt is not None:
        t = at - bt
    elif bt is not None:
        t = bt * -1  # a zero tensor less bt: bt times -1 (not a negation: NaNs keep their sign)
    else:
        t = at
    return Dual(ap - bp, t)


def _mul(a, b) -> Dual:
    (ap, at), (bp, bt) = _parts(a), _parts(b)
    if at is not None and bt is not None:
        t = bt * ap + at * bp
    elif at is not None:
        t = at * bp
    elif bt is not None:
        t = bt * ap
    else:
        t = None
    return Dual(ap * bp, t)


def _divisor(x, like: torch.Tensor):
    # a number as a tensor on the operand's device: torch divides by a
    # Python number on the card through its reciprocal
    return torch.tensor(x, dtype=like.dtype, device=like.device) if isinstance(x, float) else x


def _div(a, b) -> Dual:
    (ap, at), (bp, bt) = _parts(a), _parts(b)
    bp = _divisor(bp, ap)
    r = ap / bp
    if at is not None and bt is not None:
        t = (at - bt * r) / bp
    elif at is not None:
        t = at / bp
    elif bt is not None:
        t = (bt * r) * -1 / bp
    else:
        t = None
    return Dual(r, t)


def _where(cond: torch.Tensor, a, b) -> Dual:
    (ap, at), (bp, bt) = _parts(a), _parts(b)
    p = torch.where(cond, ap, bp)
    if at is None and bt is None:
        return Dual(p)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    return Dual(p, torch.where(cond, zero if at is None else at, zero if bt is None else bt))


def _join(fn, xs: list, dim: int) -> Dual:
    """stack / cat: the missing tangents materialized as +0."""
    parts = [_parts(x) for x in xs]
    p = fn([q for q, _ in parts], dim)
    if all(t is None for _, t in parts):
        return Dual(p)
    tdim = dim if dim < 0 else dim + 1
    ts = [(t if t is not None else torch.zeros((), dtype=q.dtype, device=q.device))
          .expand(12, *q.shape) for q, t in parts]
    return Dual(p, fn(ts, tdim))


def _sqrt(x: Dual) -> Dual:
    r = torch.sqrt(x.p)
    return Dual(r, None if x.t is None else x.t / (2 * r))


def _sqrt_rn(x: Dual) -> Dual:
    return _sqrt(x.to(_F64)).to(x.p.dtype)


def _dmm(a, b) -> Dual:
    """core/exact.mm of duals (or a dual and a tensor)."""
    out = _mul(a[..., :, 0:1], b[..., 0:1, :])
    for k in range(1, _parts(a)[0].shape[-1]):
        out = _add(out, _mul(a[..., :, k:k + 1], b[..., k:k + 1, :]))
    return out


def _sq3(v: Dual) -> Dual:
    return ((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2])[..., None]


def _skew(k: Dual) -> Dual:
    z = torch.zeros_like(k.p[..., 0])
    row = lambda *xs: _join(torch.stack, list(xs), -1)  # noqa: E731
    return _join(torch.stack, [row(z, -k[..., 2], k[..., 1]), row(k[..., 2], z, -k[..., 0]),
                               row(-k[..., 1], k[..., 0], z)], -2)


def _rigid(r: Dual, t: Dual) -> Dual:
    bottom = torch.eye(4, dtype=r.p.dtype, device=r.p.device)[3:].expand(*r.p.shape[:-2], 1, 4)
    return _join(torch.cat, [_join(torch.cat, [r, t[..., None]], -1), bottom], -2)


def _exp_se3_small(xi: Dual) -> Dual:
    omega, v = xi[..., :3], xi[..., 3:]
    t2 = _sq3(omega)
    ox = _skew(omega)
    a = (1.0 - t2 / 6.0)[..., None]
    b = (0.5 - t2 / 24.0)[..., None]
    cc = (1.0 / 6.0 - t2 / 120.0)[..., None]
    eye = torch.eye(3, dtype=xi.p.dtype, device=xi.p.device)
    ox2 = _dmm(ox, ox)
    r = eye + a * ox + b * ox2
    t = _dmm(eye + b * ox + cc * ox2, v[..., None])[..., 0]
    return _rigid(r, t)


def _inv_rigid(m: Dual) -> Dual:
    rt = m[..., :3, :3].transpose(-1, -2)
    t = _dmm(rt, -m[..., :3, 3:4])
    bottom = torch.eye(4, dtype=m.p.dtype, device=m.p.device)[3:].expand(*m.p.shape[:-2], 1, 4)
    return _join(torch.cat, [_join(torch.cat, [rt, t], -1), bottom], -2)


def _sincos(theta: Dual) -> Tuple[Dual, Dual]:
    k = theta * INV_TWO_PI
    k = Dual(torch.round(k.p), torch.zeros_like(k.t))
    t = theta - k * TWO_PI
    t2 = t * t
    s = torch.full_like(t.p, (-1) ** (SIN_TERMS - 1) * INV_FACT[2 * SIN_TERMS - 1])
    c = torch.full_like(t.p, (-1) ** SIN_TERMS * INV_FACT[2 * SIN_TERMS])
    for m in range(SIN_TERMS - 2, -1, -1):
        s = (-1) ** m * INV_FACT[2 * m + 1] + t2 * s
    for m in range(SIN_TERMS - 1, -1, -1):
        c = (-1) ** m * INV_FACT[2 * m] + t2 * c
    return t * s, c


def _sin_cos(x: Dual) -> Tuple[Dual, Dual]:
    s, c = _sincos(x.to(_F64))
    return s.to(x.p.dtype), c.to(x.p.dtype)


def _abs(x: Dual) -> Dual:
    return Dual(torch.abs(x.p), None if x.t is None else x.t * torch.sgn(x.p))


def _atan2(y: Dual, x: Dual) -> Dual:
    ax, ay = _abs(x), _abs(y)
    swap = ay.p > ax.p
    num = _where(swap, ax, ay)
    den = _where(swap, ay, ax)
    z = num / _where(den.p == 0, 1.0, den)
    big = z.p > TAN_PI_8
    zr = _where(big, (z - 1.0) / (z + 1.0), z)
    z2 = zr * zr
    p = torch.full_like(zr.p, (-1) ** (ATAN_TERMS - 1) / (2 * ATAN_TERMS - 1))
    for k in range(ATAN_TERMS - 2, -1, -1):
        p = (-1) ** k / (2 * k + 1) + z2 * p
    a = zr * p
    a = _where(big, math.pi / 4 + a, a)
    a = _where(swap, math.pi / 2 - a, a)
    a = _where(x.p < 0, math.pi - a, a)
    return _where(y.p < 0, -a, a)


def _so3_log(r: Dual) -> Dual:
    vee = _join(torch.stack, [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                              r[..., 1, 0] - r[..., 0, 1]], -1)
    trace = (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2])[..., None]
    u = (trace - 1.0) * 0.5
    inside = (u.p >= -1.0) & (u.p <= 1.0)
    cos_t = Dual(torch.clamp(u.p, -1.0, 1.0),
                 torch.where(inside, u.t, torch.zeros((), dtype=u.p.dtype, device=u.p.device)))
    s2 = _sq3(vee)
    small = s2.p < 4e-4
    s2_safe = _where(small, 1.0, s2)
    sin_t = 0.5 * _sqrt_rn(s2_safe)
    theta = _atan2(sin_t.to(_F64), cos_t.to(_F64)).to(r.p.dtype)
    fac = _where(small, 0.5 + s2 / 48.0, theta / (2.0 * sin_t))
    return fac * vee


def _se3_log(m: Dual) -> Dual:
    omega = _so3_log(m[..., :3, :3])
    t2 = _sq3(omega)
    ox = _skew(omega)
    small = t2.p < 1e-4
    t2_safe = _where(small, 1.0, t2)
    theta = _sqrt_rn(t2_safe)
    s, c = _sin_cos(theta)
    coef = _where(small, 1.0 / 12.0 + t2 / 720.0,
                  (1.0 - theta * s / (2.0 * (1.0 - c))) / t2_safe)[..., None]
    eye = torch.eye(3, dtype=m.p.dtype, device=m.p.device)
    v_inv = eye - 0.5 * ox + coef * _dmm(ox, ox)
    return _join(torch.cat, [omega, _dmm(v_inv, m[..., :3, 3:4])[..., 0]], -1)


def edge_jacobians_reference(t_i: torch.Tensor, t_j: torch.Tensor, z_inv: torch.Tensor,
                             w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The edges' residuals se3_log(Z^-1 inv(T_i) T_j) w and their Jacobians
    against xi_i and xi_j at xi = 0, from poses t_i, t_j and z_inv f32 [E,
    4, 4] and w f32 [E, 1]: (d r / d xi_i, d r / d xi_j f32 [E, 6, 6], r f32
    [E, 6]).  The bits of systems/loop_closure._edge_jacobians, which runs
    torch's forward mode over the 12 unit tangents: the same operations,
    each with its forward-mode formula written out (see Dual), on every
    device (a number divides as a device tensor)."""
    e = t_i.shape[0]
    eye = torch.eye(12, dtype=t_i.dtype, device=t_i.device)[:, None, :].expand(12, e, 12)
    zero = torch.zeros((e, 6), dtype=t_i.dtype, device=t_i.device)
    xi_i = Dual(zero, eye[..., :6].contiguous())
    xi_j = Dual(zero, eye[..., 6:].contiguous())
    a = _dmm(_exp_se3_small(xi_i), t_i)
    b = _dmm(_exp_se3_small(xi_j), t_j)
    r = _se3_log(_dmm(z_inv, _dmm(_inv_rigid(a), b))) * w
    return r.t[:6].permute(1, 2, 0), r.t[6:].permute(1, 2, 0), r.p


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


def _shape(dev: torch.device, m: int, ctas: int, shared: bool, passes: bool) -> None:
    """At first use of a shape on a device: raise unless the card holds
    every CTA of it at once; there is no fallback."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), m, ctas, shared,
           passes)
    if key in _shape.checked:
        return
    ok = _C.c_int(0)
    fn = build.entry("pose_graph", "dst_pose_graph_shape",
                     [_C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_void_p])
    with torch.cuda.device(dev):
        build.check(fn(m, ctas, int(not shared), int(passes), _C.byref(ok)),
                    "pose_graph_solve (occupancy)")
    if not ok.value:
        raise RuntimeError(f"pose_graph_solve: {torch.cuda.get_device_name(dev)} cannot hold "
                           f"{ctas} CTAs of the kernel at {m} rows at once")
    _shape.checked.add(key)


_shape.checked = set()


def launch_layout(m: int, sms: int, shared: Optional[bool] = None,
                  passes: bool = False) -> Tuple[bool, bool]:
    """(shared, passes) of a launch at m rows: grid_shape's choice where
    shared is None; the pass layout above WIDE_ROWS rows, or at any m where
    `passes` forces it (the columns in device memory)."""
    if passes:
        if shared:
            raise ValueError("the pass layout keeps the columns in device memory: passes=True "
                             "takes shared=None or False")
        return False, True
    shared = grid_shape(m, sms)[1] if shared is None else bool(shared)
    return shared, passes_for(m, shared)


def _launch_shape(dev: torch.device, m: int, e: int, ctas: Optional[int], shared: Optional[bool],
                  passes: bool) -> Tuple[int, bool, bool]:
    props = torch.cuda.get_device_properties(dev)
    shared, passes = launch_layout(m, props.multi_processor_count, shared, passes)
    fit = shapes(m, props.multi_processor_count, shared, passes)
    ctas = (fit[-1] if fit else 0) if ctas is None else int(ctas)
    if ctas not in fit:
        raise ValueError(f"pose_graph_solve: ctas must be one of {fit} at {m} rows "
                         f"(shared={shared}, passes={passes}), got {ctas}")
    need = scratch_bytes(m, e)
    if need > props.total_memory:
        raise ValueError(f"pose_graph_solve at {m} rows needs {need / 1e9:.1f} GB of scratch "
                         f"([H | g] and its LU's multipliers); {props.name} has "
                         f"{props.total_memory / 1e9:.1f} GB")
    _shape(dev, m, ctas, shared, passes)
    return ctas, shared, passes


def _timeline(timeline: Optional[torch.Tensor], dev: torch.device, m: int) -> _C.c_void_p:
    if timeline is None:
        return _C.c_void_p(None)
    if (timeline.dtype != torch.int64 or timeline.device != dev or not timeline.is_contiguous()
            or timeline.numel() < timeline_slots(m)):
        raise ValueError(f"timeline must be int64 [{timeline_slots(m)}] on {dev}")
    return build.ptr(timeline)


def _scratch(dev: torch.device, m: int, e: int) -> Tuple[list, torch.Tensor, torch.Tensor]:
    """The scratch's pointers (gv, eflag, hg, lbuf, ibuf, lpiv, prow, lpos,
    flags), with the tensors that hold them: one byte buffer, and the flags
    zeroed."""
    lay = _scratch_layout(m, e)
    buf = torch.empty((lay["bytes"],), dtype=torch.uint8, device=dev)
    flags = torch.zeros((panels(m) + 2,), dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    ptrs = [_C.c_void_p(base + lay[k]) for k in ("gv", "eflag", "hg", "lbuf", "ibuf", "lpiv",
                                                   "prow", "lpos")]
    return ptrs + [build.ptr(flags)], buf, flags


def timeline_slots(m: int) -> int:
    """The int64 words of a launch's timeline at m rows (see csrc/pose_graph.cu's
    MARK): 8, then 4 for each panel."""
    return 8 + 4 * panels(m)


def pose_graph_solve(ja: torch.Tensor, jb: torch.Tensor, rd: torch.Tensor, ei: torch.Tensor,
                     ej: torch.Tensor, diag: torch.Tensor, ctas: Optional[int] = None,
                     shared: Optional[bool] = None, passes: bool = False,
                     timeline: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch (see pose_graph_solve_reference for the contract; ei, ej
    int32, every tensor contiguous).  ctas and shared override grid_shape's
    choice of the launch (ctas one of `shapes(m, sms, shared, passes)`; the
    same bits at every shape), passes forces the pass layout at any m
    (launch_layout); timeline, an int64 tensor of
    timeline_slots(m) on the device, receives the device clock (ns) at the
    launch's stages."""
    _check_inputs(ja, jb, rd, ei, ej, diag)
    if ja.device.type == "cpu":
        return pose_graph_solve_reference(ja, jb, rd, ei, ej, diag)
    if ja.device.type != "cuda":
        raise ValueError(f"pose_graph_solve takes CPU or CUDA tensors, got {ja.device}")
    dev = ja.device
    m = diag.shape[0]
    ctas, shared, passes = _launch_shape(dev, m, ei.shape[0], ctas, shared, passes)
    dx = torch.empty((m // 6, 6), dtype=_F32, device=dev)
    scratch, _buf, _flags = _scratch(dev, m, ei.shape[0])
    fn = build.entry("pose_graph", "dst_pose_graph_solve", [_C.c_void_p] * 6 + [_C.c_int] * 5
                     + [_C.c_void_p] * 12)
    with torch.cuda.device(dev):
        err = fn(build.ptr(ja), build.ptr(jb), build.ptr(rd), build.ptr(ei), build.ptr(ej),
                 build.ptr(diag), ei.shape[0], m, ctas, int(not shared), int(passes), *scratch,
                 _timeline(timeline, dev, m), build.ptr(dx), build.stream_of(ja))
        count_launch(pose_graph_solve)
        build.check(err, "pose_graph_solve")
    return dx


pose_graph_solve.launches = 0


def pose_graph_fused_reference(poses: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor,
                               z_inv: torch.Tensor, w: torch.Tensor,
                               diag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused entry: poses f32 [n, 4, 4], ei, ej integer
    [E] (nodes in [0, n)), z_inv f32 [E, 4, 4] (the measurements' inverses),
    w f32 [E], diag f64 [6n] -> (dx f32 [n, 6], the residuals f64 [E, 6]):
    edge_jacobians_reference, then pose_graph_solve_reference."""
    ja, jb, r = edge_jacobians_reference(poses[ei.long()], poses[ej.long()], z_inv, w[:, None])
    ja, jb, rd = (x.double().contiguous() for x in (ja, jb, r))
    return pose_graph_solve_reference(ja, jb, rd, ei, ej, diag), rd


def _check_fused(poses, ei, ej, z_inv, w, diag) -> None:
    e = ei.shape[0] if ei.dim() == 1 else -1
    n = poses.shape[0] if poses.dim() == 3 else -1
    if e < 1 or n < 1:
        raise ValueError(f"pose_graph_fused takes E >= 1 edges and n >= 1 nodes, got ei "
                         f"{tuple(ei.shape)}, poses {tuple(poses.shape)}")
    for name, t, shape, dtype in (("poses", poses, (n, 4, 4), _F32), ("ei", ei, (e,), torch.int32),
                                  ("ej", ej, (e,), torch.int32), ("z_inv", z_inv, (e, 4, 4), _F32),
                                  ("w", w, (e,), _F32), ("diag", diag, (6 * n,), _F64)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != poses.device:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")


def pose_graph_fused(poses: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor,
                     z_inv: torch.Tensor, w: torch.Tensor, diag: torch.Tensor,
                     ctas: Optional[int] = None, shared: Optional[bool] = None,
                     passes: bool = False,
                     timeline: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the fused entry (see pose_graph_fused_reference for the
    contract; ei, ej int32, every tensor contiguous): the edges' residuals and
    Jacobians, then the solve, in the kernel.  Counts on
    pose_graph_solve.launches; ctas, shared, passes and timeline as
    pose_graph_solve's."""
    _check_fused(poses, ei, ej, z_inv, w, diag)
    if poses.device.type == "cpu":
        return pose_graph_fused_reference(poses, ei, ej, z_inv, w, diag)
    if poses.device.type != "cuda":
        raise ValueError(f"pose_graph_fused takes CPU or CUDA tensors, got {poses.device}")
    dev = poses.device
    m, e = diag.shape[0], ei.shape[0]
    ctas, shared, passes = _launch_shape(dev, m, e, ctas, shared, passes)
    dx = torch.empty((m // 6, 6), dtype=_F32, device=dev)
    jac = torch.empty((2, e, 6, 6), dtype=_F64, device=dev)
    rd = torch.empty((e, 6), dtype=_F64, device=dev)
    scratch, _buf, _flags = _scratch(dev, m, e)
    fn = build.entry("pose_graph", "dst_pose_graph_fused", [_C.c_void_p] * 6 + [_C.c_int] * 5
                     + [_C.c_void_p] * 15)
    with torch.cuda.device(dev):
        err = fn(build.ptr(poses), build.ptr(ei), build.ptr(ej), build.ptr(z_inv), build.ptr(w),
                 build.ptr(diag), e, m, ctas, int(not shared), int(passes), build.ptr(jac[0]),
                 build.ptr(jac[1]), build.ptr(rd),
                 *scratch, _timeline(timeline, dev, m), build.ptr(dx), build.stream_of(poses))
        count_launch(pose_graph_solve)
        build.check(err, "pose_graph_fused")
    return dx, rd


def chain(col: torch.Tensor, ctas: int, out: torch.Tensor) -> None:
    """The order floor's probe (not on any path, not counted): the m - 1
    pivot steps of an m-row solve alone (a column maximum, a CTA barrier
    and the multipliers each, a flag handed over between panels) over col
    f64 [m] (CUDA), at `ctas` CTAs; out int32 [ctas]."""
    m = col.shape[0]
    flags = torch.zeros((panels(m),), dtype=torch.int32, device=col.device)
    fn = build.entry("pose_graph", "dst_pose_graph_chain",
                     [_C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p])
    with torch.cuda.device(col.device):
        build.check(fn(build.ptr(col), m, ctas, build.ptr(flags), build.ptr(out),
                       build.stream_of(col)), "pose_graph_solve (chain)")
