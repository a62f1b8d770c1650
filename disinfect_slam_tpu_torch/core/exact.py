"""Arithmetic that gives the same bits on every device.

A float sum's bits depend on its order, and torch sums in one order on
the CPU (and another for another thread count) and in another on the
card; its matmuls, solves and float32 sin, cos, atan2 and sqrt differ
between the CPU's libraries and CUDA's too.  The tracker and the loop
closure amplify each such ulp (ROADMAP's watch list), so they take their
sums, products, solves and transcendental functions from here: only
elementwise IEEE operations with one rounding each, in one fixed order,
so the CPU and the card compute the same bits (csrc/icp_step.cu repeats
the same orders in CUDA).

  tree_sum      a float64 sum in a fixed pairwise tree
  mm            a matrix product with each entry summed in index order
  solve_lu      a float64 solve by LU with partial pivoting
  sincos        float64 sin and cos by one fixed polynomial
  atan2         float64 atan2 by one fixed polynomial
  sqrt_rn       a correctly rounded root (taken in float64)
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_F64 = torch.float64
SIN_TERMS = 15  # sin to t^29, cos to t^30
# 1/n! as correctly rounded doubles (csrc/icp_step.cu holds the same
# values as hex literals; tests/test_torch_icp_kernel.py compares them)
INV_FACT = tuple(1.0 / math.factorial(n) for n in range(2 * SIN_TERMS + 1))
TWO_PI = 2.0 * math.pi
INV_TWO_PI = 1.0 / TWO_PI
ATAN_TERMS = 21  # atan's series on |z| <= tan(pi / 8): z^41 / 41 < 1e-17
TAN_PI_8 = math.tan(math.pi / 8)


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The float64 sum of x over `dim`: padded with zeros to a power of two,
    then halving adds (x[:h] + x[h:])."""
    x = x.to(_F64).movedim(dim, -1)
    n = x.shape[-1]
    n2 = 1 << max(n - 1, 0).bit_length()
    if n2 > n:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], n2 - n))], -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., n, k] @ b [..., k, m] with each entry summed in index order,
    ((a0 b0 + a1 b1) + a2 b2) + ... (broadcasting the leading dims);
    elementwise, so it traces under torch.func."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def solve_lu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, m] x = b [m] in float64 by LU with partial pivoting, the
    method of jnp.linalg.solve: at step k the first largest |a[i, k]|, i >= k
    (a NaN counts as largest, as torch.argmax), swaps in, and the rows below
    take l * row k away; then back substitution column by column, so x_i =
    (((b_i - a_i,m-1 x_m-1) - a_i,m-2 x_m-2) ...) / a_ii."""
    m = torch.cat([a.to(_F64), b.to(_F64)[:, None]], 1)
    n = a.shape[0]
    rows = torch.arange(n, device=a.device)
    for k in range(n - 1):
        p = k + torch.argmax(torch.abs(m[k:, k]))
        # rows k and p swap in place, by a two-row copy on the device (exact)
        kp = torch.stack([rows[k], p])
        m.index_copy_(0, kp, m.index_select(0, kp.flip(0)))
        lo = m[k + 1:, k] / m[k, k]
        m[k + 1:, k + 1:] -= lo[:, None] * m[k, k + 1:]
    rhs = m[:, n]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        x[i] = rhs[i] / m[i, i]
        rhs[:i] -= m[:i, i] * x[i]
    return torch.stack(x)


def sincos(theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin and cos of a float64 tensor: theta less its nearest multiple of
    2 pi, then Horner's rule on the Taylor series of sin to t^29 and of cos
    to t^30 (1e-16 on [-pi, pi])."""
    k = torch.round(theta * INV_TWO_PI)
    t = theta - k * TWO_PI
    t2 = t * t
    s = torch.full_like(t, (-1) ** (SIN_TERMS - 1) * INV_FACT[2 * SIN_TERMS - 1])
    c = torch.full_like(t, (-1) ** SIN_TERMS * INV_FACT[2 * SIN_TERMS])
    for m in range(SIN_TERMS - 2, -1, -1):
        s = (-1) ** m * INV_FACT[2 * m + 1] + t2 * s
    for m in range(SIN_TERMS - 1, -1, -1):
        c = (-1) ** m * INV_FACT[2 * m] + t2 * c
    return t * s, c


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 of float64 tensors: the octant folded into z = min/max of |y|,
    |x|, z above tan(pi/8) moved by pi/4 ((z - 1) / (z + 1)), then the
    series of atan to z^41 by Horner's rule (1e-16).  atan2(0, 0) is 0."""
    ax, ay = torch.abs(x), torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    z = num / torch.where(den == 0, 1.0, den)
    big = z > TAN_PI_8
    zr = torch.where(big, (z - 1.0) / (z + 1.0), z)
    z2 = zr * zr
    p = torch.full_like(zr, (-1) ** (ATAN_TERMS - 1) / (2 * ATAN_TERMS - 1))
    for k in range(ATAN_TERMS - 2, -1, -1):
        p = (-1) ** k / (2 * k + 1) + z2 * p
    a = zr * p
    a = torch.where(big, math.pi / 4 + a, a)
    a = torch.where(swap, math.pi / 2 - a, a)
    a = torch.where(x < 0, math.pi - a, a)
    return torch.where(y < 0, -a, a)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded root of x in its own dtype, taken in float64
    (torch's CPU float32 sqrt is not correctly rounded)."""
    return torch.sqrt(x.to(_F64)).to(x.dtype)
