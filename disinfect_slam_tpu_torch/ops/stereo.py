"""Stereo disparity -> depth as torch ops (counterpart of
disinfect_slam_tpu/ops/stereo.py, op for op).

The reference's online pipeline is driven by a stereo camera but never
computes depth from it (ZEDNative::GetStereoFrame feeds rectified pairs
to SLAM, cameras/zed_native.cc:24-33; depth comes from an RGBD sensor).
This module makes stereo-only sensors first-class: rectified pairs
(ops/image_ops.py) in, metric depth out, so DenseSLAM and the TSDF
pipeline run without an RGBD camera.

  - cost volume: zero-mean SAD over a (ph, pw) window, one shifted image
    difference per disparity hypothesis, summed by a separable box;
  - winner-take-all argmin + parabolic sub-pixel refinement;
  - validity: left-right consistency (the right view's cost volume is a
    shear of the left one, no recompute), uniqueness ratio, borders.

Every op is elementwise, a shift, a gather, a comparison, a min or an
argmin (first index on ties, as jnp.argmin), except three sums, which
are written as explicit adds in XLA:CPU's order: the box (the window's
rows, then its columns, left to right from zero), the gray conversion
(r*w0, then fused multiply-adds of g*w1 and b*w2) and the 2x2 mean
(((x00 + x01) + x10) + x11) / 4.  XLA:CPU's rewrites of the jitted JAX
functions are restated: a division by a constant becomes a product with
its float32 reciprocal, and a product feeding an add is one fused
multiply-add (image_ops.fma32).  No convolution, matmul
or reduction sum runs, and every divisor and scalar factor is a float32
tensor on the device, so the card gives the CPU's bits.

depth = fx * baseline / disparity, the rectified-pinhole relation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .image_ops import fma32

METHODS = ("flat", "pyramid")


class StereoDepthResult(NamedTuple):
    depth: torch.Tensor  # f32 [H, W] metres; 0 where invalid
    disparity: torch.Tensor  # f32 [H, W] pixels (sub-pixel)
    valid: torch.Tensor  # bool [H, W]


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as the float32 tensor JAX's weak typing makes of it."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _to_gray(img: torch.Tensor) -> torch.Tensor:
    """JAX's img @ [0.299, 0.587, 0.114]: r*w0, then XLA's two fused
    multiply-adds of g and b."""
    if img.ndim == 3:
        w0, w1, w2 = (_f32(v, img) for v in (0.299, 0.587, 0.114))
        return fma32(img[..., 2], w2, fma32(img[..., 1], w1, img[..., 0] * w0))
    return img


def _window_sum(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """SAME-padded window sum of size k along `dim`: zero padding of
    (k - 1) // 2 before and k // 2 after, then the k shifted slices added
    left to right (reduce_window's order)."""
    lo, hi = (k - 1) // 2, k // 2
    pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [lo, hi]
    xp = F.pad(x, pad)
    n = x.shape[dim]
    out = xp.narrow(dim, 0, n).clone()
    for i in range(1, k):
        out += xp.narrow(dim, i, n)
    return out


def _box(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Windowed sum over the trailing two axes, SAME padding: the window's
    rows (ph adds), then its columns (pw adds)."""
    return _window_sum(_window_sum(x, ph, -2), pw, -1)


def _zero_mean(g: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """g less its window mean.  XLA folds JAX's `/ area` by a constant into
    a product with the float32 reciprocal and contracts that product and
    the subtraction into one fused multiply-add, so the port does both."""
    inv_area = np.float32(1.0) / np.float32(ph * pw)
    return fma32(-_box(g, ph, pw), _f32(float(inv_area), g), g)


def _shifted_right_images(gr: torch.Tensor, max_disp: int) -> torch.Tensor:
    """[D, H, W]: gr[y, x - d] for d < max_disp, replicate padding on the
    left edge (the stack of JAX's _shift_right_image)."""
    w = gr.shape[1]
    grp = torch.cat([gr[:, :1].expand(-1, max_disp - 1), gr], 1)
    # window k of the padded rows starts at column k: shift d = D - 1 - k
    return grp.unfold(1, w, 1).permute(1, 0, 2).flip(0).contiguous()


def cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    max_disp: int,
    patch: Tuple[int, int] = (7, 9),
) -> torch.Tensor:
    """Zero-mean SAD cost volume [D, H, W] for the *left* view.

    Zero-mean (local window mean subtracted per image) buys exposure/gain
    invariance for nearly the cost of plain SAD."""
    ph, pw = patch
    gl = _zero_mean(_to_gray(left.to(torch.float32)), ph, pw)
    gr = _zero_mean(_to_gray(right.to(torch.float32)), ph, pw)
    diffs = (gl[None] - _shifted_right_images(gr, max_disp)).abs()
    return _box(diffs, ph, pw)


def _take(cost: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cost[idx[y, x], y, x]."""
    return torch.gather(cost, 0, idx[None].to(torch.int64))[0]


def _subpixel(cost: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Parabola fit through (c[d-1], c[d], c[d+1]) around the argmin."""
    d_max = cost.shape[0] - 1
    c0 = _take(cost, torch.clamp(best - 1, 0, d_max))
    c1 = _take(cost, best)
    c2 = _take(cost, torch.clamp(best + 1, 0, d_max))
    denom = c0 - 2.0 * c1 + c2
    eps = _f32(1e-9, cost)
    offset = torch.where(denom.abs() > eps,
                         0.5 * (c0 - c2) / torch.maximum(denom, eps), _f32(0.0, cost))
    return best.to(torch.float32) + torch.clamp(offset, -1.0, 1.0)


def _unique(cost: torch.Tensor, best: torch.Tensor, unique_ratio: float) -> torch.Tensor:
    """The winning cost beats the best cost outside a +-1 neighbourhood
    of the winner by the given ratio."""
    d_idx = torch.arange(cost.shape[0], dtype=torch.int32, device=cost.device)
    near = (d_idx[:, None, None] - best[None]).abs() <= 1
    c_second = torch.where(near, _f32(float("inf"), cost), cost).amin(0)
    return _take(cost, best) <= _f32(unique_ratio, cost) * c_second


def _argmin(cost: torch.Tensor) -> torch.Tensor:
    return torch.argmin(cost, 0).to(torch.int32)


def block_match(
    left: torch.Tensor,
    right: torch.Tensor,
    max_disp: int = 64,
    patch: Tuple[int, int] = (7, 9),
    lr_tol: float = 1.0,
    unique_ratio: float = 0.98,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense sub-pixel disparity for the left view + validity mask."""
    cost = cost_volume(left, right, max_disp, patch)  # [D, H, W]
    best = _argmin(cost)  # [H, W]
    disp = _subpixel(cost, best)

    # left-right consistency without recomputing: the right view's cost
    # volume is the left one sheared along x, cost_R[d, y, x] =
    # cost_L[d, y, min(x + d, W - 1)]: a strided view of the left volume
    # padded on the right by its last column (no [D, H, W] gather)
    h, w = best.shape
    costp = torch.cat([cost, cost[:, :, -1:].expand(-1, -1, max_disp - 1)], 2)
    s0, s1, _ = costp.stride()
    cost_r = costp.as_strided((max_disp, h, w), (s0 + 1, s1, 1))
    best_r = _argmin(cost_r)
    del costp, cost_r
    x_idx = torch.arange(w, dtype=torch.int32, device=best.device)
    # the disparity the right view gives the pixel the left one matched
    match_x = torch.clamp(x_idx[None, :] - best, 0, w - 1)
    d_from_r = torch.gather(best_r, 1, match_x.to(torch.int64))
    lr_ok = (d_from_r.to(torch.float32) - best.to(torch.float32)).abs() <= _f32(lr_tol, cost)

    uniq_ok = _unique(cost, best, unique_ratio)
    # borders: pixels whose hypothesis range ran off the image
    border_ok = x_idx[None, :] >= best
    valid = lr_ok & uniq_ok & border_ok & (best > 0) & (best < max_disp - 1)
    return disp, valid


# ----------------------------------------------------------------------
# coarse-to-fine block matching (the frame-rate path)
# ----------------------------------------------------------------------
def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling; odd dims edge-pad to even first."""
    h, w = x.shape
    if h % 2 or w % 2:
        x = F.pad(x[None, None], (0, w % 2, 0, h % 2), mode="replicate")[0, 0]
    return (((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]) / _f32(4.0, x)


def _upsample2_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest 2x upsample cropped to (h, w) (the refinement band absorbs
    the half-pixel placement error of nearest against linear)."""
    return x.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]


def _spread3(d: torch.Tensor) -> torch.Tensor:
    """max - min over each 3x3 neighbourhood (SAME, -inf padding)."""
    dmax = F.max_pool2d(d[None, None], 3, 1, 1)[0, 0]
    dmin = -F.max_pool2d(-d[None, None], 3, 1, 1)[0, 0]
    return dmax - dmin


def block_match_pyramid(
    left: torch.Tensor,
    right: torch.Tensor,
    max_disp: int = 64,
    patch: Tuple[int, int] = (7, 9),
    levels: int = 2,
    band: int = 2,
    lr_tol: float = 1.0,
    unique_ratio: float = 0.98,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse-to-fine dense disparity: the flat matcher at 1/2^levels
    resolution, then a +-band refinement at each finer level (one gather
    of the right image per hypothesis, 2*band+1 in all).

    Validity: the coarse level runs the flat matcher's full battery;
    refinement levels drop a pixel whose seed's 3x3 spread exceeds the
    band (a depth edge the band cannot reach) or whose minimum lies on
    the band's edge, and the finest level adds band-local uniqueness,
    border and disparity-range checks.  The left-right check runs on the
    coarse seed only (as in JAX)."""
    ph, pw = patch
    gl = _to_gray(left.to(torch.float32))
    gr = _to_gray(right.to(torch.float32))
    pyr = [(gl, gr)]
    for _ in range(levels):
        pyr.append((_downsample2(pyr[-1][0]), _downsample2(pyr[-1][1])))

    # coarse seed: the flat matcher at the top of the pyramid
    cd = max(4, -(-max_disp // (1 << levels)))
    d, valid = block_match(pyr[-1][0], pyr[-1][1], max_disp=cd, patch=patch,
                           lr_tol=lr_tol, unique_ratio=unique_ratio)
    band_f = _f32(float(band), d)

    for lvl in range(levels - 1, -1, -1):
        # discontinuity guard: a seed whose 3x3 spread exceeds the band
        # cannot reach the true disparity of every pixel under it
        valid = valid & (_spread3(d) * 2.0 <= band_f)
        glz, grz = pyr[lvl]
        h, w = glz.shape
        d = 2.0 * _upsample2_to(d, h, w)
        valid = _upsample2_to(valid, h, w)
        glz = _zero_mean(glz, ph, pw)
        grz = _zero_mean(grz, ph, pw)
        di = torch.round(d).to(torch.int32)  # half to even, as jnp.round
        x_idx = torch.arange(w, dtype=torch.int32, device=d.device)[None, :]
        costs = torch.stack([
            (glz - torch.gather(grz, 1, torch.clamp(x_idx - di - j, 0, w - 1).to(torch.int64)))
            .abs() for j in range(-band, band + 1)])
        cost = _box(costs, ph, pw)  # [2B+1, H, W]
        bj = _argmin(cost)
        d_int = di + bj - band
        # a minimum on the band's edge: the seed was off by more than the
        # band, and the true minimum may lie outside it
        valid = valid & (bj > 0) & (bj < 2 * band)
        if lvl == 0:
            # sub-pixel and band-local uniqueness at the finest level only
            sub = _subpixel(cost, bj)  # band coords + offset
            d = d_int.to(torch.float32) + (sub - bj.to(torch.float32))
            border_ok = x_idx >= d_int
            valid = (valid & _unique(cost, bj, unique_ratio) & border_ok
                     & (d_int > 0) & (d_int < max_disp - 1))
        else:
            d = d_int.to(torch.float32)
    return d, valid


def stereo_depth(
    left: torch.Tensor,
    right: torch.Tensor,
    fx: float,
    baseline_m: float,
    max_disp: int = 64,
    patch: Tuple[int, int] = (7, 9),
    min_depth: float = 0.1,
    max_depth: float = 10.0,
    method: str = "flat",
) -> StereoDepthResult:
    """Rectified stereo pair -> metric depth (left view).

    fx is the rectified focal length (StereoRectifier.rectified_intrinsics
    / the P2 matrix of stereo_rectifier.cc:78); baseline_m the camera
    separation (|t| of the extrinsics, e.g. 0.12 m for a ZED).

    method "flat" = full cost volume; "pyramid" = coarse-to-fine."""
    if method not in METHODS:
        raise ValueError(f"stereo method must be 'flat' or 'pyramid', got {method!r}")
    matcher = block_match_pyramid if method == "pyramid" else block_match
    disp, valid = matcher(left, right, max_disp=max_disp, patch=patch)
    # fx * baseline is a float64 product rounded to float32 once, as JAX's
    # weak-typed scalar (and a true division, not a reciprocal)
    depth = _f32(fx * baseline_m, disp) / torch.maximum(disp, _f32(1e-6, disp))
    valid = valid & (depth >= _f32(min_depth, disp)) & (depth <= _f32(max_depth, disp))
    return StereoDepthResult(depth=torch.where(valid, depth, _f32(0.0, disp)),
                             disparity=disp, valid=valid)


class StereoDepthEstimator:
    """Host-facing wrapper: fixes the geometry once.

    A drop-in depth source: (left, right) uint8/float arrays -> depth in
    metres with invalid pixels zeroed (the TSDF integrate path treats
    depth <= 0 as no measurement, as the reference zeroes masked depth,
    disinfect_slam.cc:55-58).  It runs on the CUDA device unless the
    caller asks for another."""

    def __init__(
        self,
        fx: float,
        baseline_m: float,
        max_disp: int = 64,
        patch: Tuple[int, int] = (7, 9),
        min_depth: float = 0.1,
        max_depth: float = 10.0,
        method: str = "flat",
        device="cuda",
    ):
        if method not in METHODS:
            raise ValueError(f"stereo method must be 'flat' or 'pyramid', got {method!r}")
        self.fx = float(fx)
        self.baseline_m = float(baseline_m)
        self.device = resolve_device(device)
        self._kw = dict(fx=self.fx, baseline_m=self.baseline_m, max_disp=max_disp,
                        patch=patch, min_depth=min_depth, max_depth=max_depth, method=method)

    def _upload(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def depth_device(self, left, right) -> torch.Tensor:
        """Depth on the device: feed it to integrate / DenseSLAM without a
        host round trip."""
        return stereo_depth(self._upload(left), self._upload(right), **self._kw).depth

    def __call__(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        return self.depth_device(left, right).cpu().numpy()
