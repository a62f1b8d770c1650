"""fuse_rows: frame sampling + semantic TSDF fusion, in place on the pool.

Counterpart of the TPU kernels `fuse_rows_packed` (K2) and `fuse_rows`
(K3) of disinfect_slam_tpu/ops/pallas/fuse_kernel.py.  The CUDA kernel
(csrc/fuse_rows.cu) runs one 512-thread CTA per visible block, loads each
voxel's pixel directly (no patch, no frame-size limit, so it covers K3's
large frames too), reads and writes the block's pool rows in place
through pool_idx, and reduces min |tsdf| per row for carving.  What bounds
it on an H100 is device memory traffic (see the source's header).

`fuse_rows` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors it runs `fuse_rows_reference`, the plain torch version
with the same signature.  `fuse_math` holds the fusion formulas as torch
ops; the reference and the two-stage sampler path share it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...core.voxel import round_half_away
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


def fuse_rows_reference(
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
    """Plain version.  img f32 [H, W, 8]; us, vs i32 [V, 512] clipped
    pixel coordinates; z f32 [V, 512]; gate bool [V, 512] (live row and
    in-image voxel); pool_idx i32 [V]; count i32 [] live rows (each with a
    distinct pool row); tsdf f32, rgbw i32, prob f32 [B, 512] pool arrays.

    Fuses rows < count into their pool rows in place and returns min
    |tsdf| per row f32 [V] (rows at or past count are unspecified)."""
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


def _check_inputs(img, us, vs, z, gate, pool_idx, count, tsdf, rgbw, prob):
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"fuse_rows takes CPU or CUDA tensors, got {dev}")
    if img.dtype != torch.float32 or img.dim() != 3 or img.shape[2] != 8:
        raise ValueError(f"img must be f32 [H, W, 8], got {img.dtype} {tuple(img.shape)}")
    rows = us.shape[0]
    want = {
        "us": (us, torch.int32, (rows, 512)),
        "vs": (vs, torch.int32, (rows, 512)),
        "z": (z, torch.float32, (rows, 512)),
        "gate": (gate, torch.bool, (rows, 512)),
        "pool_idx": (pool_idx, torch.int32, (rows,)),
        "tsdf": (tsdf, torch.float32, (tsdf.shape[0], 512)),
        "rgbw": (rgbw, torch.int32, (tsdf.shape[0], 512)),
        "prob": (prob, torch.float32, (tsdf.shape[0], 512)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    if count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError("count must be a one-element i32 tensor")
    for t in (img, us, vs, z, gate, pool_idx, count, tsdf, rgbw, prob):
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if img.data_ptr() % 16:
        raise ValueError("img must be 16-byte aligned")


def fuse_rows(
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
    """Fuse the live rows into the pool in place; see fuse_rows_reference
    for the contract."""
    args = (img, us, vs, z, gate, pool_idx, count, tsdf, rgbw, prob)
    consts = dict(truncation=truncation, max_depth=max_depth,
                  max_weight=max_weight, prob_eps=prob_eps)
    if img.device.type == "cpu":
        return fuse_rows_reference(*args, **consts)
    _check_inputs(*args)
    rows = us.shape[0]
    minabs = torch.empty(rows, dtype=torch.float32, device=img.device)
    fn = build.entry("dst_fuse_rows", [
        _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p,
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
        _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_float, _C.c_float, _C.c_float, _C.c_float, _C.c_float,
        _C.c_void_p,
    ])
    with torch.cuda.device(img.device):
        err = fn(
            build.ptr(img), img.shape[0], img.shape[1], build.ptr(us),
            build.ptr(vs), build.ptr(z), build.ptr(gate), build.ptr(pool_idx),
            build.ptr(count), rows, tsdf.shape[0], build.ptr(tsdf),
            build.ptr(rgbw), build.ptr(prob), build.ptr(minabs),
            truncation, max_depth, max_weight, prob_eps,
            # the upper clamp bound 1 - prob_eps, rounded to f32 from the
            # double as the torch version rounds it
            1.0 - prob_eps,
            build.stream_of(img),
        )
    fuse_rows.launches += 1
    build.check(err, "fuse_rows")
    return minabs


fuse_rows.launches = 0
