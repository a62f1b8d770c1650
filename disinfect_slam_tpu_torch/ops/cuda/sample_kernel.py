"""sample_rows: the stacked frame channels at every voxel's pixel.

Counterpart of the TPU kernel `sample_patches` (K1,
disinfect_slam_tpu/ops/pallas/sample_kernel.py).  The CUDA kernel
(csrc/sample_rows.cu) loads each voxel's 32-byte pixel directly, so every
in-image voxel is sampled exactly, with no patch limit; what bounds it on
an H100 is device memory traffic (see the source's header).

`sample_rows` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it runs `sample_rows_reference`, the plain torch
version with the same signature.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...utils.graphs import count_launch
from . import build

_C = ctypes


def sample_rows_reference(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version.  img f32 [H, W, 8]; u, v i32 [V, 512] pixel
    coordinates (not clipped); count i32 [] live rows.

    Returns (channels f32 [8, V, 512], valid bool [V, 512]): valid marks
    in-image voxels, whose channels are the pixel's; other voxels read 0.
    Rows at or past count are unspecified (the kernel does not write
    them)."""
    img_h, img_w, _ = img.shape
    valid = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    s = img[v.clamp(0, img_h - 1).long(), u.clamp(0, img_w - 1).long()]
    s = torch.where(valid[..., None], s, 0.0)
    return s.permute(2, 0, 1).contiguous(), valid


def _check_inputs(img, u, v, count) -> None:
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"sample_rows takes CPU or CUDA tensors, got {dev}")
    if img.dtype != torch.float32 or img.dim() != 3 or img.shape[2] != 8:
        raise ValueError(f"img must be f32 [H, W, 8], got {img.dtype} {tuple(img.shape)}")
    for name, t in (("u", u), ("v", v)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 512:
            raise ValueError(f"{name} must be i32 [V, 512], got {t.dtype} {tuple(t.shape)}")
    if u.shape != v.shape:
        raise ValueError("u and v must have the same shape")
    if count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError("count must be a one-element i32 tensor")
    for t in (img, u, v, count):
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if img.data_ptr() % 16:
        raise ValueError("img must be 16-byte aligned")


def sample_rows(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample the stacked frame at every voxel's pixel; see
    sample_rows_reference for the contract."""
    if img.device.type == "cpu":
        return sample_rows_reference(img, u, v, count)
    _check_inputs(img, u, v, count)
    rows = u.shape[0]
    chans = torch.empty((8, rows, 512), dtype=torch.float32, device=img.device)
    valid = torch.empty((rows, 512), dtype=torch.bool, device=img.device)
    fn = build.entry("sample_rows", "dst_sample_rows", [
        _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p,
        _C.c_void_p, _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ])
    with torch.cuda.device(img.device):
        err = fn(
            build.ptr(img), img.shape[0], img.shape[1], build.ptr(u),
            build.ptr(v), build.ptr(count), rows, build.ptr(chans),
            build.ptr(valid), build.stream_of(img),
        )
    count_launch(sample_rows)
    build.check(err, "sample_rows")
    return chans, valid


sample_rows.launches = 0
