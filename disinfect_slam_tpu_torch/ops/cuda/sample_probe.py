"""Hopper probes of the frame sampler (K1) and of fuse_rows' stages (K2),
the counterparts of the TPU probes P1-P6 (scripts/probe_sample2.py,
probe_sample3.py, probe_sample4.py, probe_sample_overhead.py,
probe_kernel_stages.py, probe_mxu_shapes.py).  Source:
csrc/sample_probe.cu, with fuse_rows' body from csrc/fuse_rows.cuh.

- P4, `direct`: K1's body, its pixel loads alone (one word written a
  voxel) and its writes alone.
- P1/P2/P6, `patch`: the TPU's design on this card: each block's aligned
  patch (24x32 and 48x64 pixels) staged in shared memory by the bulk copy
  engine, each voxel reading its pixel there, 1, 4 and 16 rows a CTA;
  voxels in the image but outside the patch come back invalid and are
  counted (the TPU's sampler_skipped).
- P3, `mma`: the 24x32 patch selected through exact one-hot u8 mma.sync
  on four byte planes.
- P5, `fuse_stages`: fuse_rows stripped to the ring of pool rows, then
  with the projection, then with the sampling; each reduces min |tsdf|
  over the voxels its stages let through and writes their pool words back
  unchanged (the bytes of the fusion without its arithmetic).  The fusion
  is fuse_rows.

Every mode is held against its plain torch version (`*_reference`), its
largest difference from it reported (`max_abs_err`, 0 or it raises), and
timed with the timer it is given, timer(fn, kernel_name, nbytes), nbytes
being the bytes its bound counts; `run` gives chip_smoke.py's report.
The probe kernels take CUDA tensors only; each wrapper counts its
launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, fuse_kernel
from .sample_kernel import sample_rows, sample_rows_reference

_C = ctypes
_P = _C.c_void_p
SOURCE = "sample_probe"
PATCH_SHAPES = ((24, 32), (48, 64))
ROWS_PER_CTA = (1, 4, 16)
MMA_ROWS_PER_CTA = 4
DIRECT_MODES = ("full", "loads_only", "writes_only")
FUSE_STAGES = ("ring", "ring + projection", "ring + projection + sampling")


def patch_origins(u: torch.Tensor, v: torch.Tensor, img_h: int, img_w: int):
    """Each row's patch origin before alignment, as the JAX package's
    fuse_visible computes it for sample_patches: the row's lowest
    in-image pixel column and row (img_w - 1, img_h - 1 for a row with
    none).  -> (u0, v0) i32 [V]."""
    in_img = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    u0 = torch.where(in_img, u, img_w - 1).amin(1).to(torch.int32)
    v0 = torch.where(in_img, v, img_h - 1).amin(1).to(torch.int32)
    return u0, v0


def align_origins(u0, v0, img_h: int, img_w: int, ph: int, pw: int):
    """As sample_patches aligns them: columns down to 16 pixels (128 lanes
    of 8 channels), rows down to 8, clipped so the patch lies in the
    image."""
    u0 = torch.clamp((u0 // 16) * 16, 0, ((img_w - pw) // 16) * 16)
    v0 = torch.clamp((v0 // 8) * 8, 0, ((img_h - ph) // 8) * 8)
    return u0.to(torch.int32).contiguous(), v0.to(torch.int32).contiguous()


def patch_sample_reference(img, u, v, count, u0, v0, ph: int, pw: int):
    """Plain version of the patch modes.  img f32 [H, W, 8]; u, v i32 [V,
    512]; count i32 []; u0, v0 i32 [V] the origins of patch_origins.

    Returns (channels f32 [8, V, 512], valid bool [V, 512], skipped i32
    [2]): valid marks voxels inside their row's aligned ph x pw patch,
    whose channels are the pixel's (others 0); skipped counts, over the
    live rows, the voxels in the image but outside the patch and the rows
    with any.  Rows at or past count are unspecified in the first two."""
    img_h, img_w, _ = img.shape
    au, av = align_origins(u0, v0, img_h, img_w, ph, pw)
    lu, lv = u - au[:, None], v - av[:, None]
    valid = (lu >= 0) & (lu < pw) & (lv >= 0) & (lv < ph)
    in_img = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    live = torch.arange(u.shape[0], device=u.device) < count
    s = img[v.clamp(0, img_h - 1).long(), u.clamp(0, img_w - 1).long()]
    chans = torch.where(valid[..., None], s, 0.0).permute(2, 0, 1).contiguous()
    skip = live[:, None] & in_img & ~valid
    skipped = torch.stack([skip.sum(), skip.any(1).sum()]).to(torch.int32)
    return chans, valid, skipped


def _sample_outputs(u):
    rows = u.shape[0]
    return (torch.empty((8, rows, 512), dtype=torch.float32, device=u.device),
            torch.empty((rows, 512), dtype=torch.bool, device=u.device))


def sample_patch(img, u, v, count, u0, v0, shape: int, rows_per_cta: int):
    """The patch kernel at PATCH_SHAPES[shape] -> (channels, valid,
    skipped) as patch_sample_reference."""
    ph, pw = PATCH_SHAPES[shape]
    au, av = align_origins(u0, v0, img.shape[0], img.shape[1], ph, pw)
    chans, valid = _sample_outputs(u)
    skipped = torch.zeros(2, dtype=torch.int32, device=u.device)
    fn = build.entry(SOURCE, "dst_probe_sample_patch", [
        _C.c_int, _P, _C.c_int, _C.c_int, _P, _P, _P, _P, _P, _C.c_int, _C.c_int, _P, _P,
        _P, _P])
    with torch.cuda.device(u.device):
        err = fn(shape, build.ptr(img), img.shape[0], img.shape[1], build.ptr(u), build.ptr(v),
                 build.ptr(au), build.ptr(av), build.ptr(count), u.shape[0], rows_per_cta,
                 build.ptr(chans), build.ptr(valid), build.ptr(skipped), build.stream_of(u))
    sample_patch.launches += 1
    build.check(err, f"probe sample_patch {ph}x{pw}")
    return chans, valid, skipped


sample_patch.launches = 0


def sample_mma(img, u, v, count, u0, v0, rows_per_cta: int = MMA_ROWS_PER_CTA):
    """The one-hot u8 mma selection at the 24x32 patch -> as sample_patch."""
    au, av = align_origins(u0, v0, img.shape[0], img.shape[1], *PATCH_SHAPES[0])
    chans, valid = _sample_outputs(u)
    skipped = torch.zeros(2, dtype=torch.int32, device=u.device)
    fn = build.entry(SOURCE, "dst_probe_sample_mma", [
        _P, _C.c_int, _C.c_int, _P, _P, _P, _P, _P, _C.c_int, _C.c_int, _P, _P, _P, _P])
    with torch.cuda.device(u.device):
        err = fn(build.ptr(img), img.shape[0], img.shape[1], build.ptr(u), build.ptr(v),
                 build.ptr(au), build.ptr(av), build.ptr(count), u.shape[0], rows_per_cta,
                 build.ptr(chans), build.ptr(valid), build.ptr(skipped), build.stream_of(u))
    sample_mma.launches += 1
    build.check(err, "probe sample_mma")
    return chans, valid, skipped


sample_mma.launches = 0


def sample_direct(img, u, v, count, mode: int):
    """P4's modes of K1's body (DIRECT_MODES[mode]) -> (channels, valid)
    for full and writes_only, the word per voxel for loads_only."""
    chans, valid = _sample_outputs(u)
    words = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    fn = build.entry(SOURCE, "dst_probe_sample_direct", [
        _C.c_int, _P, _C.c_int, _C.c_int, _P, _P, _P, _C.c_int, _P, _P, _P, _P])
    with torch.cuda.device(u.device):
        err = fn(mode, build.ptr(img), img.shape[0], img.shape[1], build.ptr(u), build.ptr(v),
                 build.ptr(count), u.shape[0], build.ptr(chans), build.ptr(valid),
                 build.ptr(words), build.stream_of(u))
    sample_direct.launches += 1
    build.check(err, f"probe sample_direct {DIRECT_MODES[mode]}")
    return words if DIRECT_MODES[mode] == "loads_only" else (chans, valid)


sample_direct.launches = 0


def sample_direct_reference(img, u, v, count, mode: int):
    """Plain versions of P4's modes: sample_rows_reference; the xor of the
    pixel's eight words (0 off the image); channel c's value c (0 off the
    image) and validity."""
    if DIRECT_MODES[mode] == "full":
        return sample_rows_reference(img, u, v, count)
    img_h, img_w, _ = img.shape
    ok = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    if DIRECT_MODES[mode] == "writes_only":
        c = torch.arange(8, dtype=torch.float32, device=u.device)[:, None, None]
        return torch.where(ok[None], c, 0.0), ok
    s = img.view(torch.int32)[v.clamp(0, img_h - 1).long(), u.clamp(0, img_w - 1).long()]
    x = s[..., 0]
    for c in range(1, 8):
        x = x ^ s[..., c]
    return torch.where(ok, x, 0)


def fuse_stage(stage: int, img, block_pos, pool_idx, count, tsdf, rgbw, prob, *,
               cam_T_world, intrinsics, voxel_size, truncation, max_depth, max_weight,
               prob_eps=0.0):
    """fuse_rows stripped to FUSE_STAGES[stage] (the arguments of
    fuse_kernel.fuse_rows; the pool words of the voxels the stage lets
    through are written back with the values they had) -> min |tsdf| f32
    [V] over those voxels (inf for none)."""
    minabs = torch.empty(block_pos.shape[0], dtype=torch.float32, device=img.device)
    fn = build.entry(SOURCE, "dst_probe_fuse_stage", [_C.c_int, *fuse_kernel.ARGTYPES])
    with torch.cuda.device(img.device):
        err = fn(stage, *fuse_kernel.c_args(
            img, block_pos, pool_idx, count, tsdf, rgbw, prob, minabs,
            cam_T_world=cam_T_world, intrinsics=intrinsics, voxel_size=voxel_size,
            truncation=truncation, max_depth=max_depth, max_weight=max_weight,
            prob_eps=prob_eps))
    fuse_stage.launches += 1
    build.check(err, f"probe fuse stage {FUSE_STAGES[stage]}")
    return minabs


fuse_stage.launches = 0


def stage_keep(stage: int, img, block_pos, pool_idx, count, *, cam_T_world, intrinsics,
               voxel_size, truncation, max_depth):
    """The voxels of the live rows that stage FUSE_STAGES[stage] lets
    through, bool [count, 512]: all of them (ring), those in the image
    (with the projection), those the update gate passes (with the
    sampling: a depth in (0, max_depth], not far behind the surface)."""
    n = int(count)
    img_h, img_w, _ = img.shape
    keep = torch.ones((n, 512), dtype=torch.bool, device=img.device)
    if stage >= 1:
        u, v, z = fuse_kernel.project_rows(block_pos[:n], cam_T_world, intrinsics, voxel_size)
        keep = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    if stage >= 2:
        s = img[v.clamp(0, img_h - 1).long(), u.clamp(0, img_w - 1).long()]
        depth, d2r = s[..., 0], s[..., 1]
        sdf = d2r * (depth - z)
        keep &= (depth > 0) & (depth <= max_depth) & (sdf > -truncation)
    return keep


def fuse_stage_reference(stage: int, img, block_pos, pool_idx, count, tsdf, rgbw, prob, *,
                         cam_T_world, intrinsics, voxel_size, truncation, max_depth,
                         max_weight, prob_eps=0.0):
    """Plain version of fuse_stage: min |tsdf| of the live rows over the
    voxels of stage_keep; rows at or past count unspecified.  The pool is
    left as it is."""
    n = int(count)
    keep = stage_keep(stage, img, block_pos, pool_idx, count, cam_T_world=cam_T_world,
                      intrinsics=intrinsics, voxel_size=voxel_size, truncation=truncation,
                      max_depth=max_depth)
    a = tsdf[pool_idx[:n].long()].abs()
    out = torch.zeros(block_pos.shape[0], dtype=torch.float32, device=img.device)
    out[:n] = torch.where(keep, a, torch.inf).amin(-1)
    return out


def _row_err(a, b, n: int) -> float:
    """Largest |a - b| over the first n rows (dim 1 of [C, V, 512], dim 0
    otherwise); bool and int as numbers, equal entries (infinities too)
    count 0."""
    a, b = (a[:, :n], b[:, :n]) if a.dim() == 3 else (a[:n], b[:n])
    a, b = a.double(), b.double()
    d = torch.where(a == b, 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def direct(dev, timer, img, u, v, count) -> list:
    """P4: each direct mode against its plain version, timed; bytes as
    each mode needs them (u, v of the live voxels, the frame once for the
    loads, the writes)."""
    n = int(count)
    voxels, frame = 512 * n, img.numel() * 4
    need = {"full": 8 * voxels + 33 * voxels + frame, "loads_only": 12 * voxels + frame,
            "writes_only": 8 * voxels + 33 * voxels}
    out = []
    for mode, name in enumerate(DIRECT_MODES):
        got = sample_direct(img, u, v, count, mode)
        ref = sample_direct_reference(img, u, v, count, mode)
        if name == "loads_only":
            err = _row_err(got, ref, n)
        else:
            err = max(_row_err(got[0], ref[0], n), _row_err(got[1], ref[1], n))
        if err:
            raise AssertionError(f"P4 {name}: differs from its plain version by {err}")
        out.append({"mode": name, "bytes": need[name], "max_abs_err": err,
                    "ms": timer(lambda m=mode: sample_direct(img, u, v, count, m),
                                "sample_direct_kernel", need[name])})
    out.append({"mode": "sample_rows (K1)", "bytes": need["full"],
                "ms": timer(lambda: sample_rows(img, u, v, count), "sample_rows_kernel",
                            need["full"])})
    return out


def _check_patch(label, got, ref, n) -> dict:
    chans, valid, skipped = got
    chans_r, valid_r, skipped_r = ref
    err = max(_row_err(valid, valid_r, n), _row_err(chans, chans_r, n),
              _row_err(skipped, skipped_r, 2))
    if err:
        raise AssertionError(f"{label}: differs from its plain version by {err} "
                             f"(skipped {skipped.tolist()} vs {skipped_r.tolist()})")
    return {"skipped_voxels": int(skipped[0]), "skipped_rows": int(skipped[1]),
            "max_abs_err": err}


def patch(dev, timer, img, u, v, count) -> list:
    """P1/P2/P6 and P3: every patch shape at every rows-per-CTA, and the
    mma selection, against the plain version; skipped voxels and rows;
    bytes: u, v of the live voxels, the origins, the outputs, the frame
    once."""
    n = int(count)
    img_h, img_w, _ = img.shape
    u0, v0 = patch_origins(u, v, img_h, img_w)
    nbytes = 41 * 512 * n + 8 * n + img.numel() * 4
    out = []
    for shape, (ph, pw) in enumerate(PATCH_SHAPES):
        ref = patch_sample_reference(img, u, v, count, u0, v0, ph, pw)
        for rpc in ROWS_PER_CTA:
            label = f"patch {ph}x{pw}, {rpc} rows a CTA"
            res = _check_patch(label, sample_patch(img, u, v, count, u0, v0, shape, rpc), ref, n)
            res.update(mode=label, bytes=nbytes, ms=timer(
                lambda s=shape, r=rpc: sample_patch(img, u, v, count, u0, v0, s, r),
                "sample_patch_kernel", nbytes))
            out.append(res)
    ref = patch_sample_reference(img, u, v, count, u0, v0, *PATCH_SHAPES[0])
    label = f"mma one-hot u8 24x32, {MMA_ROWS_PER_CTA} rows a CTA"
    res = _check_patch(label, sample_mma(img, u, v, count, u0, v0), ref, n)
    res.update(mode=label, bytes=nbytes,
               ms=timer(lambda: sample_mma(img, u, v, count, u0, v0), "sample_mma_kernel",
                        nbytes))
    out.append(res)
    return out


def fuse_stages(dev, timer, img, block_pos, pool_idx, count, pool, consts,
                fuse_rows_fn) -> list:
    """P5: each stripped stage of fuse_rows against its plain version
    (min |tsdf| of the live rows bit-equal, the pool words it wrote back
    unchanged), timed, then fuse_rows itself on a copy of the pool; bytes:
    block position and pool index per live row, the tsdf word per live
    voxel, min |tsdf| per row, the rgbw and prob words read and all three
    written for each voxel the stage lets through, the frame once from the
    sampling on (fuse_rows: the last stage's)."""
    n = int(count)
    live = pool_idx[:n].long()
    before = [a[live] for a in pool]
    gate = {k: consts[k] for k in ("cam_T_world", "intrinsics", "voxel_size", "truncation",
                                   "max_depth")}
    out = []
    for stage, name in enumerate(FUSE_STAGES):
        got = fuse_stage(stage, img, block_pos, pool_idx, count, *pool, **consts)
        ref = fuse_stage_reference(stage, img, block_pos, pool_idx, count, *pool, **consts)
        err = max(_row_err(got, ref, n), *(_row_err(a[live], b, n) for a, b in zip(pool, before)))
        if err:
            raise AssertionError(f"P5 {name}: differs from its plain version by {err}")
        through = int(stage_keep(stage, img, block_pos, pool_idx, count, **gate).sum())
        nbytes = 20 * n + 4 * 512 * n + 20 * through + (img.numel() * 4 if stage >= 2 else 0)
        out.append({"stage": name, "voxels_through": through, "bytes": nbytes,
                    "max_abs_err": err,
                    "ms": timer(lambda s=stage: fuse_stage(s, img, block_pos, pool_idx, count,
                                                           *pool, **consts),
                                "fuse_rows_kernel", nbytes)})
    copy = [a.clone() for a in pool]
    out.append({"stage": "ring + projection + sampling + fusion (fuse_rows)",
                "ms": timer(lambda: fuse_rows_fn(img, block_pos, pool_idx, count, *copy,
                                                 **consts), "fuse_rows_kernel", nbytes)})
    del copy, before
    return out


def run(dev, timer, sample_case, fuse_case, fuse_rows_fn) -> dict:
    """All modes.  timer(fn, kernel_name, nbytes) -> ms; sample_case (img, u, v,
    count) at K1's shapes; fuse_case (img, block_pos, pool_idx, count,
    (tsdf, rgbw, prob), consts) at fuse_rows'; fuse_rows_fn the fusion
    kernel's wrapper."""
    return {"p4": direct(dev, timer, *sample_case),
            "patch": patch(dev, timer, *sample_case),
            "p5": fuse_stages(dev, timer, *fuse_case, fuse_rows_fn)}
