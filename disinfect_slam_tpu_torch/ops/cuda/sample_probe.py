"""Hopper probes of the frame sampler (K1) and of fuse_rows' stages (K2).
Source: csrc/sample_probe.cu, with fuse_rows' body from csrc/fuse_rows.cuh.

- P4 and P5, the TPU probes scripts/probe_sample_overhead.py (run in four
  modes) and scripts/probe_kernel_stages.py (four variants): the Pallas
  sampler's stripped modes on the probes' own inputs (`probe_inputs`),
  `sample_modes` (one launch of sample_modes_kernel): the 8 channel planes
  and the valid plane of each mode (P4 over every row; P5 over the 16-row
  steps below a live count read on the device), with the probes' bf16
  splits (`bf16_splits`: P4's full mode is the exact pixel, P5's two
  splits are not); `run_modes` holds each on the card to its plain
  version, `sample_modes_reference`.
- P1/P2/P6, `patch`: the exact samples of each block's aligned window
  (24x32 and 48x64 pixels), 1, 4 and 16 rows a CTA; voxels in the image
  but outside the window come back invalid and are counted (the TPU's
  sampler_skipped).  Each row stages only its voxels' box in the window
  (`patch_boxes`) in shared memory, through a ring of two slots of
  `SLOT_BYTES` (one slot for a CTA of one row), in strips of box rows
  where a box is taller than a slot holds (`staging_plan`;
  `patch_sample_staged` is the staging written out in torch).
- P3, the TPU's one-hot matmul selection: on this card the same kernel at
  24x32, `P3_ROWS_PER_CTA` rows a CTA: a shared-memory load is Hopper's
  gather, where the one-hot form's int8 mma work alone came to 37.5% of
  the byte bound.
- The port's own instruments: K1's split, `direct` (K1's body, its pixel
  loads alone with one word written a voxel, and its writes alone); K2's
  stages, `fuse_stages` (fuse_rows stripped to the ring of pool rows,
  then with the projection, then with the sampling; each reduces min
  |tsdf| over the voxels its stages let through and writes their pool
  words back unchanged: the bytes of the fusion without its arithmetic;
  the fusion is fuse_rows).

Every mode is held against its plain torch version (`*_reference`), its
largest difference from it reported (`max_abs_err`, 0 or it raises), and
timed with the timer it is given, timer(fn, kernel_name, nbytes), nbytes
being the bytes its bound counts; `run` and `run_modes` give
chip_smoke.py's report.  `sample_patch` and `sample_modes` run their
plain versions on CPU tensors and their kernels on CUDA tensors; the
other probe kernels take CUDA tensors only.  Each wrapper counts its
launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, fuse_kernel
from .sample_kernel import sample_rows, sample_rows_reference

_C = ctypes
_P = _C.c_void_p
SOURCE = "sample_probe"
PATCH_SHAPES = ((24, 32), (48, 64))
ROWS_PER_CTA = (1, 4, 16)
P3_ROWS_PER_CTA = 4
SLOT_BYTES = 24576  # a ring slot: the 24x32 window, so any 24x32 box fits whole
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


def patch_boxes(img, u, v, count, u0, v0, ph: int, pw: int):
    """Each row's footprint box in its aligned ph x pw window (arguments as
    patch_sample_reference's): (c0, r0, c1, r1) i32 [V, 4], the least and
    greatest lu = u - u0 and lv = v - v0 over the row's voxels inside the
    window, (u0, v0) the aligned origin; an empty box (pw, ph, -1, -1) for
    a row with none and for the rows at or past count."""
    au, av = align_origins(u0, v0, img.shape[0], img.shape[1], ph, pw)
    lu, lv = u - au[:, None], v - av[:, None]
    inside = (lu >= 0) & (lu < pw) & (lv >= 0) & (lv < ph)
    inside &= (torch.arange(u.shape[0], device=u.device) < count)[:, None]
    return torch.stack([torch.where(inside, lu, pw).amin(1), torch.where(inside, lv, ph).amin(1),
                        torch.where(inside, lu, -1).amax(1), torch.where(inside, lv, -1).amax(1)],
                       1).to(torch.int32)


def staging_plan(boxes, slot_bytes: int = SLOT_BYTES) -> dict:
    """How the kernel stages each box of patch_boxes through ring slots of
    slot_bytes: i64 [V] each of `width` and `height` (pixels; 0 for an
    empty box), `strip_rows` (box rows a strip: as many 32-byte-pixel rows
    as a slot holds), `strips` (ring turns; 0 for an empty box) and
    `bytes` (staged)."""
    b = boxes.long()
    width = (b[:, 2] - b[:, 0] + 1).clamp(min=0)
    height = (b[:, 3] - b[:, 1] + 1).clamp(min=0)
    strip_rows = torch.minimum(height, slot_bytes // (32 * width.clamp(min=1))).clamp(min=1)
    return {"width": width, "height": height, "strip_rows": strip_rows,
            "strips": (height + strip_rows - 1) // strip_rows, "bytes": 32 * width * height}


def staging_stats(img, u, v, count, u0, v0, ph: int, pw: int,
                  slot_bytes: int = SLOT_BYTES) -> dict:
    """What the kernel stages on these rows (arguments as
    patch_sample_reference's): bytes in all, the bytes whole windows would
    stage, the median and the largest box (pixels, width x height), the
    rows whose box is staged in more than one strip, and the ring turns."""
    n = int(count)
    plan = {k: t[:n] for k, t in staging_plan(
        patch_boxes(img, u, v, count, u0, v0, ph, pw), slot_bytes).items()}
    area = plan["width"] * plan["height"]
    big = int(area.argmax()) if n else 0
    return {"slot_bytes": slot_bytes, "staged_bytes": int(plan["bytes"].sum()),
            "window_bytes": 32 * ph * pw * n,
            "box_median_px": int(area.median()) if n else 0,
            "box_largest": [int(plan["width"][big]), int(plan["height"][big])] if n else [0, 0],
            "rows_in_strips": int((plan["strips"] > 1).sum()),
            "empty_rows": int((plan["strips"] == 0).sum()), "turns": int(plan["strips"].sum())}


def patch_sample_staged(img, u, v, count, u0, v0, ph: int, pw: int,
                        slot_bytes: int = SLOT_BYTES):
    """The kernel's staging written out in torch, row by row: each live
    row's box (patch_boxes) copied in strips of staging_plan's box rows
    into a buffer of at most slot_bytes, each voxel inside the window
    reading its pixel from the strip that holds its row -> (channels,
    valid, skipped) as patch_sample_reference (rows at or past count:
    channels 0, valid False)."""
    img_h, img_w, _ = img.shape
    au, av = align_origins(u0, v0, img_h, img_w, ph, pw)
    boxes = patch_boxes(img, u, v, count, u0, v0, ph, pw)
    plan = staging_plan(boxes, slot_bytes)
    rows = u.shape[0]
    chans = torch.zeros((rows, 512, 8), dtype=torch.float32, device=u.device)
    valid = torch.zeros((rows, 512), dtype=torch.bool, device=u.device)
    skipped = [0, 0]
    for row in range(min(int(count), rows)):
        lu, lv = u[row] - au[row], v[row] - av[row]
        inside = (lu >= 0) & (lu < pw) & (lv >= 0) & (lv < ph)
        in_img = (u[row] >= 0) & (u[row] < img_w) & (v[row] >= 0) & (v[row] < img_h)
        skip = int((in_img & ~inside).sum())
        skipped[0] += skip
        skipped[1] += skip > 0
        valid[row] = inside
        c0, r0 = int(boxes[row, 0]), int(boxes[row, 1])
        bw, sr = int(plan["width"][row]), int(plan["strip_rows"][row])
        top, left = int(av[row]) + r0, int(au[row]) + c0
        for s in range(int(plan["strips"][row])):
            first = s * sr
            strip = img[top + first:top + min(first + sr, int(plan["height"][row])),
                        left:left + bw].contiguous()
            assert strip.numel() * 4 <= slot_bytes
            here = inside & ((lv - r0) // sr == s)
            chans[row, here] = strip[(lv[here] - r0 - first).long(), (lu[here] - c0).long()]
    return (chans.permute(2, 0, 1).contiguous(), valid,
            torch.tensor(skipped, dtype=torch.int32, device=u.device))


def _sample_outputs(u):
    rows = u.shape[0]
    return (torch.empty((8, rows, 512), dtype=torch.float32, device=u.device),
            torch.empty((rows, 512), dtype=torch.bool, device=u.device))


def sample_patch(img, u, v, count, u0, v0, shape: int, rows_per_cta: int,
                 slot_bytes: int = SLOT_BYTES):
    """The patch kernel at PATCH_SHAPES[shape], rows_per_cta rows a CTA,
    its ring's slots of slot_bytes each (a multiple of 128, at least one
    window row; two slots, one at one row a CTA) -> (channels, valid,
    skipped) as patch_sample_reference, which it runs for CPU tensors."""
    ph, pw = PATCH_SHAPES[shape]
    if img.device.type == "cpu":
        return patch_sample_reference(img, u, v, count, u0, v0, ph, pw)
    if slot_bytes % 128 or slot_bytes < 32 * pw or slot_bytes > 98304:
        raise ValueError(f"slot_bytes {slot_bytes}: a multiple of 128 from {32 * pw} to 98304")
    if img.shape[0] < ph or img.shape[1] < pw or img.data_ptr() % 16:
        raise ValueError(f"img {tuple(img.shape)} must hold a {ph}x{pw} window, 16-byte aligned")
    au, av = align_origins(u0, v0, img.shape[0], img.shape[1], ph, pw)
    chans, valid = _sample_outputs(u)
    skipped = torch.zeros(2, dtype=torch.int32, device=u.device)
    fn = build.entry(SOURCE, "dst_probe_sample_patch", [
        _C.c_int, _P, _C.c_int, _C.c_int, _P, _P, _P, _P, _P, _C.c_int, _C.c_int, _C.c_int,
        _P, _P, _P, _P])
    with torch.cuda.device(u.device):
        err = fn(shape, build.ptr(img), img.shape[0], img.shape[1], build.ptr(u), build.ptr(v),
                 build.ptr(au), build.ptr(av), build.ptr(count), u.shape[0], rows_per_cta,
                 slot_bytes, build.ptr(chans), build.ptr(valid), build.ptr(skipped),
                 build.stream_of(u))
    sample_patch.launches += 1
    build.check(err, f"probe sample_patch {ph}x{pw}")
    return chans, valid, skipped


sample_patch.launches = 0


def sample_direct(img, u, v, count, mode: int):
    """K1's split: the modes of K1's body (DIRECT_MODES[mode]) ->
    (channels, valid) for full and writes_only, the word per voxel for
    loads_only."""
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
    """Plain versions of K1's split: sample_rows_reference; the xor of the
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
    c, _pose = fuse_kernel.c_args(
        img, block_pos, pool_idx, count, tsdf, rgbw, prob, minabs,
        cam_T_world=cam_T_world, intrinsics=intrinsics, voxel_size=voxel_size,
        truncation=truncation, max_depth=max_depth, max_weight=max_weight, prob_eps=prob_eps)
    with torch.cuda.device(img.device):
        err = fn(stage, *c)
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
    """K1's split: each direct mode against its plain version, timed; bytes as
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
            raise AssertionError(f"K1's split {name}: differs from its plain version by {err}")
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
    """P1/P2/P6 and P3: every window shape at every rows-per-CTA, and P3's
    mode (24x32, P3_ROWS_PER_CTA rows a CTA), against the plain version;
    skipped voxels and rows; what each shape stages (staging_stats);
    bytes: u, v of the live voxels, the origins, the outputs, the frame
    once."""
    n = int(count)
    img_h, img_w, _ = img.shape
    u0, v0 = patch_origins(u, v, img_h, img_w)
    nbytes = 41 * 512 * n + 8 * n + img.numel() * 4
    modes = [(shape, rpc, f"patch {ph}x{pw}, {rpc} rows a CTA")
             for shape, (ph, pw) in enumerate(PATCH_SHAPES) for rpc in ROWS_PER_CTA]
    modes.append((0, P3_ROWS_PER_CTA, "P3: patch 24x32 selected from shared memory, "
                                      f"{P3_ROWS_PER_CTA} rows a CTA"))
    refs, stats, out = {}, {}, []
    for shape, rpc, label in modes:
        if shape not in refs:
            ph, pw = PATCH_SHAPES[shape]
            refs[shape] = patch_sample_reference(img, u, v, count, u0, v0, ph, pw)
            stats[shape] = staging_stats(img, u, v, count, u0, v0, ph, pw)
        res = _check_patch(label, sample_patch(img, u, v, count, u0, v0, shape, rpc),
                           refs[shape], n)
        res.update(mode=label, bytes=nbytes, staging=stats[shape], ms=timer(
            lambda s=shape, r=rpc: sample_patch(img, u, v, count, u0, v0, s, r),
            "sample_patch_kernel", nbytes))
        out.append(res)
    return out


def fuse_stages(dev, timer, img, block_pos, pool_idx, count, pool, consts,
                fuse_rows_fn) -> list:
    """K2's stages: each stripped stage of fuse_rows against its plain version
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
            raise AssertionError(f"K2's stage {name}: differs from its plain version by {err}")
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
    """K1's split, the window modes and K2's stages.  timer(fn,
    kernel_name, nbytes) -> ms; sample_case (img, u, v, count) at K1's
    shapes; fuse_case (img, block_pos, pool_idx, count, (tsdf, rgbw,
    prob), consts) at fuse_rows'; fuse_rows_fn the fusion kernel's
    wrapper."""
    return {"k1_direct": direct(dev, timer, *sample_case),
            "patch": patch(dev, timer, *sample_case),
            "k2_stages": fuse_stages(dev, timer, *fuse_case, fuse_rows_fn)}


# --- P4 / P5: the Pallas sampler's modes on their own inputs ----------------

IMG_H, IMG_W, CHANNELS = 480, 640, 8  # the probes' frame, flat as [H, W * 8]
PROBE_PH, PROBE_PW = 24, 32  # the patch each row's origin (u0, v0) opens
TILE_ROWS = 16  # TB: the Pallas grid runs rows in steps of 16
P4_V = 32768  # probe_sample_overhead.py's rows
P5_VCAP, P5_COUNT = 32768, 22336  # probe_kernel_stages.py's rows and live count
# the Pallas functions, by probe, in the scripts' order
MODES = {"P4": ("nodma", "dma_only", "stage1", "full"),
         "P5": ("dma_only", "mxu", "mask_fold", "vmem_img")}
# each function as the kernel computes it (csrc/sample_probe.cu's
# sample_modes_kernel<Mode>): (kernel mode, pixel column, pixel row,
# bf16 splits, masked).  The pixel is (u0 + lu_c, v0 + lv_c) or the
# patch's column or row 0; 0 splits: no pixel; masked: times vmask.
# nodma writes vmask * c, P5's dma_only lu_c
_SAMPLE_MODES = {("P4", "nodma"): (0, None, None, 0, True),
                 ("P4", "dma_only"): (1, "origin", "origin", 1, True),
                 ("P4", "stage1"): (2, "origin", "lv", 3, True),
                 ("P4", "full"): (3, "lu", "lv", 3, True),
                 ("P5", "dma_only"): (4, None, None, 0, True),
                 ("P5", "mxu"): (5, "origin", "lv", 2, False),
                 ("P5", "mask_fold"): (6, "lu", "lv", 2, True),
                 ("P5", "vmem_img"): (6, "lu", "lv", 2, True)}


def probe_inputs(probe: str, rows: int | None = None, count: int | None = None) -> list:
    """The arrays probe ("P4" or "P5") hands its pallas_call, drawn as its
    main draws them at `rows` rows (default the script's V / VCAP): P4
    [u0, v0, img, u, v], P5 [u0, v0, count, img, u, v] (count int32 of
    shape (1,), default COUNT); img float32 [480, 640 * 8], u0 / v0 int32
    [rows] origins on a 16 / 8 grid, u, v int32 [rows, 512] within 16
    pixels of them."""
    rows = (P4_V if probe == "P4" else P5_VCAP) if rows is None else rows
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (IMG_H, IMG_W * CHANNELS)).astype(np.float32)
    u0 = (rng.integers(0, (IMG_W - PROBE_PW) // 16, rows) * 16).astype(np.int32)
    v0 = (rng.integers(0, (IMG_H - PROBE_PH) // 8, rows) * 8).astype(np.int32)
    u = (u0[:, None] + rng.integers(0, 16, (rows, 512))).astype(np.int32)
    v = (v0[:, None] + rng.integers(0, 16, (rows, 512))).astype(np.int32)
    if probe == "P4":
        return [u0, v0, img, u, v]
    cnt = np.full((1,), P5_COUNT if count is None else count, np.int32)
    return [u0, v0, cnt, img, u, v]


def rows_computed(count: int, rows: int) -> int:
    """The rows a Pallas grid of 16-row steps computes when it runs the
    steps whose first row lies below count."""
    return min(rows, -(-max(count, 0) // TILE_ROWS) * TILE_ROWS)


def bf16_splits(x: torch.Tensor, splits: int) -> torch.Tensor:
    """x through the probes' bf16 splits, summed in float32 in their
    order: hi = bf16(x), mid = bf16(x - hi), lo = bf16((x - hi) - mid);
    2 splits give hi + mid, 3 give (hi + mid) + lo."""
    hi = x.to(torch.bfloat16).float()
    r1 = x - hi
    mid = r1.to(torch.bfloat16).float()
    if splits == 2:
        return hi + mid
    return (hi + mid) + (r1 - mid).to(torch.bfloat16).float()


def _mode_pixels(u0, v0, u, v, probe: str, mode: str):
    """(vmask f32, lu_c, pixel column, pixel row) of each voxel as the
    mode reads them (the pixel clamped into the frame, which the probe's
    inputs never leave)."""
    _, col, row, _, _ = _SAMPLE_MODES[(probe, mode)]
    lu = u - u0[:, None]
    lv = v - v0[:, None]
    vmask = ((lu >= 0) & (lu < PROBE_PW) & (lv >= 0) & (lv < PROBE_PH)).float()
    lu_c, lv_c = lu.clamp(0, PROBE_PW - 1), lv.clamp(0, PROBE_PH - 1)
    pu = u0.long()[:, None] + (lu_c.long() if col == "lu" else 0)
    pv = v0.long()[:, None] + (lv_c.long() if row == "lv" else 0)
    return (vmask, lu_c, pu.clamp(0, IMG_W - 1).expand(u.shape),
            pv.clamp(0, IMG_H - 1).expand(u.shape))


def pixel_index(u0, v0, u, v, probe: str, mode: str):
    """The flat pixel (row of img.view(-1, 8)) each voxel reads, int64
    [rows, 512]; None for the modes that read no pixel."""
    if not _SAMPLE_MODES[(probe, mode)][3]:
        return None
    _, _, pu, pv = _mode_pixels(u0, v0, u, v, probe, mode)
    return pv * IMG_W + pu


def sample_modes_reference(probe: str, mode: str, u0, v0, img, u, v, count=None):
    """Plain version of the Pallas function probe.mode (MODES) on its
    pallas_call's inputs (u0, v0 int32 [V]; img float32 [480, 5120]; u, v
    int32 [V, 512]; P5's count int32 [1]) -> float32 [9, V, 512]: the 8
    channel planes and the valid plane (vmask) as the Pallas out_shape
    lays them out.  P5 computes the rows of rows_computed(count) (the
    others 0 here, unwritten by the kernel)."""
    kmode, _, _, splits, masked = _SAMPLE_MODES[(probe, mode)]
    vmask, lu_c, pu, pv = _mode_pixels(u0, v0, u, v, probe, mode)
    out = torch.empty((CHANNELS + 1, *u.shape), dtype=torch.float32, device=u.device)
    if splits:
        px = img.view(-1, CHANNELS)[pv * IMG_W + pu]  # [V, 512, 8]
        if splits > 1:
            px = bf16_splits(px, splits)
        out[:CHANNELS] = (px * vmask[..., None] if masked else px).permute(2, 0, 1)
    elif kmode == 0:
        c = torch.arange(CHANNELS, dtype=torch.float32, device=u.device)[:, None, None]
        out[:CHANNELS] = vmask[None] * c
    else:
        out[:CHANNELS] = lu_c.float()[None]
    out[CHANNELS] = vmask
    if count is not None:
        step = torch.arange(u.shape[0], device=u.device) // TILE_ROWS * TILE_ROWS
        out = torch.where((step < count.reshape(()).to(u.device))[None, :, None], out, 0.0)
    return out


def _check_modes(probe, mode, u0, v0, img, u, v, count) -> None:
    if (probe, mode) not in _SAMPLE_MODES:
        raise ValueError(f"sample_modes: no function {probe}.{mode}")
    rows = u.shape[0]
    want = [("u0", u0, (rows,), torch.int32), ("v0", v0, (rows,), torch.int32),
            ("img", img, (IMG_H, IMG_W * CHANNELS), torch.float32),
            ("u", u, (rows, 512), torch.int32), ("v", v, (rows, 512), torch.int32)]
    if probe == "P5":
        if count is None:
            raise ValueError("sample_modes: P5 takes its live count")
        want.append(("count", count, (1,), torch.int32))
    elif count is not None:
        raise ValueError("sample_modes: P4 runs every row and takes no count")
    for name, t, shape, dtype in want:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"sample_modes: {name} must be contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"sample_modes: {name} on {t.device}, u on {u.device}")
    if rows % TILE_ROWS:
        raise ValueError(f"sample_modes: {rows} rows, not a multiple of {TILE_ROWS} "
                         "(the Pallas grid's step)")


def sample_modes(probe: str, mode: str, u0, v0, img, u, v, count=None) -> torch.Tensor:
    """The Pallas function probe.mode (MODES) -> float32 [9, V, 512]; the
    arguments and layout of sample_modes_reference.  On CPU tensors the
    plain version; on CUDA tensors one launch of sample_modes_kernel
    (P5's rows past rows_computed(count) left unwritten), counted in
    sample_modes.launches."""
    _check_modes(probe, mode, u0, v0, img, u, v, count)
    if u.device.type == "cpu":
        return sample_modes_reference(probe, mode, u0, v0, img, u, v, count)
    if any(t.data_ptr() % 16 for t in (img, u, v)):
        raise ValueError("sample_modes: img, u and v must be 16-byte aligned")
    out = torch.empty((CHANNELS + 1, *u.shape), dtype=torch.float32, device=u.device)
    fn = build.entry(SOURCE, "dst_probe_sample_modes",
                     [_C.c_int, _P, _C.c_int, _C.c_int, _P, _P, _P, _P, _P, _C.c_int, _P, _P])
    with torch.cuda.device(u.device):
        err = fn(_SAMPLE_MODES[(probe, mode)][0], build.ptr(img), IMG_H, IMG_W, build.ptr(u),
                 build.ptr(v), build.ptr(u0), build.ptr(v0),
                 None if count is None else build.ptr(count), u.shape[0], build.ptr(out),
                 build.stream_of(u))
    sample_modes.launches += 1
    build.check(err, f"probe sample_modes {probe}.{mode}")
    return out


sample_modes.launches = 0


def modes_bytes(probe: str, mode: str, u0, v0, img, u, v, count=None) -> int:
    """The bytes the mode must move on these inputs, over the rows it
    computes: u and v, the origins (and P5's count) read once, the nine
    planes written once, and each distinct 32-byte pixel it reads once."""
    n = u.shape[0] if count is None else rows_computed(int(count.reshape(())), u.shape[0])
    nbytes = 8 * 512 * n + 8 * n + 36 * 512 * n + (0 if count is None else 4)
    pix = pixel_index(u0[:n], v0[:n], u[:n], v[:n], probe, mode)
    if pix is not None:
        nbytes += 32 * int(torch.unique(pix).numel())
    return nbytes


def run_modes(dev, timer) -> dict:
    """P4 and P5 on the card at the scripts' own rows and inputs: every
    function bit-equal to its plain version on the card over the rows it
    computes, each kernel mode timed once (timer(fn, kernel_name, nbytes)
    -> ms) beside its bytes; for P4's full and P5's mask_fold the plain
    version (CUDA events) and the library call, the one gather
    img.view(-1, 8).index_select of the pixels read (indices built
    outside the timed window; timer(fn, None, 0)).  Raises on any
    difference.  -> {probe: {"rows", "rows_computed", "functions": {mode:
    result}, "head", "plain_ms", "library_ms"}}."""
    from ...utils.timing import cuda_time_ms

    out = {}
    for probe, modes in MODES.items():
        t = [torch.from_numpy(a).to(dev) for a in probe_inputs(probe)]
        args = (t[0], t[1], t[3], t[4], t[5], t[2]) if probe == "P5" else tuple(t)
        rows = args[3].shape[0]
        n = rows if probe == "P4" else rows_computed(int(args[5]), rows)
        res, timed = {}, {}
        for mode in modes:
            got = sample_modes(probe, mode, *args)
            plain = sample_modes_reference(probe, mode, *args)
            r = {"kernel_mode": _SAMPLE_MODES[(probe, mode)][0],
                 "max_abs_err": _row_err(got, plain, n),
                 "bits_equal": bool(torch.equal(got[:, :n].view(torch.int32),
                                                plain[:, :n].view(torch.int32))),
                 "bytes": modes_bytes(probe, mode, *args)}
            if r["max_abs_err"] or not r["bits_equal"]:
                raise AssertionError(f"{probe} {mode}: differs from its plain version: {r}")
            if r["kernel_mode"] not in timed:
                timed[r["kernel_mode"]] = timer(lambda m=mode: sample_modes(probe, m, *args),
                                                "sample_modes_kernel", r["bytes"])
            r["ms"] = timed[r["kernel_mode"]]
            res[mode] = r
            del got, plain
        head = "full" if probe == "P4" else "mask_fold"
        pix = pixel_index(*args[:2], *args[3:5], probe, head)[:n].reshape(-1)
        px8 = args[2].view(-1, CHANNELS)
        out[probe] = {
            "rows": rows, "rows_computed": n, "head": head, "functions": res,
            "plain_ms": cuda_time_ms(lambda: sample_modes_reference(probe, head, *args)),
            "library_ms": timer(lambda: px8.index_select(0, pix), None, 0)}
        del t, args, pix
    return out
