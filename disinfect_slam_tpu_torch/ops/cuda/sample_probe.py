"""Hopper probes of the frame sampler (K1) and of fuse_rows' stages (K2),
the counterparts of the TPU probes P1-P6 (scripts/probe_sample2.py,
probe_sample3.py, probe_sample4.py, probe_sample_overhead.py,
probe_kernel_stages.py, probe_mxu_shapes.py).  Source:
csrc/sample_probe.cu, with fuse_rows' body from csrc/fuse_rows.cuh.

- P4, `direct`: K1's body, its pixel loads alone (one word written a
  voxel) and its writes alone.
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
- P5, `fuse_stages`: fuse_rows stripped to the ring of pool rows, then
  with the projection, then with the sampling; each reduces min |tsdf|
  over the voxels its stages let through and writes their pool words back
  unchanged (the bytes of the fusion without its arithmetic).  The fusion
  is fuse_rows.

Every mode is held against its plain torch version (`*_reference`), its
largest difference from it reported (`max_abs_err`, 0 or it raises), and
timed with the timer it is given, timer(fn, kernel_name, nbytes), nbytes
being the bytes its bound counts; `run` gives chip_smoke.py's report.
`sample_patch` runs its plain version on CPU tensors and its kernel on
CUDA tensors; the other probe kernels take CUDA tensors only.  Each
wrapper counts its launches in its `launches` attribute.
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
