"""Hopper probes of the splat z-buffer merge (K4).  Source:
csrc/splat_probe.cu, with the tile kernel it shares with splat_zbuf_blocks
(csrc/splat_zbuf_tile.cuh).

- P8 and P9, the TPU probes scripts/probe_splat2.py (run_v2, run_v2i,
  run_v3) and scripts/probe_splat2b.py (run in five modes): the Pallas
  z-buffer from given inputs, `splat_zbuf_given` (one fill launch, then,
  for a function that merges, one launch of splat_zbuf_given_kernel).  Each block b < n has a box
  origin (bu, bv) and 512 voxels with box-relative pixels lu, lv and a
  depth dq (BIG: dead); the Pallas kernels min-merge each voxel's 2x2
  footprint into a compact [16, 128] patch (run_v3: [16, 32]) and the
  patch into the padded HPAD x WPAD z-buffer through an aligned 24 x 256
  window at (u0a, v0a), rolled by (bv - v0a, bu - u0a) inside the window
  (circular) or, in `norollfull`, not rolled; `rmw`, `rowwrite` and
  `roll` merge nothing and give the BIG fill.  `pallas_inputs` restates
  each probe's numpy draws, `numpy_zbuf` the numpy z-buffer of
  probe_splat2.py's main, `splat_zbuf_given_reference` the function in
  torch; `run_given` holds every mode on the card to both.
- K4's own instruments, on splat_zbuf_blocks' block rows (block
  positions, pool indices, the tsdf pool, the pose and the camera),
  projecting in registers as K4 does:
  - `ab`: the z-buffer body before the tile (one global atomicMin per
    footprint pixel of every band voxel) against the tile kernel at
    splat_zbuf_blocks' 32x32 tile, on the rows it is given.  Both must
    equal the plain scatter-min.
  - `sweep`: the tile kernel built at 16x32, 32x32 and 64x64 pixels,
    each with the registers, local (spill) bytes and shared bytes the
    compiled kernel reports, whether it launches and agrees with the
    plain version on each case of rows, the rows on each branch, and its
    time.

`splat_zbuf_given` runs its plain version on CPU tensors and its kernel
on CUDA tensors; the K4 instruments need a CUDA device.  `run` and
`run_given` give the reports chip_smoke.py prints, with the timer they
are given.  The probe builds into a library of its own, so a fault in
its source leaves the kernels it probes loadable.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, splat_kernel

_C = ctypes
TILE_SHAPES = ((16, 32), (32, 32), (64, 64))
PRODUCTION_TILE = 1  # splat_rows.cu's 32x32
_ROWS_ARGTYPES = [_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p,
                  _C.c_void_p, _C.POINTER(_C.c_float), _C.POINTER(_C.c_float),
                  _C.c_int, _C.c_int, _C.c_void_p]


def _rows_args(block_pos, pool_idx, count, tsdf, geometry, zbuf):
    """(the rows' C arguments, the DevicePose to keep until the launch)."""
    cam = geometry["cam"]
    scalars, pose = splat_kernel.c_geometry(block_pos.device, **geometry)
    return (build.ptr(block_pos), build.ptr(pool_idx), build.ptr(count), block_pos.shape[0],
            tsdf.shape[0], build.ptr(tsdf), *scalars, cam.img_h, cam.img_w,
            build.ptr(zbuf)), pose


def _empty_zbuf(block_pos, geometry):
    cam = geometry["cam"]
    return torch.full((cam.img_h * cam.img_w,), splat_kernel.BIG, dtype=torch.int32,
                      device=block_pos.device)


def zbuf_atomic(block_pos, pool_idx, count, tsdf, **geometry) -> torch.Tensor:
    """The per-voxel-atomic z-buffer body (K4's A/B, its A side); the arguments of
    splat_kernel.splat_zbuf_blocks."""
    zbuf = _empty_zbuf(block_pos, geometry)
    fn = build.entry("splat_probe", "dst_probe_splat_zbuf_atomic",
                     [*_ROWS_ARGTYPES, _C.c_void_p])
    args, _pose = _rows_args(block_pos, pool_idx, count, tsdf, geometry, zbuf)
    with torch.cuda.device(block_pos.device):
        err = fn(*args, build.stream_of(block_pos))
    zbuf_atomic.launches += 1
    build.check(err, "probe zbuf_atomic")
    return zbuf


zbuf_atomic.launches = 0


def zbuf_tile(shape: int, block_pos, pool_idx, count, tsdf, branches=None,
              **geometry) -> torch.Tensor:
    """The tile kernel at TILE_SHAPES[shape] (K4's tile sweep); the arguments
    of splat_kernel.splat_zbuf_blocks."""
    zbuf = _empty_zbuf(block_pos, geometry)
    fn = build.entry("splat_probe", "dst_probe_splat_zbuf_tile",
                     [_C.c_int, *_ROWS_ARGTYPES, _C.c_void_p, _C.c_void_p])
    args, _pose = _rows_args(block_pos, pool_idx, count, tsdf, geometry, zbuf)
    with torch.cuda.device(block_pos.device):
        err = fn(shape, *args, None if branches is None else build.ptr(branches),
                 build.stream_of(block_pos))
    zbuf_tile.launches += 1
    build.check(err, f"probe zbuf_tile {TILE_SHAPES[shape]}")
    return zbuf


zbuf_tile.launches = 0


def tile_attributes(shape: int) -> dict:
    """What the compiled tile kernel at TILE_SHAPES[shape] uses."""
    out = (_C.c_int * 6)()
    fn = build.entry("splat_probe", "dst_probe_splat_tile_attributes",
                     [_C.c_int, _C.POINTER(_C.c_int)])
    build.check(fn(shape, out), "probe tile attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "max_threads": out[3], "tile": [out[4], out[5]]}


def _max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def ab(dev, timer, case) -> dict:
    """K4's A/B: the per-voxel-atomic body against the tile kernel at
    splat_zbuf_blocks' 32x32 tile on `case`, ((block_pos, pool_idx,
    count), (tsdf, ...), geometry keywords); both bit-equal to the plain
    scatter-min.  timer(fn, kernel_name) -> ms."""
    rows, pool, geometry = case
    args = (*rows, pool[0])
    ref = splat_kernel.splat_zbuf_blocks_reference(*args, **geometry)
    branches = torch.zeros(2, dtype=torch.int32, device=dev)
    tiled = zbuf_tile(PRODUCTION_TILE, *args, branches, **geometry)
    atomic = zbuf_atomic(*args, **geometry)
    torch.cuda.synchronize()
    cam = geometry["cam"]
    res = {"rows": rows[0].shape[0], "count": int(rows[2]), "image": [cam.img_h, cam.img_w],
           "max_abs_err": max(_max_err(atomic, ref), _max_err(tiled, ref)),
           "tile_branches": branches.tolist(),
           "atomic_ms": timer(lambda: zbuf_atomic(*args, **geometry),
                              "probe_zbuf_atomic_kernel"),
           "tile_ms": timer(lambda: zbuf_tile(PRODUCTION_TILE, *args, **geometry),
                            "splat_zbuf_tile_kernel")}
    if res["max_abs_err"]:
        raise AssertionError(f"K4's A/B: a z-buffer differs from the plain scatter-min: {res}")
    return res


def sweep(dev, timer, cases: dict) -> list:
    """K4's tile sweep: each tile shape's resources, launch, agreement and time on each
    case of rows ({name: case}, each case as for `ab`), with the rows on
    its tile and atomic branches; timer as for `ab`."""
    refs = {k: splat_kernel.splat_zbuf_blocks_reference(*rows, pool[0], **geometry)
            for k, (rows, pool, geometry) in cases.items()}
    out = []
    for i in range(len(TILE_SHAPES)):
        res = tile_attributes(i)
        for name, (rows, pool, geometry) in cases.items():
            args = (*rows, pool[0])
            branches = torch.zeros(2, dtype=torch.int32, device=dev)
            z = zbuf_tile(i, *args, branches, **geometry)
            torch.cuda.synchronize()
            res[name] = {"max_abs_err": _max_err(z, refs[name]), "branches": branches.tolist(),
                         "ms": timer(lambda a=args, g=geometry: zbuf_tile(i, *a, **g),
                                     "splat_zbuf_tile_kernel")}
            if res[name]["max_abs_err"]:
                raise AssertionError(f"K4's tile sweep: tile {TILE_SHAPES[i]} differs on {name}: "
                                     f"{res}")
        out.append(res)
    return out


def run(dev, timer, cases: dict) -> dict:
    """K4's instruments: the A/B on the first case of rows, the tile sweep
    on every case; timer(fn, kernel_name) -> ms times each kernel."""
    return {"k4_ab": ab(dev, timer, next(iter(cases.values()))),
            "k4_tiles": sweep(dev, timer, cases)}


# --- P8 / P9: the Pallas z-buffer from given inputs -------------------------

BIG = 1 << 30  # the probes' empty pixel and dead voxel
IMG_H, IMG_W = 480, 640  # the frame the probes draw their boxes in
HPAD, WPAD = 496, 768  # the padded z-buffer
WIN_H, WIN_W = 24, 256  # the aligned window a patch is merged through
PATCH_H = 16  # the compact patch's rows (CH)
PATCH_W = 32  # the kernel's shared patch columns (CW)
VOXELS = 512
BLOCKS_A_STEP = 8  # TB: the Pallas grid runs blocks in steps of 8
P8_S, P9_S = 12288, 64  # the scripts' block counts
# the Pallas functions, by probe, in the scripts' order
FUNCTIONS = {"P8": ("run_v2", "run_v2i", "run_v3"),
             "P9": ("rmw", "rowwrite", "roll", "norollfull", "full")}
# each function's kernel mode: 0 the fill alone (merges nothing), 1
# rolled through a [16, 128] patch, 2 rolled through a [16, 32] patch
# (run_v3's column loop), 3 placed unrolled at (u0a, v0a).  run_v2 reads
# scratch lanes it never writes; interpret mode gives run_v2i's z-buffer,
# and so does the port
KERNEL_MODES = {"run_v2": 1, "run_v2i": 1, "run_v3": 2, "rmw": 0, "rowwrite": 0, "roll": 0,
                "norollfull": 3, "full": 1}
# the functions whose z-buffer is probe_splat2.py main's numpy reference
NUMPY_EQUAL = ("run_v2", "run_v2i", "run_v3", "full")


def pallas_inputs(probe: str, s: int | None = None) -> list:
    """The arrays probe ("P8" or "P9") hands its pallas_call, drawn as
    its main draws them at s blocks (default the script's own):
    [bu, bv, n, lu, lv, dq] (int32; n of shape (1,))."""
    s = (P8_S if probe == "P8" else P9_S) if s is None else s
    rng = np.random.default_rng(0)
    if probe == "P8":
        bu = rng.integers(0, IMG_W - 16, s).astype(np.int32)
        bv = rng.integers(0, IMG_H - 16, s).astype(np.int32)
    else:
        bu = rng.integers(0, 600, s).astype(np.int32)
        bv = rng.integers(0, 460, s).astype(np.int32)
    lu = rng.integers(0, 13, (s, VOXELS)).astype(np.int32)
    lv = rng.integers(0, 13, (s, VOXELS)).astype(np.int32)
    dq = rng.integers(100, 2**20, (s, VOXELS)).astype(np.int32)
    if probe == "P8":  # ~128 live voxels a block
        dq = np.where(rng.uniform(size=(s, VOXELS)) < 0.75, BIG, dq)
    return [bu, bv, np.array(s, np.int32).reshape(1), lu, lv, dq]


def numpy_zbuf(bu, bv, lu, lv, dq) -> np.ndarray:
    """probe_splat2.py main's reference: each voxel's depth min-merged
    over its 2x2 footprint at (bu + lu, bv + lv) -> int64 [HPAD, WPAD]."""
    zref = np.full((HPAD, WPAD), BIG, np.int64)
    uu = (bu[:, None] + lu).reshape(-1)
    vv = (bv[:, None] + lv).reshape(-1)
    dd = dq.reshape(-1).astype(np.int64)
    for du in (0, 1):
        for dv in (0, 1):
            np.minimum.at(zref, (vv + dv, uu + du), dd)
    return zref


def footprint_scatter(bu, bv, n, lu, lv, dq, function: str):
    """The footprint pixels function merges: (flat z-buffer index int64
    [k], depth int32 [k]).  Blocks at or past n, dead voxels (dq >= BIG:
    min with the fill leaves BIG) and footprint pixels outside the patch
    (rows 16 and on, columns past its width) merge nothing; a rolled
    pixel wraps inside the window; one outside the z-buffer (a negative
    origin, where the Pallas window would leave it) is dropped."""
    mode = KERNEL_MODES[function]
    rolls, cols = mode != 3, 32 if mode == 2 else 128
    dev = lu.device
    if not mode:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    live = torch.arange(lu.shape[0], device=dev) < n.reshape(()).to(dev)
    bu64, bv64 = bu.long(), bv.long()
    u0a = torch.clamp(torch.div(bu64, 128, rounding_mode="floor") * 128, max=WPAD - WIN_W)
    v0a = torch.clamp(torch.div(bv64, 8, rounding_mode="floor") * 8, max=HPAD - WIN_H)
    rx, ry = (bu64 - u0a)[:, None], (bv64 - v0a)[:, None]
    base = live[:, None] & (dq < BIG)
    idx, val = [], []
    for du in (0, 1):
        for dv in (0, 1):
            r, c = lv.long() + dv, lu.long() + du
            keep = base & (r >= 0) & (r < PATCH_H) & (c >= 0) & (c < cols)
            y = v0a[:, None] + ((r + ry) % WIN_H if rolls else r)
            x = u0a[:, None] + ((c + rx) % WIN_W if rolls else c)
            keep &= (y >= 0) & (x >= 0)
            idx.append((y * WPAD + x)[keep])
            val.append(dq[keep])
    return torch.cat(idx), torch.cat(val)


def splat_zbuf_given_reference(bu, bv, n, lu, lv, dq, function: str) -> torch.Tensor:
    """Plain version of the Pallas function `function` (FUNCTIONS): the
    z-buffer int32 [HPAD, WPAD], BIG where nothing merged."""
    idx, val = footprint_scatter(bu, bv, n, lu, lv, dq, function)
    zbuf = torch.full((HPAD * WPAD,), BIG, dtype=torch.int32, device=lu.device)
    return zbuf.scatter_reduce_(0, idx, val, "amin").view(HPAD, WPAD)


def _check_given(bu, bv, n, lu, lv, dq) -> None:
    s = lu.shape[0]
    for name, t, shape in (("bu", bu, (s,)), ("bv", bv, (s,)), ("n", n, (1,)),
                           ("lu", lu, (s, VOXELS)), ("lv", lv, (s, VOXELS)),
                           ("dq", dq, (s, VOXELS))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"splat_zbuf_given: {name} must be contiguous int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != lu.device:
            raise ValueError(f"splat_zbuf_given: {name} on {t.device}, lu on {lu.device}")
    if s % BLOCKS_A_STEP:
        raise ValueError(f"splat_zbuf_given: {s} blocks, not a multiple of {BLOCKS_A_STEP} "
                         "(the Pallas grid's step)")


def splat_zbuf_given(bu, bv, n, lu, lv, dq, function: str) -> torch.Tensor:
    """The Pallas function `function` (FUNCTIONS) on its pallas_call's
    inputs (bu, bv int32 [S]; n int32 [1], read on the device; lu, lv, dq
    int32 [S, 512]; S a multiple of 8) -> int32 [HPAD, WPAD].  On CPU
    tensors the plain version; on CUDA tensors one fill launch and, for
    the functions that merge, one launch of splat_zbuf_given_kernel, each
    launch counted in splat_zbuf_given.launches."""
    _check_given(bu, bv, n, lu, lv, dq)
    if lu.device.type == "cpu":
        return splat_zbuf_given_reference(bu, bv, n, lu, lv, dq, function)
    if any(t.data_ptr() % 16 for t in (lu, lv, dq)):
        raise ValueError("splat_zbuf_given: lu, lv and dq must be 16-byte aligned")
    zbuf = torch.empty((HPAD, WPAD), dtype=torch.int32, device=lu.device)
    p = _C.c_void_p
    fn = build.entry("splat_probe", "dst_probe_splat_zbuf_given",
                     [_C.c_int, p, p, p, p, p, p, _C.c_int, p, p])
    mode = KERNEL_MODES[function]
    with torch.cuda.device(lu.device):
        err = fn(mode, build.ptr(bu), build.ptr(bv), build.ptr(n), build.ptr(lu), build.ptr(lv),
                 build.ptr(dq), lu.shape[0], build.ptr(zbuf), build.stream_of(lu))
    splat_zbuf_given.launches += 1 + (mode != 0 and lu.shape[0] > 0)  # the fill, the merge
    build.check(err, f"probe splat_zbuf_given {function}")
    return zbuf


splat_zbuf_given.launches = 0


def given_bytes(lu) -> int:
    """The bytes a merging function must move: bu, bv, n, lu, lv, dq read
    once, the z-buffer written once."""
    s = lu.shape[0]
    return 4 * (2 * s + 1 + 3 * s * VOXELS + HPAD * WPAD)


def run_given(dev, timer) -> dict:
    """P8 and P9 on the card at the scripts' own block counts and inputs:
    every function bit-equal to its plain version on the card, those of
    NUMPY_EQUAL equal to main's numpy z-buffer, rmw / rowwrite / roll the
    BIG fill; each kernel mode timed once (timer(fn, kernel_name, nbytes)
    -> ms); the plain version of the
    headline function (run_v2i, full) by CUDA events and its library
    call, one scatter_reduce "amin" of its footprint pixels into a BIG
    z-buffer, indices built outside the timed window (timer(fn, None,
    0)).  Raises on any difference.  -> {probe: {"blocks", "bytes",
    "numpy_zbuf_set", "functions": {function: result}, ...}}."""
    from ...utils.timing import cuda_time_ms

    out = {}
    for probe, functions in FUNCTIONS.items():
        arrays = pallas_inputs(probe)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        zref = numpy_zbuf(arrays[0], arrays[1], arrays[3], arrays[4], arrays[5])
        zref = torch.from_numpy(zref.astype(np.int32)).to(dev)
        fill = torch.full((HPAD, WPAD), BIG, dtype=torch.int32, device=dev)
        nbytes = given_bytes(t[3])
        res, timed = {}, {}
        for function in functions:
            got = splat_zbuf_given(*t, function)
            plain = splat_zbuf_given_reference(*t, function)
            mode = KERNEL_MODES[function]
            r = {"kernel_mode": mode, "max_abs_err": _max_err(got, plain),
                 "pixels_set": int((got != BIG).sum())}
            want = zref if function in NUMPY_EQUAL else None if mode else fill
            if want is not None:
                r["numpy_err"] = _max_err(got, want)
            if r["max_abs_err"] or r.get("numpy_err"):
                raise AssertionError(f"{probe} {function}: the z-buffer differs from its plain "
                                     f"version or main's numpy reference: {r}")
            if mode not in timed:
                timed[mode] = timer(lambda f=function: splat_zbuf_given(*t, f), "zbuf_given",
                                    nbytes if mode else 4 * HPAD * WPAD)
            r["ms"] = timed[mode]
            res[function] = r
        head = "run_v2i" if probe == "P8" else "full"
        idx, val = footprint_scatter(*t, head)
        base = torch.full((HPAD * WPAD,), BIG, dtype=torch.int32, device=dev)
        if not torch.equal(base.scatter_reduce(0, idx, val, "amin").view(HPAD, WPAD), zref):
            raise AssertionError(f"{probe}: the library call computes another z-buffer")
        entry = {"blocks": t[3].shape[0], "bytes": nbytes, "head": head,
                 "numpy_zbuf_set": int((zref != BIG).sum()), "footprint_pixels": idx.numel(),
                 "functions": res,
                 "plain_ms": cuda_time_ms(lambda: splat_zbuf_given_reference(*t, head)),
                 "library_ms": timer(lambda: base.scatter_reduce(0, idx, val, "amin"), None, 0)}
        out[probe] = entry
        del t, zref, fill, idx, val, base
    return out
