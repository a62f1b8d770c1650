"""Hopper probes of the splat z-buffer merge (K4), the counterparts of the
TPU probes P8 (scripts/probe_splat2.py) and P9 (scripts/probe_splat2b.py).
Sources: csrc/splat_probe.cu and the tile kernel it shares with
splat_zbuf_blocks (csrc/splat_zbuf_tile.cuh).  Both probes take
splat_zbuf_blocks' block rows (block positions, pool indices, the tsdf
pool, the pose and the camera) and project in registers, as K4 does.

- P8, `ab`: the z-buffer body before the tile (one global atomicMin per
  footprint pixel of every band voxel) against the tile kernel at
  splat_zbuf_blocks' 32x32 tile, on the rows it is given.  Both must equal
  the plain scatter-min.
- P9, `sweep`: the tile kernel built at 16x32, 32x32 and 64x64 pixels,
  each with the registers, local (spill) bytes and shared bytes the
  compiled kernel reports, whether it launches and agrees with the plain
  version on each case of rows, the rows on each branch, and its time.

Both need a CUDA device; `run` gives the report chip_smoke.py prints, with
the timer it is given.  The probe builds into a library of its own, so
a fault in its source leaves the kernels it probes loadable.
"""

from __future__ import annotations

import ctypes

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
    """The per-voxel-atomic z-buffer body (P8's A side); the arguments of
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
    """The tile kernel at TILE_SHAPES[shape] (P9's sweep); the arguments
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
    """P8: the per-voxel-atomic body against the tile kernel at
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
        raise AssertionError(f"P8: a z-buffer differs from the plain scatter-min: {res}")
    return res


def sweep(dev, timer, cases: dict) -> list:
    """P9: each tile shape's resources, launch, agreement and time on each
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
                raise AssertionError(f"P9: tile {TILE_SHAPES[i]} differs on {name}: {res}")
        out.append(res)
    return out


def run(dev, timer, cases: dict) -> dict:
    """Both probes: P8 on the first case of rows, P9 on every case;
    timer(fn, kernel_name) -> ms times each kernel."""
    return {"p8": ab(dev, timer, next(iter(cases.values()))), "p9": sweep(dev, timer, cases)}
