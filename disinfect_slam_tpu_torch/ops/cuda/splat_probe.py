"""Hopper probes of the splat z-buffer merge (K4), the counterparts of the
TPU probes P8 (scripts/probe_splat2.py) and P9 (scripts/probe_splat2b.py).
Sources: csrc/splat_probe.cu and the tile kernel it shares with
splat_zbuf_rows (csrc/splat_zbuf_tile.cuh).

- P8, `ab`: the z-buffer body before the tile (one global atomicMin per
  footprint pixel of every band voxel) against splat_zbuf_rows' tile
  kernel, at P8's shapes: S = 12288 surface blocks, 640x480, each block's
  voxels within a 14x14-pixel footprint box, a quarter of them in the
  band, depths from [100, 2^20).  Both must equal the plain scatter-min.
- P9, `sweep`: the tile kernel built at 16x32, 32x32 and 64x64 pixels,
  each with the registers, local (spill) bytes and shared bytes the
  compiled kernel reports, whether it launches and agrees with the plain
  version on P8's rows (and on rows whose footprints outgrow the two
  smaller tiles), the rows on each branch, and its time.

Both need a CUDA device; `run` gives the report chip_smoke.py prints, with
the timer it is given.  The probe builds into a library of its own, so
a fault in its source leaves the kernels it probes loadable.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, splat_kernel

_C = ctypes
TILE_SHAPES = ((16, 32), (32, 32), (64, 64))
P8_ROWS, P8_H, P8_W = 12288, 480, 640


def p8_rows(dev, seed: int = 0, spread: int = 13):
    """P8's inputs (probe_splat2.py:198-207): floor pixels bu + lu with lu
    in [0, spread), so footprints fit a (spread + 1)-pixel box; 75% of
    voxels outside the band.  -> (u0, v0, dq, count) on `dev`."""
    rng = np.random.default_rng(seed)
    s = P8_ROWS
    bu = rng.integers(0, P8_W - 16, (s, 1))
    bv = rng.integers(0, P8_H - 16, (s, 1))
    u0 = bu + rng.integers(0, spread, (s, 512))
    v0 = bv + rng.integers(0, spread, (s, 512))
    dq = rng.integers(100, 2**20, (s, 512))
    dq[rng.uniform(size=(s, 512)) < 0.75] = splat_kernel.BIG
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    return t(u0), t(v0), t(dq), torch.tensor(s, dtype=torch.int32, device=dev)


def zbuf_atomic(u0, v0, dq, count, img_h: int, img_w: int) -> torch.Tensor:
    """The per-voxel-atomic z-buffer body (P8's A side)."""
    zbuf = torch.full((img_h * img_w,), splat_kernel.BIG, dtype=torch.int32,
                      device=u0.device)
    fn = build.entry("splat_probe", "dst_probe_splat_zbuf_atomic", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int,
        _C.c_int, _C.c_void_p, _C.c_void_p])
    with torch.cuda.device(u0.device):
        err = fn(build.ptr(u0), build.ptr(v0), build.ptr(dq), build.ptr(count),
                 u0.shape[0], img_h, img_w, build.ptr(zbuf), build.stream_of(u0))
    build.check(err, "probe zbuf_atomic")
    return zbuf


def zbuf_tile(shape: int, u0, v0, dq, count, img_h: int, img_w: int, branches=None):
    """The tile kernel at TILE_SHAPES[shape] (P9's sweep)."""
    zbuf = torch.full((img_h * img_w,), splat_kernel.BIG, dtype=torch.int32,
                      device=u0.device)
    fn = build.entry("splat_probe", "dst_probe_splat_zbuf_tile", [
        _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
        _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p])
    with torch.cuda.device(u0.device):
        err = fn(shape, build.ptr(u0), build.ptr(v0), build.ptr(dq), build.ptr(count),
                 u0.shape[0], img_h, img_w, build.ptr(zbuf),
                 None if branches is None else build.ptr(branches), build.stream_of(u0))
    build.check(err, f"probe zbuf_tile {TILE_SHAPES[shape]}")
    return zbuf


def tile_attributes(shape: int) -> dict:
    """What the compiled tile kernel at TILE_SHAPES[shape] uses."""
    out = (_C.c_int * 6)()
    fn = build.entry("splat_probe", "dst_probe_splat_tile_attributes",
                     [_C.c_int, _C.POINTER(_C.c_int)])
    build.check(fn(shape, out), "probe tile attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "max_threads": out[3], "tile": [out[4], out[5]]}


def ab(dev, timer) -> dict:
    """P8: the per-voxel-atomic body against splat_zbuf_rows' tile kernel
    on P8's rows; both bit-equal to the plain scatter-min.  timer(fn,
    kernel_name) -> ms."""
    u0, v0, dq, count = p8_rows(dev)
    ref = splat_kernel.splat_zbuf_rows_reference(u0, v0, dq, count, P8_H, P8_W)
    branches = torch.zeros(2, dtype=torch.int32, device=dev)
    tiled = splat_kernel.splat_zbuf_rows(u0, v0, dq, count, P8_H, P8_W, branches)
    atomic = zbuf_atomic(u0, v0, dq, count, P8_H, P8_W)
    torch.cuda.synchronize()
    res = {"rows": P8_ROWS, "image": [P8_H, P8_W],
           "atomic_equal": torch.equal(atomic, ref), "tile_equal": torch.equal(tiled, ref),
           "tile_branches": branches.tolist(),
           "atomic_ms": timer(lambda: zbuf_atomic(u0, v0, dq, count, P8_H, P8_W),
                              "probe_zbuf_atomic_kernel"),
           "tile_ms": timer(lambda: splat_kernel.splat_zbuf_rows(
               u0, v0, dq, count, P8_H, P8_W), "splat_zbuf_tile_kernel")}
    if not (res["atomic_equal"] and res["tile_equal"]):
        raise AssertionError(f"P8: a z-buffer differs from the plain scatter-min: {res}")
    return res


def sweep(dev, timer) -> list:
    """P9: each tile shape's resources, launch, agreement and time on
    P8's rows (all on the tile branch) and on rows with footprints of up
    to 40 pixels (the smaller tiles send some to the atomic branch);
    timer as for `ab`."""
    cases = {"p8": p8_rows(dev), "wide": p8_rows(dev, seed=1, spread=39)}
    refs = {k: splat_kernel.splat_zbuf_rows_reference(*c, P8_H, P8_W)
            for k, c in cases.items()}
    out = []
    for i in range(len(TILE_SHAPES)):
        res = tile_attributes(i)
        for name, c in cases.items():
            branches = torch.zeros(2, dtype=torch.int32, device=dev)
            z = zbuf_tile(i, *c, P8_H, P8_W, branches)
            torch.cuda.synchronize()
            res[name] = {"equal": torch.equal(z, refs[name]), "branches": branches.tolist(),
                         "ms": timer(lambda c=c: zbuf_tile(i, *c, P8_H, P8_W),
                                     "splat_zbuf_tile_kernel")}
            if not res[name]["equal"]:
                raise AssertionError(f"P9: tile {TILE_SHAPES[i]} differs on {name}: {res}")
        out.append(res)
    return out


def run(dev, timer) -> dict:
    """Both probes; timer(fn, kernel_name) -> ms times each kernel."""
    return {"p8": ab(dev, timer), "p9": sweep(dev, timer)}
