"""Hopper feature probe, the counterpart of the TPU probe
scripts/probe_mosaic_features.py (P7): each primitive the port's kernels
rely on, compiled for sm_90a (csrc/feature_probe.cu) and checked on a tiny
input against numpy or torch on the card.  Each check reports its largest
difference from what it is held against (`max_abs_err`); `run` raises
AssertionError naming every check that failed; it needs a CUDA device.
`launch` counts the probe kernels it launches in `launch.launches`.

  python -c "import torch; from disinfect_slam_tpu_torch.ops.cuda import \\
      feature_probe; print(feature_probe.run(torch.device('cuda')))"
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

_C = ctypes
_P = _C.c_void_p
SOURCE = "feature_probe"


def launch(name: str, argtypes: list, *args, stream) -> None:
    """Launch the probe kernel of entry `name` on `stream`."""
    err = build.entry(SOURCE, name, argtypes)(*args, stream)
    launch.launches += 1
    build.check(err, f"probe {name}")


launch.launches = 0


def _err(*pairs) -> float:
    """Largest |a - b| over pairs of numpy arrays, as float64; equal
    entries (infinities too) count 0."""
    err = 0.0
    for a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d = np.where(a == b, 0.0, np.abs(a - b))
        err = max(err, float(d.max()) if d.size else 0.0)
    return err


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def rotate(dev, rng) -> dict:
    """P7's roll_lanes: a lane rotate by a runtime shift, __shfl_sync."""
    x = rng.standard_normal(32 * 8).astype(np.float32)
    out = torch.empty(x.size, dtype=torch.float32, device=dev)
    xd = _t(x, dev)
    launch("dst_probe_rotate", [_P, _C.c_int, _C.c_int, _P, _P], build.ptr(xd), 8, 13,
           build.ptr(out), stream=build.stream_of(xd))
    want = np.roll(x.reshape(8, 32), 13, axis=1).reshape(-1)
    err = _err((out.cpu().numpy(), want))
    return {"ok": err == 0, "max_abs_err": err}


def address(dev, rng) -> dict:
    """P7's roll_sublanes, take_along_lanes, reshapes, strided slice and
    reshape-and-sum as shared-memory address arithmetic (integer-valued
    words: the sums are exact in any order)."""
    rows, cols = 64, 128
    x = rng.integers(-1000, 1000, (rows, cols)).astype(np.float32)
    idx = rng.integers(0, cols, (rows, cols)).astype(np.int32)
    out = torch.empty(3 * rows * cols + 2 * rows * cols // 8, dtype=torch.float32, device=dev)
    xd, idd = _t(x, dev), _t(idx, dev)
    launch("dst_probe_address", [_P, _P, _C.c_int, _P, _P], build.ptr(xd), build.ptr(idd), 5,
           build.ptr(out), stream=build.stream_of(xd))
    o = out.cpu().numpy()
    n = rows * cols
    parts = {
        "roll_rows": (o[:n], np.roll(x, 5, axis=0).reshape(-1)),
        "take_along": (o[n:2 * n], np.take_along_axis(x, idx, axis=1).reshape(-1)),
        "reshape": (o[2 * n:3 * n], x.reshape(n // 8, 8).reshape(-1)),
        "strided": (o[3 * n:3 * n + n // 8], x[:, ::8].reshape(-1)),
        "reshape_sum": (o[3 * n + n // 8:], x.reshape(rows, cols // 8, 8).sum(2).reshape(-1)),
    }
    res = {k: bool(np.array_equal(a, b)) for k, (a, b) in parts.items()}
    return {"ok": all(res.values()), "max_abs_err": _err(*parts.values()), **res}


def dot(dev, rng) -> dict:
    """P7's f32_dot: a float32 dot with no multiply-add contracted (the
    sources build with -fmad=false) equals numpy's float32 loop of
    separate roundings bit for bit; the same dot by fmaf stays within
    1e-5 of the float64 product and differs from it somewhere."""
    m, k, n = 32, 256, 32
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    out = torch.empty(2 * m * n, dtype=torch.float32, device=dev)
    ad, bd = _t(a, dev), _t(b, dev)
    launch("dst_probe_dot", [_P, _P, _C.c_int, _C.c_int, _C.c_int, _P, _P], build.ptr(ad),
           build.ptr(bd), m, k, n, build.ptr(out), stream=build.stream_of(ad))
    plain, fused = out.cpu().numpy().reshape(2, m, n)
    want = np.zeros((m, n), np.float32)
    for j in range(k):
        want = want + a[:, j:j + 1] * b[j:j + 1, :]
    exact = a.astype(np.float64) @ b.astype(np.float64)
    differ = int((plain != fused).sum())
    res = {"plain_equal_numpy": bool(np.array_equal(plain, want)),
           "max_abs_err": _err((plain, want)),
           "fma_max_abs_err": float(np.abs(fused - exact).max()),
           "fma_differs_from_plain": differ}
    res["ok"] = res["plain_equal_numpy"] and res["fma_max_abs_err"] <= 1e-5 and differ > 0
    return res


def reduce(dev, rng) -> dict:
    """__reduce_min_sync / __reduce_max_sync on int and unsigned words."""
    warps = 16
    x = rng.integers(-(1 << 31), 1 << 31, 32 * warps, dtype=np.int64).astype(np.int32)
    out = torch.empty(4 * warps, dtype=torch.int32, device=dev)
    xd = _t(x, dev)
    launch("dst_probe_reduce", [_P, _C.c_int, _P, _P], build.ptr(xd), warps, build.ptr(out),
           stream=build.stream_of(xd))
    o = out.cpu().numpy().reshape(4, warps)
    w, u = x.reshape(warps, 32), x.reshape(warps, 32).view(np.uint32)
    pairs = ((o[0], w.min(1)), (o[1], w.max(1)), (o[2].view(np.uint32), u.min(1)),
             (o[3].view(np.uint32), u.max(1)))
    res = {"int": bool(np.array_equal(*pairs[0]) and np.array_equal(*pairs[1])),
           "unsigned": bool(np.array_equal(*pairs[2]) and np.array_equal(*pairs[3]))}
    return {"ok": all(res.values()), "max_abs_err": _err(*pairs), **res}


def atomics(dev, rng) -> dict:
    """Shared and global atomicMin / atomicMax on int and on unsigned
    words, half of them with the top bit set, many to a slot."""
    n, slots = 8192, 64
    vals = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    slot = rng.integers(0, slots, n).astype(np.int32)
    init = np.array([0, 0, 0, 0, np.iinfo(np.int32).max, np.iinfo(np.int32).min, -1, 0],
                    np.int32)
    out = _t(np.repeat(init, slots), dev)
    vd, sd = _t(vals, dev), _t(slot, dev)
    launch("dst_probe_atomics", [_P, _P, _C.c_int, _C.c_int, _P, _P], build.ptr(vd),
           build.ptr(sd), n, slots, build.ptr(out), stream=build.stream_of(vd))
    o = out.cpu().numpy().reshape(8, slots)
    want = np.zeros((4, slots), np.int64)
    for s in range(slots):
        v = vals[slot == s]
        want[:, s] = (v.min(), v.max(), v.view(np.uint32).min(), v.view(np.uint32).max())
    got = o.astype(np.int64)
    got[[2, 3, 6, 7]] &= 0xFFFFFFFF
    res = {"shared": bool(np.array_equal(got[:4], want)),
           "global": bool(np.array_equal(got[4:], want))}
    return {"ok": all(res.values()), "max_abs_err": _err((got[:4], want), (got[4:], want)),
            **res}


def bulk_copy(dev, rng) -> dict:
    """Four 2 KB cp.async.bulk copies into shared memory, completing on
    one mbarrier phase, read back intact."""
    x = rng.standard_normal(4 * 512).astype(np.float32)
    xd = _t(x, dev)
    out = torch.empty_like(xd)
    launch("dst_probe_bulk_copy", [_P, _C.c_int, _P, _P], build.ptr(xd), 4, build.ptr(out),
           stream=build.stream_of(xd))
    err = _err((out.cpu().numpy(), x))
    return {"ok": err == 0, "max_abs_err": err}


def float2int(dev, rng) -> dict:
    """__float2int_rz saturates +-inf and large values, takes NaN to 0 and
    truncates toward zero, as torch's .to(torch.int32) converts on the
    card."""
    x = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.5, -2.5, -0.5, 0.0, 7.99],
                 np.float32)
    want = np.array([2**31 - 1, -2**31, 0, 2**31 - 1, -2**31, 2, -2, 0, 0, 7], np.int32)
    xd = _t(x, dev)
    out = torch.empty(x.size, dtype=torch.int32, device=dev)
    launch("dst_probe_float2int", [_P, _C.c_int, _P, _P], build.ptr(xd), x.size,
           build.ptr(out), stream=build.stream_of(xd))
    o = out.cpu().numpy()
    torch_o = xd.to(torch.int32).cpu().numpy()
    res = {"expected": bool(np.array_equal(o, want)),
           "as_torch_on_the_card": bool(np.array_equal(o, torch_o))}
    return {"ok": all(res.values()), "max_abs_err": _err((o, want), (o, torch_o)), **res}


def sqrt(dev, rng) -> dict:
    """A double sqrt rounded to float equals __fsqrt_rn (and torch's
    float64 root rounded to float32 on the card) over magnitudes from
    denormals to 1e30."""
    x = np.concatenate([10.0 ** rng.uniform(-40, 30, 4096),
                        [0.0, 1.0, 2.0, 1e-45]]).astype(np.float32)
    xd = _t(x, dev)
    out = torch.empty(2 * x.size, dtype=torch.float32, device=dev)
    launch("dst_probe_sqrt", [_P, _C.c_int, _P, _P], build.ptr(xd), x.size, build.ptr(out),
           stream=build.stream_of(xd))
    via_double, fsqrt = out.view(2, -1)
    torch_o = torch.sqrt(xd.double()).float()
    res = {"double_equals_fsqrt_rn": bool(torch.equal(via_double, fsqrt)),
           "as_torch_on_the_card": bool(torch.equal(via_double, torch_o))}
    v, f, t = (a.cpu().numpy() for a in (via_double, fsqrt, torch_o))
    return {"ok": all(res.values()), "max_abs_err": _err((v, f), (v, t)), **res}


CHECKS = (rotate, address, dot, reduce, atomics, bulk_copy, float2int, sqrt)


def timed_pair(dev):
    """(kernels, plain, nbytes): closures over fixed inputs on `dev` that
    launch every probe kernel once, and that compute the same outputs
    with torch ops on the card (its plain version), for timing the two;
    and the bytes the kernels read and write, each once."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal(8192).astype(np.float32), dev)
    idx = _t(rng.integers(0, 128, 8192).astype(np.int32), dev)
    a = _t(rng.uniform(-1, 1, (32, 256)).astype(np.float32), dev)
    b = _t(rng.uniform(-1, 1, (256, 32)).astype(np.float32), dev)
    iv = _t(rng.integers(-(1 << 31), 1 << 31, 8192, dtype=np.int64).astype(np.int32), dev)
    slot = _t(rng.integers(0, 64, 8192).astype(np.int32), dev)
    f = _t(np.abs(rng.standard_normal(4096)).astype(np.float32), dev)
    out = torch.empty(4 * 8192, dtype=torch.float32, device=dev)
    iout = torch.empty(8192, dtype=torch.int32, device=dev)
    st = build.stream_of(x)
    entries = (
        ("dst_probe_rotate", [_P, _C.c_int, _C.c_int, _P, _P],
         (build.ptr(x), 256, 13, build.ptr(out))),
        ("dst_probe_address", [_P, _P, _C.c_int, _P, _P],
         (build.ptr(x), build.ptr(idx), 5, build.ptr(out))),
        ("dst_probe_dot", [_P, _P, _C.c_int, _C.c_int, _C.c_int, _P, _P],
         (build.ptr(a), build.ptr(b), 32, 256, 32, build.ptr(out))),
        ("dst_probe_reduce", [_P, _C.c_int, _P, _P], (build.ptr(iv), 256, build.ptr(iout))),
        ("dst_probe_atomics", [_P, _P, _C.c_int, _C.c_int, _P, _P],
         (build.ptr(iv), build.ptr(slot), 8192, 64, build.ptr(iout))),
        ("dst_probe_bulk_copy", [_P, _C.c_int, _P, _P], (build.ptr(x), 4, build.ptr(out))),
        ("dst_probe_float2int", [_P, _C.c_int, _P, _P],
         (build.ptr(f), 4096, build.ptr(iout))),
        ("dst_probe_sqrt", [_P, _C.c_int, _P, _P], (build.ptr(f), 4096, build.ptr(out))),
    )

    words = (2 * 8192 + (2 * 8192 + 3 * 8192 + 2 * 1024) + (2 * 32 * 256 + 2 * 32 * 32)
             + (8192 + 4 * 256) + (2 * 8192 + 8 * 64) + 2 * 2048 + 2 * 4096 + 3 * 4096)

    def kernels():
        for name, argtypes, args in entries:
            launch(name, argtypes, *args, stream=st)

    def plain():
        x2 = x.view(64, 128)
        u = iv.long() & 0xFFFFFFFF
        big = torch.full((64,), 1 << 40, dtype=torch.int64, device=dev)
        return (torch.roll(x.view(-1, 32), 13, 1), torch.roll(x2, 5, 0),
                torch.gather(x2, 1, idx.view(64, 128).long()), x2.reshape(1024, 8).clone(),
                x2[:, ::8].clone(), x2.view(64, 16, 8).sum(2), a @ b,
                iv.view(-1, 32).amin(1), iv.view(-1, 32).amax(1),
                u.view(-1, 32).amin(1), u.view(-1, 32).amax(1),
                big.scatter_reduce(0, slot.long(), iv.long(), "amin"),
                (-big).scatter_reduce(0, slot.long(), iv.long(), "amax"),
                big.scatter_reduce(0, slot.long(), u, "amin"),
                torch.zeros_like(big).scatter_reduce(0, slot.long(), u, "amax"),
                x[:2048].clone(), f.to(torch.int32), torch.sqrt(f.double()).float())

    return kernels, plain, 4 * words


def run(dev) -> dict:
    """Every check -> {name: result}; raises if any failed."""
    rng = np.random.default_rng(0)
    with torch.cuda.device(dev):
        res = {fn.__name__: fn(dev, rng) for fn in CHECKS}
    torch.cuda.synchronize(dev)
    failed = [k for k, v in res.items() if not v["ok"]]
    if failed:
        raise AssertionError(f"feature probe: {failed} failed: {res}")
    return res
