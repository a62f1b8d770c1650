"""Hopper feature probe, the counterpart of the TPU probe
scripts/probe_mosaic_features.py (P7), as one launch of
`feature_probe_kernel` (csrc/feature_probe.cu).

The launch computes, each as a role of its own CTAs of one grid:
  - the Pallas probe's eight functions at its shapes, on its inputs
    (`pallas_inputs`: its numpy generators, restated; the shifts 37 and 5
    are kernel arguments, as the probe's prefetched scalars are):
    roll_lanes, roll_sublanes, take_along_lanes, f32_dot (256^3, as the
    plain sum s = s + a b in ascending j, which -fmad=false and the
    kernel's __fadd_rn / __fmul_rn keep bit-equal to the sequential
    float32 loop, and as the same sum by fmaf), reshape_2d_split,
    reshape_2d_merge, strided_lane_slice, cast_2d_3d;
  - the port's own primitive checks (`own_inputs`): __reduce_min_sync /
    __reduce_max_sync on int and unsigned words, shared and global
    atomicMin / atomicMax on int and unsigned words (the global role
    spans several CTAs), four cp.async.bulk copies on one mbarrier phase,
    __float2int_rz on +-inf, NaN and large values, and a double sqrt
    rounded to float beside __fsqrt_rn.
Every input is packed into one int32 word buffer and every output into a
second, at the offsets of `LAYOUT`; `ROLES` fixes each role's CTAs.
`feature_probe_reference` computes the same outputs in the same layout
with torch ops on any device.  `run(dev)` holds the launch bit for bit to
the plain version on the card, the fmaf rows included (`fma32` rounds
once, as fmaf does), and every output to numpy's expectations; on the
CPU it runs the plain version only.

  python -c "import torch; from disinfect_slam_tpu_torch.ops.cuda import \\
      feature_probe; print(feature_probe.run(torch.device('cuda')))"
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import build

SOURCE = "feature_probe"
LANE_SHIFT, ROW_SHIFT = 37, 5  # the Pallas probe's roll_lanes / roll_sublanes shifts
N = 256  # take_along_lanes' and f32_dot's width
SLOTS, VALUES = 64, 8192  # the atomics' slots and values
LINE = 32  # words of a 128-byte line: the global merges keep each slot on one of its own
BULK_CHUNKS, BULK_WORDS = 4, 512  # four 2 KB copies
F2I = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.5, -2.5, -0.5, 0.0, 7.99], np.float32)
INT_MIN, INT_MAX = -2**31, 2**31 - 1

# The Pallas probe's functions, in its order (scripts/probe_mosaic_features.py)
PALLAS = ("roll_lanes", "roll_sublanes", "take_along_lanes", "f32_dot", "reshape_2d_split",
          "reshape_2d_merge", "strided_lane_slice", "cast_2d_3d")
# Each role and its CTAs, in the grid's order (the dot first, so that its
# CTAs land on distinct SMs); the same order as csrc/feature_probe.cu's Role
ROLES = (("f32_dot", 128), ("take_along_lanes", 16), ("atomics_global", 32), ("roll_lanes", 1),
         ("roll_sublanes", 1), ("reshape_2d_split", 1), ("reshape_2d_merge", 1),
         ("strided_lane_slice", 1), ("cast_2d_3d", 1), ("reduce", 1), ("atomics_shared", 4),
         ("bulk_copy", 1), ("float2int", 1), ("sqrt", 5))
CHECKS = tuple(name for name, _ in ROLES)
GRID = sum(c for _, c in ROLES)

_F, _I = torch.float32, torch.int32
# (name, shape, dtype) of the packed inputs and outputs, in the order of
# csrc/feature_probe.cu's In and Out
_IN = (("roll_lanes.x", (8, 256), _F), ("roll_sublanes.x", (64, 128), _F),
       ("take_along_lanes.x", (N, N), _F), ("take_along_lanes.idx", (N, N), _I),
       ("f32_dot.a", (N, N), _F), ("f32_dot.b", (N, N), _F),
       ("reshape_2d_split.x", (24, 256), _F), ("reshape_2d_merge.x", (512, 16), _F),
       ("strided_lane_slice.x", (8, 256), _F), ("cast_2d_3d.x", (8, 256), _F),
       ("reduce.x", (16, 32), _I), ("atomics.vals", (VALUES,), _I),
       ("atomics.slots", (VALUES,), _I),
       # int min, int max, unsigned min, unsigned max: the global role's
       # initial values, each slot's the first word of its line, which it
       # merges into in place (merging the same values again leaves them
       # unchanged)
       ("atomics_global.init", (4, SLOTS, LINE), _I),
       ("bulk_copy.x", (BULK_CHUNKS, BULK_WORDS), _F), ("sqrt.x", (4100,), _F),
       ("float2int.x", (F2I.size,), _F),
       ("atomics_global.ticket", (1,), _I))  # 0: the role's CTAs count themselves out here
_OUT = (("roll_lanes", (8, 256), _F), ("roll_sublanes", (64, 128), _F),
        ("take_along_lanes", (N, N), _F), ("f32_dot", (N, N), _F), ("f32_dot.fma", (N, N), _F),
        ("reshape_2d_split", (768, 8), _F), ("reshape_2d_merge", (8192, 1), _F),
        ("strided_lane_slice", (8, 32), _F), ("cast_2d_3d", (8, 32), _F),
        ("reduce", (4, 16), _I), ("atomics_shared", (4, SLOTS), _I),
        ("atomics_global", (4, SLOTS), _I), ("bulk_copy", (BULK_CHUNKS, BULK_WORDS), _F),
        ("sqrt", (2, 4100), _F), ("float2int", (F2I.size,), _I))


class Region(NamedTuple):
    offset: int  # in 4-byte words
    shape: tuple
    dtype: torch.dtype

    @property
    def words(self) -> int:
        return int(np.prod(self.shape))


def _layout(regions) -> dict:
    """Each region at the next 16-byte boundary (every bulk-copy source
    and float4 load is aligned)."""
    out, at = {}, 0
    for name, shape, dtype in regions:
        out[name] = Region(at, shape, dtype)
        at += -(-int(np.prod(shape)) // 4) * 4
    return out


LAYOUT = {"in": _layout(_IN), "out": _layout(_OUT)}
IN_WORDS = max(r.offset + r.words for r in LAYOUT["in"].values())
OUT_WORDS = max(r.offset + r.words for r in LAYOUT["out"].values())
# float32 operations: the dot's multiply and add, and its fmaf (two), over
# 256^3; cast_2d_3d's 7 adds a sum
OPS = 4 * N**3 + 8 * 32 * 7


def table() -> np.ndarray:
    """The kernel's role table (csrc/feature_probe.cu's Table): each
    role's first CTA and the grid's size, every input's and output's
    offset, the two shifts."""
    first = np.cumsum([0] + [c for _, c in ROLES])
    return np.concatenate([first, [r.offset for r in LAYOUT["in"].values()],
                           [r.offset for r in LAYOUT["out"].values()],
                           [LANE_SHIFT, ROW_SHIFT]]).astype(np.int32)


def pallas_inputs() -> dict:
    """The arrays each of the Pallas probe's functions hands its
    pallas_call, made as it makes them: {name: [arrays]}."""
    lanes = np.arange(8 * 256, dtype=np.float32).reshape(8, 256)
    rng = np.random.default_rng(0)
    take = [rng.uniform(0, 1, (N, N)).astype(np.float32),
            rng.integers(0, N, (N, N)).astype(np.int32)]
    rng = np.random.default_rng(0)
    dot = [rng.uniform(-1, 1, (N, N)).astype(np.float32),
           rng.uniform(-1, 1, (N, N)).astype(np.float32)]
    return {
        "roll_lanes": [np.array([LANE_SHIFT], np.int32), lanes],
        "roll_sublanes": [np.array([ROW_SHIFT], np.int32),
                          np.arange(64 * 128, dtype=np.float32).reshape(64, 128)],
        "take_along_lanes": take,
        "f32_dot": dot,
        "reshape_2d_split": [np.arange(24 * 256, dtype=np.float32).reshape(24, 256)],
        "reshape_2d_merge": [np.arange(512 * 16, dtype=np.float32).reshape(512, 16)],
        "strided_lane_slice": [lanes],
        "cast_2d_3d": [lanes],
    }


def own_inputs() -> dict:
    """The port's own checks' inputs: int words over the whole range for
    the reductions and merges (half with the top bit set), many values to
    a slot; a 2 KB-chunked row for the bulk copies; +-inf, NaN, large and
    fractional values for __float2int_rz; magnitudes from denormals to
    1e30 for the roots."""
    rng = np.random.default_rng(1)

    def word(n):
        return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)

    reduce = word(16 * 32).reshape(16, 32)
    vals = word(VALUES)
    slots = rng.integers(0, SLOTS, VALUES).astype(np.int32)
    bulk = rng.standard_normal((BULK_CHUNKS, BULK_WORDS)).astype(np.float32)
    roots = np.concatenate([10.0 ** rng.uniform(-40, 30, 4096),
                            [0.0, 1.0, 2.0, 1e-45]]).astype(np.float32)
    return {"reduce.x": reduce, "atomics.vals": vals, "atomics.slots": slots,
            "bulk_copy.x": bulk, "float2int.x": F2I.copy(), "sqrt.x": roots}


def pack(pallas: dict, own: dict) -> np.ndarray:
    """The packed input words at LAYOUT["in"]'s offsets."""
    arrays = {
        "roll_lanes.x": pallas["roll_lanes"][1], "roll_sublanes.x": pallas["roll_sublanes"][1],
        "take_along_lanes.x": pallas["take_along_lanes"][0],
        "take_along_lanes.idx": pallas["take_along_lanes"][1],
        "f32_dot.a": pallas["f32_dot"][0], "f32_dot.b": pallas["f32_dot"][1],
        **{f"{name}.x": pallas[name][0] for name in ("reshape_2d_split", "reshape_2d_merge",
                                                      "strided_lane_slice", "cast_2d_3d")},
        "atomics_global.init": np.broadcast_to(
            np.array([INT_MAX, INT_MIN, -1, 0], np.int32)[:, None, None], (4, SLOTS, LINE)),
        "atomics_global.ticket": np.zeros(1, np.int32), **own}
    words = np.zeros(IN_WORDS, np.int32)
    for name, r in LAYOUT["in"].items():
        a = np.ascontiguousarray(arrays[name])
        if a.shape != r.shape:
            raise ValueError(f"{name}: shape {a.shape}, the layout's {r.shape}")
        words[r.offset:r.offset + r.words] = a.reshape(-1).view(np.int32)
    return words


def region(words, r: Region):
    """The region r of a word buffer (torch or numpy) as its dtype and
    shape (a view)."""
    part = words[r.offset:r.offset + r.words]
    if isinstance(part, np.ndarray):
        return part.view(np.float32 if r.dtype == _F else np.int32).reshape(r.shape)
    return part.view(r.dtype).view(r.shape)


def unpack(words, side: str = "out") -> dict:
    """{name: view} of every region of a packed buffer."""
    return {name: region(words, r) for name, r in LAYOUT[side].items()}


def fma32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z rounded once to float32, as fmaf: the float32 product is
    exact in float64; the sum is rounded to odd at 53 bits (TwoSum's error
    term sets the last bit), and rounding that to float32 is the one
    rounding of the exact value (53 >= 24 + 2).  Eager float64 ops, so
    every device gives the same bits."""
    p, c = x.double() * y.double(), z.double()
    s = p + c
    pb = s - c
    e = (c - (s - pb)) + (p - pb)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    bits = torch.where((e != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def _unsigned(x: torch.Tensor) -> torch.Tensor:
    return x.long() & 0xFFFFFFFF


def _signed(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def feature_probe_reference(inp: torch.Tensor) -> torch.Tensor:
    """The launch's outputs (int32 words [OUT_WORDS], padding 0) from its
    packed inputs, with torch ops on inp's device."""
    x = unpack(inp, "in")
    out = torch.zeros(OUT_WORDS, dtype=torch.int32, device=inp.device)
    o = unpack(out)
    o["roll_lanes"].copy_(torch.roll(x["roll_lanes.x"], LANE_SHIFT, 1))
    o["roll_sublanes"].copy_(torch.roll(x["roll_sublanes.x"], ROW_SHIFT, 0))
    o["take_along_lanes"].copy_(torch.gather(x["take_along_lanes.x"], 1,
                                             x["take_along_lanes.idx"].long()))
    a, b = x["f32_dot.a"], x["f32_dot.b"]
    plain = torch.zeros(N, N, dtype=_F, device=inp.device)
    fused = torch.zeros_like(plain)
    for j in range(N):
        plain = plain + a[:, j:j + 1] * b[j:j + 1, :]
        fused = fma32(a[:, j:j + 1], b[j:j + 1, :], fused)
    o["f32_dot"].copy_(plain)
    o["f32_dot.fma"].copy_(fused)
    o["reshape_2d_split"].copy_(x["reshape_2d_split.x"].reshape(768, 8))
    o["reshape_2d_merge"].copy_(x["reshape_2d_merge.x"].reshape(8192, 1))
    o["strided_lane_slice"].copy_(x["strided_lane_slice.x"][:, ::8])
    o["cast_2d_3d"].copy_(x["cast_2d_3d.x"].reshape(8, 32, 8).sum(2))
    w = x["reduce.x"]
    u = _unsigned(w)
    o["reduce"].copy_(torch.stack([w.amin(1), w.amax(1), _signed(u.amin(1)),
                                   _signed(u.amax(1))]))
    slots, vals = x["atomics.slots"].long(), x["atomics.vals"].long()
    uvals = _unsigned(vals)
    init = x["atomics_global.init"][:, :, 0].long()
    init[2:] &= 0xFFFFFFFF
    for name, start in (("atomics_shared", torch.tensor([INT_MAX, INT_MIN, 2**32 - 1, 0])),
                        ("atomics_global", init)):
        start = start.to(inp.device).reshape(4, -1).expand(4, SLOTS)
        merged = [start[k].scatter_reduce(0, slots, v, how)
                  for k, (v, how) in enumerate(((vals, "amin"), (vals, "amax"),
                                                (uvals, "amin"), (uvals, "amax")))]
        o[name].copy_(torch.stack([merged[0].to(_I), merged[1].to(_I), _signed(merged[2]),
                                   _signed(merged[3])]))
    o["bulk_copy"].copy_(x["bulk_copy.x"])
    # __float2int_rz: toward zero, saturating at the int range, NaN to 0
    f = x["float2int.x"].double()
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f.clamp(INT_MIN, INT_MAX).trunc())
    o["float2int"].copy_(f.to(torch.int64).to(_I))
    # both rows: the float64 root rounded once to float32 is the correctly
    # rounded float32 root (53 >= 2 * 24 + 2), which __fsqrt_rn gives; torch's
    # float32 sqrt on the CPU is not correctly rounded everywhere
    root = torch.sqrt(x["sqrt.x"].double()).float()
    o["sqrt"].copy_(torch.stack([root, root]))
    return out


def _check_words(inp: torch.Tensor) -> None:
    if inp.dtype != _I or inp.shape != (IN_WORDS,) or not inp.is_contiguous():
        raise ValueError(f"feature probe: inputs must be contiguous int32 [{IN_WORDS}], got "
                         f"{inp.dtype} {tuple(inp.shape)}")


def launch(inp: torch.Tensor, clocks: torch.Tensor | None = None) -> torch.Tensor:
    """The probe's outputs (int32 words [OUT_WORDS]) from its packed
    inputs: on a CUDA tensor one launch of feature_probe_kernel, counted
    in launch.launches (it merges inp's atomics_global.init rows in place
    and leaves its ticket 0 again; outputs unchanged on a second launch),
    with padding words left unwritten, and, where `clocks` (int64
    [2, GRID]) is given, the device's nanosecond clock at each CTA's start
    and end; on a CPU tensor the plain version."""
    _check_words(inp)
    if inp.device.type == "cpu":
        return feature_probe_reference(inp)
    if inp.data_ptr() % 16:
        raise ValueError("feature probe: inputs must be 16-byte aligned")
    p = ctypes.c_void_p
    clock_ptr = p(0)
    if clocks is not None:
        if clocks.dtype != torch.int64 or clocks.shape != (2, GRID) or clocks.device != inp.device:
            raise ValueError(f"feature probe: clocks must be int64 [2, {GRID}] on {inp.device}")
        clock_ptr = build.ptr(clocks)
    out = torch.empty(OUT_WORDS, dtype=_I, device=inp.device)
    t = table()
    fn = build.entry(SOURCE, "dst_feature_probe", [p, p, p, ctypes.c_int, p, p])
    err = fn(build.ptr(inp), build.ptr(out), t.ctypes.data_as(p), t.size, clock_ptr,
             build.stream_of(inp))
    launch.launches += 1
    build.check(err, "feature probe")
    return out


launch.launches = 0


def _err(*pairs) -> float:
    """Largest |a - b| over pairs of arrays, as float64; equal entries
    (infinities too) count 0."""
    err = 0.0
    for a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d = np.where(a == b, 0.0, np.abs(a - b))
        err = max(err, float(d.max()) if d.size else 0.0)
    return err


def expectations(out: dict, pallas: dict, own: dict) -> dict:
    """{role: {"ok", "max_abs_err", ...}}: the outputs (numpy, unpacked)
    held to numpy: the Pallas probe's own comparisons (f32_dot by its
    np.allclose(atol=1e-3)); the plain dot equal to numpy's sequential
    float32 loop; the fmaf dot within the error bound of a 256-term
    float32 sum, gamma_256 (|a| @ |b|), of the float64 product and unlike
    the plain dot somewhere; the port's primitives exactly."""
    lanes = pallas["roll_lanes"][1]
    a, b = pallas["f32_dot"]
    want = {
        "roll_lanes": np.roll(lanes, int(pallas["roll_lanes"][0][0]), axis=1),
        "roll_sublanes": np.roll(pallas["roll_sublanes"][1], int(pallas["roll_sublanes"][0][0]),
                                 axis=0),
        "take_along_lanes": np.take_along_axis(*pallas["take_along_lanes"], axis=1),
        "reshape_2d_split": pallas["reshape_2d_split"][0].reshape(768, 8),
        "reshape_2d_merge": pallas["reshape_2d_merge"][0].reshape(8192, 1),
        "strided_lane_slice": pallas["strided_lane_slice"][0][:, ::8],
        "cast_2d_3d": pallas["cast_2d_3d"][0].reshape(8, 32, 8).sum(axis=2),
    }
    res = {k: {"ok": bool(np.array_equal(out[k], v)), "max_abs_err": _err((out[k], v))}
           for k, v in want.items()}

    seq = np.zeros((N, N), np.float32)
    for j in range(N):
        seq = seq + a[:, j:j + 1] * b[j:j + 1, :]
    exact = a.astype(np.float64) @ b.astype(np.float64)
    u = 2.0**-24
    gamma = N * u / (1 - N * u)
    plain, fused = out["f32_dot"], out["f32_dot.fma"]
    dot = {"allclose_numpy": bool(np.allclose(plain, a @ b, atol=1e-3)),
           "max_abs_err_numpy": float(np.abs(plain - a @ b).max()),
           "plain_equal_sequential": bool(np.array_equal(plain, seq)),
           "fma_max_abs_err_f64": float(np.abs(fused - exact).max()),
           "fma_within_bound": bool(np.all(np.abs(fused - exact)
                                           <= gamma * (np.abs(a) @ np.abs(b)))),
           "fma_differs_from_plain": int((plain != fused).sum())}
    dot["ok"] = (dot["allclose_numpy"] and dot["plain_equal_sequential"]
                 and dot["fma_within_bound"] and dot["fma_differs_from_plain"] > 0)
    dot["max_abs_err"] = _err((plain, seq))
    res["f32_dot"] = dot

    w = own["reduce.x"]
    uw = w.view(np.uint32)
    res["reduce"] = _exact(out["reduce"], [w.min(1), w.max(1), uw.min(1).view(np.int32),
                                           uw.max(1).view(np.int32)])
    vals, slots = own["atomics.vals"], own["atomics.slots"]
    merged = np.zeros((4, SLOTS), np.int32)
    for s in range(SLOTS):
        v = vals[slots == s]
        merged[:, s] = (v.min(), v.max(), v.view(np.uint32).min().view(np.int32),
                        v.view(np.uint32).max().view(np.int32))
    res["atomics_shared"] = _exact(out["atomics_shared"], merged)
    res["atomics_global"] = _exact(out["atomics_global"], merged)
    res["bulk_copy"] = _exact(out["bulk_copy"], own["bulk_copy.x"])
    res["float2int"] = _exact(out["float2int"], np.array(
        [INT_MAX, INT_MIN, 0, INT_MAX, INT_MIN, 2, -2, 0, 0, 7], np.int32))
    root = np.sqrt(own["sqrt.x"].astype(np.float64)).astype(np.float32)
    res["sqrt"] = _exact(out["sqrt"], np.stack([root, root]))
    return res


def _exact(got, want) -> dict:
    """Bit-equality of int or float words; the error as unsigned words
    for ints (a top-bit word compares by its unsigned value)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == np.int32:
        g, w = got.view(np.uint32), np.asarray(want, np.int32).view(np.uint32)
        return {"ok": bool(np.array_equal(g, w)), "max_abs_err": _err((g, w))}
    return {"ok": bool(np.array_equal(got.view(np.int32), np.asarray(want, np.float32)
                                      .view(np.int32))), "max_abs_err": _err((got, want))}


def run(dev) -> dict:
    """Every role's checks -> {role: result}; raises AssertionError naming
    every role that failed.  On a CUDA device: one launch, every output
    region bit-equal to the plain version run on the card (max_abs_err is
    the largest difference from it), and every output held to numpy's
    expectations; on the CPU the plain version alone, held to numpy's
    expectations (max_abs_err from them)."""
    dev = torch.device(dev)
    pallas, own = pallas_inputs(), own_inputs()
    inp = torch.from_numpy(pack(pallas, own)).to(dev)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            words = launch(inp).cpu().numpy()
            plain = feature_probe_reference(inp).cpu().numpy()
    else:
        words = feature_probe_reference(inp).numpy()
        plain = None
    out = unpack(words)
    res = expectations(out, pallas, own)
    if plain is not None:
        ref = unpack(plain)
        for name in res:
            parts = [name] + (["f32_dot.fma"] if name == "f32_dot" else [])
            equal = all(np.array_equal(out[p].view(np.int32), ref[p].view(np.int32))
                        for p in parts)
            res[name]["plain_bits_equal"] = equal
            res[name]["max_abs_err"] = _err(*((out[p], ref[p]) for p in parts))
            res[name]["ok"] = res[name]["ok"] and equal
    failed = [k for k, v in res.items() if not v["ok"]]
    if failed:
        raise AssertionError(f"feature probe: {failed} failed: {res}")
    return res


def timed_pair(dev):
    """(kernel, plain, nbytes, ops): closures over the probe's packed
    inputs on `dev` that launch the kernel once and that run its plain
    version, for timing the two; the bytes the launch must move (every
    input read once, every output written once) and its float32
    operations."""
    inp = torch.from_numpy(pack(pallas_inputs(), own_inputs())).to(dev)
    # of the global role's lines, their first words
    nbytes = 4 * (sum(r.words for r in LAYOUT["in"].values()) - 4 * SLOTS * (LINE - 1)
                  + sum(r.words for r in LAYOUT["out"].values()))
    return (lambda: launch(inp)), (lambda: feature_probe_reference(inp)), nbytes, OPS
