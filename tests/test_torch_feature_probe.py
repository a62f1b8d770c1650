"""PyTorch port, the feature probe's plain version (ops/cuda/
feature_probe.py, P7): the Pallas probe scripts/probe_mosaic_features.py
runs each of its eight functions here in interpret mode, its pallas_call
wrapped to record what each call is given and returns; the port's inputs
equal what it was given and feature_probe_reference's outputs equal what
it returned, bit for bit (f32_dot within the probe's own atol of 1e-3).
The port's own primitive rows are held to numpy, fma32 to exact rational
arithmetic, and the packed layout to its alignment.  (The kernel is held
against this plain version on the card: tests/test_torch_gpu.py and
chip_smoke.py.)"""

import importlib.util
import os
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from disinfect_slam_tpu_torch.ops.cuda import build
from disinfect_slam_tpu_torch.ops.cuda import feature_probe as fp

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                      "probe_mosaic_features.py")


@pytest.fixture(scope="module")
def pallas():
    """{name: (the function's verdict, [its pallas_call's inputs], output)}
    for each of the Pallas probe's functions in interpret mode."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("probe_mosaic_features", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(script)  # sets jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    calls = []
    pallas_call = pl.pallas_call

    def recording(*args, **kwargs):
        kernel = pallas_call(*args, **kwargs)

        def call(*inputs):
            out = kernel(*inputs)
            calls.append(([np.asarray(x) for x in inputs], np.asarray(out)))
            return out

        return call

    res = {}
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(script.pl, "pallas_call", recording)
        for name in fp.PALLAS:
            calls.clear()
            verdict = getattr(script, name)()
            assert len(calls) == 1, name
            res[name] = (bool(verdict), *calls[0])
    return res


@pytest.fixture(scope="module")
def plain():
    """The plain version's outputs (unpacked numpy) on the port's inputs."""
    inp = torch.from_numpy(fp.pack(fp.pallas_inputs(), fp.own_inputs()))
    return fp.unpack(fp.feature_probe_reference(inp).numpy())


@pytest.mark.parametrize("name", fp.PALLAS)
def test_inputs_equal_the_pallas_probe(pallas, name):
    """The port's restated generators give each pallas_call's inputs bit
    for bit (the shifts as the prefetched scalars)."""
    want = pallas[name][1]
    got = fp.pallas_inputs()[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", fp.PALLAS)
def test_reference_equals_the_pallas_probe(pallas, plain, name):
    """feature_probe_reference equals each Pallas output bit for bit, and
    f32_dot within the probe's own np.allclose(atol=1e-3); the probe's own
    verdict is True."""
    verdict, _, want = pallas[name]
    assert verdict
    got = plain[name]
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "f32_dot":
        err = float(np.abs(got - want).max())
        print(f"f32_dot: the plain sequential dot against the Pallas dot in interpret mode, "
              f"largest difference {err:.3e}")
        assert np.allclose(got, want, atol=1e-3)
    else:
        assert got.tobytes() == want.tobytes()


def _words(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("role", ["reduce", "atomics_shared", "atomics_global", "bulk_copy",
                                  "float2int", "sqrt"])
def test_own_primitives_against_numpy(plain, role):
    """The port's own rows: int and unsigned min / max by warp and by slot
    (unsigned words compared as unsigned), the bulk copy intact,
    __float2int_rz's saturating rule, the correctly rounded root in both
    rows."""
    own = fp.own_inputs()
    if role == "reduce":
        w = own["reduce.x"]
        want = [w.min(1), w.max(1), _words(w).min(1), _words(w).max(1)]
        got = plain["reduce"]
        assert np.array_equal(got[:2], np.stack(want[:2]))
        assert np.array_equal(_words(got[2:]), np.stack(want[2:]))
    elif role.startswith("atomics"):
        vals, slots = own["atomics.vals"], own["atomics.slots"]
        got = plain[role]
        for s in range(fp.SLOTS):
            v = vals[slots == s]
            assert v.size > 1
            assert (got[0, s], got[1, s]) == (v.min(), v.max())
            assert (_words(got[2, s]), _words(got[3, s])) == (_words(v).min(), _words(v).max())
    elif role == "bulk_copy":
        assert plain["bulk_copy"].tobytes() == own["bulk_copy.x"].tobytes()
    elif role == "float2int":
        x = own["float2int.x"].astype(np.float64)
        want = np.where(np.isnan(x), 0, np.trunc(np.clip(x, -2.0**31, 2.0**31 - 1)))
        assert np.array_equal(plain["float2int"], want.astype(np.int64))
        assert plain["float2int"][:3].tolist() == [2**31 - 1, -2**31, 0]
    else:
        x = own["sqrt.x"]
        want = np.sqrt(x.astype(np.float64)).astype(np.float32)
        assert plain["sqrt"][0].tobytes() == want.tobytes()
        assert plain["sqrt"][1].tobytes() == want.tobytes()


def _round32(q: Fraction) -> np.float32:
    """The exact value q rounded once to float32, ties to even."""
    near = np.float32(float(q))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - q) for c in cands)
    ties = [c for c in cands if abs(Fraction(float(c)) - q) == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.uint32)) & 1)


def test_fma32_rounds_once():
    """fma32 equals x y + z rounded once to float32 by exact rational
    arithmetic: on random triples over many exponents, and on one whose
    float64 sum lands exactly on a float32 tie (rounded twice it would go
    up: 1 + 2^-23 + 2^-24 - 2^-70 rounds to 1 + 2^-23)."""
    rng = np.random.default_rng(3)
    n = 1500
    x = rng.uniform(-1, 1, n).astype(np.float32)
    y = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-30, 30, n)).astype(np.float32)
    z = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-30, 30, n)).astype(np.float32)
    x = np.append(x, np.float32(1 + 2**-23))
    y = np.append(y, np.float32(2**-24 * (1 - 2**-23)))
    z = np.append(z, np.float32(1 + 2**-23))
    got = fp.fma32(*(torch.from_numpy(a) for a in (x, y, z))).numpy()
    want = np.array([_round32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
                     for a, b, c in zip(x, y, z)], np.float32)
    assert got.tobytes() == want.tobytes()
    assert got[-1] == np.float32(1 + 2**-23)
    twice = (x[-1].astype(np.float64) * y[-1] + z[-1]).astype(np.float32)
    assert twice == np.float32(1 + 2**-22)


def test_fused_dot_rows(plain):
    """The fmaf rows: within gamma_256 (|a| @ |b|) of the float64 product
    and unlike the plain rows somewhere; the plain rows equal numpy's
    sequential float32 loop."""
    a, b = fp.pallas_inputs()["f32_dot"]
    seq = np.zeros((fp.N, fp.N), np.float32)
    for j in range(fp.N):
        seq = seq + a[:, j:j + 1] * b[j:j + 1, :]
    assert plain["f32_dot"].tobytes() == seq.tobytes()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    u = 2.0**-24
    gamma = fp.N * u / (1 - fp.N * u)
    fused = plain["f32_dot.fma"]
    assert np.all(np.abs(fused - exact) <= gamma * (np.abs(a) @ np.abs(b)))
    assert (fused != plain["f32_dot"]).any()


@pytest.mark.parametrize("side", ["in", "out"])
def test_layout_regions_disjoint_and_aligned(side):
    """Every region starts on a 16-byte boundary (each bulk-copy source and
    float4 load is aligned), after the end of the one before, inside the
    buffer; the table gives each role's first CTA in ROLES' order and the
    offsets in the layout's."""
    regions = list(fp.LAYOUT[side].values())
    words = fp.IN_WORDS if side == "in" else fp.OUT_WORDS
    end = 0
    for r in regions:
        assert r.offset % 4 == 0 and r.offset >= end
        end = r.offset + r.words
    assert end == words
    assert fp.LAYOUT["in"]["bulk_copy.x"].offset * 4 % 16 == 0
    t = fp.table()
    roles = len(fp.ROLES)
    assert t[:roles + 1].tolist() == np.cumsum([0] + [c for _, c in fp.ROLES]).tolist()
    assert t[roles] == fp.GRID and dict(fp.ROLES)["atomics_global"] > 1
    first = roles + 1 + (0 if side == "in" else len(fp.LAYOUT["in"]))
    assert t[first:first + len(regions)].tolist() == [r.offset for r in regions]
    assert t[-2:].tolist() == [fp.LANE_SHIFT, fp.ROW_SHIFT]


def test_pack_round_trips():
    """pack puts each input at its region, and unpack reads it back."""
    pallas, own = fp.pallas_inputs(), fp.own_inputs()
    got = fp.unpack(fp.pack(pallas, own), "in")
    assert got["f32_dot.b"].tobytes() == pallas["f32_dot"][1].tobytes()
    assert got["take_along_lanes.idx"].tobytes() == pallas["take_along_lanes"][1].tobytes()
    assert got["atomics.slots"].tobytes() == own["atomics.slots"].tobytes()
    assert got["atomics_global.ticket"][0] == 0
    assert np.all(got["atomics_global.init"] == np.array([2**31 - 1, -2**31, -1, 0])[:, None, None])


def test_merged_initial_rows_leave_the_outputs(plain):
    """The kernel merges the global role's values into the input's initial
    rows in place: run again on those merged rows, the plain version's
    outputs are the same."""
    inp = torch.from_numpy(fp.pack(fp.pallas_inputs(), fp.own_inputs()))
    fp.region(inp, fp.LAYOUT["in"]["atomics_global.init"])[:, :, 0] = torch.from_numpy(
        plain["atomics_global"])
    again = fp.unpack(fp.feature_probe_reference(inp).numpy())
    for name in ("atomics_global", "atomics_shared", "f32_dot", "sqrt"):
        assert again[name].tobytes() == plain[name].tobytes()


def test_run_on_the_cpu_runs_the_plain_version_only(monkeypatch):
    """run(cpu) builds and launches nothing, and every check passes."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel was asked for on the CPU")

    monkeypatch.setattr(build, "entry", no_kernel)
    monkeypatch.setattr(build, "library", no_kernel)
    before = fp.launch.launches
    res = fp.run(torch.device("cpu"))
    assert fp.launch.launches == before
    assert set(res) == set(fp.CHECKS)
    assert all(r["ok"] and r["max_abs_err"] == 0 for r in res.values())
    assert res["f32_dot"]["fma_differs_from_plain"] > 0


def test_launch_on_a_cpu_tensor_is_the_plain_version(plain):
    """launch on CPU words returns the plain version's outputs uncounted;
    words of another type or size raise."""
    inp = torch.from_numpy(fp.pack(fp.pallas_inputs(), fp.own_inputs()))
    before = fp.launch.launches
    got = fp.unpack(fp.launch(inp).numpy())
    assert fp.launch.launches == before
    assert all(got[k].tobytes() == plain[k].tobytes() for k in plain)
    with pytest.raises(ValueError):
        fp.launch(inp.float())
    with pytest.raises(ValueError):
        fp.launch(inp[:-1])
