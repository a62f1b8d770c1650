"""PyTorch port, the splat z-buffer probes P8 and P9 from given inputs
(ops/cuda/splat_probe.py): the Pallas probes scripts/probe_splat2.py
(run_v2, run_v2i, run_v3; its S cut to 128 blocks) and
scripts/probe_splat2b.py (five modes at its own 64 blocks) run here in
interpret mode, their pallas_call recorded; the port's restated inputs
equal what each call was given and splat_zbuf_given_reference's z-buffer
equals what it returned, bit for bit, also where a box's roll wraps
inside its window.  (The kernel is held against this plain version on
the card: tests/test_torch_gpu.py and chip_smoke.py.)"""

import numpy as np
import pytest
import torch

from disinfect_slam_tpu_torch.ops.cuda import build
from disinfect_slam_tpu_torch.ops.cuda import splat_probe as zp

from .torch_probe_record import load_script, recording

torch.set_num_threads(1)

P8_BLOCKS = 128  # probe_splat2.py's S = 12288, cut
FUNCTIONS = [(probe, f) for probe, fs in zp.FUNCTIONS.items() for f in fs]
IDS = [f"{p}-{f}" for p, f in FUNCTIONS]


@pytest.fixture(scope="module")
def pallas():
    """{(probe, function): ([pallas_call inputs], output)}, with "stdout"
    the scripts' own prints: probe_splat2.py's main (run_v3 and run_v2i on
    its draws, checked there against its numpy z-buffer), then run_v2 on
    the same inputs; probe_splat2b.py's main (its five modes)."""
    res = {}
    p8 = load_script("probe_splat2", S=P8_BLOCKS)
    with recording(p8) as (rec, out):
        p8.main()
        inputs = rec.calls[0][2]
        p8.run_v2(*inputs)
    calls = rec.named()
    names = {"_v3_kernel": "run_v3", "_v2_init_kernel": "run_v2i", "_v2_kernel": "run_v2"}
    assert [c[0] for c in calls] == ["_v3_kernel", "_v2_init_kernel", "_v2_kernel"]
    assert rec.runs == 3  # main's timing calls returned the recorded outputs
    for name, _, ins, o in calls:
        res[("P8", names[name])] = (ins, o)
    stdout = out.getvalue()
    p9 = load_script("probe_splat2b")
    with recording(p9) as (rec, out):
        p9.main()
    for _, modes, ins, o in rec.named():
        res[("P9", modes[0])] = (ins, o)
    res["stdout"] = stdout + out.getvalue()
    return res


def _tensors(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("probe,function", FUNCTIONS, ids=IDS)
def test_inputs_equal_the_pallas_probe(pallas, probe, function):
    """pallas_inputs restates each script's numpy draws: every array the
    pallas_call was given, byte for byte (n as the (1,) scalar it
    prefetches)."""
    want = pallas[(probe, function)][0]
    got = zp.pallas_inputs(probe, P8_BLOCKS if probe == "P8" else None)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("probe,function", FUNCTIONS, ids=IDS)
def test_reference_equals_the_pallas_probe(pallas, probe, function):
    """splat_zbuf_given_reference gives each Pallas function's z-buffer bit
    for bit, and so does splat_zbuf_given on CPU tensors."""
    inputs, want = pallas[(probe, function)]
    got = zp.splat_zbuf_given_reference(*_tensors(inputs), function).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (zp.HPAD, zp.WPAD)
    assert got.tobytes() == want.tobytes()
    assert zp.splat_zbuf_given(*_tensors(inputs), function).numpy().tobytes() == want.tobytes()


def test_main_checks_its_numpy_zbuf(pallas):
    """probe_splat2.py's main finds both of its functions exact against
    its numpy z-buffer; numpy_zbuf restates that z-buffer, equal to every
    function of NUMPY_EQUAL; rmw, rowwrite and roll give the BIG fill and
    norollfull another z-buffer (its patches unrolled)."""
    assert "v3: " in pallas["stdout"] and "v2: " in pallas["stdout"]
    assert pallas["stdout"].count("exact=True") == 2
    for probe in zp.FUNCTIONS:
        inputs = pallas[(probe, zp.FUNCTIONS[probe][-1])][0]
        zref = zp.numpy_zbuf(inputs[0], inputs[1], inputs[3], inputs[4], inputs[5])
        for function in zp.FUNCTIONS[probe]:
            out = pallas[(probe, function)][1]
            if function in zp.NUMPY_EQUAL:
                assert np.array_equal(out.astype(np.int64), zref), function
            elif function == "norollfull":
                assert (out != zp.BIG).any() and not np.array_equal(out.astype(np.int64), zref)
            else:
                assert (out == zp.BIG).all(), function


def _wrapping_inputs(seed: int = 11):
    """16 blocks (two Pallas grid steps), n = 14: blocks 0-5 at box
    origins bu >= 755 or bv >= 483, whose rolled patches wrap inside their
    24x256 windows (rows past 24, columns past 256 of the window), the
    rest inside the frame; a quarter of voxels dead, lu / lv over the
    patch's rows, lu past its 32 columns for block 2."""
    rng = np.random.default_rng(seed)
    s = 16
    bu = rng.integers(0, 400, s).astype(np.int32)
    bv = rng.integers(0, 400, s).astype(np.int32)
    bu[:3] = [755, 767, 760]
    bv[3:6] = [483, 495, 490]
    bv[0], bu[4] = 488, 762
    lu = rng.integers(0, 15, (s, zp.VOXELS)).astype(np.int32)
    lv = rng.integers(0, 16, (s, zp.VOXELS)).astype(np.int32)
    lu[2] = rng.integers(0, 127, zp.VOXELS)
    dq = rng.integers(100, 2**20, (s, zp.VOXELS)).astype(np.int32)
    dq = np.where(rng.uniform(size=dq.shape) < 0.25, zp.BIG, dq).astype(np.int32)
    return [bu, bv, np.array([14], np.int32), lu, lv, dq]


@pytest.mark.parametrize("probe,function", [("P9", "full"), ("P9", "norollfull"),
                                            ("P8", "run_v2i"), ("P8", "run_v3")],
                         ids=["P9-full", "P9-norollfull", "P8-run_v2i", "P8-run_v3"])
def test_a_roll_that_wraps_matches_interpret_mode(probe, function):
    """Boxes at bu >= 755 and bv >= 483: the roll by (bv - v0a, bu - u0a)
    carries footprint pixels past the window's last row or column, and
    the Pallas roll wraps them to its first; the plain version computes
    the same wrap (norollfull places the same patches unrolled; run_v3
    drops what lies past patch column 32, run_v2i keeps it), and blocks
    at or past n merge nothing."""
    inputs = _wrapping_inputs()
    script = load_script("probe_splat2" if probe == "P8" else "probe_splat2b", S=16)
    with recording(script):
        want = np.asarray(getattr(script, function)(*inputs) if probe == "P8"
                          else script.run(function, inputs))
    got = zp.splat_zbuf_given_reference(*_tensors(inputs), function).numpy()
    assert got.tobytes() == want.tobytes()
    # the wrapped blocks' pixels land in their windows' first rows or columns
    idx, _ = zp.footprint_scatter(*_tensors(inputs), function)
    ys, xs = np.divmod(idx.numpy(), zp.WPAD)
    if function == "norollfull":
        assert ys.max() < zp.HPAD and xs.max() < zp.WPAD
    else:
        assert ((ys >= zp.HPAD - zp.WIN_H) & (ys < zp.HPAD - zp.WIN_H + 8)).any()
        assert ((xs >= zp.WPAD - zp.WIN_W) & (xs < zp.WPAD - zp.WIN_W + 16)).any()
    ins = _tensors(inputs)
    ins[2] = torch.tensor([16], dtype=torch.int32)
    more = zp.splat_zbuf_given_reference(*ins, function).numpy()
    assert (more <= got).all() and (more < got).any()


def test_modes_and_kernel_modes():
    """Every Pallas function has a kernel mode: run_v2, run_v2i and full
    one (rolled, 128 columns), run_v3 its own (32 columns), norollfull its
    own, rmw / rowwrite / roll the fill alone."""
    modes = {f: zp.KERNEL_MODES[f] for p in zp.FUNCTIONS.values() for f in p}
    assert modes == {"run_v2": 1, "run_v2i": 1, "run_v3": 2, "rmw": 0, "rowwrite": 0,
                     "roll": 0, "norollfull": 3, "full": 1}
    assert set(zp.NUMPY_EQUAL) == {f for f, m in modes.items() if m in (1, 2)}


def test_dead_voxels_and_blocks_past_n_merge_nothing():
    """A block past n, and dead voxels (dq >= BIG, BIG + 1 too), leave the
    fill; the library call's scatter of footprint_scatter gives the plain
    version's z-buffer; the bytes count each input once and the
    z-buffer once."""
    bu, bv, n, lu, lv, dq = _tensors(zp.pallas_inputs("P9", 8))
    dq[:4] = zp.BIG
    dq[4, :100] = zp.BIG + 1
    n[0] = 6
    z = zp.splat_zbuf_given_reference(bu, bv, n, lu, lv, dq, "full")
    only = dq.clone()
    only[:4] = zp.BIG
    only[6:] = zp.BIG
    assert torch.equal(z, zp.splat_zbuf_given_reference(
        bu, bv, torch.tensor([8], dtype=torch.int32), lu, lv, only, "full"))
    idx, val = zp.footprint_scatter(bu, bv, n, lu, lv, dq, "full")
    assert (val < zp.BIG).all() and idx.numel() == 4 * int((dq[4:6] < zp.BIG).sum())
    base = torch.full((zp.HPAD * zp.WPAD,), zp.BIG, dtype=torch.int32)
    assert torch.equal(base.scatter_reduce(0, idx, val, "amin").view(zp.HPAD, zp.WPAD), z)
    assert zp.given_bytes(lu) == 4 * (2 * 8 + 1 + 3 * 8 * 512 + 496 * 768)


def test_wrapper_checks_its_inputs(monkeypatch):
    """splat_zbuf_given on CPU tensors builds and launches nothing; a
    block count off the Pallas grid's step of 8, a wrong type or shape
    raise."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel was asked for on the CPU")

    monkeypatch.setattr(build, "entry", no_kernel)
    monkeypatch.setattr(build, "library", no_kernel)
    t = _tensors(zp.pallas_inputs("P9", 16))
    before = zp.splat_zbuf_given.launches
    zp.splat_zbuf_given(*t, "full")
    assert zp.splat_zbuf_given.launches == before
    with pytest.raises(ValueError):
        zp.splat_zbuf_given(*_tensors(zp.pallas_inputs("P9", 12)), "full")
    with pytest.raises(ValueError):
        zp.splat_zbuf_given(t[0].long(), *t[1:], "full")
    with pytest.raises(ValueError):
        zp.splat_zbuf_given(*t[:3], t[3][:, :256].contiguous(), *t[4:], "full")
