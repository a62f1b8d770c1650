"""PyTorch port, the sampler probes P4 and P5 on their own inputs
(ops/cuda/sample_probe.py `sample_modes`): the Pallas probes
scripts/probe_sample_overhead.py (four modes; its V cut to 64 rows) and
scripts/probe_kernel_stages.py (four variants; VCAP cut to 64, COUNT to
48) run here in interpret mode, their pallas_call recorded; the port's
restated inputs equal what each call was given and
sample_modes_reference's nine planes equal what it returned, bit for bit
(P5 on the rows below COUNT).  P5's variants run through the script's
own run_variant, each distinct pallas_call once.  (The kernel is held
against this plain version on the card: tests/test_torch_gpu.py and
chip_smoke.py.)"""

import numpy as np
import pytest
import torch

from disinfect_slam_tpu_torch.ops.cuda import build
from disinfect_slam_tpu_torch.ops.cuda import sample_probe as sp

from .torch_probe_record import load_script, recording

torch.set_num_threads(1)

P4_ROWS = 64  # probe_sample_overhead.py's V = 32768, cut
P5_ROWS, P5_COUNT = 64, 48  # probe_kernel_stages.py's VCAP = 32768 and COUNT = 22336, cut
FUNCTIONS = [(probe, m) for probe, ms in sp.MODES.items() for m in ms]
IDS = [f"{p}-{m}" for p, m in FUNCTIONS]


@pytest.fixture(scope="module")
def pallas():
    """{(probe, mode): ([pallas_call inputs], [9 outputs])}: P4's main
    (its four modes, each timed on recorded outputs); P5's main
    (mask_fold, vmem_img), then run_variant for dma_only and mxu on main's
    arrays."""
    res = {}
    p4 = load_script("probe_sample_overhead", V=P4_ROWS)
    with recording(p4) as (rec, _):
        p4.main()
    assert rec.runs == len(sp.MODES["P4"])
    for _, modes, ins, out in rec.named():
        res[("P4", modes[0])] = (ins, out)
    p5 = load_script("probe_kernel_stages", VCAP=P5_ROWS, COUNT=P5_COUNT)
    with recording(p5) as (rec, _):
        p5.main()
        u0, v0, _, img, u, v = rec.calls[0][2]
        for mode in ("dma_only", "mxu"):
            p5.run_variant(mode, u0, v0, img, u, v)
    assert rec.runs == len(sp.MODES["P5"])
    for (name, modes, ins, out), mode in zip(rec.named(), ("mask_fold", "vmem_img", "dma_only",
                                                            "mxu")):
        assert modes == ((mode,) if mode != "vmem_img" else ()), (name, modes)
        res[("P5", mode)] = (ins, out)
    return res


def _args(probe, arrays):
    """sample_modes' arguments from a pallas_call's inputs."""
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    return (t[0], t[1], t[3], t[4], t[5], t[2]) if probe == "P5" else tuple(t)


@pytest.mark.parametrize("probe,mode", FUNCTIONS, ids=IDS)
def test_inputs_equal_the_pallas_probe(pallas, probe, mode):
    """probe_inputs restates each script's numpy draws: every array the
    pallas_call was given, byte for byte (P5's count as the (1,) scalar
    it prefetches)."""
    want = pallas[(probe, mode)][0]
    got = (sp.probe_inputs("P4", P4_ROWS) if probe == "P4"
           else sp.probe_inputs("P5", P5_ROWS, P5_COUNT))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("probe,mode", FUNCTIONS, ids=IDS)
def test_reference_equals_the_pallas_probe(pallas, probe, mode):
    """sample_modes_reference gives each Pallas function's 8 channel
    planes and valid plane bit for bit, P5's over the rows below COUNT
    (the grid steps it runs), and so does sample_modes on CPU tensors."""
    inputs, outs = pallas[(probe, mode)]
    want = np.stack(outs)
    n = P4_ROWS if probe == "P4" else P5_COUNT
    rows = P4_ROWS if probe == "P4" else P5_ROWS
    assert want.shape == (9, rows, 512) and want.dtype == np.float32
    for got in (sp.sample_modes_reference(probe, mode, *_args(probe, inputs)),
                sp.sample_modes(probe, mode, *_args(probe, inputs))):
        assert got.shape == (9, rows, 512) and got.dtype == torch.float32
        assert got[:, :n].numpy().tobytes() == want[:, :n].tobytes()


def test_splits_exact_in_p4_and_not_in_p5(pallas):
    """P4's full mode, three bf16 splits, is the exact pixel; P5's
    mask_fold, two, is hi + mid: not the pixel for most voxels, within
    2^-16 of it relative; the probes' pixels are all inside their
    patches, so vmask is 1 throughout."""
    for probe, mode in (("P4", "full"), ("P5", "mask_fold")):
        inputs, outs = pallas[(probe, mode)]
        args = _args(probe, inputs)
        n = P4_ROWS if probe == "P4" else P5_COUNT
        pix = sp.pixel_index(args[0], args[1], args[3], args[4], probe, mode)[:n]
        exact = args[2].view(-1, 8)[pix].permute(2, 0, 1).numpy()
        got = np.stack(outs)[:, :n]
        assert (got[8] == 1).all()
        if probe == "P4":
            assert got[:8].tobytes() == exact.tobytes()
        else:
            assert (got[:8] != exact).mean() > 0.5
            assert np.all(np.abs(got[:8] - exact) <= 2.0**-16 * np.abs(exact))
    x = torch.from_numpy(np.random.default_rng(1).uniform(-300, 300, 4096).astype(np.float32))
    assert torch.equal(sp.bf16_splits(x, 3), x)
    assert not torch.equal(sp.bf16_splits(x, 2), x)


def test_rows_computed_by_grid_step():
    """P5 runs the 16-row steps whose first row lies below count: count 40
    computes 48 rows, 48 computes 48, 0 none; P4 every row."""
    assert [sp.rows_computed(c, 64) for c in (0, 1, 16, 40, 48, 64, 99)] == [0, 16, 16, 48, 48,
                                                                               64, 64]
    arrays = sp.probe_inputs("P5", 64, 40)
    out = sp.sample_modes_reference("P5", "mxu", *_args("P5", arrays))
    assert (out[:, 48:] == 0).all() and (out[8, :48] == 1).all()


def test_masked_voxels_and_the_pixel_read():
    """Voxels outside their row's 24x32 patch: vmask 0 (their channels 0,
    but mxu's, which is unmasked); the pixel each mode reads clamps lu, lv
    into the patch; modes_bytes counts each distinct pixel once."""
    u0, v0, img, u, v = sp.probe_inputs("P4", 16)
    u, v = u.copy(), v.copy()
    u[0, :10] = u0[0] + 40  # past the patch's 32 columns
    v[1, :10] = v0[1] - 1  # above its first row
    args = _args("P4", [u0, v0, img, u, v])
    full = sp.sample_modes_reference("P4", "full", *args)
    assert (full[8, :2, :10] == 0).all() and (full[:8, :2, :10] == 0).all()
    assert (full[8, 2:] == 1).all()
    cnt = np.full((1,), 16, np.int32)
    mxu = sp.sample_modes_reference("P5", "mxu", *_args("P5", [u0, v0, cnt, img, u, v]))
    assert (mxu[:8, :2, :10] != 0).all() and (mxu[8, :2, :10] == 0).all()
    pix = sp.pixel_index(args[0], args[1], args[3], args[4], "P4", "full")
    assert int(pix[0, 0]) == int(v[0, 0]) * sp.IMG_W + int(u0[0]) + 31
    nbytes = sp.modes_bytes("P4", "full", *args)
    assert nbytes == 16 * 512 * 44 + 16 * 8 + 32 * int(torch.unique(pix).numel())
    assert sp.pixel_index(args[0], args[1], args[3], args[4], "P4", "nodma") is None


def test_wrapper_checks_its_inputs(monkeypatch):
    """sample_modes on CPU tensors builds and launches nothing; a row
    count off the grid's step of 16, a P5 call without its count, a P4
    call with one, or an image of another shape raise."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel was asked for on the CPU")

    monkeypatch.setattr(build, "entry", no_kernel)
    monkeypatch.setattr(build, "library", no_kernel)
    args = _args("P4", sp.probe_inputs("P4", 16))
    before = sp.sample_modes.launches
    sp.sample_modes("P4", "stage1", *args)
    assert sp.sample_modes.launches == before
    with pytest.raises(ValueError):
        sp.sample_modes("P4", "stage1", *_args("P4", sp.probe_inputs("P4", 8)))
    with pytest.raises(ValueError):
        sp.sample_modes("P5", "mxu", *args)
    with pytest.raises(ValueError):
        sp.sample_modes("P4", "full", *args, torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError):
        sp.sample_modes("P4", "full", args[0], args[1], args[2].view(480, 640, 8), *args[3:])
    with pytest.raises(ValueError):
        sp.sample_modes("P4", "mask_fold", *args)
