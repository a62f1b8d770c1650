"""PyTorch port, utils/kernel_verify.py and scripts/port_verify.py on the
CPU: verify_all passes (the wrappers run their plain versions here), each
check fails when its kernel side gets a perturbed input, an exception
counts as a failure and makes the script exit 1, and the small scene the
integrate and splat checks fuse is held against the JAX suite's
_small_scene_step("gather") under the fingerprint limits of PERF.md §2
(live blocks and observed voxels 0.1%, sum |tsdf| 1e-4, sum weight and
sum prob 1e-3; measured: the counts and sum weight equal, sum |tsdf|
1.3e-9, sum prob 4.4e-10, on both the two-stage and the fused path).
verify_all's default device, cuda, is pinned by tests/test_torch_device.py."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from disinfect_slam_tpu.utils import kernel_verify as jkv
from disinfect_slam_tpu_torch.io.checkpoint import volume_to_numpy
from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint
from disinfect_slam_tpu_torch.utils import kernel_verify as kv

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "port_verify.py")


def test_verify_all_passes_on_the_cpu(capsys):
    assert kv.verify_all(device="cpu")
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[port_verify]")]
    assert len(lines) == len(kv.CHECKS) and all(" PASS " in ln for ln in lines)


@pytest.mark.parametrize("name", [name for name, _ in kv.CHECKS])
def test_each_check_fails_on_a_perturbed_input(name):
    fn = dict(kv.CHECKS)[name]
    ok, err, _ = fn(device="cpu", perturb=True)
    assert not ok and err > 0


def _raises(**_kw):
    raise RuntimeError("launch failed")


def test_an_exception_fails_the_gate_and_the_script(monkeypatch, capsys):
    monkeypatch.setattr(kv, "CHECKS", [("raises", _raises)] + kv.CHECKS[:1])
    assert not kv.verify_all(device="cpu")
    err = capsys.readouterr().err
    assert "FAIL  raises" in err and "PASS  sample_rows" in err
    spec = importlib.util.spec_from_file_location("port_verify", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr("sys.argv", ["port_verify.py", "--device", "cpu"])
    assert script.main() == 1
    monkeypatch.setattr(kv, "CHECKS", kv.CHECKS[1:])
    assert script.main() == 0


def _summary(arrays) -> dict:
    fp = volume_fingerprint(arrays)
    live = np.asarray(arrays["entry_block"]) >= 0
    rows = np.asarray(arrays["entry_block"])[live]
    fp["observed"] = int(((np.asarray(arrays["rgbw"])[rows].view(np.uint32) >> 24) > 0).sum())
    return fp


@pytest.mark.parametrize("sampler", ["gather", "pallas_fused"])
def test_small_scene_matches_jax(sampler):
    ours = _summary(volume_to_numpy(kv._small_scene_step(sampler, "cpu")))
    vol = jkv._small_scene_step("gather")
    ref = _summary({f: np.asarray(getattr(vol, f)) for f in (
        "entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")})
    assert ours["active_blocks"] > 100 and ours["observed"] > 10000
    for key, tol in (("active_blocks", 1e-3), ("observed", 1e-3), ("sum_abs_tsdf", 1e-4),
                     ("sum_weight", 1e-3), ("sum_prob", 1e-3)):
        assert abs(ours[key] - ref[key]) <= tol * abs(ref[key]), (key, ours[key], ref[key])
