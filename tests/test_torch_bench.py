"""PyTorch port, the benchmark (apps/bench.py, bench_torch.py and the
scripts/port_bench_*.py scripts) on the CPU: the JSON line's contract,
the bench's fusion loop against the JAX package's integrate jitted as
bench.py jits it (by volume fingerprint, within PERF.md §2's limits), the
frame sources against bench.py's, bit for bit, the reference check, and
the three scripts at tiny sizes."""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.config import TSDFConfig as JConfig
from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.ops.gather import gather_valid as j_gather_valid
from disinfect_slam_tpu.ops.integrate import FrameInput as JFrame
from disinfect_slam_tpu.ops.integrate import integrate as j_integrate
from disinfect_slam_tpu_torch.apps import bench as tbench
from disinfect_slam_tpu_torch.config import BENCH_MAX_DEPTH, TINY_DENSE
from disinfect_slam_tpu_torch.core.geometry import CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.io.orbit_scene import make_orbit_frames
from disinfect_slam_tpu_torch.io.png_io import write_image
from disinfect_slam_tpu_torch.ops.gather import fingerprint_gaps, volume_fingerprint

from .test_torch_hash import jax_arrays, port_cfg

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import bench as jbench  # noqa: E402

KEYS = ["metric", "value", "unit", "vs_baseline", "platform", "img", "voxel_m", "online_fps",
        "online_fps_fast", "stereo_ms", "fallback", "dataset"]
CPU = torch.device("cpu")


def test_bench_json_line_on_the_cpu(monkeypatch, capsys):
    """main(["--device", "cpu"]) at bench_contract's counts: the last
    stdout line has bench.py's twelve keys, in its order, with the CPU's
    values; no hand kernel launches on the CPU."""
    for k, v in (("FRAMES", "4"), ("RAYCAST", "0"), ("SEG_ITERS", "2"), ("STEREO_ITERS", "1")):
        monkeypatch.setenv(f"DSTPU_BENCH_{k}", v)
    res = tbench.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    payload = json.loads(out[-1])
    assert list(payload) == KEYS
    assert payload == {k: res[k] for k in KEYS}
    assert payload["metric"] == "tsdf_fusion_fps" and payload["unit"] == "frames/s"
    assert payload["platform"] == "cpu" and payload["vs_baseline"] is None
    assert payload["fallback"] is False
    assert payload["value"] > 0 and payload["stereo_ms"] > 0
    assert isinstance(payload["online_fps"], float) and payload["online_fps"] > 0
    assert payload["online_fps_fast"] is None
    assert payload["img"] == "160x120" and payload["voxel_m"] == 0.004
    assert payload["dataset"] == "synthetic-orbit (TUM rgbd_1 unavailable: no egress)"
    stages = res["stages"]
    assert stages["frames"] == 4 and stages["raycast_ms"] is None
    assert stages["splat_ms"] > 0 and stages["seg_ms"] > 0 and stages["seg_dev_ms"] > 0
    assert not stages["held_to_reference"] and stages["self_check_launches"] == {}
    assert all(n == 0 for s in stages["launches"].values() for n in s.values())
    assert set(stages["launches"]) == {"fusion", "fusion eager", "splat", "splat eager",
                                       "online unet", "online unet eager", "seg", "stereo"}
    assert stages["fusion_eager_fps"] > 0 and stages["splat_eager_ms"] > 0
    assert stages["online_eager_fps"]["unet"] > 0


# bench.py's CPU branch (bench.py:227-262), as it builds its config
J_CPU_CFG = JConfig(
    voxel_size=0.004, truncation=0.024, num_buckets_log2=14, num_blocks_log2=12,
    max_candidates=8192, max_visible=4096, max_new_per_round=2048, max_probe=16,
    sampler_splits=2, alloc_stride=1, alloc_every=1, scatter_window_log2=-1)


def test_bench_cpu_branch_is_bench_py_s():
    cfg, max_depth, w, h, k, n = tbench.bench_setup(CPU)
    assert cfg == port_cfg(J_CPU_CFG) == tbench.CPU_CFG
    assert (max_depth, w, h, k, n) == (4.0, 160, 120, (131.3, 131.3, 79.9, 59.9), 6)


def test_bench_fusion_matches_jax_by_fingerprint():
    """The bench's timed loop over 4 synthetic frames at the CPU branch
    against the JAX integrate jitted as bench.py jits it, on the same
    frames: blocks and records within 0.1%, sum |tsdf| 1e-4, sum weight
    and sum prob 1e-3 relative (XLA:CPU contracts FMAs, so voxels at
    half-pixel ties can take the other pixel: a fingerprint, never voxel
    by voxel)."""
    w, h, k = tbench.CPU_W, tbench.CPU_H, tbench.CPU_K
    frames = make_orbit_frames(4, w, h, k)
    cam = CameraParams.create(CameraIntrinsics.create(*k), h, w)
    vol, fps = tbench.time_fusion(tbench.CPU_CFG, cam, tbench.stage_frames(frames, CPU),
                                  BENCH_MAX_DEPTH, CPU)
    assert fps > 0
    port = tbench.volume_summary(vol)

    jcam = JCam.create(JIntr.create(*k), h, w)
    step = jax.jit(lambda v, f, m: j_integrate(v, f, jcam, JSE3.from_matrix(m), BENCH_MAX_DEPTH),
                   donate_argnums=0)
    jvol = JVolume.create(J_CPU_CFG)
    for pose, rgb, depth, ht, lt in frames:
        fr = JFrame(*(jax.device_put(a) for a in (rgb, depth, ht, lt)))
        jvol = step(jvol, fr, jax.device_put(pose))
    ref = volume_fingerprint(jax_arrays(jvol))
    ref["records"] = int(j_gather_valid(jvol).count)
    assert ref["active_blocks"] > 100
    gaps = fingerprint_gaps(port, ref)
    assert all(d <= tol for d, tol in gaps.values()), gaps


def test_reference_check_holds_the_limits(capsys):
    """check_reference passes the reference itself and exits on a sum
    |tsdf| 2e-4 off (its limit 1e-4)."""
    with open(tbench.FINGERPRINT) as f:
        ref = json.load(f)
    tbench.check_reference(dict(ref), ref)
    with pytest.raises(SystemExit, match="sum_abs_tsdf"):
        tbench.check_reference({**ref, "sum_abs_tsdf": ref["sum_abs_tsdf"] * (1 + 2e-4)}, ref)


def _write_tum(seq, h=480, w=640, n=12):
    """tests/test_bench_contract.py's synthetic TUM sequence, written with
    the port's PNG writer."""
    rng = np.random.default_rng(3)
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(n):
        t = 1305031102.0 + 0.033 * i
        write_image(str(seq / "rgb" / f"{t:.6f}.png"),
                    rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        write_image(str(seq / "depth" / f"{t:.6f}.png"),
                    (rng.uniform(0.5, 3.0, (h, w)) * 5000).astype(np.uint16))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t + 0.004:.6f} depth/{t:.6f}.png")
        gt_lines.append(f"{t + 0.002:.6f} {0.01 * i:.4f} 0 0 0 0 0 1")
    (seq / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_lines) + "\n")
    (seq / "depth.txt").write_text("# d\n" + "\n".join(depth_lines) + "\n")
    (seq / "groundtruth.txt").write_text("# gt\n" + "\n".join(gt_lines) + "\n")


def _assert_same_frames(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert len(fa) == len(fb) == 5
        for x, y in zip(fa, fb):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_tum_autodetect_matches_bench_py(tmp_path, monkeypatch):
    seq = tmp_path / "rgbd_dataset_freiburg1_test"
    _write_tum(seq)
    monkeypatch.setenv("DSTPU_TUM_DIR", str(seq))
    ours, ref = tbench.load_tum_frames(10, 640, 480), jbench.load_tum_frames(10, 640, 480)
    assert ours[1] == ref[1] == "rgbd_dataset_freiburg1_test"
    _assert_same_frames(ours[0], ref[0])
    assert abs(ours[0][5][0][0, 3] - (-0.05)) < 1e-4
    # the wrong shape: no sequence
    assert tbench.load_tum_frames(10, 320, 240) is None
    assert jbench.load_tum_frames(10, 320, 240) is None


def test_replay_frames_match_bench_py():
    ours = tbench.load_replay_frames(3, 640, 480)
    _assert_same_frames(ours, jbench.load_replay_frames(3, 640, 480))
    assert tbench.load_replay_frames(3, 320, 240) is None
    frames, dataset = tbench.bench_frames(3, 640, 480, tbench.K, on_card=True)
    assert dataset.startswith("orbit_vga (checked-in logged replay")
    _assert_same_frames(frames, ours)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY_K = (52.7, 53.3, 31.71, 23.43)
TINY_CFG = dataclasses.replace(TINY_DENSE, voxel_size=0.05, truncation=0.15,
                               max_candidates=2048, max_visible=256, max_new_per_round=512)
SCRIPTS = {
    "port_bench_dense_slam": (
        lambda m, d: m.run("cpu", n_frames=5, w=64, h=48, K=TINY_K, cfg=TINY_CFG),
        ["backend=cpu (cpu) track_scale=1", "dense_slam steady state: "]),
    "port_bench_mesh": (
        lambda m, d: m.run("cpu", n_frames=2, w=64, h=48, K=TINY_K, cfg=TINY_CFG,
                           obj_path=str(d / "mesh.obj")),
        ["device cpu (cpu)", "populating volume (2 frames)...", "active blocks: ",
         "extract_mesh_chunked[f32]: ", "extract_mesh_chunked[q16]: ", "full-volume OBJ: ",
         "2 m-bbox query: "]),
    "port_bench_stereo": (
        lambda m, d: m.run("cpu", sizes=((24, 32, 8), (32, 48, 16)), iters=2),
        ["device cpu (cpu)", "32x24, 8 disparities", "flat      : ", "pyr L1 B2 : ",
         "pyr L1 B3 : ", "pyr L2 B2 : ", "pyr L2 B3 : ", "48x32, 16 disparities"]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_port_bench_script_prints_its_lines(name, tmp_path, capsys):
    call, starts = SCRIPTS[name]
    res = call(_script(name), tmp_path)
    lines = capsys.readouterr().out.splitlines()
    for s in starts:
        assert any(line.startswith(s) for line in lines), (s, lines)
    if name == "port_bench_dense_slam":
        assert res["frames"] == 2 and res["lost"] == 0 and res["ms_per_frame"] > 0
    elif name == "port_bench_mesh":
        assert res["f32"] > 0 and res["obj"] > 0 and not (tmp_path / "mesh.obj").exists()
    else:
        assert len(res) == 2 and all(len(r) == 5 for r in res.values())
