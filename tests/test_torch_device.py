"""PyTorch port, devices and the import guarantee: every engine object,
loader and app of the port runs on the CUDA device unless the caller asks
for the CPU, so without CUDA each of them called without a device raises
(the apps exit non-zero) naming CUDA; no module of the port, nor
chip_smoke.py, bench_torch.py or the port's scripts, imports JAX, the
JAX package, cv2 or bench.py; and the
host modules the port restates equal the JAX package's."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from disinfect_slam_tpu_torch.apps import serve
from disinfect_slam_tpu_torch.config import TINY_DENSE
from disinfect_slam_tpu_torch.core.state import TSDFVolume
from disinfect_slam_tpu_torch.io.config_reader import load_yaml
from disinfect_slam_tpu_torch.io.zed_calib import rectifier_from_factory_conf
from disinfect_slam_tpu_torch.io.checkpoint import load_volume, volume_from_numpy, volume_to_numpy
from disinfect_slam_tpu_torch.models.segmentation import create_model, load_model
from disinfect_slam_tpu_torch.models.train import (create_train_state, make_eval_step,
                                                   make_train_step)
from disinfect_slam_tpu_torch.ops.image_ops import StereoRectifier
from disinfect_slam_tpu_torch.ops.stereo import StereoDepthEstimator
from disinfect_slam_tpu_torch.ops.gather import volume_from_spatial_records
from disinfect_slam_tpu_torch.parallel.seg_parallel import (make_mesh_2d, make_sharded_infer,
                                                            make_sharded_train_step)
from disinfect_slam_tpu_torch.parallel.sharding import DistributedTSDF, load_distributed, make_mesh
from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM
from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem
from disinfect_slam_tpu_torch.systems.loop_closure import LoopClosureManager
from disinfect_slam_tpu_torch.systems.odometry import ICPOdometry
from disinfect_slam_tpu_torch.systems.slam import ICPSource
from disinfect_slam_tpu_torch.systems.online_step import FusedOnlineStep
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid
from disinfect_slam_tpu_torch.systems.tsdf_system import TSDFSystem
from disinfect_slam_tpu_torch.utils.kernel_verify import verify_all

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = (52.7, 53.3, 31.71, 23.43)
CFG = dataclasses.replace(TINY_DENSE, voxel_size=0.05, truncation=0.15)

def _model_opt(state):
    return state.model, state.opt


def _unet():
    return create_model(widths=(8, 16, 16, 16))


def _card_mesh():
    """A 2x2 mesh of the one card, built without asking for CUDA."""
    return make_mesh_2d(devices=[torch.device("cuda", 0)] * 4)


DEFAULT_DEVICE_CALLS = {
    "TSDFGrid": lambda: TSDFGrid(0.05, 0.15, cfg=CFG),
    "TSDFGrid(host_spill)": lambda: TSDFGrid(0.05, 0.15, cfg=CFG, host_spill=True),
    # the service as apps.serve builds it, over a DISINFSystem
    "ReconstructionService": lambda: serve.build(serve.parse_args(["--port", "0"])),
    "DenseSLAM(host_spill)": lambda: DenseSLAM(K, 48, 64, cfg=CFG, host_spill=True),
    "TSDFSystem": lambda: TSDFSystem(0.05, 0.15, 4.0, K, cfg=CFG),
    "DISINFSystem": lambda: DISINFSystem(K, cfg=CFG),
    "FusedOnlineStep": lambda: FusedOnlineStep(CFG, K, 48, 64, 4.0),
    "load_model": lambda: load_model("fast"),
    # the device is resolved before the file is opened
    "load_volume": lambda: load_volume(str(ROOT / "no_such_checkpoint.npz")),
    "TSDFVolume.create": lambda: TSDFVolume.create(CFG),
    "volume_from_numpy": lambda: volume_from_numpy(
        volume_to_numpy(TSDFVolume.create(CFG, device="cpu")), CFG),
    "volume_from_spatial_records": lambda: volume_from_spatial_records(
        np.array([[0.0, 0.0, 0.0, 0.5], [0.05, 0.0, 0.0, -0.5]], np.float32)),
    "DenseSLAM": lambda: DenseSLAM(K, 48, 64, cfg=CFG),
    "ICPOdometry": lambda: ICPOdometry(K, 48, 64),
    "ICPSource": lambda: ICPSource(K, 48, 64),
    "LoopClosureManager": lambda: LoopClosureManager(K, 48, 64),
    "create_train_state": lambda: create_train_state(widths=(8, 16, 16, 16)),
    "DistributedTSDF": lambda: DistributedTSDF(CFG),
    "DistributedTSDF(cuda mesh)": lambda: DistributedTSDF(CFG, ["cuda:0"] * 2),
    "make_mesh": lambda: make_mesh(1),
    # the mesh is resolved before the file is opened
    "load_distributed": lambda: load_distributed(str(ROOT / "no_such_checkpoint.npz"),
                                                 cfg=CFG),
    "StereoDepthEstimator": lambda: StereoDepthEstimator(100.0, 0.12),
    "StereoRectifier.from_yaml": lambda: StereoRectifier.from_yaml(
        load_yaml(str(ROOT / "configs" / "zed_native_stereo.yaml"))),
    # the device is resolved before the file is read
    "rectifier_from_factory_conf": lambda: rectifier_from_factory_conf(
        str(ROOT / "no_such_calibration.conf"), "VGA"),
    "make_mesh_2d": lambda: make_mesh_2d(),
    # the captured steps: the train and eval steps on a state a user makes
    # without a device, the sharded ones on a mesh of the card
    "make_train_step(capture=True)": lambda: make_train_step(
        *_model_opt(create_train_state(widths=(8, 16, 16, 16))), capture=True),
    "make_eval_step(capture=True)": lambda: make_eval_step(
        create_train_state(widths=(8, 16, 16, 16)).model, capture=True),
    "make_sharded_train_step(capture=True)": lambda: make_sharded_train_step(
        _unet(), {}, _card_mesh(), capture=True),
    "make_sharded_infer(capture=True)": lambda: make_sharded_infer(
        _unet(), _card_mesh(), capture=True),
    "verify_all": lambda: verify_all(verbose=False),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_default_device_is_cuda(monkeypatch, name):
    """Called without a device on a host without CUDA, each raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DEFAULT_DEVICE_CALLS[name]()


APP_ARGS = {
    "tsdf2mesh": lambda d: [str(d / "data.bin"), str(d / "out.ply")],
    "serve": lambda d: ["--port", "0", "--synthetic", "2"],
    "view_volume": lambda d: ["--volume", str(d / "vol.npz"), "--out", str(d / "views")],
    "train_seg": lambda d: ["--steps", "1", "--out", str(d / "seg.npz")],
    "bench": lambda d: [],
}


@pytest.mark.parametrize("app", ["offline", "online", "tsdf2mesh", "dense_slam", "serve",
                                 "view_volume", "train_seg", "bench"])
def test_apps_without_device_exit_nonzero_naming_cuda(app, tmp_path):
    """The CLI as a user runs it, with CUDA hidden and no --device: it
    stops with a non-zero exit code and says that CUDA is missing."""
    args = APP_ARGS.get(app, lambda d: ["--logdir", str(d)])(tmp_path)
    code = (
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = ['{app}', *{args!r}]\n"
        f"runpy.run_module('disinfect_slam_tpu_torch.apps.{app}', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr[-2000:]


def test_evaluate_app_needs_no_device(tmp_path):
    """apps.evaluate scores trajectory files on the host: with CUDA hidden
    it runs to its end (exit 0) and uses no device."""
    rows = "".join(f"{i} 1 0 0 {0.01 * i} 0 1 0 0 0 0 1 {0.002 * i * i}\n" for i in range(6))
    for name in ("gt.txt", "est.txt"):
        (tmp_path / name).write_text(rows)
    code = (
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = ['evaluate', '{tmp_path / 'gt.txt'}', '{tmp_path / 'est.txt'}']\n"
        "runpy.run_module('disinfect_slam_tpu_torch.apps.evaluate', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"pairs": 6' in proc.stdout


# an import statement of jax, flax, optax, msgpack, cv2, the JAX package
# (not of the port, whose name only starts like it) or the repo's bench.py
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|flax|optax|msgpack|cv2|disinfect_slam_tpu|bench)"
    r"(?:\.|\s|,|$)", re.M)


def test_forbidden_import_pattern():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "    from disinfect_slam_tpu.ops import integrate",
                 "import disinfect_slam_tpu", "from flax import linen", "import bench",
                 "    from bench import make_orbit_frames", "import optax",
                 "    import msgpack", "from flax.serialization import to_bytes",
                 "    import cv2", "from cv2 import remap"):
        assert FORBIDDEN_IMPORT.search(line), line
    for line in ("from disinfect_slam_tpu_torch.ops import integrate",
                 "import disinfect_slam_tpu_torch", "import jaxtyping_free",
                 "# no jax here", "import benchmark_tools", "import cv2x"):
        assert not FORBIDDEN_IMPORT.search(line), line


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "disinfect_slam_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "scripts" / "port_verify.py"]
    files += [ROOT / "scripts" / f"port_bench_{s}.py" for s in ("dense_slam", "mesh", "stereo")]
    assert len(files) > 30
    # the export and tracking slices' modules are among them
    for mod in ("ops/mesh.py", "systems/bridge.py", "apps/tsdf2mesh.py", "ops/gather.py",
                "ops/hash.py", "systems/odometry.py", "systems/dense_slam.py",
                "systems/loop_closure.py", "systems/slam.py", "systems/imu.py",
                "utils/trajectory_eval.py", "apps/dense_slam.py", "apps/evaluate.py",
                "systems/block_streaming.py", "systems/server.py", "viz/viewer_html.py",
                "utils/validate.py", "io/dataset.py", "io/orbit_scene.py", "apps/serve.py",
                "apps/view_volume.py", "models/train.py", "models/synth_data.py",
                "apps/train_seg.py", "io/flax_msgpack.py", "parallel/sharding.py",
                "io/sync.py", "io/logger.py", "io/cameras.py", "native/runtime.py",
                "io/zed_calib.py", "ops/image_ops.py", "ops/stereo.py",
                "parallel/seg_parallel.py", "utils/kernel_verify.py", "apps/bench.py",
                "utils/graphs.py"):
        assert ROOT / "disinfect_slam_tpu_torch" / mod in files, mod
    bad = {}
    for path in files:
        hits = FORBIDDEN_IMPORT.findall(path.read_text())
        if hits:
            bad[str(path.relative_to(ROOT))] = hits
    assert not bad, bad


def test_stereo_slice_runs_without_jax_or_cv2(tmp_path):
    """The stereo slice in a process where jax, the JAX package and cv2
    cannot be imported: the rectifier of a factory calibration, its remap,
    both matchers and the online app's module."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'disinfect_slam_tpu', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "import disinfect_slam_tpu_torch.apps.online\n"
        "from disinfect_slam_tpu_torch.io.zed_calib import rectifier_from_factory_conf\n"
        "from disinfect_slam_tpu_torch.ops.stereo import StereoDepthEstimator\n"
        "from tests.torch_cases import ZED_FACTORY_CONF\n"
        f"path = {str(tmp_path / 'SN1.conf')!r}\n"
        "open(path, 'w').write(ZED_FACTORY_CONF)\n"
        "rect = rectifier_from_factory_conf(path, 'VGA', device='cpu')\n"
        "img = np.random.default_rng(0).uniform(0, 255, (376, 672)).astype(np.float32)\n"
        "l, r = rect.rectify(img, np.roll(img, -5, 1))\n"
        "for m in ('flat', 'pyramid'):\n"
        "    est = StereoDepthEstimator(rect.rectified_intrinsics()[0], 0.12, max_disp=16,\n"
        "                               method=m, device='cpu')\n"
        "    assert est(l[:96, :160], r[:96, :160]).shape == (96, 160)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_zed_calib_restated_matches_jax(tmp_path):
    """io/zed_calib.py is a restatement of the JAX package's jax-free
    module: the same resolutions, Rodrigues matrices bit for bit, and the
    same parse of a factory file."""
    from disinfect_slam_tpu.io import zed_calib as jzc
    from disinfect_slam_tpu_torch.io import zed_calib as tzc

    from .torch_cases import ZED_FACTORY_CONF

    assert tzc.RESOLUTIONS == jzc.RESOLUTIONS
    assert tzc.FactoryCalib._fields == jzc.FactoryCalib._fields
    rng = np.random.default_rng(8)
    for rvec in [np.zeros(3), np.full(3, 1e-13), *rng.normal(0, 0.5, (20, 3))]:
        np.testing.assert_array_equal(tzc._rodrigues(rvec), jzc._rodrigues(rvec))
    conf = tmp_path / "SN1.conf"
    conf.write_text(ZED_FACTORY_CONF)
    for res in ("VGA", "HD"):  # HD: its sections and keys missing, read as 0
        a, b = tzc.parse_factory_conf(str(conf), res), jzc.parse_factory_conf(str(conf), res)
        for f in jzc.FactoryCalib._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
