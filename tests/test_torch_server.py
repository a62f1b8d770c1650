"""PyTorch port, the reconstruction service (systems/server.py) on the
CPU: an HTTP roundtrip over every route on port 0; /query and /render
against the JAX package's service on the same frame; the viewer page
against the JAX package's string; the replay driver's start, pause and
step; the orbit scene against bench.py's generator."""

import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from disinfect_slam_tpu.systems.disinf_system import DISINFSystem as JSystem
from disinfect_slam_tpu.systems.server import ReconstructionService as JService
from disinfect_slam_tpu.systems.server import make_server as j_make_server
from disinfect_slam_tpu.viz.viewer_html import VIEWER_HTML as J_VIEWER_HTML
from disinfect_slam_tpu_torch.io.orbit_scene import make_orbit_frames
from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem
from disinfect_slam_tpu_torch.systems.server import (
    ReconstructionService,
    ReplayDriver,
    make_server,
)
from disinfect_slam_tpu_torch.viz.viewer_html import VIEWER_HTML

from .scenes import look_at, render_wall
from .test_integrate import CFG_DENSE, H, K, W
from .test_torch_hash import port_arrays, port_cfg, port_from_jax
from .test_torch_integrate import assert_matches_jax

torch.set_num_threads(1)

POSE = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0)).astype(np.float32)
DEPTH = render_wall(W, H, K, POSE, wall_z=2.0131)
RGB = np.full((H, W, 3), 120, np.float32)
SYS = dict(depth_factor=1.0, voxel_size=0.05, truncation=0.15, half_scale=False)


def _post_npz(url, **arrays):
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()))


def _get(url, raw=False):
    with urllib.request.urlopen(url, timeout=240) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type")
    if raw:
        return body, ctype
    if ctype == "application/json":
        return json.loads(body)
    return np.load(io.BytesIO(body))


class _Served:
    """A service on 127.0.0.1 at a free port, served by a thread."""

    def __init__(self, svc, maker=make_server, replay=None):
        self.httpd = maker(svc, replay=replay)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def __enter__(self):
        return self.base

    def __exit__(self, *a):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_http_roundtrip_every_route():
    """POST a frame, then every GET route of the service on the CPU."""
    with DISINFSystem(K, cfg=port_cfg(CFG_DENSE), device="cpu", **SYS) as system:
        with _Served(ReconstructionService(system)) as base:
            out = _post_npz(f"{base}/frame", rgb=RGB, depth=DEPTH,
                            timestamp_ms=np.asarray(0), pose=POSE)
            assert bool(out["ok"])
            np.testing.assert_allclose(out["pose"], POSE, atol=1e-5)
            stats = _get(f"{base}/stats")
            assert stats["frames"] == 1 and stats["active_blocks"] > 10
            assert stats["mode"] == "disinf" and "spilled_blocks" not in stats
            np.testing.assert_allclose(_get(f"{base}/pose?t=0")["pose"], POSE, atol=1e-5)
            assert len(_get(f"{base}/pose_json?t=0")["pose"]) == 16
            rec = _get(f"{base}/query?bbox=-2,2,-2,2,0,3")["records"]
            assert rec.shape[1] == 4 and len(rec) > 100
            assert _get(f"{base}/query_json?bbox=-2,2,-2,2,0,3")["count"] == len(rec)
            mesh = _get(f"{base}/mesh")
            assert len(mesh["verts"]) > 50 and len(mesh["faces"]) > 50
            r = _get(f"{base}/render?fx=52.7&w=64&h=48")
            assert r["rgba"].shape == (48, 64, 4) and (r["depth"] > 0).mean() > 0.1
            csv = ",".join(str(float(x)) for x in POSE.ravel())
            png, ctype = _get(f"{base}/render?fx=52.7&w=64&h=48&fmt=png&pose={csv}", raw=True)
            assert ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
            page, ctype = _get(f"{base}/", raw=True)
            assert ctype.startswith("text/html") and page.decode() == VIEWER_HTML
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"{base}/ctrl?cmd=start")
            assert e.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"{base}/nothing")
            assert e.value.code == 404


def test_query_and_render_match_the_jax_service():
    """The same frame POSTed to the JAX service and to the port's: the
    fused volumes within test_torch_integrate.py's limits; then, with the
    port's service holding the JAX volume, /query returns the same records
    and /render (the splat) the same rgba, normal and depth, bit for bit."""
    with JSystem(K, cfg=CFG_DENSE, **SYS) as jsys, \
            DISINFSystem(K, cfg=port_cfg(CFG_DENSE), device="cpu", **SYS) as tsys:
        with _Served(JService(jsys), j_make_server) as jbase, \
                _Served(ReconstructionService(tsys)) as tbase:
            for base in (jbase, tbase):
                _post_npz(f"{base}/frame", rgb=RGB, depth=DEPTH, timestamp_ms=np.asarray(0),
                          pose=POSE)
            jsys.tsdf.flush()
            tsys.tsdf.flush()
            jgrid, tgrid = jsys.tsdf.tsdf, tsys.tsdf.tsdf
            assert_matches_jax(tgrid.volume, jgrid.volume)
            tgrid.volume = port_from_jax(jgrid.volume)
            q = "bbox=-2,2,-1.5,2,0,3"
            ours, ref = (_get(f"{b}/query?{q}")["records"] for b in (tbase, jbase))
            assert len(ref) > 100
            np.testing.assert_array_equal(ours, ref)
            r = "render?fx=52.7&w=64&h=48"
            ours, ref = (_get(f"{b}/{r}") for b in (tbase, jbase))
            assert (ref["depth"] > 0).mean() > 0.1
            for k in ("rgba", "normal", "depth"):
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_posted_semantics_are_dropped_as_the_jax_service_drops_them():
    """Frames POSTed with ht / lt and a pose to the JAX service and to the
    port's, each over a DISINFSystem: both drop the semantics (disinf
    mode), so the two served volumes agree within
    test_torch_integrate.py's limits, and the port's equals a grid fed
    the same frames with ht = lt = None, bit for bit."""
    from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

    rng = np.random.default_rng(6)
    frames = []
    for i in range(3):
        pose = look_at((0.01 + 0.03 * i, 0.02, -0.01), (0.04, -0.03, 2.0)).astype(np.float32)
        ht = rng.uniform(0.05, 0.95, (H, W)).astype(np.float32)
        frames.append((pose, render_wall(W, H, K, pose, wall_z=2.0131), ht, 1 - ht))
    cfg = port_cfg(CFG_DENSE)
    grid = TSDFGrid(0.05, 0.15, cfg=cfg, device="cpu")
    with JSystem(K, cfg=CFG_DENSE, **SYS) as jsys, \
            DISINFSystem(K, cfg=cfg, device="cpu", **SYS) as tsys:
        with _Served(JService(jsys), j_make_server) as jbase, \
                _Served(ReconstructionService(tsys)) as tbase:
            for i, (pose, depth, ht, lt) in enumerate(frames):
                for base in (jbase, tbase):
                    _post_npz(f"{base}/frame", rgb=RGB, depth=depth,
                              timestamp_ms=np.asarray(i), ht=ht, lt=lt, pose=pose)
                grid.integrate(RGB, depth, None, None, 4.0, K, pose)
            assert _get(f"{tbase}/stats")["frames"] == 3
            jsys.tsdf.flush()
            tsys.tsdf.flush()
            assert_matches_jax(tsys.tsdf.tsdf.volume, jsys.tsdf.tsdf.volume)
            served = port_arrays(tsys.tsdf.tsdf.volume)
    ref = port_arrays(grid.volume)
    assert (ref["entry_block"] >= 0).sum() > 10
    for f in ref:
        np.testing.assert_array_equal(served[f], ref[f], err_msg=f)


def test_viewer_page_is_the_jax_string():
    assert VIEWER_HTML == J_VIEWER_HTML


def test_replay_driver_start_pause_step():
    """Step one frame, play out the rest, pause: the driver feeds the
    service each frame once, in order, and /ctrl and /stats report it."""
    frames = [(RGB, DEPTH, i * 33, None, None, POSE) for i in range(3)]
    with DISINFSystem(K, cfg=port_cfg(CFG_DENSE), device="cpu", **SYS) as system:
        svc = ReconstructionService(system)
        replay = ReplayDriver(svc, frames)
        try:
            with _Served(svc, replay=replay) as base:
                assert _get(f"{base}/ctrl?cmd=step")["total"] == 3
                for _ in range(300):
                    if _get(f"{base}/ctrl?cmd=status")["frame"] >= 1:
                        break
                    time.sleep(0.05)
                time.sleep(0.2)  # a paused driver takes no second frame
                st = _get(f"{base}/ctrl?cmd=status")
                assert st["frame"] == 1 and not st["playing"]
                assert _get(f"{base}/ctrl?cmd=start")["playing"]
                for _ in range(600):
                    if _get(f"{base}/ctrl?cmd=status")["done"]:
                        break
                    time.sleep(0.05)
                assert not _get(f"{base}/ctrl?cmd=pause")["playing"]
                stats = _get(f"{base}/stats")
                assert stats["frames"] == 3 and stats["replay"]["done"]
                assert stats["active_blocks"] > 10
        finally:
            replay.shutdown()


def test_orbit_scene_matches_bench():
    """apps.serve --synthetic's frames equal bench.py's generator's."""
    import bench

    k = (52.7, 53.3, 31.71, 23.43)
    ours, ref = make_orbit_frames(3, 64, 48, k), bench.make_orbit_frames(3, 64, 48, k)
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
