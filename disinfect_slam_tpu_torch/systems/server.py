"""Reconstruction service: an HTTP front end over the DISINF / DenseSLAM
stack (counterpart of disinfect_slam_tpu/systems/server.py).

The analogue of the reference's ROS topic surface (ros_offline.cc
subscribers and publishers) for hosts without ROS: clients stream RGB-D
frames and pull poses, bbox voxel queries, meshes and rendered views.
Payloads are npz / numpy binary (stdlib http.server; reconstruction is
serialised by the TSDF queue anyway).

Endpoints:
  POST /frame   npz{rgb, depth, timestamp_ms[, ht, lt, pose]} -> {pose, ok}
  GET  /pose?t=MS                -> npz{pose}
  GET  /pose_json?t=MS           -> json{pose: [16 floats]}
  GET  /stats                    -> json
  GET  /query?bbox=x0,x1,y0,y1,z0,z1 -> npz{records [N,4]}
  GET  /query_json?bbox=...      -> json{count}
  GET  /mesh                     -> npz{verts, faces}
  GET  /render?fx=..&w=..&h=..[&pose=16csv&view=rgba|normal&fmt=png]
                                 -> npz{rgba, normal, depth} or image/png
  GET  / (or /view)              -> the browser viewer (arcball orbit,
                                    zoom, pan, follow-cam, Start/Pause/Step
                                    of the replay, bbox query: the
                                    renderer_module.cc:20-102 surface)
  GET  /ctrl?cmd=start|pause|step|status -> json replay status

/render is the splat renderer: on a CUDA volume the splat_zbuf_blocks and
splat_payload_blocks kernels, which raise if they cannot build or
launch; on a CPU volume their plain versions.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..io.png_io import encode_png
from ..ops.cuda.splat_kernel import splat_render_cuda
from ..ops.gather import BoundingCube, gather_voxels, to_numpy_records
from ..ops.mesh import extract_mesh_chunked, merge_vertices
from ..viz.viewer_html import VIEWER_HTML


class ReconstructionService:
    """Wraps a DISINFSystem (poses provided) or a DenseSLAM (self-tracking)
    behind frame-in / artifacts-out methods."""

    def __init__(self, system, mode: str = "disinf", auto_recenter: bool = False):
        self.system = system
        self.mode = mode
        self.auto_recenter = auto_recenter
        self._lock = threading.Lock()
        self.frames = 0

    def process_frame(self, rgb, depth, timestamp_ms, ht=None, lt=None, pose=None):
        with self._lock:
            self.frames += 1
            if self.mode == "slam":
                # the window follows at waypoint cadence (DISINFSystem
                # recenters on its own in disinf mode)
                if self.auto_recenter and self.frames % 30 == 0:
                    self.system.maybe_recenter()
                est, ok = self.system.process_frame(rgb, depth, ht, lt)
                return est.cpu().numpy(), bool(ok)
            if pose is not None:
                self.system.feed_pose(int(timestamp_ms), pose)
            # the POSTed ht / lt reach the fusion (the JAX service drops
            # them in this mode, though /frame takes them)
            self.system.feed_rgbd_frame(rgb, depth, int(timestamp_ms), ht=ht, lt=lt)
            return self.system.query_camera_pose(int(timestamp_ms)), True

    def pose(self, timestamp_ms):
        if self.mode == "slam":
            return np.linalg.inv(self.system.world_T_cam)
        return self.system.query_camera_pose(int(timestamp_ms))

    def _volume(self):
        if self.mode == "slam":
            return self.system.volume
        self.system.tsdf.flush()
        return self.system.tsdf.tsdf.snapshot()

    def _grid(self):
        return self.system if self.mode == "slam" else self.system.tsdf.tsdf

    def stats(self) -> dict:
        # drain the queue, then read the counter under the grid's lock,
        # without the full snapshot _volume() takes: stats is the
        # viewer's liveness probe
        if self.mode == "slam":
            vol = self.system.volume
            count = int(vol.num_active_blocks)
            vsz = vol.cfg.voxel_size
        else:
            self.system.tsdf.flush()
            grid = self.system.tsdf.tsdf
            count = grid.num_active_blocks()
            vsz = grid.cfg.voxel_size
        out = {"frames": self.frames, "active_blocks": count, "voxel_size": vsz,
               "mode": self.mode}
        store = self._grid().spill_store
        if store is not None:
            out["spilled_blocks"] = len(store)
            out["spilled_bytes"] = store.nbytes()
        return out

    def query(self, bbox: BoundingCube) -> np.ndarray:
        return to_numpy_records(gather_voxels(self._volume(), bbox))

    def mesh(self):
        return merge_vertices(extract_mesh_chunked(self._volume()))

    def render(self, fx, img_h, img_w, pose=None, max_depth=10.0):
        """The splat render of a virtual camera (focal fx, centred) ->
        numpy (rgba, normal, depth)."""
        if pose is None:
            pose = self.pose(0)
        cam = CameraParams.create(
            CameraIntrinsics.create(fx, fx, (img_w - 1) / 2, (img_h - 1) / 2), img_h, img_w)
        res = splat_render_cuda(self._volume(), cam, SE3.from_matrix(np.asarray(pose)),
                                max_depth)
        return res.rgba.cpu().numpy(), res.normal.cpu().numpy(), res.depth.cpu().numpy()


class ReplayDriver:
    """Start / Pause / Step control over a frame replay feeding the service
    (the offline.cc:139-155 Start/Pause loop, controllable over HTTP).

    `frames` is a sequence of (rgb, depth, timestamp_ms, ht, lt, pose)
    tuples (ht, lt and pose may be None).  fps > 0 throttles playback."""

    def __init__(self, service: ReconstructionService, frames, fps: float = 0.0):
        self.service = service
        self.frames = list(frames)
        self.fps = fps
        self.idx = 0
        self._playing = threading.Event()
        self._steps = 0
        self._stop = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            with self._lock:
                want = self._playing.is_set() or self._steps > 0
                if want and self._steps > 0:
                    self._steps -= 1
            if not want or self.idx >= len(self.frames):
                time.sleep(0.05)
                continue
            rgb, depth, ts, ht, lt, pose = self.frames[self.idx]
            t0 = time.perf_counter()
            self.service.process_frame(rgb, depth, ts, ht, lt, pose)
            self.idx += 1
            if self.fps > 0:
                budget = 1.0 / self.fps - (time.perf_counter() - t0)
                if budget > 0:
                    time.sleep(budget)

    def start(self):
        self._playing.set()

    def pause(self):
        self._playing.clear()

    def step(self):
        with self._lock:
            self._steps += 1

    def shutdown(self):
        self._stop = True
        self._playing.clear()

    def status(self) -> dict:
        return {"playing": self._playing.is_set(), "frame": self.idx,
                "total": len(self.frames), "done": self.idx >= len(self.frames)}


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def make_server(service: ReconstructionService, host="127.0.0.1", port=0,
                replay: "ReplayDriver | None" = None) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._send(200, json.dumps(obj).encode(), "application/json")

        def do_POST(self):
            if urlparse(self.path).path != "/frame":
                return self._send(404, b"not found", "text/plain")
            n = int(self.headers.get("Content-Length", 0))
            data = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
            pose, ok = service.process_frame(
                data["rgb"], data["depth"], int(data["timestamp_ms"]),
                data["ht"] if "ht" in data else None,
                data["lt"] if "lt" in data else None,
                data["pose"] if "pose" in data else None,
            )
            self._send(200, _npz_bytes(pose=pose, ok=np.asarray(ok)))

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path in ("/", "/view"):
                self._send(200, VIEWER_HTML.encode(), "text/html; charset=utf-8")
            elif url.path == "/stats":
                stats = service.stats()
                if replay is not None:
                    stats["replay"] = replay.status()
                self._json(stats)
            elif url.path == "/ctrl":
                if replay is None:
                    return self._send(400, b'{"error": "no replay attached"}',
                                      "application/json")
                cmd = q.get("cmd", ["status"])[0]
                if cmd == "start":
                    replay.start()
                elif cmd == "pause":
                    replay.pause()
                elif cmd == "step":
                    replay.step()
                self._json(replay.status())
            elif url.path == "/pose":
                self._send(200, _npz_bytes(pose=service.pose(int(q.get("t", ["0"])[0]))))
            elif url.path == "/pose_json":
                pose = np.asarray(service.pose(int(q.get("t", ["0"])[0])), np.float64)
                self._json({"pose": [float(x) for x in pose.reshape(-1)]})
            elif url.path in ("/query", "/query_json"):
                rec = service.query(BoundingCube(*(float(x) for x in q["bbox"][0].split(","))))
                if url.path == "/query":
                    self._send(200, _npz_bytes(records=rec))
                else:
                    self._json({"count": int(len(rec))})
            elif url.path == "/mesh":
                verts, faces = service.mesh()
                self._send(200, _npz_bytes(verts=verts, faces=faces))
            elif url.path == "/render":
                fx = float(q.get("fx", ["525"])[0])
                w = int(q.get("w", ["640"])[0])
                h = int(q.get("h", ["360"])[0])
                pose = None
                if "pose" in q:
                    pose = np.asarray([float(x) for x in q["pose"][0].split(",")],
                                      np.float32).reshape(4, 4)
                rgba, normal, depth = service.render(fx, h, w, pose=pose)
                if q.get("fmt", ["npz"])[0] == "png":
                    img = rgba if q.get("view", ["normal"])[0] == "rgba" else normal
                    self._send(200, encode_png(img), "image/png")
                else:
                    self._send(200, _npz_bytes(rgba=rgba, normal=normal, depth=depth))
            else:
                self._send(404, b"not found", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)
