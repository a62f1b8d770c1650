"""The reconstruction HTTP service and its browser viewer on the PyTorch
port (counterpart of apps/serve.py).

  python -m disinfect_slam_tpu_torch.apps.serve --port 8800 --mode slam --voxel 0.01
  # clients: POST /frame npz{rgb, depth, timestamp_ms[, ht, lt, pose]},
  #          GET /stats /pose /query /mesh /render

With a replay attached, http://host:port/ serves the viewer (orbit, zoom,
pan, follow-cam, Start/Pause/Step, bbox query: the renderer_module.cc
surface):

  python -m disinfect_slam_tpu_torch.apps.serve --replay DIR --depth-factor 1000
  python -m disinfect_slam_tpu_torch.apps.serve --synthetic 60   # the orbit scene

It runs on the CUDA device unless asked for another (--device cpu); /render
is the splat renderer, its two kernels on a CUDA device.
"""

from __future__ import annotations

import argparse

from ..io.dataset import LoggedReplay, TUMReplay
from ..io.orbit_scene import make_orbit_frames
from ..systems.dense_slam import DenseSLAM
from ..systems.disinf_system import DISINFSystem
from ..systems.server import ReconstructionService, ReplayDriver, make_server
from ..utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--mode", choices=["disinf", "slam"], default="disinf")
    ap.add_argument("--auto-recenter", action="store_true",
                    help="dense backend: follow the robot past the coverage window's "
                         "edge (TSDFGrid.maybe_recenter)")
    ap.add_argument("--spill", action="store_true",
                    help="with --auto-recenter: keep the blocks leaving the window in "
                         "host memory and restore them on return "
                         "(systems/block_streaming.py)")
    ap.add_argument("--fx", type=float, default=517.3)
    ap.add_argument("--fy", type=float, default=516.5)
    ap.add_argument("--cx", type=float, default=318.6)
    ap.add_argument("--cy", type=float, default=255.3)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--trunc", type=float, default=0.06)
    ap.add_argument("--max-depth", type=float, default=4.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the volume and the kernels; without CUDA "
                         "the service stops unless this is cpu")
    ap.add_argument("--replay", default=None,
                    help="logged dataset dir (trajectory.txt + PNGs) to drive through "
                         "the viewer's Start/Pause controls")
    ap.add_argument("--tum", action="store_true", help="--replay dir is a TUM RGB-D sequence")
    ap.add_argument("--depth-factor", type=float, default=1000.0)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="attach an N-frame replay of the synthetic orbit scene")
    ap.add_argument("--fps", type=float, default=0.0,
                    help="replay throttle (0: as fast as fusion allows)")
    return ap.parse_args(argv)


def build(args):
    """(service, HTTP server, replay driver or None) for the parsed flags;
    the server is bound but not serving yet."""
    device = resolve_device(args.device)
    intr = (args.fx, args.fy, args.cx, args.cy)
    if args.mode == "slam":
        system = DenseSLAM(intr, args.height, args.width, voxel_size=args.voxel,
                           truncation=args.trunc, max_depth=args.max_depth,
                           host_spill=args.spill, device=device)
    else:
        system = DISINFSystem(intr, voxel_size=args.voxel, truncation=args.trunc,
                              max_depth=args.max_depth, half_scale=False,
                              auto_recenter=args.auto_recenter, host_spill=args.spill,
                              device=device)
    svc = ReconstructionService(system, mode=args.mode, auto_recenter=args.auto_recenter)

    replay = None
    if args.replay or args.synthetic:
        frames = []
        if args.replay:
            src = (TUMReplay(args.replay) if args.tum
                   else LoggedReplay(args.replay, args.depth_factor))
            for i, fr in enumerate(src):
                pose = None if args.mode == "slam" else fr.cam_T_world
                frames.append((fr.rgb, fr.depth, i * 33, fr.ht, fr.lt, pose))
        else:
            for i, (pose, rgb, depth, ht, lt) in enumerate(
                    make_orbit_frames(args.synthetic, args.width, args.height, intr)):
                frames.append((rgb, depth, i * 33, ht, lt,
                               None if args.mode == "slam" else pose))
        replay = ReplayDriver(svc, frames, fps=args.fps)
        print(f"[serve] replay attached: {len(frames)} frames (paused; press Start "
              f"in the viewer)", flush=True)
    httpd = make_server(svc, args.host, args.port, replay=replay)
    return svc, httpd, replay


def main(argv=None) -> None:
    args = parse_args(argv)
    _, httpd, _ = build(args)
    host, port = httpd.server_address[:2]
    print(f"[serve] {args.mode} reconstruction on http://{host}:{port} "
          f"({args.device})", flush=True)
    print(f"[serve] interactive viewer: http://{host}:{port}/", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
