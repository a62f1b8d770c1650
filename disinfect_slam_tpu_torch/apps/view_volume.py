"""Orbit views of a volume checkpoint to PNGs on the PyTorch port
(counterpart of apps/view_volume.py).

The reference's interactive GLFW/ImGui viewer (modules/renderer_module)
needs a display; this renders the same rgba and normal-shaded views from
an orbit of virtual cameras around the mapped blocks.

  python -m disinfect_slam_tpu_torch.apps.view_volume --volume vol.npz --out views/ --frames 12

The checkpoint is the .npz of io/checkpoint.py (either package's).  It
runs on the CUDA device unless asked for another (--device cpu); the
splat renderer launches its two kernels there once a view.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..io.checkpoint import load_volume
from ..io.png_io import write_image
from ..ops.cuda.splat_kernel import splat_render_cuda
from ..ops.raycast import raycast
from ..viz.headless import look_at


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--volume", required=True, help="checkpoint from io.checkpoint")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--radius", type=float, default=0.0, help="orbit radius (0: auto)")
    ap.add_argument("--fx", type=float, default=525.0)
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--renderer", choices=["splat", "raycast"], default="splat")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the volume and the kernels; without CUDA "
                         "the run stops unless this is cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Render the orbit; returns the PNG paths and each view's hit share."""
    vol = load_volume(args.volume, device=args.device)
    cfg = vol.cfg
    print(f"[view] volume: {int(vol.num_active_blocks)} blocks, voxel {cfg.voxel_size} m")

    # the scene's bounds from the live blocks
    live = (vol.entry_block >= 0).cpu().numpy()
    bp = vol.entry_pos.cpu().numpy()[live]
    centers = (bp * cfg.block_len + cfg.block_len / 2) * cfg.voxel_size
    center = centers.mean(axis=0)
    extent = np.abs(centers - center).max()
    radius = args.radius or float(extent * 2.5 + 0.5)

    w, h = (int(x) for x in args.size.split("x"))
    cam = CameraParams.create(
        CameraIntrinsics.create(args.fx, args.fx, (w - 1) / 2, (h - 1) / 2), h, w)
    render = splat_render_cuda if args.renderer == "splat" else raycast

    os.makedirs(args.out, exist_ok=True)
    paths, hits = [], []
    for i in range(args.frames):
        ang = 2 * np.pi * i / args.frames
        eye = center + np.array([np.sin(ang), -0.3, -np.cos(ang)]) * radius
        res = render(vol, cam, SE3.from_matrix(look_at(eye, center)), args.max_depth)
        for view in ("rgba", "normal"):
            paths.append(os.path.join(args.out, f"orbit_{i:03d}_{view}.png"))
            write_image(paths[-1], getattr(res, view).cpu().numpy())
        hits.append(float(res.hit.float().mean()))
        print(f"[view] frame {i}: hit {hits[-1]:.2%}")
    return {"paths": paths, "hit": hits}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
