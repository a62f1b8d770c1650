#!/usr/bin/env python
"""Stereo matcher latency on the PyTorch port, the flat cost volume
against coarse-to-fine (counterpart of scripts/bench_stereo.py): a random
left image and its 13-pixel roll at VGA with 64 disparities and at HD
with 128; the flat matcher, then the pyramid at 1 and 2 levels with
bands of 2 and 3 pixels, each eager and captured.  Eager: each call is
fed the last one's output.  Captured: the matcher on static copies of the
pair as one CUDA graph (utils/graphs.StepGraphs, as
StereoDepthEstimator captures it), replayed.  The device is synchronised
once at the end of the `iters` calls.

    python scripts/port_bench_stereo.py [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from disinfect_slam_tpu_torch.ops.stereo import block_match, block_match_pyramid  # noqa: E402
from disinfect_slam_tpu_torch.utils.device import resolve_device  # noqa: E402
from disinfect_slam_tpu_torch.utils.graphs import StepGraphs, keep  # noqa: E402
from disinfect_slam_tpu_torch.utils.timing import card_name_and_power  # noqa: E402

SIZES = ((480, 640, 64), (720, 1280, 128))  # (h, w, disparities): VGA, HD
ITERS = 30
ROLL = 13
PYRAMIDS = tuple((levels, band) for levels in (1, 2) for band in (2, 3))


def time_matcher(fn, left, right, iters: int, **kw) -> float:
    """ms a call of fn over `iters` chained calls after one warm-up."""
    def step(x):
        disp, valid = fn(x, right, **kw)
        return x + (disp.sum() + valid.sum()) * 0.0

    x = step(left)
    float(x.sum())  # warm-up and settle
    t0 = time.perf_counter()
    for _ in range(iters):
        x = step(x)
    float(x.sum())  # one sync at the end
    return (time.perf_counter() - t0) / iters * 1e3


def time_captured(fn, left, right, iters: int, **kw) -> float:
    """ms a replay of fn(left, right) captured on static copies of the
    pair, over `iters` replays after the key's first (eager) call and its
    capture."""
    graphs = StepGraphs(left.device)
    static = (left.clone(), right.clone())
    outputs = {}

    def body():
        keep(outputs, "out", *fn(*static, **kw))

    graphs.run("match", body)
    float(outputs["out"][0].sum())  # settle
    t0 = time.perf_counter()
    for _ in range(iters):
        graphs.run("match", body)
    float(outputs["out"][0].sum())  # one sync at the end
    return (time.perf_counter() - t0) / iters * 1e3


def timed(fn, left, right, iters: int, **kw) -> dict:
    return {"eager": time_matcher(fn, left, right, iters, **kw),
            "captured": time_captured(fn, left, right, iters, **kw)}


def line(name: str, t: dict, flat=None) -> str:
    ratio = "" if flat is None else f" ({flat['eager'] / t['eager']:.1f}x flat eager)"
    return (f"{name} : {t['eager']:.1f} ms eager, {t['captured']:.1f} ms captured "
            f"({t['eager'] / t['captured']:.1f}x){ratio}")


def run(device, sizes=SIZES, iters: int = ITERS, seed: int = 0) -> dict:
    """{(h, w, d): {"flat": {"eager": ms, "captured": ms}, "pyr L1 B2":
    ..., ...}}, each size's lines printed."""
    dev = resolve_device(device)
    print(f"device {dev} ({card_name_and_power() if dev.type == 'cuda' else 'cpu'})",
          flush=True)
    rng = np.random.default_rng(seed)
    out = {}
    for h, w, d in sizes:
        left = rng.uniform(0, 1, (h, w)).astype(np.float32)
        ld = torch.from_numpy(left).to(dev)
        rd = torch.from_numpy(np.roll(left, -ROLL, axis=1)).to(dev)
        res = {"flat": timed(block_match, ld, rd, iters, max_disp=d)}
        print(f"{w}x{h}, {d} disparities", flush=True)
        print(line("flat     ", res["flat"]), flush=True)
        for levels, band in PYRAMIDS:
            t = timed(block_match_pyramid, ld, rd, iters, max_disp=d, levels=levels, band=band)
            res[f"pyr L{levels} B{band}"] = t
            print(line(f"pyr L{levels} B{band}", t, res["flat"]), flush=True)
        out[(h, w, d)] = res
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
