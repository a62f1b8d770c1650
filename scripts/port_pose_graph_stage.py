#!/usr/bin/env python3
"""The loop closure's pose graph and keyframe query, for the PyTorch port
of any checkout: two trees timed by one code on one card.

At each size (n_pad nodes, e_pad edges: 8/16, 32/64, 128/256, 256/512,
512/1024; tests/torch_cases.pose_graph_case's drifting chain with loop and
padded edges; the case is always this checkout's), a closure's pose graph as the
tree's LoopClosureManager runs it: its wall ms a call, the optimized
poses read to the host (median of `--reps`), and one call under the
profiler (device kernels, host kernel-launch calls and graph launches, idle
share; not for an eager call at 128 nodes and up), captured
(`PoseGraphStep`) and eager, both held bit-equal to the CPU's run; then
the kernel (ops/cuda/pose_graph_kernel.py): its device ms a call at the
launch shapes it takes (both layouts of the columns; above 64 nodes the
device-memory layout's two widest) beside the order floor (the chain of
pivot steps alone), and the fused entry's device ms and one call's stages
(the kernel's timeline).  Then the keyframe's query
(LoopClosureManager.query and the read of its scores) at 320x240 with a
database of 24 keyframes; with --soak, chip_smoke.py phase 12's soak
(1000 frames, its wall time and counts).  It runs against the
disinfect_slam_tpu_torch package under --root (default: this checkout).
Needs a CUDA device; prints the result as one JSON line.

  python3 scripts/port_pose_graph_stage.py [--root DIR] [--out FILE.json] [--reps N] [--soak]

To compare a commit with its parent, unpack the parent's package into a
git-ignored directory and run parent, change, change, parent on one card:

  mkdir -p .verify_tmp/parent
  git archive PARENT disinfect_slam_tpu_torch | tar -x -C .verify_tmp/parent
  python3 scripts/port_pose_graph_stage.py --root .verify_tmp/parent --out parent1.json
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((8, 16), (32, 64), (128, 256), (256, 512), (512, 1024))
QUERY_H, QUERY_W = 480, 640  # the frame; the query runs at its half, 320x240
QUERY_DB = 24  # keyframes in the database (the soak's cap)


def _wall_ms(fn, reps: int) -> list:
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def pose_graph_times(chip_smoke, dev, reps: int) -> list:
    """Each size: wall ms a closure's pose graph (read included), its
    profile, and the kernel's device ms."""
    import torch

    from disinfect_slam_tpu_torch.systems import loop_closure as lc
    from tests.torch_cases import pose_graph_case

    from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk

    out = []
    for n_pad, e_pad in SIZES:
        graph = pose_graph_case(n_pad, e_pad, seed=n_pad)
        res = {"n_pad": n_pad, "e_pad": e_pad, "m": 6 * n_pad}
        # the CPU's run, where it takes seconds, not minutes (a 1536-row LU)
        host = (lc.optimize_pose_graph(*(torch.from_numpy(a) for a in graph))
                if n_pad <= 128 else None)

        def eager(g=graph):
            return lc.optimize_pose_graph(*(torch.from_numpy(a).to(dev) for a in g))[0].cpu()

        step = lc.PoseGraphStep(dev)
        runs = {"eager": eager, "captured": lambda s=step, g=graph: s(*g)[0].cpu()}
        for name, fn in runs.items():
            got = fn()  # a captured step's first call captures
            if host is None:
                host = (got,)  # the card's eager and captured runs held to each other
            if not torch.equal(got, host[0]):
                raise SystemExit(f"{name} pose graph at n_pad {n_pad} differs from the CPU's")
            fast = name == "captured" or n_pad <= 32
            ms = _wall_ms(fn, reps if fast else 1)
            # an eager call at 128 nodes and up makes 10^5-10^6 launches: not profiled
            prof = chip_smoke.step_profile(fn, 1) if fast else None
            res[name] = {"wall_ms": ms, "median_ms": statistics.median(ms), "profile": prof}
            chip_smoke.log(f"[port_pose_graph_stage] n_pad {n_pad}, e_pad {e_pad}, {name}: "
                           f"{res[name]}")
        res["kernel"] = kernel_times(chip_smoke, pk, lc, graph, dev)
        out.append(res)
        torch.cuda.empty_cache()
    return out


def kernel_times(chip_smoke, pk, lc, graph, dev) -> dict:
    """pose_graph_solve's device ms a call on the graph's first iteration at
    the launch shapes the size takes (held bit-equal to the plain version
    first; "Ns" N CTAs with the columns in shared memory, "Ng" in device
    memory), the order floor at the shape the wrapper picks, the fused
    entry's ms and one call's stages from the kernel's timeline."""
    import torch

    args = [t.to(dev) for t in lc.pose_graph_system(*(torch.from_numpy(a) for a in graph))]
    m = args[5].shape[0]
    want = pk.pose_graph_solve_reference(*args)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    auto, _ = pk.grid_shape(m, sms)
    wide = pk.shapes(m, sms, False)
    shapes = ([(c, True) for c in pk.shapes(m, sms, True)]
              + [(c, False) for c in (wide if m <= 384 else wide[-2:])])
    res = {"auto": list(pk.grid_shape(m, sms)), "shapes": {}}
    for ctas, shared in shapes:
        fn = lambda c=ctas, s=shared: pk.pose_graph_solve(*args, ctas=c, shared=s)  # noqa: E731
        if not torch.equal(fn(), want):
            raise SystemExit(f"pose_graph_solve at m {m}, {ctas} CTAs, shared {shared} differs "
                             "from its plain version")
        res["shapes"][f"{ctas}{'s' if shared else 'g'}"] = chip_smoke.kernel_ms(
            fn, "pose_graph_kernel", reps=5)
    col = torch.rand(m, dtype=torch.float64, device=dev)
    sink = torch.empty(sms, dtype=torch.int32, device=dev)
    res["order_floor_ms"] = chip_smoke.kernel_ms(lambda: pk.chain(col, auto, sink),
                                                 "pose_graph_chain", reps=5)
    poses, ei, ej, z, w = (torch.from_numpy(a).to(dev) for a in graph)
    fargs = [poses, ei.int(), ej.int(), lc._inv_rigid(z).contiguous(), w, args[5]]
    fused = lambda: pk.pose_graph_fused(*fargs)  # noqa: E731
    got, plain = fused(), pk.pose_graph_fused_reference(*fargs)
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        raise SystemExit(f"pose_graph_fused at m {m} differs from its plain version")
    res["fused_ms"] = chip_smoke.kernel_ms(fused, "pose_graph_kernel", reps=5)
    res["stages"] = chip_smoke._timeline_breakdown(
        pk, lambda tl: pk.pose_graph_fused(*fargs, timeline=tl), m, dev)
    chip_smoke.log(f"[port_pose_graph_stage] pose_graph_solve at m {m}: {res}")
    return res


def query_times(dev, reps: int) -> dict:
    """LoopClosureManager.query at 320x240 and the read of its scores,
    against a database of QUERY_DB keyframes."""
    import numpy as np
    import torch

    from disinfect_slam_tpu_torch.systems.loop_closure import LoopClosureManager

    rng = np.random.default_rng(3)
    lc = LoopClosureManager((525.0, 525.0, 319.5, 239.5), QUERY_H, QUERY_W,
                            max_keyframes=QUERY_DB, device=dev)
    lc.db_desc.copy_(torch.from_numpy(rng.normal(0, 0.05, tuple(lc.db_desc.shape))
                                      .astype(np.float32)))
    lc.count = QUERY_DB
    depth = rng.uniform(0.5, 4.0, (QUERY_H, QUERY_W)).astype(np.float32)
    inten = rng.uniform(0, 255, (QUERY_H, QUERY_W)).astype(np.float32)
    fn = lambda: lc.query(depth, inten).scores.cpu()  # noqa: E731
    fn()
    ms = _wall_ms(fn, reps)
    return {"wall_ms": ms, "median_ms": statistics.median(ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose disinfect_slam_tpu_torch is timed")
    ap.add_argument("--out", help="also write the result to this JSON file")
    ap.add_argument("--reps", type=int, default=5, help="timed calls a size")
    ap.add_argument("--soak", action="store_true", help="also run phase 12's soak")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, REPO]

    import torch

    if not torch.cuda.is_available():
        print("port_pose_graph_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    import disinfect_slam_tpu_torch
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power

    pkg = os.path.dirname(os.path.abspath(disinfect_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"disinfect_slam_tpu_torch came from {pkg}, not from {root}")
    _, log, seconds = build.build()
    chip_smoke.log(f"[port_pose_graph_stage] kernels built in {seconds:.1f} s; ptxas: "
                   + " | ".join(ln.strip() for ln in log.splitlines()
                                if "pose_graph" in ln or ("Used" in ln and "pose" in ln)))
    dev = torch.device("cuda", 0)
    res = {"root": root, "card": card_name_and_power(),
           "pose_graph": pose_graph_times(chip_smoke, dev, args.reps),
           "query": query_times(dev, 20)}
    chip_smoke.log(f"[port_pose_graph_stage] query: {res['query']}")
    if args.soak:
        from tests.torch_cases import run_soak

        soak, slam = run_soak(chip_smoke.SOAK_FRAMES, dev)
        res["soak"] = soak
        del slam
        chip_smoke.log(f"[port_pose_graph_stage] soak: {soak}")
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
