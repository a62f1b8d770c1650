#!/usr/bin/env python3
"""Variants of ICP's kernel (csrc/icp_step.cu) on one card: what bounds
it, and which warp, pixel and stage counts to ship.

Each variant is the source with some of its constants or lines replaced
(PATCHES, joined by "+"; VARIANTS the default list), built with the
package's nvcc flags into disinfect_slam_tpu_torch/_build/ and loaded
beside the others.  At 640x480 and 320x240 (orbit_vga's frame 59 against
58 at track_res_scale 1, chip_smoke.icp_inputs) each variant's device
time a call is read from a profiler trace (chip_smoke.kernel_ms, median
of 10), with ptxas's registers and spills and whether its result is
bit-equal to the plain version.  The patches marked diagnostic give wrong
results on purpose, to time one part alone: "producers_only" (the
consumer folds nothing: the per-pixel arithmetic and the ring),
"consumer_only" (the producers write nothing: the fold and the
barriers), and the producers without their gather, their source loads,
with contiguous pixels, or storing into another CTA's ring.  The order
floor (icp_kernel.chain) is timed beside them.  Needs a CUDA device;
prints one JSON line.

  python3 scripts/port_icp_variants.py [--only NAME ...] [--out FILE.json] [--build-only]

A variant that deadlocks hangs its process, so on the card build them all
first (--build-only) and run each under a timeout of its own.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO]

PRODUCE = ("      produce(L, Tr, Pr, delta, j, k * kStageRows + (g % kSlotWarps) * 32 * kPix,\n"
           "              k * kStageRows, lane, live, ring + slot * kStageFloats);\n")
FOLD = "    if (whole > 0) {\n      mbar_wait(full, 0);"


# a variant is "+"-joined names of these patches ("shipped" alone: none)
PATCHES = {
    "shipped": [],
    # diagnostic (wrong results): one side of the ring alone
    "producers_only": [(re.escape(FOLD),
                        "    for (int k = 0; k < whole; ++k) {\n"
                        "      mbar_wait(full + k % kStages, (k / kStages) & 1);\n"
                        "      mbar_arrive(empty + k % kStages);\n    }\n"
                        "    if (false) {\n      mbar_wait(full, 0);")],
    "consumer_only": [(re.escape(PRODUCE), "")],
    # every warp but the consumer produces (15, sharing the consumer's
    # scheduler), in stages of three warps' parts
    "all15": [(r"constexpr int kProducers = [^;]+;", "constexpr int kProducers = kWarps - 1;"),
              (re.escape("} else if (warp % 4 != 0) {"), "} else {"),
              (re.escape("const int pw = warp - warp / 4 - 1;"), "const int pw = warp - 1;"),
              (r"constexpr int kSlotWarps = \d+;", "constexpr int kSlotWarps = 3;"),
              (r"constexpr int kStages = \d+;", "constexpr int kStages = 5;")],
    # the Huber weight without its division where |r| < delta (the
    # quotient is then at least 1, and the weight 1)
    "huber": [(re.escape("    const float qh = delta / lo;\n"
                         "    const float huber = qh > 1.f ? 1.f : qh;"),
               "    float huber = 1.f;\n    if (!(lo < delta)) {\n"
               "      const float qh = delta / lo;\n      huber = qh > 1.f ? 1.f : qh;\n    }")],
    # diagnostic (wrong results): the producers without the reference-row
    # gather / without the source loads (values made from the pixel instead)
    "nogather": [(re.escape("    g0[q] = __ldg(L.ref_pack + 2 * row);\n"
                            "    g1[q] = __ldg(L.ref_pack + 2 * row + 1);"),
                  "    g0[q] = make_float4(px[q] * 1.001f, py[q], pz[q] + 0.01f, 0.f);\n"
                  "    g1[q] = make_float4(0.f, 1.f, static_cast<float>(row & 1), 0.f);")],
    "nosrc": [(re.escape("    x[q] = __ldg(L.src + 3 * p);\n    y[q] = __ldg(L.src + 3 * p + 1);\n"
                         "    zs[q] = __ldg(L.src + 3 * p + 2);"),
               "    x[q] = 1e-4f * static_cast<float>(i);\n    y[q] = 1e-3f * lane;\n"
               "    zs[q] = 1.5f;")],
    # diagnostic (wrong results): CTA j's producers read pixels 0, 1, 2, ...
    # (contiguous) instead of j, j + 8, ...: loads coalesced across a warp
    "contiguous": [(re.escape("static_cast<size_t>(j) + static_cast<size_t>(kAcc) * "
                              "(i < live ? i : 0);"), "static_cast<size_t>(i < live ? i : 0);")],
    # diagnostic (wrong results): the products stored into the next CTA's
    # ring through distributed shared memory (what remote stores cost)
    "remote": [(re.escape("    float* out = stage + r_in;"),
                "    float* out = cg::this_cluster().map_shared_rank(stage + r_in, (j + 1) % kAcc);")],
    # the consumer's loads in flight
    "ahead4": [(r"constexpr int kAhead = \d+;", "constexpr int kAhead = 4;")],
    "ahead16": [(r"constexpr int kAhead = \d+;", "constexpr int kAhead = 16;")],
    # stages of one or four warps' parts (128 / 512 rows)
    "slot1": [(r"constexpr int kSlotWarps = \d+;", "constexpr int kSlotWarps = 1;"),
              (r"constexpr int kStages = \d+;", "constexpr int kStages = 12;")],
    "slot4": [(r"constexpr int kSlotWarps = \d+;", "constexpr int kSlotWarps = 4;"),
              (r"constexpr int kStages = \d+;", "constexpr int kStages = 3;")],
}
VARIANTS = ["shipped", "producers_only", "consumer_only", "producers_only+nogather",
            "producers_only+nosrc", "producers_only+nosrc+nogather", "producers_only+contiguous",
            "producers_only+remote", "slot1", "slot4", "ahead4", "ahead16", "all15", "huber"]


def patches(name):
    return [rep for part in name.split("+") for rep in PATCHES[part]]


def build_variant(name, rep):
    """Write and compile the variant's source -> (library path, nvcc proc)."""
    from disinfect_slam_tpu_torch.ops.cuda import build

    src = open(os.path.join(build.CSRC, "icp_step.cu")).read()
    for pat, new in rep:
        src, k = re.subn(pat, new.replace("\\", r"\\"), src)
        if k != 1:
            raise SystemExit(f"{name}: {pat!r} matched {k} times")
    out = build.BUILD_DIR / "icp_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"icp_{name}.cu"
    lib = out / f"libicp_{name}.so"
    log = out / f"icp_{name}.log"
    if lib.exists() and cu.exists() and cu.read_text() == src:
        return lib, subprocess.Popen(["cat", str(log)], stdout=subprocess.PIPE, text=True)
    cu.write_text(src)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)]
    return lib, subprocess.Popen(["sh", "-c", " ".join(cmd) + f" > {log} 2>&1; s=$?; cat {log}; "
                                  "exit $s"], stdout=subprocess.PIPE, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*",
                    help="variants to run, each a +-joined list of PATCHES (default: VARIANTS)")
    ap.add_argument("--out", help="also write the result to this JSON file")
    ap.add_argument("--build-only", action="store_true",
                    help="build the variants (in parallel) and exit; a later run reuses them")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_icp_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from disinfect_slam_tpu_torch.ops.cuda import build, icp_kernel
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power

    names = args.only or VARIANTS
    procs = {n: build_variant(n.replace("+", "-"), patches(n)) for n in names}
    if args.build_only:
        for n, (_, proc) in procs.items():
            proc.communicate()
            print(f"{n}: nvcc exited {proc.returncode}")
        return 0
    dev = torch.device("cuda", 0)
    delta = torch.tensor(0.05)
    dist2 = float(np.float32(0.25 * 0.25))
    levels = chip_smoke.icp_inputs(dev, 1)[:2]
    host = [icp_kernel.icp_step_reference(T0, src, pack, rp, delta, intr, w, h, dist2)
            for T0, src, pack, rp, intr, w, h in levels]
    C = ctypes
    res = {"card": card_name_and_power(), "variants": {}}
    seed = torch.full((32,), 1e-3, device=dev)
    sink = torch.empty(32, device=dev)
    res["order_floor_ms"] = {f"{w}x{h}": chip_smoke.kernel_ms(
        lambda r=-(-w * h // 8): icp_kernel.chain(seed, r, sink), "icp_chain")
        for _, _, _, _, _, w, h in levels}
    for name in names:
        lib_path, proc = procs[name]
        log, _ = proc.communicate()
        ptxas = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        if proc.returncode != 0:
            res["variants"][name] = {"error": log[-2000:]}
            chip_smoke.log(f"[port_icp_variants] {name}: build failed\n{log[-2000:]}")
            continue
        lib = C.CDLL(str(lib_path))
        step = lib.dst_icp_step
        step.argtypes = [C.c_void_p] * 5 + [C.c_int, C.c_int] + [C.c_float] * 5 + [C.c_void_p] * 3
        step.restype = C.c_int
        clusters = C.c_int(0)
        lib.dst_icp_clusters.argtypes = [C.c_void_p]
        build.check(lib.dst_icp_clusters(C.byref(clusters)), f"{name} clusters")
        out = {"ptxas": ptxas, "clusters": clusters.value}
        for (T0, src, pack, rp, intr, w, h), want in zip(levels, host):
            a = [t.to(dev) for t in (T0, src, pack, rp, delta)]
            T_new = torch.empty((4, 4), device=dev)
            o = torch.empty(2, device=dev)

            def call(a=a, intr=intr, w=w, h=h, T_new=T_new, o=o):
                build.check(step(*(build.ptr(t) for t in a), w, h, *intr, dist2,
                                 build.ptr(T_new), build.ptr(o), build.stream_of(a[1])), name)

            call()
            torch.cuda.synchronize()
            equal = (torch.equal(T_new.cpu(), want[0]) and torch.equal(o[0].cpu(), want[1])
                     and torch.equal(o[1].cpu(), want[2]))
            out[f"{w}x{h}"] = {"ms": chip_smoke.kernel_ms(call, "icp_step"), "bit_equal": equal}
        res["variants"][name] = out
        chip_smoke.log(f"[port_icp_variants] {name}: {out}")
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
