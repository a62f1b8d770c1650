#!/usr/bin/env python
"""The hand kernels' self-check (counterpart of scripts/tpu_verify.py).

Runs every CUDA kernel of the PyTorch port against its plain torch version
on the card (utils/kernel_verify.py: sample_rows K1, fuse_rows K2,
splat_zbuf_blocks / splat_payload_blocks K4 / K5), building the kernels
first when they are not built, prints one PASS/FAIL line each and exits 1
on any failure.  It takes under 60 s once the kernels are built:

    python scripts/port_verify.py               # the card
    python scripts/port_verify.py --device cpu  # the plain versions only
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch

    from disinfect_slam_tpu_torch.utils.device import resolve_device
    from disinfect_slam_tpu_torch.utils.kernel_verify import verify_all

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[port_verify] device={device} ({name})", file=sys.stderr, flush=True)
    if device.type == "cuda":
        from disinfect_slam_tpu_torch.ops.cuda import build

        t0 = time.perf_counter()
        build.build()
        print(f"[port_verify] kernels built in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    ok = verify_all(verbose=True, device=device)
    print(f"[port_verify] {'ALL PASS' if ok else 'FAILURES'} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
