#!/usr/bin/env python3
"""The PyTorch/CUDA port's benchmark (disinfect_slam_tpu_torch/apps/bench.py):
its last line of stdout is bench.py's JSON line, measured on the card.

    python bench_torch.py                 # the card (raises without CUDA)
    python bench_torch.py --device cpu    # bench.py's CPU configuration
"""

from disinfect_slam_tpu_torch.apps.bench import main

if __name__ == "__main__":
    main()
