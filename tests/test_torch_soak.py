"""PyTorch port, the long-run soak (port of tests/test_soak.py): loop
closure, host spill, maybe_recenter and the keyframe cap together in
DenseSLAM over a corridor out and back (tests/torch_cases.py:run_soak),
with the JAX soak's assertions and, at 1000 frames, within the JAX soak's
own counts on the same corridor (data/soak_fingerprint.json,
tests/torch_cases.py:check_soak_fingerprint).

The frame count tunes through DSTPU_SOAK_FRAMES, as the JAX test's does,
with its default of 1000 (~95 s on one CPU thread).  Shorter corridors
move the camera further a frame, and the two packages' trajectories part
along the corridor: at 700 frames the JAX soak passes and the port's end
position is 0.206 m from its start (the JAX one's 0.011 m), so the port
misses the last assertion; at 900 both fail (the JAX soak never spills,
the port ends 0.573 m out); at 600 and 800 both fail on the end position
(scripts/port_soak_fingerprint.py).  chip_smoke.py runs the 1000 frames
on the card."""

import os

import numpy as np
import pytest
import torch

from .torch_cases import (check_soak, check_soak_fingerprint, run_soak, soak_corridor_depth,
                          soak_fingerprint)

torch.set_num_threads(1)


def test_soak_corridor_is_the_jax_tests():
    from .test_soak import corridor_depth

    for x in (0.0, 0.37, 2.9, 8.0):
        d_jax, pose_jax = corridor_depth(x)
        d, pose = soak_corridor_depth(x)
        np.testing.assert_array_equal(d, d_jax)
        np.testing.assert_array_equal(pose, pose_jax)


def test_soak_loop_spill_recenter_cap():
    n_frames = int(os.environ.get("DSTPU_SOAK_FRAMES", "1000"))
    if n_frames < 600:
        # the corridor's pace scales with n_frames but the loop-closure gap
        # (min_gap_frames=200) and the spill pressure do not: below ~600
        # frames no closure can happen (tests/test_soak.py)
        pytest.skip(f"soak needs >= 600 frames (got {n_frames})")
    res, _ = run_soak(n_frames, "cpu")
    print(f"[soak] {res}")
    check_soak(res)
    ref = soak_fingerprint()
    if n_frames == ref["frames"]:
        check_soak_fingerprint(res, ref)
