"""Opt-in volume invariant validation, the debug/sanitizer pass
(counterpart of disinfect_slam_tpu/utils/validate.py).

The reference's device-side guards are debug-build macros
(utils/cuda/errors.cuh:13-30) plus manual cuda-memcheck runs; what is
left to sanitize here is the coherence of the volume's state.  Checked on
the host, with the same messages as the JAX package:

  H1  0 <= num_free <= num_blocks
  H2  the free heap slice holds unique, in-range pool indices
  P1  allocated entry_block values are unique, in-range pool indices
      (no double allocation)
  P2  free heap + allocated pool indices exactly partition [0, B)
  E1  occupied entries have unique block coordinates
  D1  (dense backend) block_table's resident pool indices match the
      allocated set
  V1  payloads are sane on allocated blocks: tsdf finite in [-1, 1],
      weight integral in [0, max_weight], prob in [0, 1], rgb in
      [0, 255]

Used by the offline app's --debug (after every frame).  A call copies the
index arrays to the host once and the allocated blocks' payload rows
once.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.state import EMPTY, TSDFVolume


class VolumeCorruptionError(AssertionError):
    """Raised when a volume invariant is violated."""


def validate_volume(vol: TSDFVolume, strict: bool = True) -> List[str]:
    """Check the volume's invariants; returns the violations (empty if
    healthy).  strict=True raises VolumeCorruptionError instead."""
    cfg = vol.cfg
    b = cfg.num_blocks
    errs: List[str] = []

    num_free = int(vol.num_free)
    heap = vol.heap.cpu().numpy()
    entry_block = vol.entry_block.cpu().numpy()
    entry_pos = vol.entry_pos.cpu().numpy()

    # H1: free counter bounds
    if not (0 <= num_free <= b):
        errs.append(f"H1: num_free={num_free} outside [0, {b}]")
        num_free = int(np.clip(num_free, 0, b))  # bound the checks below

    # H2: free-list uniqueness / range
    free = heap[:num_free]
    if free.size and (free.min() < 0 or free.max() >= b):
        errs.append(f"H2: heap free slice out of range [{free.min()}, {free.max()}]")
    elif np.unique(free).size != free.size:
        errs.append("H2: duplicate pool indices in the free heap slice")

    # P1: no double allocation
    alloc = entry_block[entry_block >= 0]
    if alloc.size and alloc.max() >= b:
        errs.append(f"P1: allocated pool index {alloc.max()} >= {b}")
    if np.unique(alloc).size != alloc.size:
        errs.append("P1: pool index allocated by more than one entry")

    # P2: free + allocated partition the pool exactly
    if not errs:
        union = np.concatenate([free, alloc])
        if union.size != b or np.unique(union).size != b:
            errs.append(
                f"P2: free ({free.size}) + allocated ({alloc.size}) do not "
                f"partition the {b}-block pool"
            )

    # E1: occupied entries carry unique block coords
    pos = entry_pos[entry_block >= 0]
    if pos.size and np.unique(pos, axis=0).shape[0] != pos.shape[0]:
        errs.append("E1: duplicate block coordinate across occupied entries")

    # D1: dense table coherence
    if cfg.backend == "dense":
        table = vol.block_table.cpu().numpy()
        resident = np.sort(table[table != EMPTY])
        if not np.array_equal(resident, np.sort(alloc)):
            errs.append(
                f"D1: block_table resident set ({resident.size}) != "
                f"allocated entry set ({alloc.size})"
            )

    # V1: payload sanity on allocated blocks (rows past the pool clamp, as
    # the JAX gather does)
    if alloc.size:
        idx = torch.from_numpy(np.clip(alloc, 0, b - 1)).to(vol.device).long()
        tsdf = vol.tsdf[idx].cpu().numpy()
        rgbw = vol.rgbw[idx].cpu().numpy().view(np.uint32)
        prob = vol.prob[idx].cpu().numpy()
        weight = (rgbw >> 24).astype(np.uint8)
        rgb = np.stack([(rgbw >> s & 0xFF).astype(np.uint8) for s in (0, 8, 16)], -1)
        if not np.isfinite(tsdf).all():
            errs.append("V1: non-finite tsdf in allocated blocks")
        elif tsdf.min() < -1.0 - 1e-5 or tsdf.max() > 1.0 + 1e-5:
            errs.append(
                f"V1: tsdf outside [-1, 1]: [{tsdf.min():.4f}, {tsdf.max():.4f}]"
            )
        if weight.min() < 0 or weight.max() > cfg.max_weight:
            errs.append(
                f"V1: weight outside [0, {cfg.max_weight}]: "
                f"[{weight.min():.2f}, {weight.max():.2f}]"
            )
        elif not np.array_equal(weight, np.round(weight)):
            errs.append("V1: non-integral weight")
        if not np.isfinite(prob).all() or prob.min() < 0 or prob.max() > 1:
            errs.append("V1: prob outside [0, 1]")
        if rgb.min() < 0 or rgb.max() > 255:
            errs.append(f"V1: rgb outside [0, 255]: [{rgb.min()}, {rgb.max()}]")

    if errs and strict:
        raise VolumeCorruptionError("; ".join(errs))
    return errs
