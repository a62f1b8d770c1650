"""Volume checkpoint / resume in the JAX package's `.npz` format
(counterpart of disinfect_slam_tpu/io/checkpoint.py).

A checkpoint written by either package loads in the other: the file holds
every volume field as a numpy array plus the config as JSON.  rgbw is
stored as uint32 (the JAX dtype) and held by the port as the int32 view
of the same bits.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..config import TSDFConfig
from ..core.state import TSDFVolume

_FIELDS = (
    "entry_key",
    "entry_block",
    "block_table",
    "heap",
    "num_free",
    "oob_count",
    "tsdf",
    "rgbw",
    "prob",
)


def volume_to_numpy(vol: TSDFVolume) -> dict:
    """Every field as a host numpy array, rgbw as uint32 (JAX layout)."""
    out = {f: getattr(vol, f).cpu().numpy() for f in _FIELDS}
    out["rgbw"] = out["rgbw"].view(np.uint32)
    return out


def volume_from_numpy(arrays: dict, cfg: TSDFConfig, device="cpu") -> TSDFVolume:
    """Build a port volume from the JAX fields as numpy arrays (rgbw as
    uint32 or int32)."""
    kwargs = {}
    for f in _FIELDS:
        a = np.asarray(arrays[f])
        if f == "rgbw":
            a = a.view(np.int32)
        kwargs[f] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return TSDFVolume(cfg=cfg, **kwargs)


def save_volume(path: str, vol: TSDFVolume) -> None:
    """Write the full volume state + config to one .npz file."""
    arrays = volume_to_numpy(vol)
    arrays["__config__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(vol.cfg)).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_volume(path: str, device="cpu") -> TSDFVolume:
    """Read a checkpoint written by either package's save_volume."""
    with np.load(path) as data:
        fields = json.loads(bytes(data["__config__"]).decode())
        # drop keys this version does not know; JSON has no tuples
        known = {f.name for f in dataclasses.fields(TSDFConfig)}
        fields = {k: v for k, v in fields.items() if k in known}
        if fields.get("grid_origin") is not None:
            fields["grid_origin"] = tuple(fields["grid_origin"])
        cfg = TSDFConfig(**fields)
        missing = [f for f in _FIELDS if f not in data.files]
        if missing:
            raise ValueError(f"{path}: checkpoint lacks fields {missing}")
        return volume_from_numpy({f: data[f] for f in _FIELDS}, cfg, device)
