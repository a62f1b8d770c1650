"""Volume checkpoint / resume in the JAX package's `.npz` format
(counterpart of disinfect_slam_tpu/io/checkpoint.py).

A checkpoint written by either package loads in the other: the file holds
every volume field as a numpy array plus the config as JSON.  rgbw is
stored as uint32 (the JAX dtype) and held by the port as the int32 view
of the same bits.  The older layouts the JAX loader upgrades load too.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..config import TSDFConfig
from ..core.state import TSDFVolume
from ..core.voxel import pack_block_coord
from ..utils.device import resolve_device

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


def volume_from_numpy(arrays: dict, cfg: TSDFConfig, device="cuda") -> TSDFVolume:
    """Build a port volume on `device` (CUDA unless the caller asks for
    another) from the JAX fields as numpy arrays (rgbw as uint32 or
    int32)."""
    device = resolve_device(device)
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


def _upgrade(data, cfg: TSDFConfig) -> dict:
    """The fields of a checkpoint in any layout the JAX loader reads
    (disinfect_slam_tpu/io/checkpoint.py:57-75): the unpacked [E, 3]
    `entry_pos` becomes the packed `entry_key`; a missing `oob_count` is
    0; separate `weight` and `rgb` arrays pack into the rgbw word."""
    arrays = {f: data[f] for f in _FIELDS if f in data.files}
    if "entry_key" not in arrays and "entry_pos" in data.files:
        arrays["entry_key"] = pack_block_coord(
            torch.from_numpy(np.asarray(data["entry_pos"], np.int32)), cfg).numpy()
    arrays.setdefault("oob_count", np.zeros((), np.int32))
    if "rgbw" not in arrays and "weight" in data.files and "rgb" in data.files:
        w8 = np.asarray(data["weight"]).astype(np.uint32)
        rgb8 = np.asarray(data["rgb"]).astype(np.uint32)
        arrays["rgbw"] = (rgb8[..., 0] | (rgb8[..., 1] << 8) | (rgb8[..., 2] << 16)
                          | (w8 << 24))
    return arrays


def load_volume(path: str, device="cuda") -> TSDFVolume:
    """Read a checkpoint written by either package's save_volume, in the
    current layout or an older one, onto `device` (CUDA unless the caller
    asks for another)."""
    device = resolve_device(device)
    with np.load(path) as data:
        fields = json.loads(bytes(data["__config__"]).decode())
        # drop keys this version does not know; JSON has no tuples
        known = {f.name for f in dataclasses.fields(TSDFConfig)}
        fields = {k: v for k, v in fields.items() if k in known}
        if fields.get("grid_origin") is not None:
            fields["grid_origin"] = tuple(fields["grid_origin"])
        cfg = TSDFConfig(**fields)
        arrays = _upgrade(data, cfg)
        missing = [f for f in _FIELDS if f not in arrays]
        if missing:
            raise ValueError(f"{path}: checkpoint lacks fields {missing}")
        return volume_from_numpy(arrays, cfg, device)
