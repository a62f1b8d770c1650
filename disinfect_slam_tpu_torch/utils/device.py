"""Device selection, host uploads and the float32 switch shared by the
port's engine objects."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA raises (the
    port never drops to the CPU on its own).  The engine objects, the
    loaders and the apps default to "cuda": the CPU runs only when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available "
                           f"(ask for device='cpu', or --device cpu, to run on the CPU)")
    return dev


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array as a float32 tensor on `device`, never aliasing the
    caller's buffer.  To a CUDA device the copy goes through a pinned
    staging buffer and does not wait for the stream (a pageable upload
    would sync it)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def exact_fp32():
    """Full float32 convolutions and matmuls on CUDA (TF32 off) for the
    duration of the block; the previous settings come back after it."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
