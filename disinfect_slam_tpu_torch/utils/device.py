"""Device selection shared by the port's engine objects."""

from __future__ import annotations

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
