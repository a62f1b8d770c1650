"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by nvcc into one shared library with a
plain C interface, at first use, into `disinfect_slam_tpu_torch/_build/`
under a name keyed by a hash of the sources and flags, and loaded with
ctypes.  Nothing here runs at import time; the CPU-only tests import the
kernel modules without ever building.

`-fmad=false`: the plain versions are eager torch ops, which never
contract a multiply and an add into one FMA; with contraction the kernel
could flip blocks that sit exactly at the 0.9 carve threshold (see the
header of disinfect_slam_tpu/ops/pallas/fuse_kernel.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found; set CUDA_HOME to the CUDA toolkit")
    return nvcc


def build() -> tuple[pathlib.Path, str, float]:
    """Compile the kernels unless the library for these sources and flags
    exists.  Returns (library path, compiler output, seconds compiling)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libdstorch_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename, so that a concurrent or
    # interrupted build never leaves a partial library under the final name
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.dst_error_string.argtypes = [ctypes.c_int]
    lib.dst_error_string.restype = ctypes.c_char_p
    return lib


def entry(name: str, argtypes: list) -> "ctypes._CFuncPtr":
    """A C entry point of the library with its argument types declared;
    every entry returns a cudaError_t as int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library().dst_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
