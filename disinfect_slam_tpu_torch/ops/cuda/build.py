"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` file is compiled by nvcc into a shared library of
its own with a plain C interface, at first use, into
`disinfect_slam_tpu_torch/_build/` under a name keyed by a hash of the
source, the headers the sources include (`csrc/*.cuh`) and the flags, and
loaded with ctypes.  One source that fails to build (a probe, say) leaves
the other kernels loadable.  Nothing here runs at import time; the
CPU-only tests import the kernel modules without ever building.

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
ERRORS = "errors"  # csrc/errors.cu: the error text every entry point's code maps to


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found; set CUDA_HOME to the CUDA toolkit")
    return nvcc


def sources() -> list[str]:
    """The names of the kernel sources, csrc/<name>.cu."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> pathlib.Path:
    """Where csrc/<name>.cu's library goes: keyed by the flags, the source
    and every header."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names=None) -> tuple[dict, str, float]:
    """Compile the named sources (all of them by default) whose library
    for these sources and flags does not exist yet: one nvcc for each,
    all started together.  Returns ({name: library path}, compiler
    output, wall seconds compiling)."""
    names = sources() if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    missing = [n for n in names if not paths[n].exists()]
    if not missing:
        return paths, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in missing:
        # compile to a temporary name and rename, so that a concurrent or
        # interrupted build never leaves a partial library under the final name
        tmp = paths[n].with_name(f"{paths[n].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu: nvcc exited with code {proc.returncode}:\n{out}")
        else:
            os.replace(tmp, paths[n])
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths, "".join(logs), seconds


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built on first use)."""
    paths, _, _ = build([name])
    lib = ctypes.CDLL(str(paths[name]))
    if name == ERRORS:
        lib.dst_error_string.argtypes = [ctypes.c_int]
        lib.dst_error_string.restype = ctypes.c_char_p
    return lib


def entry(source: str, name: str, argtypes: list) -> "ctypes._CFuncPtr":
    """The C entry point `name` of csrc/<source>.cu's library with its
    argument types declared; every entry returns a cudaError_t as int."""
    fn = getattr(library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library(ERRORS).dst_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
