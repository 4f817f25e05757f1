"""Build and load the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` has a plain C interface. It is compiled
with nvcc for sm_90a into the package's gitignored build directory, under a
name keyed on the source's hash (a stale library is never loaded), written
to a temporary name and moved into place, then loaded with ctypes. Nothing
is built at import time: a kernel module calls `load` at its first launch,
and `compile_all` builds several sources at once, one nvcc process each,
all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.normpath(os.path.join(_HERE, "..", "csrc"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=None)
def l2_bytes(device: str) -> int:
    """The L2 cache size of a CUDA device, in bytes."""
    import torch

    return int(torch.cuda.get_device_properties(device).L2_cache_size)


def source(name: str) -> str:
    """Path of the kernel source `csrc/<name>.cu`."""
    return os.path.join(CSRC, f"{name}.cu")


def _so_path(name: str) -> str:
    with open(source(name), "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_all(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, one nvcc
    process per source, all started together. Returns each build's wall
    seconds (0.0 for a library already built). A failed build raises
    CalledProcessError after the other builds are stopped."""
    secs: Dict[str, float] = {}
    running = {}
    try:
        for name in names:
            so = _so_path(name)
            if os.path.exists(so):
                secs[name] = 0.0
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)]
            running[name] = (subprocess.Popen(cmd), cmd, tmp, so,
                             time.perf_counter())
        while running:
            for name in list(running):
                proc, cmd, tmp, so, t0 = running[name]
                rc = proc.poll()
                if rc is None:
                    continue
                del running[name]
                if rc != 0:
                    raise subprocess.CalledProcessError(rc, cmd)
                os.replace(tmp, so)
                secs[name] = time.perf_counter() - t0
            time.sleep(0.02)
    finally:
        for proc, *_ in running.values():
            proc.kill()
            proc.wait()
    return secs


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (built first if missing);
    `declare(lib)` sets its functions' argtypes and restype once."""
    lib = _LIBS.get(name)
    if lib is None:
        compile_all([name])
        lib = ctypes.CDLL(_so_path(name))
        declare(lib)
        _LIBS[name] = lib
    return lib
