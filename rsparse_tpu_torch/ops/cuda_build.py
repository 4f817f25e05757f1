"""Build and load the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` has a plain C interface. It is compiled
with nvcc for sm_90a into the package's gitignored build directory, under a
name keyed on the source's hash (a stale library is never loaded), written
to a temporary name and moved into place, then loaded with ctypes. Nothing
is built at import time: a kernel module calls `load` at its first launch,
and `compile_all` builds several sources at once, one nvcc process each,
all started together.

`sanitize()` (exported as `utils.sanitize`) is the kernels' debugging mode:
inside it each kernel wrapper range-checks the index streams its kernel will
read, on the host, before the launch (`check_index`, `check_pointers`), and
synchronizes after it (`synchronize`), so that an asynchronous CUDA error
raises at the launch that caused it, naming the kernel.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, Iterable

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.normpath(os.path.join(_HERE, "..", "csrc"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

KERNELS = ("sptrsv", "spmm", "spmv_dia")  # the sources under csrc/

_LIBS: Dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=None)
def l2_bytes(device: str) -> int:
    """The L2 cache size of a CUDA device, in bytes."""
    import torch

    return int(torch.cuda.get_device_properties(device).L2_cache_size)


def require_card(device):
    """`device` as a torch.device; a RuntimeError for a CUDA device when
    torch sees no card. Nothing falls back to the CPU: a caller that wants
    the CPU names it."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device (pass "
                           "the CPU explicitly to run there)")
    return dev


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
    """The loaded library of `csrc/<name>.cu` (built first if missing, in a
    `build.kernel` span whose attribute is the name's index in KERNELS);
    `declare(lib)` sets its functions' argtypes and restype once."""
    lib = _LIBS.get(name)
    if lib is None:
        if not os.path.exists(_so_path(name)):
            from ..utils.profiling import phase_timer

            with phase_timer("build.kernel", attr=KERNELS.index(name)):
                compile_all([name])
        lib = ctypes.CDLL(_so_path(name))
        declare(lib)
        _LIBS[name] = lib
    return lib


_SANITIZE = contextvars.ContextVar("rsparse_tpu_torch_sanitize", default=False)


@contextlib.contextmanager
def sanitize():
    """Kernel launches inside check their index streams first and
    synchronize after (see the module docstring)."""
    token = _SANITIZE.set(True)
    try:
        yield
    finally:
        _SANITIZE.reset(token)


def sanitizing() -> bool:
    """Whether the caller runs inside `sanitize()`."""
    return _SANITIZE.get()


def _host(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      np.int64)


def check_index(kernel: str, name: str, t, hi: int, lo: int = 0) -> None:
    """Raise IndexError unless every value of stream `t` lies in [lo, hi)."""
    v = _host(t)
    bad = np.flatnonzero((v < lo) | (v >= hi))
    if len(bad):
        k = int(bad[0])
        raise IndexError(f"{kernel} kernel: {name}[{k}] = {int(v[k])} outside "
                         f"[{lo}, {hi}) ({len(bad)} entries)")


def check_pointers(kernel: str, name: str, t, total: int) -> None:
    """Raise IndexError unless pointer stream `t` starts at 0, never
    decreases and ends at `total`."""
    v = _host(t)
    if len(v) == 0 or v[0] != 0 or v[-1] != total:
        raise IndexError(f"{kernel} kernel: {name} must run from 0 to {total}")
    down = np.flatnonzero(np.diff(v) < 0)
    if len(down):
        k = int(down[0])
        raise IndexError(f"{kernel} kernel: {name} decreases at {k + 1} "
                         f"({int(v[k])} -> {int(v[k + 1])})")


def synchronize(kernel: str, device) -> None:
    """Wait for the device; an error the kernel left raises naming it."""
    import torch

    try:
        torch.cuda.synchronize(device)
    except RuntimeError as e:
        raise RuntimeError(f"{kernel} kernel failed on {device}: {e}") from e
