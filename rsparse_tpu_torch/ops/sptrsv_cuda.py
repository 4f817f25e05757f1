"""Level-scheduled SpTRSV over a batch of RHS columns: the CUDA kernel and
its plain torch twin.

`sptrsv_multi(tx, X, plan, kind)` solves T X = B (or T' X = B) for X[n, B]
with the level schedule of `solve.tri_plan`, in float32 or float64. It
replaces the TPU kernel `rsparse_tpu/ops/sptrsv_pallas.py::_sweep_call`
(f32 only there) and, in float64, its XLA twin `solve._tri_sweep_multi`.

  - On a CUDA tensor it launches the hand-written kernel in
    `csrc/sptrsv.cu` (one launch for the whole schedule; the source's header
    says what bounds it and how). A build or launch failure raises: there
    is no fallback.
  - On a CPU tensor it runs `sptrsv_plain_multi`, the plain torch version
    (a Python loop over levels with `index_add_`), which the CPU tests use
    and which the chip check compares the kernel with.

The kernel is compiled with nvcc from the one source at first use
(`cuda_build`), into the package's gitignored build directory, under a name
keyed on the source's hash. Nothing is built at import time.

Streams derived from the plan (`_streams`): per level offsets eoff/coff,
entry rows erow, entry columns ecol (scatter kinds) or slots eslot (gather
kinds), sorted columns cid, and the positions epos/cdiag of the entry and
diagonal values in the factor's value array. The value prepass
`ev = tx[epos]`, `dv = tx[cdiag]` is a torch gather outside the kernel, as it
was on the TPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .plan import device_cache

__all__ = ["sptrsv_multi", "sptrsv_plain_multi", "build"]

SOURCE = cuda_build.source("sptrsv")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.sptrsv_sweep_f32, lib.sptrsv_sweep_f64):
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return cuda_build.load("sptrsv", _declare)


def _streams(plan, device: torch.device) -> dict:
    """The plan's schedule streams as int32 tensors on `device` (cached)."""

    def make():
        t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
        return dict(
            eoff=t(plan.ent_off), coff=t(plan.col_off),
            eoff_h=[int(v) for v in plan.ent_off],
            coff_h=[int(v) for v in plan.col_off],
            epos=t(plan.ent_pos), erow=t(plan.ent_row), ecol=t(plan.ent_col),
            eslot=t(plan.ent_slot), cid=t(plan.col_id), cdiag=t(plan.col_diag),
        )

    return device_cache(plan, "_sptrsv_streams", device, make)


def _prepass(tx: torch.Tensor, X: torch.Tensor, plan, kind: int):
    if kind not in (0, 1, 2, 3):
        raise ValueError(f"kind must be 0..3, got {kind}")
    if X.dim() != 2 or X.shape[0] != plan.n:
        raise ValueError(f"X must be [{plan.n}, B], got {tuple(X.shape)}")
    if tx.dtype != X.dtype or tx.device != X.device:
        raise ValueError("factor values and X must share dtype and device")
    st = _streams(plan, X.device)
    ev = tx[st["epos"]]
    dv = tx[st["cdiag"]]
    eb = st["ecol"] if kind in (0, 1) else st["eslot"]
    return st, ev, dv, eb


def sptrsv_plain_multi(tx: torch.Tensor, X: torch.Tensor, plan,
                       kind: int) -> torch.Tensor:
    """Plain torch sweep (any device): the kernel's reference version."""
    return _sweep_plain(*_prepass(tx, X, plan, kind), X, plan, kind)


def _sweep_plain(st, ev, dv, eb, X: torch.Tensor, plan, kind: int):
    x = X.clone()
    B = x.shape[1]
    cid, erow = st["cid"], st["erow"]
    eo, co = st["eoff_h"], st["coff_h"]
    for lev in range(plan.nlev):
        c0, c1, e0, e1 = co[lev], co[lev + 1], eo[lev], eo[lev + 1]
        j = cid[c0:c1]
        d = dv[c0:c1, None]
        if kind in (0, 1):
            x[j] = x[j] / d
            x.index_add_(0, erow[e0:e1], ev[e0:e1, None] * x[eb[e0:e1]],
                         alpha=-1)
        else:
            contrib = x.new_zeros((c1 - c0, B)).index_add_(
                0, eb[e0:e1], ev[e0:e1, None] * x[erow[e0:e1]])
            x[j] = (x[j] - contrib) / d
    return x


def _tile(B: int, scatter: bool) -> int:
    """RHS columns per CTA. Measured on an H100 at n = 16,384 (PERF.md):
    the scatter form is fastest with one column per CTA (B CTAs, each
    latency-bound on the level chain), the gather form with 8, where wider
    tiles serialize fewer lanes on the same contrib slot."""
    return 1 if scatter else min(B, 8)


def _sweep_cuda(st, ev, dv, eb, X: torch.Tensor, plan, kind: int):
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"SpTRSV kernel takes float32/float64, got {X.dtype}")
    B = X.shape[1]
    scatter = kind in (0, 1)
    tile = _tile(B, scatter)
    if plan.emax * tile >= 2**31:
        raise ValueError("level too wide for the kernel's 32-bit loop index")
    lib = build()
    x = X.contiguous().clone()
    contrib = None if scatter else x.new_zeros((plan.wmax, B))
    fn = lib.sptrsv_sweep_f32 if X.dtype == torch.float32 else lib.sptrsv_sweep_f64
    dev = X.device
    rc = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
            st["eoff"].data_ptr(), st["coff"].data_ptr(), ev.data_ptr(),
            st["erow"].data_ptr(), eb.data_ptr(), dv.data_ptr(),
            st["cid"].data_ptr(), x.data_ptr(),
            contrib.data_ptr() if contrib is not None else None,
            plan.nlev, B, tile, int(scatter),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SpTRSV kernel launch failed (cudaError {rc})")
    sptrsv_multi.launches += 1
    return x


def sptrsv_multi(tx: torch.Tensor, X: torch.Tensor, plan,
                 kind: int) -> torch.Tensor:
    """Batched triangular solve of X[n, B] (returns a new tensor).

    tx: the factor's value array (1-D tensor; the plan's positions index
    it), on X's device and in X's dtype. plan: `solve.tri_plan(t, kind)`.
    kind: 0 lsolve / 1 usolve (scatter form), 2 ltsolve / 3 utsolve (gather
    form). A CUDA tensor goes through the kernel; a CPU tensor through the
    plain version.
    """
    st, ev, dv, eb = _prepass(tx, X, plan, kind)
    if X.numel() == 0:
        return X.clone()
    if X.device.type == "cuda":
        return _sweep_cuda(st, ev, dv, eb, X, plan, kind)
    if X.device.type == "cpu":
        return _sweep_plain(st, ev, dv, eb, X, plan, kind)
    raise ValueError(f"no SpTRSV path for device {X.device}")


sptrsv_multi.launches = 0  # kernel launches (the CPU path does not count)
