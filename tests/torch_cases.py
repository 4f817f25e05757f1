"""The inputs of the port's parity tests (`tests/test_torch_*.py`), and the
JAX package's answers on them.

A case is a name in `CASES`: a matrix family at one size and seed, built
once per process as numpy CSC fields `(m, n, p, i, x)` (read-only).
`port(case)` and `jax(case)` make a fresh `Sprs` of either package from it
(a test may change its values), `dense(case)` its dense matrix (duplicate
entries summed). Where a size was chosen for a route, the comment beside
it names the route; a new test takes an existing case, and adds one only
for a route that no case reaches.

The JAX package compiles its programs for each pattern it meets, and a
pytest-xdist worker (`--dist loadfile`) keeps them across tests and files:
one small set of patterns is compiled once per worker. `jax_answer(call,
case, *args)` keeps each answer of the JAX package once per process, keyed
by the call, the case, its arguments and the config it ran under, as
read-only numpy arrays. The same input still goes through both packages
in the run; nothing is stored between runs.

This module imports numpy alone; the port, jax and the JAX package only
inside the functions that need them, so that `test_torch_kernel.py` and
the card command (`python -m pytest --noconftest -m gpu
tests/test_torch_kernel.py`) import it without JAX, and the JAX package's
reference processes of `torch_dist_ranks.py` without torch. It also runs
torch's intra-op work on one thread in each test process
(`TORCH_THREADS`): the tier-1 command runs six workers on one machine,
beside XLA's own threads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys

import numpy as np

# ---------------------------------------------------------------------------
# The families: numpy CSC fields (m, n, p, i, x)
# ---------------------------------------------------------------------------


def csc(d: np.ndarray):
    """CSC fields of a dense matrix's nonzeros (rows ascending)."""
    m, n = d.shape
    c, r = np.nonzero(d.T)  # column-major order: (col, row)
    p = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=p[1:])
    return m, n, p, r.astype(np.int64), d[r, c]


def _sprs_fields(a):
    nz = a.nnz()
    return (a.m, a.n, np.asarray(a.p), np.asarray(a.i[:nz]),
            np.asarray(a.x[:nz], np.float64))


def laplacian(g: int):
    """The g x g 5-point Laplacian (SPD): 4 on the diagonal, -1 beside."""
    from bench import laplacian_5pt

    n, p, i, x = laplacian_5pt(g)
    return n, n, p, i, x


def hpcg27(g: int, values: str = "hpcg", seed: int = 0):
    """HPCG's 27-point pattern on a g^3 box (`benchmark/generators/
    hpcg27.py`): HPCG's values, or seeded random symmetric ones made SPD
    by a dominant diagonal."""
    from benchmark.generators import hpcg27 as gen

    n, p, i, x = gen.make({"grid": g}, None)
    if values == "random":
        cols = np.repeat(np.arange(n), np.diff(p))
        key = np.minimum(i, cols) * n + np.maximum(i, cols)
        _, pair = np.unique(key, return_inverse=True)
        rng = np.random.default_rng(seed)
        x = -rng.uniform(0.5, 1.5, pair.max() + 1)[pair]
        off = i != cols
        rowsum = np.bincount(cols[off], np.abs(x[off]), minlength=n)
        x[~off] = rowsum[cols[~off]] + 0.25
    return n, n, p, i, np.asarray(x, np.float64)


def grid_unsym(g: int, seed: int):
    """The chip smoke's lusol matrix at a test size: the g x g 5-point
    pattern, off-diagonals -(1 + 0.3 N(0,1)), diagonal 1 + the larger of
    its row's and column's absolute sums."""
    from chip_smoke import make_matrix

    return _sprs_fields(make_matrix(g, seed))


def grid_ls(g: int, seed: int = 0):
    """The chip smoke's least-squares matrix [A5; 0.1 I] at a test size
    (A5 = grid_unsym(g, seed): m = 2 g², n = g²)."""
    from chip_smoke import qr_matrix

    return _sprs_fields(qr_matrix(seed, g))


def rand_square(n: int, seed: int, density: float):
    """A random n x n matrix of the given density, its diagonal made
    dominant (row abs-sum + 1)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    np.fill_diagonal(d, np.abs(d).sum(1) + 1.0)
    return csc(d)


def rand_tall(m: int, n: int, seed: int, density: float):
    """A random m x n matrix of the given density, 3 added to its leading
    diagonal."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    d[np.arange(n), np.arange(n)] += 3.0
    return csc(d)


def sparse_ls(m: int, n: int, extra: int, seed: int = 0, dup: bool = False):
    """An m x n sparse matrix with a dominant diagonal (the JAX package's
    `_sparse_ls`, tests/test_frontal_qr.py): 5 + U(0, 1) on the diagonal and
    `extra` normal draws added at random places; with `dup` every 7th entry
    is stored twice (the first copy a different value)."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, n))
    d[np.arange(n), np.arange(n)] = 5.0 + rng.random(n)
    for _ in range(extra):
        i, j = rng.integers(0, m), rng.integers(0, n)
        d[i, j] += rng.standard_normal()
    m, n, p, rows, vals = csc(d)
    if dup:
        cols = np.repeat(np.arange(n), np.diff(p))
        k = np.arange(0, len(rows), 7)
        rows = np.insert(rows, k, rows[k])
        cols = np.insert(cols, k, cols[k])
        vals = np.insert(vals, k, vals[k] + 0.5)
        p = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(cols, minlength=n), out=p[1:])
    return m, n, p, rows, vals


def dup_spd(n: int, seed: int):
    """An SPD matrix with duplicate (i, j) entries after `Trpl.sum_dupl`
    (the first slot an explicit zero, the last the sum): 12.5 on the
    diagonal, 3n symmetric pairs of 0.3 N(0, 1)."""
    import rsparse_tpu_torch as rt

    rng = np.random.default_rng(seed)
    t = rt.Trpl()
    for i in range(n):
        t.append(i, i, 10.0)
        t.append(i, i, 2.5)
    for _ in range(3 * n):
        i, j = int(rng.integers(n)), int(rng.integers(n))
        v = 0.3 * rng.standard_normal()
        t.append(min(i, j), max(i, j), v)
        t.append(max(i, j), min(i, j), v)
    t.sum_dupl()
    return _sprs_fields(t.to_sprs())


def pivoting(n: int, seed: int):
    """A sparse random matrix with a weak diagonal: partial pivoting must
    swap rows."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 4.0 / n)
    np.fill_diagonal(d, 1e-3 * rng.standard_normal(n))
    d[rng.permutation(n), np.arange(n)] += 3.0 + rng.random(n)
    return csc(d)


def banded(m: int, n: int, seed: int, offs=(-7, -3, -1, 0, 1, 2, 5),
           far: int = 6):
    """Random values on a few diagonals (each entry kept with probability
    0.85), plus `far` stray entries off the band."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, n))
    for o in offs:
        for j in range(n):
            if 0 <= j + o < m and rng.random() < 0.85:
                d[j + o, j] = rng.standard_normal()
    for _ in range(far):
        d[rng.integers(m), rng.integers(n)] = rng.standard_normal()
    return csc(d)


def laplacian_stray(n: int, seed: int, far: int):
    """A 5-point Laplacian (g = n**0.5) with `far` stray entries added off
    its band, which a `max_diags=5` plan sends to the COO remainder."""
    d = dense(laplacian(int(round(n ** 0.5))))
    rng = np.random.default_rng(seed)
    for _ in range(far):
        d[rng.integers(n), rng.integers(n)] = rng.standard_normal()
    return csc(d)


def rand_density(rng, m: int, n: int, density: float):
    """A random m x n matrix of the given density, its values standard
    normal (drawn from `rng`, after the pattern)."""
    return csc((rng.random((m, n)) < density) * rng.standard_normal((m, n)))


def rand_pattern(m: int, n: int, nnz: int, seed: int):
    """A uniform random pattern, duplicates merged (bench.py's
    `rand_csc`)."""
    from bench import rand_csc

    p, i, x = rand_csc(m, n, nnz, seed)
    return m, n, p, i, x


# The README's (and the reference's lib.rs docs') dense 8 x 8 and its b
README_A = [
    [8.2541e-01, 9.5622e-01, 4.6698e-01, 8.4410e-03, 6.3193e-01, 7.5741e-01, 5.3584e-01, 3.9448e-01],
    [7.4808e-01, 2.0403e-01, 9.4649e-01, 2.5086e-01, 2.6931e-01, 5.5866e-01, 3.1827e-01, 2.9819e-02],
    [6.3980e-01, 9.1615e-01, 8.5515e-01, 9.5323e-01, 7.8323e-01, 8.6003e-01, 7.5761e-01, 8.9255e-01],
    [1.8726e-01, 8.9339e-01, 9.9796e-01, 5.0506e-01, 6.1439e-01, 4.3617e-01, 7.3369e-01, 1.5565e-01],
    [2.8015e-02, 6.3404e-01, 8.4771e-01, 8.6419e-01, 2.7555e-01, 3.5909e-01, 7.6644e-01, 8.9905e-02],
    [9.1817e-01, 8.6629e-01, 5.9917e-01, 1.9346e-01, 2.1960e-01, 1.8676e-01, 8.7020e-01, 2.7891e-01],
    [3.1999e-01, 5.9988e-01, 8.7402e-01, 5.5710e-01, 2.4707e-01, 7.5652e-01, 8.3682e-01, 6.3145e-01],
    [9.3807e-01, 7.5985e-02, 7.8758e-01, 3.6881e-01, 4.4553e-01, 5.5005e-02, 3.3908e-01, 3.4573e-01],
]
README_B = [0.4377, 0.7328, 0.1227, 0.1817, 0.2634, 0.6876, 0.8711, 0.4201]


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

CASES = {
    # 5-point Laplacians (SPD)
    "lap8": lambda: laplacian(8),  # n = 64: the level Cholesky, no tail
    # n = 144: the level routes in every order (natural order: the level
    # Cholesky's all-dense tail, cut = 0); at mf_min_n = 100 the
    # multifrontal one-shot, its skeleton dense
    "lap12": lambda: laplacian(12),
    # a tail after a level phase whose leading block is swept (the cut
    # rule's defaults and DENSE_NN_MAX patched down); the halo partition
    "lap16": lambda: laplacian(16),
    "lap20": lambda: laplacian(20),  # n = 400: the card tests' solvers
    "lap24": lambda: laplacian(24),  # RECURSE_MIN = 150: recursive skeleton
    # the chip smoke's nonsymmetric 5-point matrix
    "unsym6": lambda: grid_unsym(6, 0),  # n = 36: the level LU or its escape
    # n = 144: at mf_min_n = 100 the multifrontal LU, dense skeleton
    "unsym12": lambda: grid_unsym(12, 0),
    # DENSE_SKEL_MAX = 24: the skeleton recurses; innermost dense (20) or
    # the level LU (24); unpatched, 24's skeleton is one dense block of 109
    # columns (the sweep's dense split)
    "unsym20": lambda: grid_unsym(20, 0),
    "unsym24": lambda: grid_unsym(24, 0),
    # natural order: the level LU takes its static pivots, few levels
    "rand50": lambda: rand_square(50, 0, 0.15),
    "dup150": lambda: dup_spd(150, 0),  # duplicates; mf_min_n = 50: MF
    "pivot200": lambda: pivoting(200, 3),  # mf_min_n <= 200: MF pivoting
    "readme8": lambda: csc(np.array(README_A)),
    "upper2x2": lambda: csc(np.array([[2.0, 1.0], [0.0, 3.0]])),
    "readme3x2": lambda: csc(np.array([[1.0, 0.0], [0.0, 2.0], [1.0, 1.0]])),
    # least squares: level QR in natural (40 x 15) and AMD (60 x 40) order
    "tall40x15": lambda: rand_tall(40, 15, 1, 0.35),
    "tall60x40": lambda: rand_tall(60, 40, 2, 0.08),
    # columns 3 and 4 share their only row: fictitious rows (m2 > m)
    "deficient": lambda: deficient(),
    # the multifrontal QR (mf_min_n = 100) and its plan at smax = 16
    "ls": lambda: sparse_ls(LS_M, LS_N, LS_EXTRA),
    "ls_dup": lambda: sparse_ls(LS_M, LS_N, LS_EXTRA, dup=True),
    "ls_mn": lambda: transposed(sparse_ls(LS_M, LS_N, LS_EXTRA)),
    # the chip smoke's [A5; 0.1 I] (m = 2 g^2): level (6), MF at
    # mf_min_n = 50 (10), another dimension (5)
    "grid_ls5": lambda: grid_ls(5),
    "grid_ls6": lambda: grid_ls(6),
    "grid_ls6t": lambda: transposed(grid_ls(6)),
    "grid_ls10": lambda: grid_ls(10),
    "grid_ls10t": lambda: transposed(grid_ls(10)),
}
LS_M, LS_N, LS_EXTRA = 150, 100, 450


def deficient():
    m, n, p, i, x = rand_tall(30, 20, 0, 0.1)
    d = dense((m, n, p, i, x))
    d[:, 3:5] = 0.0
    d[5, 3], d[5, 4] = 1.0, 2.0
    return csc(d)


def transposed(f):
    return csc(dense(f).T.copy())


_FIELDS: dict = {}


def fields(case: str):
    """The case's CSC fields (m, n, p, i, x), built once, read-only."""
    if case not in _FIELDS:
        m, n, p, i, x = CASES[case]()
        arrs = [np.array(v) for v in (p, i, np.asarray(x, np.float64))]
        for v in arrs:
            v.flags.writeable = False
        _FIELDS[case] = (int(m), int(n), *arrs)
    return _FIELDS[case]


def _fields_of(a):
    """(m, n, p, i, x) of a case name, a dense array or a Sprs of either
    package."""
    if isinstance(a, str):
        return fields(a)
    if isinstance(a, tuple):
        return a
    if isinstance(a, (np.ndarray, list)):
        return csc(np.asarray(a, np.float64))
    return _sprs_fields(a)


def port(a):
    """A fresh port Sprs of `a` (a case name, a dense array or a Sprs of
    either package)."""
    from rsparse_tpu_torch.convert import sprs_from_fields

    m, n, p, i, x = _fields_of(a)
    return sprs_from_fields(m, n, np.array(p), np.array(i), np.array(x))


def jax(a):
    """A fresh JAX-package Sprs of `a` (as `port`)."""
    import rsparse_tpu as rs

    m, n, p, i, x = _fields_of(a)
    return rs.Sprs(len(x), m, n, np.array(p), np.array(i), np.array(x))


def pair(a):
    """(jax(a), port(a))."""
    return jax(a), port(a)


_LU: dict = {}


def host_lu(case, order: int = 1):
    """The host engine's exact LU of a square case in `order` (pivot
    tolerance 1e-6): the fields of L and of U, built once, read-only."""
    if (case, order) not in _LU:
        import rsparse_tpu_torch as rt
        from rsparse_tpu_torch.symbolic import native

        a = port(case)
        s = rt.sqr(a, order, False)
        Lp, Li, Lx, Up, Ui, Ux, _ = native.lu_numeric(
            a.n, a.p, a.i, a.x, s.q, 1e-6, s.lnz, s.unz)
        out = []
        for f in ((Lp, Li, Lx), (Up, Ui, Ux)):
            arrs = [np.array(v) for v in f]
            for v in arrs:
                v.flags.writeable = False
            out.append((a.n, a.n, *arrs))
        _LU[case, order] = tuple(out)
    return _LU[case, order]


def host_tri(case, kind: int):
    """host_lu(case)'s L (kinds 0 and 2) or U (kinds 1 and 3)."""
    return host_lu(case)[0 if kind in (0, 2) else 1]


def symb_fields(sj) -> dict:
    """A copy of a JAX-package analysis' fields, taken before the JAX
    package's multifrontal LU and QR planners rebind `sj.q`."""
    out = {k: getattr(sj, k) for k in ("lnz", "unz", "m2")}
    for k in ("q", "pinv", "parent", "cp"):
        v = getattr(sj, k)
        out[k] = None if v is None else np.array(v)
    return out


def symb(sj):
    """The port's Symb of a JAX-package analysis, or of the fields
    `symb_fields` took of one (copied)."""
    from rsparse_tpu_torch.convert import symb_from_fields

    return symb_from_fields(**(sj if isinstance(sj, dict) else
                               symb_fields(sj)))


def dense(a) -> np.ndarray:
    """The dense matrix of `a` (as `port`), duplicate entries summed."""
    m, n, p, i, x = _fields_of(a)
    d = np.zeros((m, n))
    np.add.at(d, (np.asarray(i), np.repeat(np.arange(n), np.diff(p))), x)
    return d


def diag_mask(a) -> np.ndarray:
    """Which stored entries of `a` (as `port`) lie on the diagonal."""
    m, n, p, i, x = _fields_of(a)
    return np.asarray(i) == np.repeat(np.arange(n), np.diff(p))


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def rel(x, want) -> float:
    """max |x - want| / max(1, max |want|), in float64 (numpy arrays,
    lists, JAX arrays or torch tensors)."""
    x, want = _np(x), _np(want)
    return float(np.abs(x - want).max(initial=0.0)
                 / max(1.0, np.abs(want).max(initial=0.0)))


def close(got, want, tol: float = 1e-12) -> None:
    """Assert that got has want's shape and rel(got, want) <= tol."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = rel(got, want)
    assert err <= tol, f"relative error {err:.3g} > {tol:.3g}"


def same_sprs(got, want, tol: float = 1e-12, nzmax: bool = False,
              values: bool = True) -> None:
    """Assert that got (a Sprs of either package) has want's shape, entry
    count (and nzmax), pattern, and values to `tol` (`close`)."""
    nz = want.nnz()
    assert (got.m, got.n, got.nnz()) == (want.m, want.n, nz)
    if nzmax:
        assert got.nzmax == want.nzmax
    np.testing.assert_array_equal(np.asarray(got.p)[: got.n + 1],
                                  np.asarray(want.p)[: want.n + 1])
    np.testing.assert_array_equal(np.asarray(got.i)[:nz],
                                  np.asarray(want.i)[:nz])
    if values:
        close(np.asarray(got.x)[:nz], np.asarray(want.x)[:nz], tol)


def mf(monkeypatch, n: int = 100) -> None:
    """`config.mf_min_n = n` in both packages: the multifrontal routes at
    a test size (n = 10**9: the level routes)."""
    import rsparse_tpu as rs
    import rsparse_tpu_torch as rt

    monkeypatch.setattr(rs.config, "mf_min_n", n)
    monkeypatch.setattr(rt.config, "mf_min_n", n)


def host(monkeypatch) -> None:
    """`config.backend = "host"` in both packages: the C++ engine."""
    import rsparse_tpu as rs
    import rsparse_tpu_torch as rt

    monkeypatch.setattr(rs.config, "backend", "host")
    monkeypatch.setattr(rt.config, "backend", "host")


def scale_tree(obj, f) -> None:
    """Multiply every floating tensor of a cached factor tree by f, in
    place (a factor off by a relative f - 1)."""
    import torch

    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            obj.mul_(f)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            scale_tree(o, f)


# ---------------------------------------------------------------------------
# The JAX package's answers, once per process
# ---------------------------------------------------------------------------

_ANSWERS: dict = {}


def _key(v):
    if hasattr(v, "nnz") and hasattr(v, "p"):  # a Sprs of either package
        return ("sprs", _key(_sprs_fields(v)))
    if isinstance(v, dict):
        return ("dict", tuple((k, _key(u)) for k, u in sorted(v.items())))
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, v.dtype.str,
                hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_key(u) for u in v))
    return v


def _arg(v):
    """A copy the call may overwrite (the solvers write x into b)."""
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, list):
        return list(v)
    return v


def _frozen(v):
    if isinstance(v, list):  # the solvers' x, as the reference returns it
        v = np.array(v, np.float64)
    if isinstance(v, tuple):
        return tuple(_frozen(u) for u in v)
    if isinstance(v, dict):
        return {k: _frozen(u) for k, u in v.items()}
    if hasattr(v, "__array__") and not hasattr(v, "nnz"):
        out = np.array(v)
        out.flags.writeable = False
        return out
    return v


def jax_sweep(tj, X, kind):
    """The JAX package's f64 level sweep of the triangle tj (a call for
    `jax_answer`)."""
    from rsparse_tpu.solve import _tri_solve_multi

    return _tri_solve_multi(tj, X, kind)


def jax_pallas_sweep(tj, X, kind):
    """The JAX package's Pallas sweep of tj in f32, in interpret mode on
    the CPU (a call for `jax_answer`)."""
    from rsparse_tpu.ops.sptrsv_pallas import sptrsv_pallas_multi
    from rsparse_tpu.solve import tri_plan

    return sptrsv_pallas_multi(tj.x[: tj.nnz()], X, tri_plan(tj, kind), kind)


def jax_answer(call, case, *args, extra=(), **kwargs):
    """The JAX package's `call(jax(case), *args, **kwargs)`, computed once
    per process and kept as read-only numpy arrays (a tuple or dict of them
    for a call that returns several; any other object as it is, shared:
    read it, do not change it).

    `call` is the name of a function of `rsparse_tpu` ("cholsol",
    "lusol_multi", ...) or a function of the JAX package. The key holds
    the call, the case, the arguments, `rsparse_tpu.config` as it stands
    (a test sets `mf_min_n` or `backend` first, with `mf` or `host`) and
    `extra`, which names anything else the answer depends on (a patched
    module constant). Array arguments are passed as copies, so a solver's
    write into b stays inside."""
    import rsparse_tpu as rs

    name = call if isinstance(call, str) else (
        f"{call.__module__}.{call.__qualname__}")
    key = (name, _key(case), _key(args), _key(kwargs),
           dataclasses.astuple(rs.config), extra)
    if key not in _ANSWERS:
        fn = getattr(rs, call) if isinstance(call, str) else call
        out = fn(jax(case), *[_arg(v) for v in args],
                 **{k: _arg(v) for k, v in kwargs.items()})
        _ANSWERS[key] = _frozen(out)
    return _ANSWERS[key]


# Six tier-1 workers share the machine with XLA's own threads, and torch's
# default (one intra-op thread per core in each worker) oversubscribes it:
# each test process runs torch's intra-op work on TORCH_THREADS threads.
# Every port test file imports torch before this module; a process that
# has not loaded torch is left alone.
TORCH_THREADS = 1


def _set_threads():
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.set_num_threads(TORCH_THREADS)


_set_threads()
