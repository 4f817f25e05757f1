"""The supernodal schedule of the SpTRSV sweep on the CPU: `ops.snode`'s
panels and tasks (`TriPlan.snode`), the plain version that follows them
(`sptrsv_plain_snode_multi`) against the whole level schedule and the JAX
package, the kernel's ticket scheduler replayed in numpy in the orders a
card may run it, and the rule that engages the "supernodal" variant
(`sptrsv_cuda.launch_config`) at the benchmark cells' shapes.

The triangles are `snode_patterns.PATTERNS`: Cholesky factors of Laplacians,
of a 27-point 3D problem and of a random SPD matrix, a wide root, and panels
all of one column.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu_torch as rt  # noqa: E402
import torch_cases as C  # noqa: E402
from rsparse_tpu_torch.ops import snode  # noqa: E402
from rsparse_tpu_torch.ops import sptrsv_cuda as sc  # noqa: E402
from rsparse_tpu_torch.symbolic import native  # noqa: E402
from snode_patterns import (  # noqa: E402
    PATTERNS, TASK_ENTRIES, chol as _chol, plan as _plan,
    triangle as _triangle)

H100_SMEM = 232448  # an H100's opt-in shared memory per CTA, in bytes


def _rows(L, j):
    """Column j's rows below the diagonal, ascending."""
    seg = L.i[L.p[j]: L.p[j + 1]]
    assert seg[0] == j  # the diagonal first
    return np.sort(seg[1:])


@pytest.mark.parametrize("kind", [0, 2])
@pytest.mark.parametrize("name", PATTERNS)
def test_panels_and_tasks(name, kind):
    """Every column in one panel of nested patterns (at most PANEL wide), the
    rows below each panel and its parent as the pattern says, every panel
    in exactly one task (a bottom subtree, or alone above them), tasks in
    a topological ticket order with the dependency counts of the task tree,
    levels in dependency order inside a task, and each entry in its own
    slot of the packed blocks."""
    L = _triangle(name)
    sp = _plan(L, kind).snode
    pn = sp.panels
    n = L.n
    pf, pw, pm = (pn.pf.astype(np.int64), pn.pw.astype(np.int64),
                  pn.pm.astype(np.int64))
    assert pf[0] == 0 and np.array_equal(pf[1:], (pf + pw)[:-1])
    assert pf[-1] + pw[-1] == n
    assert pw.min() >= 1 and pw.max() <= snode.PANEL
    pid = np.repeat(np.arange(pn.npanel), pw)
    for s in range(pn.npanel):
        f, w, m = pf[s], pw[s], pm[s]
        below = pn.prow[pn.prow_off[s]: pn.prow_off[s] + m]
        assert np.all(np.diff(below) > 0) and (m == 0 or below[0] > f + w - 1)
        for j in range(f, f + w):
            assert np.array_equal(_rows(L, j),
                                  np.r_[np.arange(j + 1, f + w), below])
        assert pn.pparent[s] == (pid[below[0]] if m else -1)
    if name == "width1":
        assert pw.max() == 1
    if name == "wide_root":
        assert (pm == 0).sum() >= 1 and pw[pid[n - 71]:].sum() == 71
        assert pid[n - 1] - pid[n - 71] + 1 == 3  # 71 columns, 3 panels
    # groups: each panel once; a group's panels form its top's subtree
    assert np.array_equal(np.sort(sp.pan), np.arange(pn.npanel))
    ntask = sp.ngroup
    task_of = np.empty(pn.npanel, dtype=np.int64)
    level_of = np.empty(pn.npanel, dtype=np.int64)
    for t in range(ntask):
        for lev in range(sp.task_lvl[t], sp.task_lvl[t + 1]):
            got = sp.pan[sp.lvl_pan[lev]: sp.lvl_pan[lev + 1]]
            assert len(got)
            task_of[got], level_of[got] = t, lev
    tparent = np.full(ntask, -1)
    entries = np.zeros(ntask, dtype=np.int64)
    np.add.at(entries, task_of, pw * (pw + 1) // 2 + pw * pm)
    for s in range(pn.npanel):
        up = pn.pparent[s]
        if up < 0:
            continue
        if task_of[up] == task_of[s]:  # the parent's level comes after (0)
            assert (level_of[up] > level_of[s]) == (kind == 0)
            assert level_of[up] != level_of[s]
        else:
            assert tparent[task_of[s]] in (-1, task_of[up])
            tparent[task_of[s]] = task_of[up]
    nlev = np.diff(sp.task_lvl)
    top = np.array([sp.pan[sp.lvl_pan[sp.task_lvl[t + 1] - 1 if kind == 0
                                      else sp.task_lvl[t]]]
                    for t in range(ntask)])
    upper = ~pn.subtree[top]
    assert np.all(entries[~upper] <= TASK_ENTRIES)
    assert np.all(nlev[upper] == 1)  # a panel above the subtrees alone
    assert np.all(np.diff(sp.lvl_pan)[sp.task_lvl[:-1][upper]] == 1)
    assert 0 < np.unique(pn.root[pn.subtree]).size < ntask  # subtree tasks
    # tasks: each group's parts in order, together: a panel above the
    # subtrees parts its rows below in PART_ROWS at most, else one part
    g, p, k = sp.grp, sp.part, sp.nparts
    assert np.array_equal(np.unique(g), np.arange(ntask))
    assert np.all(np.diff(g) >= 0) and np.array_equal(p, snode._seg_arange(
        np.bincount(g)))
    assert np.array_equal(k, np.bincount(g)[g])
    m_top = pn.pm[top][g]
    assert np.array_equal(k > 1, upper[g] & (m_top > snode.PART_ROWS))
    if name.startswith("hpcg27"):  # a 3D factor's separators are parted
        assert k.max() > 2
    assert np.all(-(-m_top // k) <= np.where(upper[g], snode.PART_ROWS, m_top))
    parts = np.bincount(g)
    has = tparent >= 0
    kids = np.bincount(tparent[has], minlength=ntask)
    if kind == 0:  # children first; a group waits on its own counter
        assert np.all(tparent[has] > np.flatnonzero(has))
        need = np.bincount(tparent[has], weights=parts[has], minlength=ntask)
        assert np.array_equal(sp.need, need[g])
        assert np.array_equal(sp.wait, np.where(need > 0, np.arange(ntask),
                                                -1)[g])
        assert np.array_equal(sp.signal, tparent[g])
    else:  # the parent first; a task waits on its parent's counter
        assert np.all(tparent[has] < np.flatnonzero(has))
        assert np.array_equal(sp.need, has.astype(int)[g])
        assert np.array_equal(sp.wait, tparent[g])
        assert np.array_equal(sp.signal,
                              np.where(kids > 0, np.arange(ntask), -1)[g])
    # the packed blocks: one slot per entry, inside its panel's block
    assert len(np.unique(pn.vslot)) == L.nnz() == len(pn.vpos)
    assert np.array_equal(np.sort(pn.vpos), np.arange(L.nnz()))
    wq = -(-pw // snode.VEC) * snode.VEC
    end = pn.pval_off.astype(np.int64) + (pw + pm) * wq
    assert end[-1] == pn.val_total and np.all(pn.vslot < pn.val_total)


def test_snode_none_where_the_schedule_does_not_apply():
    """Kinds 1 and 3 have no supernodal schedule; nor does a triangle whose
    pattern is not closed along its panel tree (the kernel checks'
    synthetic triangle), nor one whose diagonal is not first."""
    import chip_smoke

    L = _triangle("poisson16")
    Ls, Us = chip_smoke.synthetic_triangle(3000, 40, 0)
    assert rt.tri_plan(Us, 1).snode is None and rt.tri_plan(Us, 3).snode is None
    assert rt.tri_plan(Ls, 0).snode is None and rt.tri_plan(Ls, 2).snode is None
    U = rt.Sprs(L.nnz(), L.n, L.n, L.p, L.i[::-1].copy(), L.x)
    assert snode.snode_panels(U.n, U.p, U.i) is None


@pytest.mark.parametrize("kind", [0, 2])
def test_remapped_plan_reads_the_larger_array(kind):
    """`remap_positions` (a factor stored inside a larger value array, as
    the level Cholesky keeps L_NN) maps the supernodal value positions too:
    the plain version on the larger array gives the original answer."""
    L = _triangle("poisson27")
    plan = rt.tri_plan(L, kind)
    nz = L.nnz()
    pos = np.arange(nz, dtype=np.int64) * 2 + 3  # L's values at odd slots
    big = np.zeros(2 * nz + 3)
    big[pos] = L.x[:nz]
    X = torch.as_tensor(np.random.default_rng(6).standard_normal((L.n, 32)))
    want = sc.sptrsv_plain_snode_multi(torch.as_tensor(L.x[:nz]), X, plan, kind)
    got = sc.sptrsv_plain_snode_multi(torch.as_tensor(big), X,
                                      plan.remap_positions(pos), kind)
    assert torch.equal(got, want)


def _X(L, kind):
    """The right-hand sides of a triangle: 128 seeded columns."""
    return np.random.default_rng(kind).standard_normal((L.n, 128))


_LEVELS: dict = {}


def _levels(name, kind, dtype):
    """The whole level schedule's answer on `_X`'s 128 columns, once per
    (pattern, kind, dtype): it treats each column on its own, so its first
    B columns are its answer at B."""
    if (name, kind, dtype) not in _LEVELS:
        L = _triangle(name)
        tx = torch.as_tensor(L.x[: L.nnz()], dtype=dtype)
        _LEVELS[name, kind, dtype] = sc.sptrsv_plain_multi(
            tx, torch.as_tensor(_X(L, kind), dtype=dtype), _plan(L, kind),
            kind)
    return _LEVELS[name, kind, dtype]


@pytest.mark.parametrize("B", [32, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("kind", [0, 2])
@pytest.mark.parametrize("name", PATTERNS)
def test_plain_snode_matches_levels_and_jax(name, kind, dtype, tol, B):
    """The supernodal plain version against the whole level schedule (in
    its dtype) and the JAX package's f64 sweep: f32 reorders and rounds
    (the TPU test's tolerance), f64 reorders sums only."""
    L = _triangle(name)
    plan = _plan(L, kind)
    X = _X(L, kind)
    tx = torch.as_tensor(L.x[: L.nnz()], dtype=dtype)
    Xt = torch.as_tensor(X[:, :B], dtype=dtype)
    got = sc.sptrsv_plain_snode_multi(tx, Xt, plan, kind)
    assert got.dtype == dtype and got.shape == Xt.shape
    assert C.rel(got, _levels(name, kind, dtype)[:, :B]) < tol
    assert C.rel(got, C.jax_answer(C.jax_sweep, L, X, kind)[:, :B]) < tol


def _replay(tx, X, plan, kind, ctas, ntile, launches, seed):
    """The kernel's scheduler replayed on the CPU: `ctas` CTAs take tickets
    (task, tile) from a counter that wraps as atomicInc does; a random CTA
    whose task's counter has risen by `need` in this launch (the epoch)
    runs the task whole (kind 0: a part arrives after solving its triangle,
    the group's last to arrive stores it; kind 2: a part adds its sums,
    the last to arrive solves and alone signals), then adds one to the
    counter it signals. The counters are never reset. Returns each
    launch's X."""
    rng = random.Random(seed)
    ks = sc._snode_streams(plan, kind, X.device)
    val = sc._snode_values(tx, ks)
    info, pval = ks["pinfo"].tolist(), ks["pval"].tolist()
    tl, lp = ks["task_lvl"].tolist(), ks["lvl_pan"].tolist()
    pan, prow, grp = ks["pan"].tolist(), ks["prow"].long(), ks["grp"].tolist()
    pk = ks["part"].tolist()
    wait, need = ks["wait"].tolist(), ks["need"].tolist()
    signal = ks["signal"].tolist()
    total, ng = len(grp) * ntile, ks["ngroup"] * ntile
    ctr = [0] * (2 * ng + 1)  # group counters, the ticket, arrivals
    cols = np.array_split(np.arange(X.shape[1]), ntile)
    outs = []

    def take():
        t = ctr[ng]
        ctr[ng] = 0 if t >= total + ctas - 1 else t + 1
        return t

    for epoch in range(launches):
        x, acc = X.clone(), {}
        held = [take() for _ in range(ctas)]
        while any(t is not None for t in held):
            ready = [c for c, t in enumerate(held) if t is not None and (
                t >= total or wait[t // ntile] < 0
                or ctr[wait[t // ntile] * ntile + t % ntile]
                - (epoch + 1) * need[t // ntile] >= 0)]
            assert ready, "the scheduler deadlocked"
            c = rng.choice(ready)
            t = held[c]
            if t >= total:
                held[c] = None
                continue
            task, cc = t // ntile, torch.as_tensor(cols[t % ntile])
            g, (p, k) = grp[task], pk[task]
            for lev in range(tl[g], tl[g + 1]):
                for s in pan[lp[lev]: lp[lev + 1]]:
                    f, w, m, ro = info[s]
                    wq = -(-w // snode.VEC) * snode.VEC
                    blk = val[pval[s]: pval[s] + (w + m) * wq].view(
                        w + m, wq)[:, :w]
                    tri = blk[:w].clone()
                    tri.diagonal().reciprocal_()
                    b0, b1 = m * p // k, m * (p + 1) // k
                    low, rows = blk[w + b0: w + b1], prow[ro + b0: ro + b1]
                    if kind == 0:
                        xp = torch.linalg.solve_triangular(
                            tri, x[f:f + w][:, cc], upper=False)
                        last = k == 1
                        if k > 1:  # arrive; the last part stores
                            a = ng + 1 + g * ntile + t % ntile
                            last, ctr[a] = ctr[a] == k - 1, (
                                0 if ctr[a] >= k - 1 else ctr[a] + 1)
                        if last:
                            x[f:f + w, cc] = xp
                        x[rows[:, None], cc[None]] -= low @ xp
                    else:  # the parts' sums meet in acc; the last solves
                        key = (g, t % ntile)
                        acc[key] = acc.get(key, 0) + low.T @ x[rows][:, cc]
                        last = k == 1
                        if k > 1:
                            a = ng + 1 + g * ntile + t % ntile
                            last, ctr[a] = ctr[a] == k - 1, (
                                0 if ctr[a] >= k - 1 else ctr[a] + 1)
                        if last:
                            y = x[f:f + w][:, cc] - acc.pop(key)
                            x[f:f + w, cc] = torch.linalg.solve_triangular(
                                tri.T, y, upper=True)
            if signal[task] >= 0 and (kind == 0 or last):
                ctr[signal[task] * ntile + t % ntile] += 1
            held[c] = take()
        assert ctr[ng] == 0 and not any(ctr[ng + 1:])  # wrapped for the next
        outs.append(x)
    return outs


@pytest.mark.parametrize("kind", [0, 2])
@pytest.mark.parametrize("name", ["poisson27", "hpcg27_10", "random",
                                  "width1"])
def test_ticket_scheduler_replayed(name, kind):
    """Any order the card may run the tickets in gives the level sweep's
    answer, launch after launch on the same counters (epochs), with fewer
    CTAs than tickets and without deadlock."""
    L = _triangle(name)
    plan = _plan(L, kind)
    tx = torch.as_tensor(L.x[: L.nnz()])
    X = torch.as_tensor(_X(L, kind)[:, :9])
    want = _levels(name, kind, torch.float64)[:, :9]
    for seed, outs in enumerate(_replay(tx, X, plan, kind, 5, 3, 3, s)
                                for s in range(2)):
        for x in outs:
            assert C.rel(x, want) < 1e-12, seed


def _cell_plans():
    """The benchmark cells' sweeps as their handles plan them, on the host
    engine's factors: lap2d-256's L (kinds 0 and 2: cholsol_serve) and
    cd2d-128's L and U (kinds 0 and 1: lusol_serve)."""
    from benchmark.generators import convdiff5, poisson5

    n, p, i, x = poisson5.make({"grid": 256}, None)
    L = _chol(C.port((n, n, p, i, x)), 1)
    n2, p2, i2, x2 = convdiff5.make({"grid": 128, "peclet": [0.5, 0.25]},
                                    None)
    a = C.port((n2, n2, p2, i2, x2))
    s = rt.sqr(a, 1, False)
    Lp, Li, Lx, Up, Ui, Ux, _ = native.lu_numeric(
        n2, a.p, a.i, a.x, s.q, 1e-6, s.lnz, s.unz)
    Lc = rt.Sprs(len(Lx), n2, n2, Lp, Li, np.asarray(Lx))
    Uc = rt.Sprs(len(Ux), n2, n2, Up, Ui, np.asarray(Ux))
    return ({0: rt.tri_plan(L, 0), 2: rt.tri_plan(L, 2)},
            {0: rt.tri_plan(Lc, 0), 1: rt.tri_plan(Uc, 1)})


def test_engagement_at_the_cells_shapes():
    """The supernodal variant runs wherever a sweep is of kind 0 or 2, of
    one instance, over B >= 32 columns, on a plan that has `snode` with at
    least SNODE_LEVELS[dtype] levels per panel of its panel tree's height
    (5 in float32, 1.5 in float64), whether or not X's column fits in a
    CTA's shared memory, and is chosen without finding the dense block:
    lap2d-256's six sweeps a request (float32, and float64 too), cd2d-128's
    L and a 27-point 3D factor's L and L' (X's column in shared memory;
    each 16-17 levels a panel) take it. B < 32 and K > 1 keep the shared
    variant where X's column fits and the global one where it does not;
    kinds 1 and 3 (cd2d-128's U) keep theirs; so do a 16 x 16 Laplacian's
    factor in float32 (2.6 levels a panel) and the wide root's band (1.2)."""
    lap, cd = _cell_plans()
    hp = _triangle("hpcg27_10")
    hp = {0: rt.tri_plan(hp, 0), 2: rt.tri_plan(hp, 2)}
    f32, f64 = torch.float32, torch.float64
    cfg = lambda plan, kind, B, dtype=f32, **kw: sc.launch_config(
        plan, dtype, "cpu", kind, B, smem_optin=H100_SMEM, **kw)["variant"]
    for plans, n, other in ((lap, 65536, "global"), (hp, 1000, "shared")):
        for kind, plan in plans.items():
            assert plan.snode is not None and plan.snode.panels.n == n
            assert cfg(plan, kind, 128) == "supernodal"
            assert cfg(plan, kind, 128, f64) == "supernodal"
            assert cfg(plan, kind, 32) == "supernodal"
            assert "dense" not in plan.__dict__  # the choice did not need it
            assert cfg(plan, kind, 31) == other
            assert cfg(plan, kind, 128, K=2) == other
    assert cfg(lap[0], 1, 128) == "global"
    assert cfg(lap[2], 3, 128) == "global"
    assert cd[0].n == cd[1].n == 16384
    assert cfg(cd[0], 0, 128) == "supernodal"
    assert "dense" not in cd[0].__dict__
    assert cfg(cd[1], 1, 128) == "shared"
    for name, f64_variant in (("poisson16", "supernodal"),
                              ("wide_root", "shared")):
        for kind in (0, 2):
            plan = rt.tri_plan(_triangle(name), kind)
            assert cfg(plan, kind, 128) == "shared"
            assert cfg(plan, kind, 128, f64) == f64_variant
    smem = sc.launch_config(lap[2], f32, "cpu", 2, 128,
                            smem_optin=H100_SMEM)["smem"]
    assert 0 < smem <= H100_SMEM // 2  # two CTAs an SM


def test_cpu_sweep_counts_no_supernodal_launch():
    L = _triangle("poisson16")
    before = (sc.sptrsv_multi.launches, sc.sptrsv_multi.supernodal)
    rt.lsolve_multi(L, np.ones((L.n, 40)), device="cpu")
    assert (sc.sptrsv_multi.launches, sc.sptrsv_multi.supernodal) == before


class _Stream:
    """A stand-in for a CUDA stream: its handle, the events it was made to
    wait for, and the events recorded on it."""

    def __init__(self, handle):
        self.cuda_stream, self.waited, self.recorded = handle, [], []

    def wait_event(self, event):
        self.waited.append(event)

    def record_event(self, event=None):
        event = event if event is not None else object()
        self.recorded.append(event)
        return event


def test_launches_on_other_streams_wait_for_the_last():
    """The supernodal counters' launch order (`_in_order`): each launch
    gets the next epoch; one on the stream of the last launch waits for
    nothing; one on another stream first waits for the event recorded
    after the last launch; a launch that raises counts for nothing."""
    c = dict(epoch=0, stream=None, done=None)
    s1, s2 = _Stream(11), _Stream(22)
    epochs = []
    for s in (s1, s1, s2, s2, s1):
        with sc._in_order(c, s) as epoch:
            epochs.append(epoch)
    assert epochs == [0, 1, 2, 3, 4]
    assert len(s1.waited) == len(s2.waited) == 1  # at the two switches
    assert s1.waited[0] is s2.waited[0] is c["done"]  # one event, recorded
    assert (len(s1.recorded), len(s2.recorded)) == (3, 2)  # after each
    with pytest.raises(RuntimeError):
        with sc._in_order(c, s2):
            raise RuntimeError("launch refused")
    assert c["epoch"] == 5 and c["stream"] == 11 and len(s2.recorded) == 2
    with sc._in_order(c, s1) as epoch:
        assert epoch == 5
    assert len(s1.waited) == 1
