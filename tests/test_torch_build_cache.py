"""The registry of grid-only construction products
(``sem_tpu_torch.build_cache``): a second build of the same grids finds
every grid, FDM solver and spectral Schur block of the first, with their
device constants, and gives the bits of a fresh build; keys that differ
miss; the registry is bounded, its host arrays read-only, and a threaded
level build of ``solve_continued`` shares it safely.  (``cuda``-marked, on
the card: a second build makes no upload of a registry constant.)"""
import pytest
import torch

from sem_tpu_torch import NavierStokesSolver, build_cache
from sem_tpu_torch.coupling import build_coupled, solve_continued
from sem_tpu_torch.models.convection_diffusion import ConvectionDiffusionSolver
from sem_tpu_torch.utils import profiling

from tests.torch_parity import one_torch_thread  # noqa: F401

#: CD and NS on different grids, as in the benchmark's coupled cells
JNK = dict(Pr=0.71, mode="JNK", mtol_nonlin=1e-8, iprint=False, P_cd=3,
           N_ex_cd=4, N_ey_cd=4, P_ns=4, N_ex_ns=4, N_ey_ns=4)
LID = dict(Gr=0.0, P=4, N_ex=4, N_ey=4, u_N=1.0, mtol=1e-12,
           mtol_newton=5e-12, iprint=[])
#: per case: the two values of Re (lid cavity) or Ra (coupled JNK) a sweep
#: visits, and the owners a build asks the registry for (grids, FDM
#: solvers, spectral Schur data)
CASES = {"lid": ((100.0, 120.0), 3), "jnk": ((1e3, 2e3), 5)}


@pytest.fixture(autouse=True)
def empty_registry():
    """Each test starts from an empty registry: its hits and misses are its
    own builds', whatever ran before it in the process."""
    build_cache.clear()


def _build_solve(case, value, device="cpu"):
    """Build at ``value`` of the case's parameter and solve from zero:
    (the fields, the solvers)."""
    if case == "lid":
        ns = NavierStokesSolver(1.0, 1.0, Re=value, device=device, **LID)
        u, v, p = ns._get_solution(torch.zeros(ns.N, dtype=torch.float64,
                                               device=device))
        return (u, v, p), (ns,)
    cd, ns, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=value, device=device,
                                **JNK)
    s = mda.solve()
    return (s.T, s.u, s.v, s.p), (cd, ns)


def _owners(solvers):
    out = []
    for s in solvers:
        out += [s.grid, s._fdm]
        if isinstance(s, NavierStokesSolver):
            out.append(s._spec)
    return out


def _build_counts(after, before):
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ("build.cache_hits", "build.cache_misses")}


def _sweep(case, device="cpu"):
    """A cold build and solve at the first value, a warm one (traced) at
    the second, then a cold one at the second after ``clear()``."""
    (a, b), _ = CASES[case]
    build_cache.clear()
    out = {}
    for label, value, cold in (("first", a, True), ("warm", b, False),
                               ("fresh", b, True)):
        if cold:
            build_cache.clear()
        before = profiling.counters()
        profiling.take_spans()
        profiling.enable()
        try:
            fields, solvers = _build_solve(case, value, device)
        finally:
            profiling.disable()
        out[label] = dict(fields=fields, owners=_owners(solvers),
                          counts=_build_counts(profiling.counters(), before),
                          spans={s.name for s in profiling.take_spans()})
    return out


@pytest.fixture(scope="module", params=list(CASES))
def sweep(request):
    return request.param, _sweep(request.param)


def test_second_build_hits_every_owner(sweep):
    """A cold build misses once per owner it asks for; a second build of
    the same grids at another Re or Ra hits every one, gets the same
    objects, and uploads nothing (no ``build.upload`` span in its build or
    its solve)."""
    case, r = sweep
    n = CASES[case][1]
    assert r["first"]["counts"] == {"build.cache_hits": 0,
                                    "build.cache_misses": n}
    assert r["warm"]["counts"] == {"build.cache_hits": n,
                                   "build.cache_misses": 0}
    assert all(a is b for a, b in zip(r["first"]["owners"],
                                      r["warm"]["owners"]))
    assert "build.upload" in r["first"]["spans"]
    assert "build.upload" not in r["warm"]["spans"]
    assert "build.host" in r["warm"]["spans"]


def test_warm_build_gives_the_bits_of_a_fresh_one(sweep):
    """Back-to-back builds at two Re (lid cavity) or two Ra (coupled JNK):
    the second, built on the first's registry entries, gives fields
    bitwise equal to a build at the same value after ``clear()``."""
    case, r = sweep
    assert not any(a is b for a, b in zip(r["fresh"]["owners"],
                                          r["warm"]["owners"]))
    for w, f in zip(r["warm"]["fields"], r["fresh"]["fields"]):
        assert torch.equal(w, f)


def _ns(**kw):
    return NavierStokesSolver(1.0, kw.pop("L_x", 1.0), Re=100.0,
                              device="cpu", **{**LID, **kw})


def _cd(**sides):
    return ConvectionDiffusionSolver(1.0, 1.0, Pe=10.0, P=4, N_ex=4, N_ey=4,
                                     device="cpu", **sides)


#: per key: a base build and one that differs in that key alone, and the
#: owners the second misses (the rest it finds)
DIFFERS = {
    "P": (lambda: _ns(), lambda: _ns(P=3), 3),
    "N_ex": (lambda: _ns(), lambda: _ns(N_ex=5), 3),
    "L": (lambda: _ns(), lambda: _ns(L_x=1.5), 3),
    "dirichlet_sides": (lambda: _cd(T_W=0.5, T_E=-0.5),
                        lambda: _cd(T_W=0.5, T_E=-0.5, T_S=0.0, T_N=0.0), 1),
    "pcd_neumann_fdm": (lambda: _ns(), lambda: _ns(schur_precon="pcd"), 1),
}


@pytest.mark.parametrize("key", list(DIFFERS))
def test_keys_that_differ_miss(key):
    """A build that differs from the one before in P, the element count,
    the domain length, the Dirichlet sides or (``'pcd'``) in needing the
    Neumann FDM misses exactly the owners that key changes, and gets new
    objects for them."""
    base, other, misses = DIFFERS[key]
    a = base()
    before = profiling.counters()
    b = other()
    counts = _build_counts(profiling.counters(), before)
    asks = 2 + isinstance(b, NavierStokesSolver)
    assert counts == {"build.cache_hits": asks - misses,
                      "build.cache_misses": misses}
    if misses == asks:
        assert a.grid is not b.grid and a._fdm is not b._fdm
    elif key == "dirichlet_sides":
        assert a.grid is b.grid and a._fdm is not b._fdm
    else:
        assert a.grid is b.grid and a._fdm is b._fdm
        assert a._fdm_p is None and b._fdm_p is not None


def test_alpha_is_part_of_the_fdm_key():
    """FDM solvers of one grid and sides that differ in the mass shift α
    are two entries; the same α is one."""
    g = build_cache.grid(3, 2, 2, 1.0, 1.0)
    f0 = build_cache.fdm(g)
    assert build_cache.fdm(g, alpha=0.0) is f0
    f1 = build_cache.fdm(g, alpha=1.0)
    assert f1 is not f0 and f1.alpha == 1.0
    assert build_cache.fdm(g, alpha=1.0) is f1


def test_eviction_bound_and_clear():
    """The registry holds at most ``MAX_GRIDS`` grid configurations, least
    recently used out first: a grid asked for again stays, the oldest
    go and are built anew when asked for; ``clear()`` empties it."""
    n = build_cache.MAX_GRIDS

    def ask(k):
        return build_cache.grid(2, k, 1, 1.0, 1.0)

    grids = {k: ask(k) for k in range(1, n + 1)}
    assert ask(1) is grids[1]                          # now the newest
    grids.update((k, ask(k)) for k in (n + 1, n + 2))  # 2 and 3 go
    held = [1] + list(range(4, n + 3))
    before = profiling.counters()
    assert all(ask(k) is grids[k] for k in held)
    assert _build_counts(profiling.counters(), before) == {
        "build.cache_hits": n, "build.cache_misses": 0}
    assert ask(2) is not grids[2] and ask(3) is not grids[3]
    assert _build_counts(profiling.counters(), before) == {
        "build.cache_hits": n, "build.cache_misses": 2}
    build_cache.clear()
    assert ask(n + 2) is not grids[n + 2]


#: the host arrays of a solver's shared owners, by name
SHARED = {
    "grid.K1x": lambda ns: ns.grid.K1x,
    "grid.gidx_flat": lambda ns: ns.grid.gidx_flat,
    "grid.mass_diag": lambda ns: ns.grid.mass_diag,
    "grid.points": lambda ns: ns.grid.points,
    "grid.KG1yT": lambda ns: ns.grid.KG1yT,
    "fdm.Zx": lambda ns: ns._fdm._Zx,
    "fdm.ginv": lambda ns: ns._fdm._ginv,
    "fdm.bmask": lambda ns: ns._fdm._bmask,
    "spectral.Zx": lambda ns: ns._spec.host["Zx"],
    "spectral.Kbb_inv": lambda ns: ns._spec.host["Kbb_inv"],
    "spectral.K1yTe": lambda ns: ns._spec.host["K1yTe"],
}


@pytest.mark.parametrize("name", list(SHARED))
def test_a_write_to_a_shared_host_array_raises(name):
    """Every host array of a shared grid, FDM solver or spectral Schur
    block is read-only: an in-place write raises."""
    a = SHARED[name](_ns())
    with pytest.raises(ValueError, match="read-only"):
        a[(0,) * a.ndim] = True if a.dtype == bool else 1.0


def test_threads_asking_together_share_one_object_per_key():
    """Sixteen threads at a short switch interval ask together for the
    grids and FDM solvers of three configurations and for one device
    constant of each grid: every thread gets the one object per key and
    the one tensor per constant, and the registry counts one miss per key
    and a hit for every other ask."""
    import sys
    import threading

    from sem_tpu_torch.utils.tensors import device_const

    configs = [(2, k, 1, 1.0, 1.0) for k in (1, 2, 3)]
    got, errors = [], []
    start = threading.Barrier(16)

    def work():
        try:
            start.wait(timeout=30)
            mine = []
            for _ in range(20):
                for c in configs:
                    g = build_cache.grid(*c)
                    f = build_cache.fdm(g)
                    t = device_const(g, "stress", lambda: g.mass_diag,
                                     torch.float32, "cpu")
                    mine.append((c, g, f, t))
            got.append(mine)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    before = profiling.counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(got) == 16
    for c in configs:
        seen = [(g, f, t) for mine in got for (k, g, f, t) in mine if k == c]
        assert len(seen) == 16 * 20
        assert all(x is y for row in seen for x, y in zip(row, seen[0]))
    asks = 16 * 20 * len(configs) * 2
    assert _build_counts(profiling.counters(), before) == {
        "build.cache_hits": asks - 2 * len(configs),
        "build.cache_misses": 2 * len(configs)}


def test_solve_continued_with_a_threaded_level_build():
    """``solve_continued`` on the ladder (P_cd, P_ns) = (2, 4) → (4, 4)
    builds the fine level in a worker thread while the main thread solves
    the coarse one on the P4 grid that the fine level's CD and NS solvers
    share: it converges to the MDA tolerance, and run again on the warm
    registry it gives the same bits."""
    kw = dict(Re=1e3, Ra=1e3, Pr=0.71, mode="JNK", mtol_nonlin=1e-8,
              iprint=False, N_ex_cd=4, N_ey_cd=4, N_ex_ns=4, N_ey_ns=4,
              ladder=[(2, 4), (4, 4)], device="cpu")
    cd, ns, mda, s = solve_continued(1.0, 1.0, **kw)
    assert cd.grid is ns.grid
    assert float(torch.linalg.vector_norm(mda._residuals(s))) \
        <= mda.atol_nonlin
    before = profiling.counters()
    cd2, ns2, mda2, s2 = solve_continued(1.0, 1.0, **kw)
    assert _build_counts(profiling.counters(), before)[
        "build.cache_misses"] == 0
    assert ns2._fdm is ns._fdm and ns2._spec is ns._spec
    for k in ("T", "u", "v", "p"):
        assert torch.equal(getattr(s, k), getattr(s2, k)), k
    assert mda2.stats.as_list() == mda.stats.as_list()


@pytest.mark.cuda
def test_second_build_on_the_card_uploads_no_registry_constant():
    """On the card, two coupled JNK builds on ``dvd``'s shapes at small P
    (CD and NS on different grids): the second, at another Ra, gives the
    bits of a fresh build at that Ra and logs no ``build.upload``; under
    ``torch.cuda.set_sync_debug_mode("warn")`` (every blocking host-to-device
    copy synchronizes) it makes no copy in ``device_const``, where the fresh
    build makes one per constant, and the same copies and reads elsewhere
    (the solvers' own masks and Dirichlet values, the host reads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device constants and copies")
    import collections
    import warnings

    from sem_tpu_torch.utils import tensors

    def traced(value):
        """(fields, build.upload spans, synchronizing calls by file)"""
        torch.cuda.synchronize()
        profiling.take_spans()
        profiling.enable()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fields, _ = _build_solve("jnk", value, "cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
            profiling.disable()
        uploads = sum(s.name == "build.upload"
                      for s in profiling.take_spans())
        syncs = collections.Counter(
            (w.filename, w.lineno) for w in caught
            if "synchronizing" in str(w.message))
        return fields, uploads, syncs

    def in_device_const(syncs):
        return sum(n for (f, _), n in syncs.items() if f == tensors.__file__)

    a, b = CASES["jnk"][0]
    build_cache.clear()
    _build_solve("jnk", a, "cuda")          # the kernel library, the disk
    build_cache.clear()                     # cache, the cuBLAS handles
    _, up_first, _ = traced(a)
    warm, up_warm, sync_warm = traced(b)
    build_cache.clear()
    fresh, up_fresh, sync_fresh = traced(b)
    assert up_first > 0 and up_warm == 0 and up_fresh == up_first
    assert in_device_const(sync_warm) == 0
    assert in_device_const(sync_fresh) == up_fresh
    others = collections.Counter({k: n for k, n in sync_fresh.items()
                                  if k[0] != tensors.__file__})
    assert sync_warm == others
    for w, f in zip(warm, fresh):
        assert torch.equal(w, f)
