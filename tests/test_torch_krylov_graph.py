"""The CUDA graph of the plain f32 chunks' operator
(``sem_tpu_torch.krylov.CapturedOperator``): off the card, under a process
group and inside a running capture the operator runs eagerly and the
solvers' chunks give the bits they gave before, with nothing captured; on
the card (``cuda``-marked) the graphed chunks and solves give the eager
bits and launch counts, one capture per linearization, and no device
memory outlives the solvers."""
import gc
import types

import numpy as np
import pytest
import torch

from sem_tpu_torch import ConvectionDiffusionSolver, NavierStokesSolver
from sem_tpu_torch import krylov
from sem_tpu_torch.coupling import build_coupled
from sem_tpu_torch.ops import LAUNCHES
from sem_tpu_torch.parallel.sharding import use_group
from sem_tpu_torch.utils.profiling import COUNTERS

from tests.torch_parity import one_torch_thread  # noqa: F401

F32 = torch.float32
GRAPH_COUNTERS = ("krylov.captures", "krylov.replays")


def _graph_counts():
    return tuple(COUNTERS[k] for k in GRAPH_COUNTERS)


def _condition(name, monkeypatch):
    """Enter one of the conditions under which the operator runs eagerly
    (besides the CPU itself): an active process group (a one-rank stub,
    under which the solvers keep their plain chunks) or a capture running
    on the current stream."""
    if name == "group":
        ctx = use_group(types.SimpleNamespace(world=1))
        ctx.__enter__()
        return lambda: ctx.__exit__(None, None, None)
    if name == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    return lambda: None


def _ns(device, P=4, Ne=4):
    """A lid cavity solver linearized at a smooth field, with the f32
    histories on."""
    ns = NavierStokesSolver(1.0, 1.0, Re=100.0, Gr=0.0, P=P, N_ex=Ne,
                            N_ey=Ne, u_N=1.0, iprint=["LGMRES_iter"],
                            device=device)
    x, y = (torch.as_tensor(a, device=device) for a in ns.points)
    _linearize_ns(ns, x, y, 1.0)
    return ns


def _linearize_ns(ns, x, y, scale):
    u = scale * torch.sin(np.pi * x) * torch.cos(np.pi * y)
    v = -scale * torch.cos(np.pi * x) * torch.sin(np.pi * y)
    ns._calc_jacobians(u, v, sigma=0.5 * scale)


def _cd(device, P=4, Ne=4):
    """A CD solver with a rotating wind and a mass shift."""
    cd = ConvectionDiffusionSolver(1.0, 1.0, Pe=50.0, P=P, N_ex=Ne, N_ey=Ne,
                                   T_W=0.5, T_E=-0.5, iprint=["LGMRES_iter"],
                                   device=device)
    x, y = (torch.as_tensor(a, device=device) for a in cd.points)
    _linearize_cd(cd, x, y, 1.0)
    return cd


def _linearize_cd(cd, x, y, scale):
    u = scale * (y - 0.5)
    v = scale * (0.5 - x)
    T = torch.zeros_like(x)
    cd._get_residuals(T, u, v)
    cd._calc_jacobians(T, sigma=0.25 * scale)


def _parts(kind, solver):
    return (solver._refinement_parts(0) if kind == "ns"
            else solver._refinement_parts())


def _eager_chunk(kind, solver):
    """The plain chunk as the solvers built it before the graph: GMRES on
    the eager operator."""
    if kind == "ns":
        mv32, pc32 = solver._coupled_ops(*solver._lin32(), F32)
        sigma = solver._sigma

        def op(q):
            return pc32(mv32(q), sigma)
    else:
        mv32 = solver._mv(*solver._lin32(), solver._sigma)
        fdm, sigma = solver._fdm, solver._sigma

        def op(q):
            return fdm(mv32(q), sigma=sigma)

    restart = solver._restart
    kw = dict(basis_dtype=solver._basis_dtype) if kind == "ns" else {}

    def chunk(rp, x0, atol_lp):
        return krylov.gmres(op, rp, x0=x0, atol=atol_lp, restart=restart,
                            maxiter=2 * restart + 5, return_hist=True, **kw)

    return chunk


def _rhs(kind, solver, pc_lp, seed=0):
    """A chunk's right-hand side: a pass's preconditioned residual of a
    seeded f64 vector, and the chunk tolerance the refinement gives it."""
    g = torch.Generator().manual_seed(seed)
    n = 3 * solver.N if kind == "ns" else solver.N
    r = torch.randn(n, generator=g, dtype=torch.float64).to(solver.device)
    rp = pc_lp(r.to(F32))
    return rp, torch.zeros_like(rp), 1e-5 * float(torch.linalg.norm(rp))


def _same(a, b):
    """Two chunks' ``(x, KrylovInfo, hist)`` agree bit for bit."""
    assert torch.equal(a[0], b[0])
    assert a[1] == b[1]
    assert torch.equal(a[2], b[2])


@pytest.mark.parametrize("condition", ["cpu", "group", "capturing"])
def test_captured_operator_runs_eagerly(condition, monkeypatch):
    """Off the card, under a process group and inside a capture the
    wrapper calls the operator itself at every call and captures
    nothing."""
    calls = []

    def fn(q):
        calls.append(q)
        return 2.0 * q + 1.0

    op = krylov.CapturedOperator(fn)
    q = torch.arange(6, dtype=F32)
    before = _graph_counts()
    leave = _condition(condition, monkeypatch)
    try:
        outs = [op(q + k) for k in range(3)]
    finally:
        leave()
    assert len(calls) == 3 and op.graph is None
    for k, out in enumerate(outs):
        assert torch.equal(out, 2.0 * (q + k) + 1.0)
    assert _graph_counts() == before


@pytest.mark.parametrize("condition", ["cpu", "group", "capturing"])
@pytest.mark.parametrize("kind", ["ns", "cd"])
def test_refinement_chunks_unchanged(kind, condition, monkeypatch):
    """The NS and CD ``_refinement_parts`` chunks give the eager chunk's
    ``x``, ``KrylovInfo`` and history bit for bit, twice on the same parts,
    and the graph counters stay 0."""
    solver = _ns("cpu") if kind == "ns" else _cd("cpu")
    before = _graph_counts()
    leave = _condition(condition, monkeypatch)
    try:
        _, pc_lp, chunk = _parts(kind, solver)
        eager = _eager_chunk(kind, solver)
        for seed in (0, 1):
            args = _rhs(kind, solver, pc_lp, seed)
            got = chunk(*args)
            assert got[1].iterations > 0
            _same(got, eager(*args))
    finally:
        leave()
    assert _graph_counts() == before


# ------------------------------ on the card ------------------------------ #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are captured there")
    return torch.device("cuda")


def _launches():
    return dict(LAUNCHES)


def _diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ns", "cd"])
def test_graphed_chunks_match_eager_on_the_card(kind):
    """On the card: two chunks of one linearization's parts, then two of a
    new linearization's, give the eager chunks' bits and kernel launch
    counts; each linearization captures once, every later operator call
    replays."""
    dev = _card()
    solver = _ns(dev, P=8) if kind == "ns" else _cd(dev, P=8)
    x, y = (torch.as_tensor(a, device=dev) for a in solver.points)
    relinearize = _linearize_ns if kind == "ns" else _linearize_cd
    for lin, scale in enumerate((1.0, 1.5)):
        if lin:
            relinearize(solver, x, y, scale)
        _, pc_lp, chunk = _parts(kind, solver)
        eager = _eager_chunk(kind, solver)
        for seed in (0, 1):
            args = _rhs(kind, solver, pc_lp, seed)
            l0, c0 = _launches(), _graph_counts()
            got = chunk(*args)
            l1, c1 = _launches(), _graph_counts()
            want = eager(*args)
            l2 = _launches()
            _same(got, want)
            assert _diff(l1, l0) == _diff(l2, l1) != {}
            # every iteration applies the operator once, and so does the
            # residual at each cycle's start and end; a new linearization's
            # first application is the eager one before its capture
            its = got[1].iterations
            assert c1[0] - c0[0] == (1 if seed == 0 else 0)
            assert its <= c1[1] - c0[1] <= 2 * its + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lid", "jnk_fused"])
def test_graphed_solves_match_eager_on_the_card(case, monkeypatch):
    """On the card: a lid-cavity Newton solve at P8 4×4 and a fused JNK
    coupled solve at P4 give the same fields, statistics and kernel launch
    counts with the graphs as with the eager operator, and capture at most
    once per ``_refinement_parts`` call."""
    dev = _card()
    parts = {"n": 0}

    def counted(cls):
        orig = cls._refinement_parts

        def wrapper(self, *a, **k):
            parts["n"] += 1
            return orig(self, *a, **k)

        monkeypatch.setattr(cls, "_refinement_parts", wrapper)

    counted(NavierStokesSolver)
    counted(ConvectionDiffusionSolver)

    def solve():
        if case == "lid":
            ns = NavierStokesSolver(1.0, 1.0, Re=100.0, Gr=0.0, P=8, N_ex=4,
                                    N_ey=4, u_N=1.0, mtol=1e-12,
                                    mtol_newton=5e-12, iprint=[],
                                    device=dev)
            T = torch.zeros(ns.N, dtype=torch.float64, device=dev)
            return ns._get_solution(T), (ns._k, ns.iter_count_solve)
        _, ns, mda = build_coupled(
            1.0, 1.0, Re=1e3, Ra=1e3, Pr=0.71, mode="JNK", mtol_nonlin=1e-8,
            iprint=False, P_cd=4, N_ex_cd=4, N_ey_cd=4, P_ns=4, N_ex_ns=4,
            N_ey_ns=4, fused=True, device_krylov=False, device=dev)
        s = mda.solve()
        return (s.T, s.u, s.v, s.p), tuple(sorted(vars(mda.stats).items()))

    solve()          # the kernel library, the disk cache, cuBLAS
    runs = {}
    for graphed in (True, False):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(krylov.CapturedOperator, "__call__",
                          lambda self, q: self.fn(q))
            parts["n"] = 0
            l0, c0 = _launches(), _graph_counts()
            fields, stats = solve()
            runs[graphed] = dict(
                fields=fields, stats=stats, launches=_diff(_launches(), l0),
                captures=_graph_counts()[0] - c0[0],
                replays=_graph_counts()[1] - c0[1], parts=parts["n"])
    g, e = runs[True], runs[False]
    assert g["stats"] == e["stats"]
    assert all(torch.equal(a, b) for a, b in zip(g["fields"], e["fields"]))
    assert g["launches"] == e["launches"] != {}
    assert 0 < g["captures"] <= g["parts"] and g["replays"] > 0
    assert e["captures"] == e["replays"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("condition", ["capturing", "group"])
def test_nothing_captured_on_the_card(condition):
    """On the card: called inside a running capture the operator is
    captured into that graph as its own kernels (the outer graph's replay
    gives the eager bits), and under a process group it runs eagerly; in
    neither case does the wrapper capture a graph of its own."""
    dev = _card()
    ns = _ns(dev, P=8)
    mv32, pc32 = ns._coupled_ops(*ns._lin32(), F32)

    def fn(q):
        return pc32(mv32(q), ns._sigma)

    op = krylov.CapturedOperator(fn)
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3 * ns.N, generator=g, dtype=F32).to(dev)
    want = fn(q)          # the eager bits; uploads the constants
    torch.cuda.synchronize()
    before = _graph_counts()
    if condition == "capturing":
        static = q.clone()
        outer = torch.cuda.CUDAGraph()
        with torch.cuda.graph(outer):
            out = op(static)
        outer.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    else:
        with use_group(types.SimpleNamespace(world=1)):
            for _ in range(3):
                assert torch.equal(op(q), want)
    assert op.graph is None
    assert _graph_counts() == before


@pytest.mark.cuda
def test_graphs_leak_no_device_memory(monkeypatch):
    """On the card: the device memory held and the memory the caching
    allocator reserves after two lid-cavity solvers were built, solved and
    dropped are what one left behind: the graphs, their pools and buffers
    go with their solvers' parts.  No capture makes a CUDA stream: each new
    stream would keep a cuBLAS workspace of its own for as long as the
    process lives, which the memory held after a solver shows only until
    the pool of streams has gone round once."""
    dev = _card()
    made = []

    class Counted(torch.cuda.Stream):
        def __new__(cls, *a, **k):
            if "stream_id" not in k:      # not a wrapper of a stream
                made.append(1)
            return super().__new__(cls, *a, **k)

    def one():
        ns = NavierStokesSolver(1.0, 1.0, Re=100.0, Gr=0.0, P=8, N_ex=4,
                                N_ey=4, u_N=1.0, mtol=1e-12,
                                mtol_newton=5e-12, iprint=[], device=dev)
        T = torch.zeros(ns.N, dtype=torch.float64, device=dev)
        c0 = _graph_counts()
        ns._get_solution(T)
        assert _graph_counts()[0] > c0[0]
        del ns, T
        gc.collect()
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(dev),
                torch.cuda.memory_reserved(dev))

    one()            # the kernel library, cuBLAS and its workspaces
    monkeypatch.setattr(torch.cuda, "Stream", Counted)
    held = [one(), one()]
    assert held[0] == held[1], held
    assert not made
