"""The port's spans and counters (``sem_tpu_torch.utils.profiling``) on its
solve path: tracing changes no bit of a solve, every host read goes through
``profiling.read``, ``ns.inner_its`` counts the NS f32 chunks' iterations,
spans nest per thread, and (``cuda``-marked, on the card) the spans lie on
the device trace's clock and make no host read of their own."""
import threading

import pytest
import torch

from sem_tpu_torch import NavierStokesSolver, build_cache
from sem_tpu_torch.coupling import build_coupled, solve_continued
from sem_tpu_torch.models import navier_stokes as nsmod
from sem_tpu_torch.ops import LAUNCHES
from sem_tpu_torch.utils import profiling

from tests.torch_parity import one_torch_thread  # noqa: F401

P4 = dict(P_cd=4, N_ex_cd=4, N_ey_cd=4, P_ns=4, N_ex_ns=4, N_ey_ns=4)
JNK = dict(Re=1e3, Ra=1e3, Pr=0.71, mode="JNK", mtol_nonlin=1e-8,
           iprint=False, **P4)
CASES = {
    "lid": None,
    "jnk_fused": dict(fused=True, device_krylov=False),
    "jnk_unfused": dict(fused=False, device_krylov=False),
    "jnk_windows": dict(device_krylov=True),
}
#: the conversions of a tensor to host values
CONVERSIONS = ("tolist", "item", "__float__", "__bool__", "__int__",
               "__index__", "numpy")


def _solve(case, device="cpu"):
    """Build and solve one case; returns (fields, stats)."""
    if CASES[case] is None:
        ns = NavierStokesSolver(1.0, 1.0, Re=100.0, Gr=0.0, P=4, N_ex=4,
                                N_ey=4, u_N=1.0, mtol=1e-12,
                                mtol_newton=5e-12, iprint=[], device=device)
        T = torch.zeros(ns.N, dtype=torch.float64, device=device)
        u, v, p = ns._get_solution(T)
        return (u, v, p), {"newton": ns._k, "solves": ns.iter_count_solve,
                           "f64": ns.f64_fallback_count}
    _, ns, mda = build_coupled(1.0, 1.0, device=device, **JNK, **CASES[case])
    s = mda.solve()
    return (s.T, s.u, s.v, s.p), dict(vars(mda.stats),
                                      f64=ns.f64_fallback_count)


def _diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _run(case, on, monkeypatch):
    """One solve with tracing on or off, built afresh (the registry of
    ``sem_tpu_torch.build_cache`` emptied first), the tensor-to-host
    conversions and the NS Krylov calls' iterations counted on the side."""
    build_cache.clear()
    calls = {"conversions": 0, "ns_krylov_its": 0, "b2_calls": 0}

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, **k):
            calls["conversions"] += 1
            return orig(self, *a, **k)

        return counted

    def krylov_counted(fn):
        def counted(*a, **k):
            out = fn(*a, **k)
            if a[1].dtype == torch.float32:     # a chunk, not an f64 solve
                calls["ns_krylov_its"] += out[1].iterations
            return out

        return counted

    def b2_counted(*a, **k):
        calls["b2_calls"] += 1
        return b2(*a, **k)

    b2 = nsmod.apply_coupled_system_best
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    profiling.take_spans()
    (profiling.enable if on else profiling.disable)()
    before = profiling.counters()
    with monkeypatch.context() as mp:
        for name in ("gmres", "fgmres"):
            mp.setattr(nsmod, name, krylov_counted(getattr(nsmod, name)))
        mp.setattr(nsmod, "apply_coupled_system_best", b2_counted)
        for name in CONVERSIONS:
            mp.setattr(torch.Tensor, name, counting(name))
        try:
            fields, stats = _solve(case)
        finally:
            profiling.disable()
    counters = _diff(profiling.counters(), before)
    return dict(fields=fields, stats=stats, launches=dict(LAUNCHES),
                counters=counters, spans=profiling.take_spans(), **calls)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    with pytest.MonkeyPatch.context() as mp:
        return request.param, {on: _run(request.param, on, mp)
                               for on in (False, True)}


def test_tracing_changes_no_bit(runs):
    """Answers, solver stats, kernel launches and every counter are the
    same with tracing on and off; spans are logged only when it is on."""
    case, r = runs
    for a, b in zip(r[False]["fields"], r[True]["fields"]):
        assert torch.equal(a, b)
    for key in ("stats", "launches", "counters", "conversions"):
        assert r[False][key] == r[True][key], key
    assert r[False]["spans"] == []
    names = {s.name for s in r[True]["spans"]}
    assert {"ns.chunk", "ns.update", "build.host", "build.upload",
            "read.pass"} <= names
    assert {"mda.newton", "mda.linearize", "mda.fgmres", "mda.precon",
            "mda.step", "mda.sweep", "cd.chunk"} <= names \
        or case == "lid"


def test_every_host_read_goes_through_read(runs):
    """The tensor-to-host conversions a solve makes (``tolist``, ``item``,
    ``float``, ``bool``, ``int``, ``index``, ``numpy``), counted by patching
    them, equal the program's ``reads.*`` counters; with tracing on each
    read is a ``read.<site>`` span."""
    case, r = runs
    for on in (False, True):
        reads = sum(v for k, v in r[on]["counters"].items()
                    if k.startswith("reads."))
        assert reads > 0 and r[on]["conversions"] == reads, (on, r[on])
    spans = [s for s in r[True]["spans"] if s.name.startswith("read.")]
    assert len(spans) == reads
    assert {s.name[5:] for s in spans} == {
        k[6:] for k in r[True]["counters"] if k.startswith("reads.")}


def test_ns_inner_its_counts_the_chunks(runs):
    """``ns.inner_its`` is the sum of the iterations of the NS Krylov calls
    on float32 right-hand sides, the chunks (no solve fell back to float64),
    and at most the calls of the B2 matvec, which each chunk's restarts call
    too."""
    case, r = runs
    for on in (False, True):
        assert r[on]["stats"]["f64"] == 0
        its = r[on]["counters"]["ns.inner_its"]
        assert its == r[on]["ns_krylov_its"] > 0
        assert its <= r[on]["b2_calls"]
    chunks = [s for s in r[True]["spans"] if s.name == "ns.chunk"]
    assert chunks and all(s.start <= s.end for s in chunks)


def test_spans_nest_and_close_in_order(runs):
    """On one thread a span that opens inside another closes before it, one
    level deeper; ``ns.chunk`` lies inside ``ns.update`` or, in a coupled
    solve, inside ``mda.precon`` or ``mda.sweep``."""
    case, r = runs
    spans = r[True]["spans"]
    assert len({s.thread for s in spans}) == 1
    for i, s in enumerate(spans):
        parents = [p for p in spans[i + 1:]
                   if p.depth < s.depth and p.start <= s.start <= p.end]
        if s.depth:
            assert parents and parents[0].depth == s.depth - 1
            assert s.end <= parents[0].end
    outer = ("ns.update", "mda.precon", "mda.sweep")
    for s in spans:
        if s.name == "ns.chunk":
            assert any(p.name in outer and p.start <= s.start
                       and s.end <= p.end for p in spans)


def test_span_off_is_one_shared_noop():
    """With tracing off ``span`` returns one shared object and logs
    nothing; ``read`` still counts."""
    profiling.disable()
    profiling.take_spans()
    assert profiling.span("a") is profiling.span("b")
    before = profiling.counters().get("reads.test", 0)
    with profiling.span("a"):
        assert profiling.read(torch.ones(2), "test") == [1.0, 1.0]
    assert profiling.take_spans() == []
    assert profiling.counters()["reads.test"] == before + 1
    snap = profiling.counters()
    assert {"launches.apply_coupled_system",
            "collectives.all_reduce"} <= set(snap)


def test_worker_thread_spans_do_not_nest_under_the_solve():
    """A span opened in another thread while the main thread's span is open
    starts at depth 0 of its own thread; ``solve_continued`` at P2→P4, which
    builds the P4 level in a worker thread while the main thread solves P2,
    logs the worker's ``build.host`` spans at depth 0 (and, built afresh,
    its ``build.upload`` spans)."""
    build_cache.clear()
    profiling.take_spans()
    profiling.enable()
    try:
        with profiling.span("outer"):
            t = threading.Thread(target=lambda: profiling.span("inner")
                                 .__enter__().__exit__())
            t.start()
            t.join(timeout=60)
        assert not t.is_alive()
        solve_continued(1.0, 1.0, levels=1, device="cpu", **JNK)
    finally:
        profiling.disable()
    spans = profiling.take_spans()
    main = threading.get_ident()
    inner, outer = spans[:2]
    assert (inner.name, inner.depth, outer.name) == ("inner", 0, "outer")
    assert inner.thread != main and outer.start < inner.start < outer.end
    worker = [s for s in spans[2:] if s.thread != main]
    assert {s.name for s in worker} == {"build.host", "build.upload"}
    assert all(s.depth == 0 for s in worker)


@pytest.mark.cuda
def test_spans_lie_on_the_device_traces_clock():
    """On the card: a span around a ``torch.cuda._sleep`` kernel and a
    ``synchronize``, with ``torch.profiler`` taking CUDA activities, holds
    the kernel's device interval within 100 µs on both sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device trace's clock")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    profiling.take_spans()
    profiling.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with profiling.span("sleep"):
                torch.cuda._sleep(2_000_000)     # about a millisecond
                torch.cuda.synchronize()
    profiling.disable()
    spans = profiling.take_spans()
    kernels = sorted((e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() != DeviceType.CPU
                     and "spin_kernel" in e.name())
    assert len(kernels) == len(spans) == 5
    for s, (k0, k1) in zip(spans, kernels):
        assert s.start - 100_000 <= k0 < k1 <= s.end + 100_000, (s, k0, k1)


#: the synchronizing calls of a solve that are not host reads: uploads of
#: host arrays (the constants of a new solver, the CPU-drawn probes)
UPLOADS = ("torch.as_tensor(", "torch.tensor(", ".to(device=")


@pytest.mark.cuda
def test_spans_make_no_host_read_of_their_own():
    """On the card, under ``torch.cuda.set_sync_debug_mode("warn")``: a
    lid-cavity solve at P4 with tracing on warns of a synchronizing call
    only inside ``profiling.read``, at most once per host read, and at the
    uploads of host arrays (:data:`UPLOADS`), which are not reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: synchronizing calls")
    import linecache
    import warnings

    _solve("lid", device="cuda")      # the kernel library, the disk cache
    torch.cuda.synchronize()
    before = profiling.counters()
    profiling.enable()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _solve("lid", device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
        profiling.disable()
        profiling.take_spans()
    reads = sum(v for k, v in _diff(profiling.counters(), before).items()
                if k.startswith("reads."))
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    in_read = [w for w in syncs if w.filename == profiling.__file__]
    others = {(w.filename, w.lineno,
               linecache.getline(w.filename, w.lineno).strip())
              for w in syncs if w.filename != profiling.__file__}
    assert 0 < len(in_read) <= reads
    assert all(any(u in line for u in UPLOADS) for _, _, line in others), \
        sorted(others)
