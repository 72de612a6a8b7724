"""The benchmark's cell ``dvd_p16_ptc.sweep`` (de Vahl Davis' Ra=1e5 regime,
each request a pseudo-transient march from zero) on the CPU at small sizes:
the cell and its traffic load; the port, driven through the benchmark's
entry on the cell's configuration with its grids cut, meets the cell's
limits while answers that are wrong fail them, and lands on the plain
reference's own dense Newton; the PTC march's spans and counters
(``mda.ptc_step``, ``ptc.*``, ``MDAStats.ptc_*``); and the three metric
readers on synthetic run records.  ``device="cpu"`` throughout; at these
sizes the configuration's program is the on-device windows (the card takes
the fused host FGMRES at 3.4 M DOF), and the tests that hold the spans run
all three programs."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import control
from portbench.generate import block_size, warmup_request
from portbench.reference import boussinesq as ref
from portbench.reference.newton import newton
from portbench.reference.sem import F64
from portbench.run import ROOT, RunRecord, judge, load_cell, load_module
from portbench.trace import Spans
from sem_tpu_torch.coupling import build_coupled
from sem_tpu_torch.coupling import mda as tmda
from sem_tpu_torch.coupling.mda import MDAStats
from sem_tpu_torch.utils import checkpoint as tckpt
from sem_tpu_torch.utils import profiling

from tests.torch_parity import one_torch_thread  # noqa: F401

CELL = "dvd_p16_ptc.sweep"
#: the grids of tests/test_torch_ptc.py's PTC_KW
PTC_GRIDS = dict(P_cd=3, N_ex_cd=4, N_ey_cd=4, P_ns=3, N_ex_ns=8, N_ey_ns=8)
#: a Rayleigh number where JNK from zero is at its limit and PTC marches
RA = 1e4
PTC_COUNTERS = ("ptc.accepted", "ptc.partial", "ptc.rejects.blowup",
                "ptc.rejects.linfail")
PROGRAMS = {"windows": {}, "fused": dict(device_krylov=False),
            "unfused": dict(device_krylov=False, fused=False)}
READERS = ("ptc_steps", "ptc_rejected_steps", "ptc_gmres_its_per_step")


def _cut_cfg(**grids):
    cfg = dict(load_cell(ROOT, CELL)[2])
    cfg.update(grids or PTC_GRIDS)
    return cfg


def _params(ra=RA):
    return dict(load_cell(ROOT, CELL)[3]["fixed"], Ra=ra)


def _ptc_counts(after, before):
    return {k: after.get(k, 0) - before.get(k, 0) for k in PTC_COUNTERS}


def _entry_solve(cfg, params):
    """One request through the benchmark's entry: (host answer, stats,
    the ``ptc.*`` counters it moved)."""
    entry = load_module(ROOT, "entries", cfg["entry"]).Entry(cfg, "cpu")
    before = profiling.counters()
    state, stats = entry.solve(params, None, Spans())
    return entry.to_host(state), stats, _ptc_counts(profiling.counters(),
                                                    before)


@pytest.fixture(scope="module")
def port_answer():
    """The port's answer at ``RA`` from zero on the cut configuration."""
    cfg = _cut_cfg()
    host, stats, counts = _entry_solve(cfg, _params())
    return cfg, host, stats, counts


def _judged(cfg, host, params):
    records = [{"params": params, "error": None, "host": host}]
    checks, failed = judge(ROOT, cfg, records, "cpu")
    return checks, failed


# ------------------------------ (a) the cell ------------------------------ #
def test_cell_loads_with_the_published_point_in_its_block():
    """The cell's configuration is the port's PTC on the north-star grids,
    nothing cut, and its block is the three log-midpoints of [5e4, 2e5], the
    middle one de Vahl Davis' Ra=1e5, which is also the warm-up."""
    _, cell, cfg, mix = load_cell(ROOT, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "dvd_p16_ptc", "ra_sweep_1e5", 1)
    assert cfg["mode"] == "PTC" and cfg["reduced"] == []
    assert (cfg["P_ns"], cfg["N_ex_ns"], cfg["P_cd"], cfg["N_ex_cd"]) == (
        16, 64, 16, 32)
    block = sorted(mix["_law"].block(mix))
    assert block_size(mix) == 3
    np.testing.assert_allclose(block, [6.30e4, 1e5, 1.587e5], rtol=1e-3)
    assert warmup_request(mix) == {"Pr": 0.71, "Re": 1000.0, "Ra": 1e5}
    assert mix["start"] == "zero"


# ------------------------- (b) the port's answer ------------------------- #
def test_port_meets_the_cells_limits(port_answer):
    """Marched from zero through the entry, with every program setting at
    its default, the answer passes the run's own judgement."""
    cfg, host, stats, _ = port_answer
    checks, failed = _judged(cfg, host, _params())
    assert failed == 0, checks
    assert stats["ptc_accepted"] > 0 and stats["gmres_iters"] > 0


WRONG = {
    "float32": lambda h: (control.f32(h), RA),
    "u_scaled": lambda h: (dict(h, u=h["u"] * (1 + 1e-3)), RA),
    "ra_5pc_high": lambda h: (h, 1.05 * RA),
    "ra_5pc_low": lambda h: (h, 0.95 * RA),
}


@pytest.mark.parametrize("wrong", list(WRONG))
def test_wrong_answers_fail_the_limits(port_answer, wrong):
    """The answer held in float32 (the control of ``portbench.control``),
    one with u scaled by 1+1e-3, and the answer read at a Ra 5 % off each
    fail the cell's limits."""
    cfg, host, _, _ = port_answer
    held, ra = WRONG[wrong](host)
    checks, failed = _judged(cfg, held, _params(ra))
    assert failed == 1, checks


def test_reference_newton_along_a_ladder_reaches_the_port():
    """The reference's own dense Newton (least-norm steps), warm-started
    along the ladder Ra = 1e3, 1e4, lands on the port's PTC answer.

    On NS P3 6×6 (CD P3 4×4): at PTC_KW's NS 8×8 a dense Newton step on
    its 2,044 unknowns takes ≈ 7 s on one thread (the ladder ≈ 50 s), and
    there the reference's Jacobian has an exact null vector, a pressure
    mode with small T, u and v parts, along which the two answers differ
    while agreeing to 2.6e-8 off it.  On 6×6 that mode is near-null
    (σ = 1.5e-6 against ‖J‖ = 24), so p is held by the residual check
    above and not compared here.  Tolerance of T, u and v: 1e-6.  Measured:
    1.7e-8 (T) and 1.4e-8 (u, v), with both residuals below the cell's
    1e-8 RMS; moving Ra by 5 % moves the reference's fields by 5.6e-3 (T)
    and 5.9e-4 (u), so a march to the wrong state fails it by far."""
    cfg = _cut_cfg(P_cd=3, N_ex_cd=4, N_ey_cd=4, P_ns=3, N_ex_ns=6,
                   N_ey_ns=6)
    host, _, _ = _entry_solve(cfg, _params())
    gc, gn = ref.grids(cfg)
    nc, nn = gc.N, gn.N

    def split(x):
        return (x[:nc].reshape(gc.Ngx, gc.Ngy),
                *(x[nc + k * nn:nc + (k + 1) * nn].reshape(gn.Ngx, gn.Ngy)
                  for k in range(3)))

    x = torch.zeros(nc + 3 * nn, dtype=F64)
    for ra in (1e3, RA):
        def F(x, ra=ra):
            return torch.cat([r.reshape(-1) for r in ref.coupled_residual(
                gc, gn, cfg["Re"], cfg["Pr"], ra, *split(x))])

        x = newton(F, x, cfg["mtol_nonlin"] * np.sqrt(nc + 3 * nn))
    x = x.numpy()
    for k, field in enumerate("Tuv"):
        got = x[:nc] if k == 0 else x[nc + (k - 1) * nn:nc + k * nn]
        np.testing.assert_allclose(got, host[field], rtol=0, atol=1e-6,
                                   err_msg=field)


# ------------------------- (c) spans and counters ------------------------- #
def test_ptc_counters_equal_the_stats(port_answer):
    """Every step attempt is accepted or rejected, and the ``ptc.*``
    counters moved by exactly the march's stats."""
    _, _, stats, counts = port_answer
    assert stats["ptc_accepted"] + stats["ptc_rejected"] \
        == stats["nonlinear_iters"]
    assert counts["ptc.accepted"] == stats["ptc_accepted"]
    assert counts["ptc.partial"] == stats["ptc_partial"]
    assert counts["ptc.rejects.blowup"] + counts["ptc.rejects.linfail"] \
        == stats["ptc_rejected"]


def test_one_forced_blowup_counts_one_reject(monkeypatch):
    """A step whose residual comes back non-finite once is rejected once,
    as a blow-up, and every other attempt of a six-attempt march is
    accepted.  (The march is bounded: on these coarse grids a 10× cut of Δt
    early in the march leaves SER creeping at one coupled iteration a step
    for more than 300 steps.)"""
    orig = tmda.BoussinesqMDA._try_step
    calls = []

    def blows_up_once(self, s, dx, alpha):
        s_new, F_new, norm = orig(self, s, dx, alpha)
        calls.append(1)
        return s_new, F_new, (float("nan") if len(calls) == 3 else norm)

    monkeypatch.setattr(tmda.BoussinesqMDA, "_try_step", blows_up_once)
    _, _, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=RA, Pr=0.71, mode="PTC",
                              mtol_nonlin=1e-8, iprint=False, device="cpu",
                              maxiter=6, **PTC_GRIDS)
    before = profiling.counters()
    with pytest.raises(RuntimeError, match="no convergence in 6"):
        mda.solve()
    counts = _ptc_counts(profiling.counters(), before)
    st = mda.stats
    assert counts["ptc.rejects.blowup"] == st.ptc_rejected == 1
    assert counts["ptc.rejects.linfail"] == 0
    assert counts["ptc.accepted"] == st.ptc_accepted == 5
    assert counts["ptc.partial"] == st.ptc_partial


def _short_march(program, traced):
    """Four step attempts of each program (the host programs do not
    converge from zero with ``'bgs'`` on these grids, ROADMAP C1): the spans
    while tracing is on, the ``ptc.*`` counters and the stats."""
    _, _, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=RA, Pr=0.71, mode="PTC",
                              mtol_nonlin=1e-8, iprint=False, device="cpu",
                              maxiter=4, **PROGRAMS[program], **PTC_GRIDS)
    profiling.take_spans()
    before = profiling.counters()
    (profiling.enable if traced else profiling.disable)()
    try:
        with pytest.raises(RuntimeError, match="no convergence in 4"):
            mda.solve()
    finally:
        profiling.disable()
    return (profiling.take_spans(), _ptc_counts(profiling.counters(),
                                                before), mda.stats)


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_each_ptc_step_holds_one_linearize_and_one_fgmres(program):
    """With tracing on, each step attempt is one ``mda.ptc_step`` span that
    holds, one level deeper, one ``mda.linearize``, one ``mda.fgmres`` and
    one ``mda.step``; the spans change no count."""
    spans, counts, stats = _short_march(program, traced=True)
    steps = [s for s in spans if s.name == "mda.ptc_step"]
    assert len(steps) == 4 == sum(counts.values()) - counts["ptc.partial"]
    for s in steps:
        held = [r.name for r in spans if r.thread == s.thread
                and s.start <= r.start and r.end <= s.end
                and r.depth == s.depth + 1]
        assert sorted(held) == ["mda.fgmres", "mda.linearize", "mda.step"]
    off = _short_march(program, traced=False)
    assert off[0] == [] and off[1] == counts and off[2] == stats


def test_tracing_changes_no_bit_of_a_march(port_answer):
    """The converged march with tracing on gives the untraced answer and
    stats bit for bit."""
    cfg, host, stats, counts = port_answer
    profiling.enable()
    try:
        traced, traced_stats, traced_counts = _entry_solve(cfg, _params())
    finally:
        profiling.disable()
    assert profiling.take_spans()
    assert traced_stats == stats and traced_counts == counts
    for k in host:
        assert np.array_equal(traced[k], host[k]), k


def test_stats_keep_their_list_positions():
    """The new fields come last with default 0: positional ``MDAStats``,
    ``as_list()`` and the order of the old fields are what they were, and a
    JNK solve leaves them 0."""
    st = MDAStats(3, 4, 5, 6)
    assert st.as_list() == [3, 4, 5]
    assert list(dataclasses.asdict(st).values()) == [3, 4, 5, 6, 0, 0, 0]
    _, _, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=1e3, Pr=0.71,
                              mode="JNK", mtol_nonlin=1e-8, iprint=False,
                              device="cpu", P_cd=3, N_ex_cd=3, N_ey_cd=3,
                              P_ns=3, N_ex_ns=3, N_ey_ns=3)
    mda.solve()
    assert (mda.stats.ptc_accepted, mda.stats.ptc_rejected,
            mda.stats.ptc_partial) == (0, 0, 0)
    assert len(mda.stats.as_list()) == 3


def test_checkpoint_iters_stay_four(tmp_path):
    """A checkpoint written with the wider stats holds the four counts it
    always held."""
    path = str(tmp_path / "c.npz")
    z = torch.zeros(4, dtype=torch.float64)
    tckpt.save_checkpoint(path, tmda.CoupledState(z, z, z, z), {},
                          MDAStats(3, 4, 5, 6, 7, 8, 9))
    assert tckpt.load_checkpoint(path, device="cpu")[2] == [3, 4, 5, 6]


# ----------------------------- (d) the readers ----------------------------- #
def _run(*stats):
    return RunRecord([{"stats": s} for s in stats], {})


EXPECTED = {"ptc_steps": 11.5, "ptc_rejected_steps": 0.5,
            # (120 / (11 + 1) + 90 / (12 + 0)) / 2
            "ptc_gmres_its_per_step": 8.75}


@pytest.mark.parametrize("name", READERS)
def test_reader_means_and_none_without_its_key(name):
    """Each reader gives the mean over the solved requests (a request that
    raised has empty stats and is left out), and ``None`` where the stats
    lack the PTC fields, as a program without them gives."""
    read = load_module(ROOT, "metrics", name).read
    with_ptc = _run({"gmres_iters": 120, "ptc_accepted": 11,
                     "ptc_rejected": 1, "nonlinear_iters": 12},
                    {"gmres_iters": 90, "ptc_accepted": 12,
                     "ptc_rejected": 0, "nonlinear_iters": 12}, {})
    assert read(with_ptc) == pytest.approx(EXPECTED[name])
    assert read(_run({"gmres_iters": 14, "nonlinear_iters": 3})) is None
    assert read(_run()) is None
