"""Port parity, default against default: the coupled Krylov program that
``BoussinesqMDA``, ``run``, ``solve_continued``, the examples and the study
CLIs choose when the caller names none, against ``sem_tpu`` on its own
defaults.  Neither side is pinned: ``sem_tpu``'s ``SEM_TPU_FG_FUSED`` and
``SEM_TPU_FUSED_PC`` are unset (both programs fused), and its size limits
``SEM_TPU_DEVICE_KRYLOV_MAX_DOF`` / ``SEM_TPU_PTC_DEVICE_MAX_DOF`` are
lowered, where a test says so, together with the port's module constants
``DEVICE_KRYLOV_MAX_DOF`` / ``PTC_DEVICE_MAX_DOF``.  ``device="cpu"``
throughout; tolerances are stated per test."""
import io
import contextlib
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import sem_tpu
import sem_tpu.coupling.mda as jmda_mod
import sem_tpu_torch
import sem_tpu_torch.coupling.mda as tmda
from sem_tpu.coupling import boussinesq as jbq
from sem_tpu.coupling import run as jax_run
from sem_tpu_torch.coupling import boussinesq as tbq
from sem_tpu_torch.coupling import run
from sem_tpu_torch.examples import boussinesq_sequential
from sem_tpu_torch.study import boussinesq_run

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.test_torch_study import _reference_study
from tests.test_torch_study_drivers import _defaults, _f64

# QUICK of tests/test_coupling.py:35-38 (DOF 400)
QUICK = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=3, N_ex_cd=3, N_ey_cd=3,
             P_ns=3, N_ex_ns=3, N_ey_ns=3, iprint=False)
# the sequential example's --quick configuration (DOF 1156)
P4_4X4 = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=4, N_ex_cd=4, N_ey_cd=4,
              P_ns=4, N_ex_ns=4, N_ey_ns=4, mode="JNK", iprint=False)
PLOT = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101),
                   indexing="ij")
# the PTC march of tests/test_torch_parallel_programs.py (NS 4×4, DOF 676)
# with 'bj': from zero the coarse 'bgs' march converges in neither package
# (ROADMAP C1)
PTC_KW = dict(Re=1e3, Ra=1e4, Pr=0.71, P_cd=3, N_ex_cd=4, N_ey_cd=4,
              P_ns=3, N_ex_ns=4, N_ey_ns=4, mtol_nonlin=1e-8, iprint=False,
              mode="PTC", precon="bj", ptc_dt0=1.0)


@pytest.fixture(autouse=True)
def reference_defaults(monkeypatch):
    """``sem_tpu`` on its own defaults: none of its program variables set."""
    for k in ("SEM_TPU_FG_FUSED", "SEM_TPU_FUSED_PC",
              "SEM_TPU_DEVICE_KRYLOV_MAX_DOF", "SEM_TPU_PTC_DEVICE_MAX_DOF"):
        monkeypatch.delenv(k, raising=False)


def _limits(monkeypatch, jnk=None, ptc=None):
    """Lower the JNK and PTC device-window limits in both packages."""
    for name, value in (("DEVICE_KRYLOV_MAX_DOF", jnk),
                        ("PTC_DEVICE_MAX_DOF", ptc)):
        if value is not None:
            monkeypatch.setenv(f"SEM_TPU_{name}", str(value))
            monkeypatch.setattr(tmda, name, value)


# --------------------------- (a) program choice --------------------------- #
class _Took(Exception):
    """Raised where a coupled linear solve starts: which program took it."""


def _first_program(monkeypatch, mod, mda, port):
    """Run ``mda.solve()`` up to its first coupled linear solve and return
    ``("device",)`` or ``("host", fused)``; on the port the fused step, if
    taken, runs once (start, preconditioner, one step) first."""
    def host(*a, fused=None, **k):
        if port and fused is not None:
            start, step, precon_split = fused
            out = start(torch.zeros_like(a[2]), a[2])
            step(*out[:6], 0, *precon_split(*out[6:-1]))
        raise _Took(("host", fused is not None))

    def device(*a, **k):
        raise _Took(("device",))

    monkeypatch.setattr(mod, "_fgmres", host)
    monkeypatch.setattr(mda, "_fgmres_device", device)
    with pytest.raises(_Took) as took:
        mda.solve()
    return took.value.args[0]


@pytest.mark.parametrize("mode", ["JNK", "PTC"])
@pytest.mark.parametrize("jnk_cut,ptc_cut", [(-1, 0), (0, -1), (0, 0)],
                         ids=["jnk_below", "ptc_below", "both_above"])
def test_program_choice_at_the_limits(mode, jnk_cut, ptc_cut, monkeypatch):
    """With the limits set one below (``-1``) or at (``0``) the coupled DOF
    of QUICK: ``device_krylov`` and the program that takes the first
    coupled linear solve are ``sem_tpu``'s; JNK takes the windows at or
    under its limit, PTC only at or under both, and the host program is
    fused."""
    dof = 400
    _limits(monkeypatch, jnk=dof + jnk_cut, ptc=dof + ptc_cut)
    kw = dict(QUICK, mode=mode, precon="bj")
    _, _, jm = jbq.build_coupled(1.0, 1.0, **kw)
    _, _, tm = tbq.build_coupled(1.0, 1.0, device="cpu", **kw)
    assert tm.DOF == jm.DOF == dof
    assert tm.device_krylov == jm.device_krylov == (jnk_cut == 0)
    got = _first_program(monkeypatch, tmda, tm, port=True)
    ref = _first_program(monkeypatch, jmda_mod, jm, port=False)
    assert got == ref
    windows = jnk_cut == 0 and (mode == "JNK" or ptc_cut == 0)
    assert got == (("device",) if windows else ("host", True))


# the solver classes patched per option, and their constructor defaults
OPTIONS = {"coupled": ((), {}), "velo_inner5": ((), {}),
           "uzawa": (("NavierStokesSolver",), dict(linear_solver="uzawa")),
           "ns_f64": (("NavierStokesSolver",), dict(mixed_precision=False)),
           "cd_f64": (("ConvectionDiffusionSolver",),
                      dict(mixed_precision=False))}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_fused_programs_follow_the_reference_gate(option, monkeypatch):
    """JNK with the host program (the limit one below QUICK's DOF), for
    each NS option the reference's ``_pc_fused`` gate names: both packages
    take the fused step, and the fused two-round preconditioner exactly
    where ``sem_tpu`` does (a ``'coupled'`` NS solver with both solvers
    mixed precision); the port's fused step runs on each option without
    raising.  Under ``'uzawa'`` and the f64 solvers it keeps the
    block-Jacobi sweep."""
    _limits(monkeypatch, jnk=399)
    names, kw = OPTIONS[option]
    for name in names:
        for pkg in (sem_tpu, sem_tpu_torch):
            _defaults(monkeypatch, getattr(pkg, name), **kw)
    kw = dict(QUICK, mode="JNK",
              velo_inner=5 if option == "velo_inner5" else 0)
    _, _, jm = jbq.build_coupled(1.0, 1.0, **kw)
    _, _, tm = tbq.build_coupled(1.0, 1.0, device="cpu", **kw)
    assert not tm.device_krylov and not jm.device_krylov
    got = _first_program(monkeypatch, tmda, tm, port=True)
    ref = _first_program(monkeypatch, jmda_mod, jm, port=False)
    assert got == ref == ("host", True)
    pc = [m._pc_fused(mtol=m.mtol_precon) is not None for m in (tm, jm)]
    assert pc[0] == pc[1] == (option in ("coupled", "velo_inner5"))


# ----------------------- (b)-(d) whole solves ----------------------------- #
def _anchors(u, v):
    return np.max(u) * 710.0, np.max(v) * 710.0


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "f64"])
def test_run_device_windows_default_against_default(mixed, monkeypatch):
    """``run(...)`` at P4 4×4 JNK (DOF 1156 ≤ 10⁶: both packages take the
    device windows): on the f64 solvers equal stats and coupled GMRES
    iterations; on the default mixed solvers equal nonlinear iterations and
    every other counter within 1 (ROADMAP C7); the de Vahl Davis anchors
    u_max·RePr, v_max·RePr within 1e-6 of each other."""
    if not mixed:
        _f64(monkeypatch)
    _, ju, jv, _, jst = jax_run(PLOT, 1.0, 1.0, return_state=True, **P4_4X4)
    _, tu, tv, _, tst = run(PLOT, 1.0, 1.0, return_state=True,
                            device="cpu", **P4_4X4)
    got, ref = tst.as_list() + [tst.gmres_iters], jst.as_list() + [
        jst.gmres_iters]
    if mixed:
        assert got[2] == ref[2]
        assert all(abs(a - b) <= 1 for a, b in zip(got, ref)), (got, ref)
    else:
        assert got == ref
    np.testing.assert_allclose(_anchors(tu, tv),
                               _anchors(np.asarray(ju), np.asarray(jv)),
                               rtol=0, atol=1e-6)


def test_run_fused_host_default_against_default(monkeypatch):
    """The same ``run(...)`` with the JNK limit below its DOF, so that both
    packages take the fused host FGMRES with the two-round preconditioner:
    equal stats and coupled GMRES iterations, T/u/v at the plot points
    within 1e-7 (tests/test_torch_mda_fused.py's tolerance for fused
    JNK)."""
    _limits(monkeypatch, jnk=1155)
    jT, ju, jv, _, jst = jax_run(PLOT, 1.0, 1.0, return_state=True,
                                 **P4_4X4)
    tT, tu, tv, _, tst = run(PLOT, 1.0, 1.0, return_state=True,
                             device="cpu", **P4_4X4)
    assert tst.as_list() == jst.as_list()
    assert tst.gmres_iters == jst.gmres_iters
    for got, ref in ((tT, jT), (tu, ju), (tv, jv)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-7)


@pytest.mark.parametrize("ptc_limit", [None, 675],
                         ids=["device_windows", "fused_host"])
def test_ptc_default_against_default(ptc_limit, monkeypatch):
    """A PTC march at Ra=1e4 from zero (DOF 676), defaults on both sides:
    the device windows (676 ≤ the PTC limit 150,000), and with the PTC
    limit one below the DOF the fused host FGMRES: equal steps, stats and
    coupled GMRES iterations, u within 1e-6."""
    _limits(monkeypatch, ptc=ptc_limit)
    _, _, jm = jbq.build_coupled(1.0, 1.0, **PTC_KW)
    js = jm.solve()
    _, _, tm = tbq.build_coupled(1.0, 1.0, device="cpu", **PTC_KW)
    assert tm.device_krylov and tm.fused
    ts = tm.solve()
    assert tm.stats.as_list() == jm.stats.as_list()
    assert tm.stats.gmres_iters == jm.stats.gmres_iters
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0,
                               atol=1e-6)


# ------------------------- (e) examples and CLIs -------------------------- #
@pytest.mark.parametrize("mode", ["GS", "NJ", "JNK"])
def test_sequential_example_default_against_default(mode, capsys):
    """``boussinesq_sequential --quick`` (P4 4×4) in each mode against
    ``sem_tpu.coupling.run`` of the same configuration, neither pinned:
    CHECK OK, the anchors within 1e-6; NJ and JNK equal stats; GS (no
    coupled Krylov program) the stats rule of
    tests/test_torch_examples.py: equal CD solves and sweeps, NS solves
    within one per sweep (the f32 chunks' spread near the Newton
    tolerance)."""
    got = boussinesq_sequential.main(check=True, quick=True, mode=mode,
                                     device="cpu")
    assert "CHECK OK" in capsys.readouterr().out
    _, u, v, _, stats = jax_run(PLOT, 1.0, 1.0, 1e3, 1e3, 0.71, 4, 4, 4, 4,
                                4, 4, mode=mode, iprint=False,
                                return_state=True)
    ref = stats.as_list()
    if mode == "GS":
        assert [got["stats"][0], got["stats"][2]] == [ref[0], ref[2]]
        assert abs(got["stats"][1] - ref[1]) <= ref[2], (got, ref)
    else:
        assert got["stats"] == ref
    assert abs(got["umax"] - np.max(u) * 710.0) <= 1e-6
    assert abs(got["vmax"] - np.max(v) * 710.0) <= 1e-6


def test_boussinesq_run_default_against_default(tmp_path, monkeypatch):
    """``boussinesq_run -P 2 -Ne 4`` in JNK (DOF 324: the device windows in
    both), neither pinned: the same files' stats with equal nonlinear
    iterations and discipline solves within 2 per nonlinear iteration
    (tests/test_torch_study.py's rule: the study's coupled tolerance, 1e-13
    RMS, sits at the f64 floor), every other entry equal."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "__stdout__", sys.stdout)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    _reference_study().run(P=2, N_e=4, mode="JNK")
    boussinesq_run.main(["-P", "2", "-Ne", "4", "-mode", "JNK", "-device",
                         "cpu", "-outdir", "torch_out"])
    stats = []
    for d in ("Boussinesq_study", "torch_out"):
        (name,) = [f for f in os.listdir(tmp_path / d)
                   if f.endswith(".stats.json")]
        stats.append(json.loads((tmp_path / d / name).read_text()))
    it_ref, it_got = (s.pop("iters") for s in stats)
    assert it_got[2] == it_ref[2]
    assert all(abs(a - b) <= 2 * it_ref[2]
               for a, b in zip(it_got, it_ref)), (it_got, it_ref)
    assert stats[0] == stats[1], stats


# ------------------------ (f) a continuation ladder ------------------------ #
def test_solve_continued_levels_pick_their_own_programs(monkeypatch):
    """``solve_continued`` P2 → P4 (NS and CD 4×4; DOF 324 and 1156) with
    the JNK limit between the two levels: each level builds its own MDA and
    picks its own program, the coarse one the device windows and the fine
    one the fused host FGMRES, in both packages; the per-level stats are
    equal, u within 1e-8."""
    _limits(monkeypatch, jnk=500)
    kw = dict(P4_4X4, mtol_nonlin=1e-9, levels=1, timing=True)
    picked = {}
    for name, mod in (("port", tbq), ("ref", jbq)):
        build, picked[name] = mod.build_coupled, []

        def recording(*a, _build=build, _seen=picked[name], **k):
            cd, ns, mda = _build(*a, **k)
            _seen.append((mda.DOF, bool(mda.device_krylov)))
            return cd, ns, mda

        monkeypatch.setattr(mod, "build_coupled", recording)
    out = {}
    for name, fn, extra in (("port", tbq.solve_continued, dict(device="cpu")),
                            ("ref", jbq.solve_continued, {})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            *_, s = fn(1.0, 1.0, **kw, **extra)
        out[name] = (re.findall(r"stats=(\[[0-9, ]*\])", buf.getvalue()),
                     np.asarray(s.u))
    assert picked["port"] == picked["ref"] == [(324, True), (1156, False)]
    assert len(out["port"][0]) == 2 and out["port"][0] == out["ref"][0]
    np.testing.assert_allclose(out["port"][1], out["ref"][1], rtol=0,
                               atol=1e-8)
