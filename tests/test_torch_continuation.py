"""Port parity, the continuation and strong-convection tools: flexible GMRES,
the row-norm estimate and ``rowscale_prep`` against ``sem_tpu.krylov``; the
``velo_inner`` flexible chunks and the escalation ladder of the NS solver;
``solve_continued``, ``solve_ns_continued`` and ``solve_ra_continued``
against direct solves and against ``sem_tpu`` (host FGMRES, un-fused, with
the port pinned to the same program by ``port_unfused``).  Everything runs with ``device="cpu"``, the
port on its kernels' plain versions.  Tolerances are stated per test."""
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sem_tpu import NavierStokesSolver as JNS
from sem_tpu import krylov as jkry
from sem_tpu.coupling import boussinesq as jbq
from sem_tpu.models.navier_stokes import solve_ns_continued as j_ns_continued
from sem_tpu_torch import NavierStokesSolver as TNS
from sem_tpu_torch import krylov as tkry
from sem_tpu_torch.coupling import (build_coupled, solve_continued,
                                    solve_ra_continued)
from sem_tpu_torch.krylov import KrylovInfo
from sem_tpu_torch.models.navier_stokes import solve_ns_continued

from tests.test_torch_fdm_krylov import _cd_system
from tests.torch_parity import (UNFUSED, _jax_probes,  # noqa: F401
                                one_torch_thread, port_unfused, rel_err,
                                t32, t64)


# ------------------------------- krylov.py ------------------------------- #
def test_rownorm_estimate_matches_reference_on_its_probes():
    """Fed the very probes JAX drew, the port's estimate of the f32 CD
    operator's row norms agrees within 1e-6 relative; from a seeded
    generator it is reproducible, its probes are ±1, and the floor
    ``1e-12·max(d)`` holds on a zero row."""
    jmv, tmv, _, _, b = _cd_system()
    n = b.shape[0]
    ref = np.asarray(jkry.rownorm_estimate(jmv(jnp.float32), n, jnp.float32,
                                           jax.random.PRNGKey(0)))
    probes = t32(_jax_probes(n, jnp.float32))
    got = tkry.rownorm_estimate(tmv(torch.float32), n, torch.float32,
                                probes=probes)
    assert got.dtype == torch.float32
    assert rel_err(got, ref) <= 1e-6

    seen = []

    def record(z):
        seen.append(z.clone())
        return tmv(torch.float32)(z)

    def gen():
        return torch.Generator(device="cpu").manual_seed(0)

    d1 = tkry.rownorm_estimate(record, n, torch.float32, gen())
    d2 = tkry.rownorm_estimate(tmv(torch.float32), n, torch.float32, gen())
    assert torch.equal(d1, d2) and len(seen) == 8
    assert all(bool((z.abs() == 1).all()) for z in seen)
    assert not torch.equal(seen[0], seen[1])
    # 8-probe estimates of the same row norms: within a factor 10 of the
    # estimate on the reference's probes, row by row
    assert float((d1 / got).max()) < 10 and float((got / d1).max()) < 10

    def zero_row(z):
        w = z.clone()
        w[0] = 0.0
        return w

    d0 = tkry.rownorm_estimate(zero_row, 5, torch.float64, gen())
    assert float(d0[0]) == 1e-12 and float(d0[1]) == 1.0


def test_rowscale_prep_matches_reference():
    """Downcast, scale and the chunk tolerance: f32 roundoff (1e-6)."""
    rng = np.random.default_rng(3)
    r, dinv = rng.standard_normal(300), rng.uniform(0.1, 2.0, 300)
    ref = jkry.rowscale_prep(jnp.asarray(r), jnp.float32(1e-5),
                             jnp.asarray(dinv, jnp.float32))
    got = tkry.rowscale_prep(t64(r), 1e-5, t32(dinv))
    assert got[0].dtype == torch.float32
    for g, j in zip(got, ref):
        assert rel_err(g, j) <= 1e-6


@pytest.mark.parametrize("lowp", [False, True], ids=["f64", "f32"])
def test_fgmres_matches_reference(lowp):
    """Flexible GMRES on the CD tangent system with a preconditioner that
    varies per application (FDM, then 2 inner GMRES steps on the operator),
    restart 8 so that restarts happen.  f64: right-preconditioned to
    1e-10·‖b‖, solution within 1e-10 relative of sem_tpu's.  f32: the
    row-scaled form of the NS solver's flexible chunks (``D⁻¹A``, ``D`` the
    row-norm estimate on sem_tpu's probes) to 1e-5·‖D⁻¹b‖, solution within
    1e-5.  Iterations within ±1 of sem_tpu's in both."""
    jmv, tmv, jfdm, tfdm, b = _cd_system()
    jdt, tdt = (jnp.float32, torch.float32) if lowp else (jnp.float64,
                                                          torch.float64)
    jA, tA = jmv(jdt), tmv(tdt)
    n = b.shape[0]
    if lowp:
        d = np.asarray(jkry.rownorm_estimate(jA, n, jdt,
                                             jax.random.PRNGKey(0)))
        jd, td = jnp.asarray(1.0 / d), t32(1.0 / d)
        jop, top = (lambda q: jA(q) * jd), (lambda q: tA(q) * td)
        jb, tb = jnp.asarray(b, jdt) * jd, t32(b) * td
        jscale, tscale = (lambda r: r / jd), (lambda r: r / td)
        atol, xtol = 1e-5 * float(jnp.linalg.norm(jb)), 1e-5
    else:
        jop, top, jb, tb = jA, tA, jnp.asarray(b), t64(b)
        jscale = tscale = (lambda r: r)
        atol, xtol = 1e-10 * np.linalg.norm(b), 1e-10

    def jpc(r):
        z = jfdm(jscale(r))
        return z + jkry.gmres(jA, jscale(r) - jA(z), atol=0.0, restart=2,
                              maxiter=2, precon=jfdm)[0]

    def tpc(r):
        z = tfdm(tscale(r))
        return z + tkry.gmres(tA, tscale(r) - tA(z), atol=0.0, restart=2,
                              maxiter=2, precon=tfdm)[0]

    x_j, jinfo, _ = jkry.fgmres(jop, jb, atol=atol, restart=8, maxiter=200,
                                precon=jpc)
    x_t, info = tkry.fgmres(top, tb, atol=atol, restart=8, maxiter=200,
                            precon=tpc)
    assert bool(jinfo.converged) and info.converged
    assert abs(info.iterations - int(jinfo.iterations)) <= 1
    assert info.resnorm <= atol
    assert x_t.dtype == tdt
    assert rel_err(x_t, x_j) <= xtol


def test_inner_gmres_runs_exactly_k_iterations():
    """``gmres(atol=0, restart=k, maxiter=k)``, the preconditioner's inner
    velocity solve: exactly k iterations on a non-zero RHS, and a zero RHS
    returns zeros without dividing by its zero norm."""
    _, tmv, _, tfdm, b = _cd_system()
    A = tmv(torch.float32)
    x, info = tkry.gmres(A, t32(b), atol=0.0, restart=5, maxiter=5,
                         precon=tfdm)
    assert info.iterations == 5 and bool(torch.isfinite(x).all())
    x0, info0 = tkry.gmres(A, torch.zeros_like(t32(b)), atol=0.0, restart=5,
                           maxiter=5, precon=tfdm)
    assert info0.iterations == 0 and float(x0.abs().max()) == 0.0


# --------------------- velo_inner and the escalation --------------------- #
VELO_KW = dict(Re=50.0, Gr=100.0, P=3, N_ex=3, N_ey=3, u_N=1.0,
               mtol=1e-11, mtol_newton=1e-9, iprint=[])


def test_ns_velo_inner_flexible_chunks_match_plain_and_reference():
    """The configuration of tests/test_ns_solver.py:185-196.  The port at
    ``velo_inner=5`` (row-scaled flexible f32 chunks) against the port at 0
    (plain chunks) and against sem_tpu at 5: u, v within 1e-6 and p within
    1e-4, equal Newton counts, no f64 fallback and no flexible retry."""
    sol, newton = {}, {}
    for k in (0, 5):
        ns = TNS(1.0, 1.0, velo_inner=k, device="cpu", **VELO_KW)
        T = 0.3 * np.sin(np.pi * ns.points[0])
        sol[k] = [f.numpy() for f in ns._get_solution(t64(T))]
        newton[k] = ns._k
        assert ns.f64_fallback_count == ns.flex_retry_count == 0
    jns = JNS(1.0, 1.0, velo_inner=5, **VELO_KW)
    ref = [np.asarray(f) for f in jns._get_solution(jnp.asarray(T))]
    assert jns.f64_fallback_count == 0
    assert newton[0] == newton[5] == jns._k
    for a, b, c, tol in zip(sol[5], sol[0], ref, (1e-6, 1e-6, 1e-4)):
        np.testing.assert_allclose(a, b, atol=tol)
        np.testing.assert_allclose(a, c, atol=tol)


def test_ns_velo_inner_f64_path_uses_flexible_gmres():
    """``mixed_precision=False`` with ``velo_inner=5`` (flexible f64 GMRES)
    lands on the plain solution: u, v within 1e-6."""
    ns0 = TNS(1.0, 1.0, device="cpu", **VELO_KW)
    T = t64(0.3 * np.sin(np.pi * ns0.points[0]))
    ref = ns0._get_solution(T)
    ns = TNS(1.0, 1.0, velo_inner=5, mixed_precision=False, device="cpu",
             **VELO_KW)
    got = ns._get_solution(T)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_dinv32_follows_the_linearization():
    """The cached row-norm scaling is dropped by ``_calc_jacobians`` and by a
    re-cast of the linearization, and rebuilt by the next flexible solve."""
    ns = TNS(1.0, 1.0, velo_inner=5, device="cpu", **VELO_KW)
    rng = np.random.default_rng(2)
    u, v = (t64(0.1 * rng.standard_normal(ns.N)) for _ in range(2))
    b = t64(rng.standard_normal(ns.N))
    ns._calc_jacobians(u, v)
    assert ns._dinv32 is None
    ns._get_update(b, b, b, mtol=1e-6)
    first = ns._dinv32
    assert first is not None and first.dtype == torch.float32
    ns._get_update(b, b, b, mtol=1e-6)
    assert ns._dinv32 is first          # one estimate per linearization
    ns._calc_jacobians(2 * u, v)
    assert ns._dinv32 is None
    ns._get_update(b, b, b, mtol=1e-6)
    assert not torch.equal(ns._dinv32, first)


def test_escalation_ladder_order(monkeypatch):
    """The monkeypatch pattern of tests/test_ns_solver.py:310-351
    (``test_best_effort_update_skips_f64_escalation``): a best-effort call
    returns the floored iterate with no retry at all; the default call
    retries on the flexible ``velo_inner=5`` chunks first (warm-started at
    the floored iterate), then in f64; a retry that is no better is not
    adopted; a solver built with ``velo_inner > 0`` skips step 1."""
    ns = TNS(1.0, 1.0, Re=50.0, Gr=0.0, P=3, N_ex=3, N_ey=3, u_N=1.0,
             iprint=[], device="cpu")
    x_plain = torch.full((3 * ns.N,), 1.0, dtype=torch.float64)
    x_flex = torch.full((3 * ns.N,), 2.0, dtype=torch.float64)
    x_f64 = torch.full((3 * ns.N,), 3.0, dtype=torch.float64)

    def floored(res):
        return KrylovInfo(converged=False, iterations=7, resnorm=res,
                          stalled=True)

    ok = KrylovInfo(converged=True, iterations=3, resnorm=0.0, stalled=False)
    flex_res = [5e2]
    mixed_calls, f64_calls = [], []

    def mixed(b, dp0, mtol, velo_inner=None, x0_full=None):
        mixed_calls.append((velo_inner, x0_full))
        if velo_inner == 5:
            return x_flex, floored(flex_res[0])
        return x_plain, floored(1e3)       # far above any atol

    monkeypatch.setattr(ns, "_update_coupled_mixed", mixed)
    monkeypatch.setattr(ns, "_update_coupled_f64",
                        lambda *a: f64_calls.append(1) or (x_f64, ok))
    b = torch.ones(ns.N, dtype=torch.float64)

    du, _, _ = ns._get_update(b, b, b, mtol=1e-6, best_effort=True)
    assert not f64_calls and [c[0] for c in mixed_calls] == [None]
    assert (ns.besteffort_floor_count, ns.f64_fallback_count,
            ns.flex_retry_count) == (1, 0, 0)
    assert float(du[0]) == 1.0

    du, _, _ = ns._get_update(b, b, b, mtol=1e-6)    # default: escalates
    assert [c[0] for c in mixed_calls] == [None, None, 5]
    assert mixed_calls[-1][1] is x_plain             # warm start
    assert (ns.flex_retry_count, ns.f64_fallback_count) == (1, 1)
    assert len(f64_calls) == 1 and float(du[0]) == 3.0
    assert ns.last_schur_info is ok

    # a flexible retry that converges ends the ladder; a worse one is dropped
    monkeypatch.setattr(ns, "_update_coupled_f64", lambda *a: 1 / 0)
    flex_res[0] = 2e3
    with pytest.raises(ZeroDivisionError):           # f64 got x_plain's case
        ns._get_update(b, b, b, mtol=1e-6)
    assert ns.flex_retry_count == 2

    def mixed_ok(b, dp0, mtol, velo_inner=None, x0_full=None):
        return (x_flex, ok) if velo_inner == 5 else (x_plain, floored(1e3))

    monkeypatch.setattr(ns, "_update_coupled_mixed", mixed_ok)
    du, _, _ = ns._get_update(b, b, b, mtol=1e-6)
    assert float(du[0]) == 2.0 and ns.flex_retry_count == 3

    ns5 = TNS(1.0, 1.0, Re=50.0, Gr=0.0, P=3, N_ex=3, N_ey=3, u_N=1.0,
              iprint=[], velo_inner=5, device="cpu")
    monkeypatch.setattr(ns5, "_update_coupled_mixed",
                        lambda *a, **k: (x_plain, floored(1e3)))
    monkeypatch.setattr(ns5, "_update_coupled_f64", lambda *a: (x_f64, ok))
    ns5._get_update(b, b, b, mtol=1e-6)
    assert (ns5.flex_retry_count, ns5.f64_fallback_count) == (0, 1)


# ----------------------------- continuation ------------------------------ #
CONT_KW = dict(Re=1e3, Ra=1e3, Pr=0.71, N_ex_cd=4, N_ey_cd=4,
               N_ex_ns=4, N_ey_ns=4, mode="JNK", mtol_nonlin=1e-9,
               iprint=False)


def _level_stats(text):
    return [eval(s) for s in re.findall(r"stats=(\[[0-9, ]*\])", text)]


@pytest.fixture(scope="module")
def direct_p4():
    cd, ns, mda = build_coupled(1.0, 1.0, P_cd=4, P_ns=4, device="cpu",
                                **CONT_KW, **UNFUSED)
    return cd, ns, mda, mda.solve()


@pytest.mark.parametrize("ladder_kw", [dict(levels=1),
                                       dict(ladder=[(2, 2), (4, 4)]),
                                       dict(levels=3)],
                         ids=["levels1", "explicit", "levels3_floor"])
def test_solve_continued_matches_direct_and_reference(ladder_kw, direct_p4,
                                                      capfd, port_unfused):
    """The configuration of tests/test_coupling.py:211-240.  The continued
    solve reaches the direct solution (u, T within 1e-6) with less
    fine-level work, and its per-level MDA stats equal sem_tpu's; the final
    u, T agree with sem_tpu's within 1e-8.  ``levels=3`` from P=4 exercises
    the floor at 2 and the duplicate removal (ladder 2, 2, 2, 4 → 2, 4)."""
    _, _, mda_d, s_d = direct_p4
    direct_solves = mda_d.stats.cd_solves + mda_d.stats.ns_solves
    capfd.readouterr()
    cd, ns, mda, s = solve_continued(1.0, 1.0, P_cd=4, P_ns=4, timing=True,
                                     device="cpu", **ladder_kw, **CONT_KW)
    got_levels = _level_stats(capfd.readouterr().out)
    assert len(got_levels) == 2 and got_levels[-1] == mda.stats.as_list()
    np.testing.assert_allclose(s.u.numpy(), s_d.u.numpy(), atol=1e-6)
    np.testing.assert_allclose(s.T.numpy(), s_d.T.numpy(), atol=1e-6)
    assert mda.stats.cd_solves + mda.stats.ns_solves < direct_solves

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", "0")
        mp.setenv("SEM_TPU_FUSED_PC", "0")
        _, _, jmda, js = jbq.solve_continued(
            1.0, 1.0, P_cd=4, P_ns=4, timing=True, device_krylov=False,
            **ladder_kw, **CONT_KW)
    assert _level_stats(capfd.readouterr().out) == got_levels
    assert abs(mda.stats.gmres_iters - jmda.stats.gmres_iters) <= 1
    np.testing.assert_allclose(s.u.numpy(), np.asarray(js.u), atol=1e-8)
    np.testing.assert_allclose(s.T.numpy(), np.asarray(js.T), atol=1e-8)


def test_solve_continued_state0_and_grids0(direct_p4):
    """A warm start on the wrong grids raises the size ``ValueError``; with
    ``grids0`` it is transferred to the coarsest level, and a converged
    fine-grid state then costs every level less than a cold start."""
    cd_d, ns_d, _, s_d = direct_p4
    with pytest.raises(ValueError, match="grids0"):
        solve_continued(1.0, 1.0, levels=1, P_cd=4, P_ns=4, state0=s_d,
                        device="cpu", **CONT_KW)
    _, _, mda, s = solve_continued(1.0, 1.0, levels=1, P_cd=4, P_ns=4,
                                   state0=s_d, grids0=(cd_d.grid, ns_d.grid),
                                   device="cpu", **CONT_KW)
    # two solves to the coupled RMS residual 1e-9 agree to ~1e-6 in state
    # (1.8e-6 when the test was written)
    np.testing.assert_allclose(s.u.numpy(), s_d.u.numpy(), atol=1e-5)
    assert mda.stats.nonlinear_iters <= 2


def test_solve_ns_continued_matches_direct_and_reference():
    """The configuration of tests/test_ns_solver.py:219-238: u, v within 5e-5
    of the direct solve (the resolution of the near-spurious coupled modes
    at a 1e-11 residual), no more fine-level Newton steps than the direct
    solve; against sem_tpu u, v within 5e-5 and the fine-level Newton count
    within 1: the two residual histories agree to 4 digits, and the fourth
    (3.6e-10 here, 2.0e-10 there, when the test was written) straddles the
    tolerance 2.9e-10."""
    kw = dict(u_N=1.0, mtol=1e-12, mtol_newton=1e-11, iprint=[])
    cfg = dict(Re=100.0, Gr=0.0, P=4, N_ex=4, N_ey=4)
    ns_d = TNS(1.0, 1.0, device="cpu", **cfg, **kw)
    u_d, v_d, _ = ns_d._get_solution(torch.zeros(ns_d.N,
                                                 dtype=torch.float64))
    ns_c, u_c, v_c, _ = solve_ns_continued(1.0, 1.0, levels=1, device="cpu",
                                           **cfg, **kw)
    np.testing.assert_allclose(u_c.numpy(), u_d.numpy(), atol=5e-5)
    np.testing.assert_allclose(v_c.numpy(), v_d.numpy(), atol=5e-5)
    assert ns_c._k <= ns_d._k and ns_c.grid.P == 4
    jns, ju, jv, _ = j_ns_continued(1.0, 1.0, levels=1, **cfg, **kw)
    assert abs(ns_c._k - jns._k) <= 1
    np.testing.assert_allclose(u_c.numpy(), np.asarray(ju), atol=5e-5)
    np.testing.assert_allclose(v_c.numpy(), np.asarray(jv), atol=5e-5)
    # a temperature field callable reaches every level
    ns_t, u_t, _, _ = solve_ns_continued(
        1.0, 1.0, Re=10.0, Gr=100.0, P=4, N_ex=2, N_ey=2, levels=1,
        T_func=lambda x, y: 0.5 - x, iprint=[], device="cpu")
    assert float(u_t.abs().max()) > 1e-3


def test_solve_ra_continued_matches_reference(port_unfused):
    """The configuration of tests/test_coupling.py:242-250 (Ra=1e4,
    ``decades=1``): converged to the MDA tolerance at the target Ra, the
    buoyancy-driven flow much stronger than at Ra=1e3 (u_max·RePr > 8), and
    the last level's MDA stats equal to sem_tpu's, u within 1e-6."""
    kw = dict(Ra=1e4, decades=1, Re=1e3, Pr=0.71, P_cd=3, N_ex_cd=2,
              N_ey_cd=2, P_ns=3, N_ex_ns=4, N_ey_ns=4, mode="JNK",
              iprint=False)
    cd, ns, mda, s = solve_ra_continued(1.0, 1.0, device="cpu", **kw)
    assert float(torch.linalg.vector_norm(mda._residuals(s))) \
        <= mda.atol_nonlin
    assert float(s.u.abs().max()) * 1e3 * 0.71 > 8.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", "0")
        mp.setenv("SEM_TPU_FUSED_PC", "0")
        _, _, jmda, js = jbq.solve_ra_continued(1.0, 1.0,
                                                device_krylov=False, **kw)
    assert mda.stats.as_list() == jmda.stats.as_list()
    np.testing.assert_allclose(s.u.numpy(), np.asarray(js.u), atol=1e-6)


def test_ra_ladder_switches_to_ptc(monkeypatch):
    """The automatic ladder: decades to 1e4, half-decades in the JNK band,
    full decades in the PTC band, PTC above ``ptc_above`` only; each level
    warm-started by the previous one.  Checked against sem_tpu's ladder on
    recording stand-ins for ``build_coupled``."""
    def record(calls):
        class FakeMDA:
            def __init__(self, Ra, mode):
                self.tag = (Ra, mode)

            def solve(self, state):
                calls.append((self.tag, state))
                return self.tag

        def fake_build(L_x, L_y, Ra=None, mode=None, **kw):
            return None, None, FakeMDA(Ra, mode)

        return fake_build

    import sem_tpu_torch.coupling.boussinesq as tbq
    for Ra, kw in ((1e6, {}), (1e5, dict(ptc_above=None)),
                   (3e4, dict(mode="NJ")), (1e6, dict(decades=2))):
        t_calls, j_calls = [], []
        monkeypatch.setattr(tbq, "build_coupled", record(t_calls))
        monkeypatch.setattr(jbq, "build_coupled", record(j_calls))
        tbq.solve_ra_continued(1.0, 1.0, Ra, iprint=False, **kw)
        jbq.solve_ra_continued(1.0, 1.0, Ra, iprint=False, **kw)
        assert t_calls == j_calls and t_calls[0][1] is None
        assert all(b[1] == a[0] for a, b in zip(t_calls, t_calls[1:]))
    assert [c[0] for c in t_calls] == [((1e4, "JNK")), ((1e5, "PTC")),
                                       ((1e6, "PTC"))]
