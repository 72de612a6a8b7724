"""Port parity, pseudo-transient continuation: the shared Δt controller, the
coupled PTC mode with the ``bj``/``bgs``/``bgs2`` preconditioners, the
standalone ``NavierStokesSolver.solve_ptc``, and checkpoints and wall-clock
budgets, against ``sem_tpu`` on its host FGMRES path (un-fused,
``device_krylov=False``), with the port pinned to the same program
(``port_unfused``).  Checkpoints
cross between the packages in both directions.  ``device="cpu"`` throughout;
tolerances are stated per test."""
import itertools
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu import NavierStokesSolver as JNS
from sem_tpu.coupling import build_coupled as jax_build_coupled
from sem_tpu.coupling.mda import CoupledState as JState
from sem_tpu.coupling.mda import MDAStats as JStats
from sem_tpu.coupling.mda import _fgmres as jax_fgmres
from sem_tpu.ptc import SERController as JSER
from sem_tpu.utils import checkpoint as jckpt
from sem_tpu_torch import NavierStokesSolver as TNS
from sem_tpu_torch.convert import state_from_numpy, state_to_numpy
from sem_tpu_torch.coupling import build_coupled
from sem_tpu_torch.coupling import mda as tmda
from sem_tpu_torch.coupling.mda import MDAStats, _fgmres
from sem_tpu_torch.ptc import SERController
from sem_tpu_torch.utils import checkpoint as tckpt

from tests.torch_parity import one_torch_thread, rel_err, t64  # noqa: F401
from tests.torch_parity import port_unfused  # noqa: F401

# the configuration of tests/test_ptc.py:146-147
PTC_KW = dict(Re=1e3, Ra=1e4, Pr=0.71, P_cd=3, N_ex_cd=4, N_ey_cd=4,
              P_ns=3, N_ex_ns=8, N_ey_ns=8, mtol_nonlin=1e-8, iprint=False)
PRECONS = ["bj", "bgs", "bgs2"]


pytestmark = pytest.mark.usefixtures("port_unfused")


@pytest.fixture(autouse=True)
def sem_tpu_host_path(monkeypatch):
    """sem_tpu's coupled solves take the un-fused host FGMRES path (the
    port's: ``port_unfused``, for every test of this file)."""
    monkeypatch.setenv("SEM_TPU_FG_FUSED", "0")
    monkeypatch.setenv("SEM_TPU_FUSED_PC", "0")


def _jax_build(**kw):
    return jax_build_coupled(1.0, 1.0, device_krylov=False, **kw)


def test_ser_controller_trajectories_equal_reference():
    """Exact equality of (dt, dt_ceil) and of every return value with
    ``sem_tpu.ptc.SERController`` over a scripted sequence that covers the
    SER ramp with its growth and shrink caps, blowup and linear-failure
    rejections, the linear-failure shrink, the ceiling and its relaxation,
    and the collapse below ``dt_min``; and over 200 random events."""
    script = [("accept", 1.0, 0.5, False), ("accept", 1.0, 1e-9, False),
              ("accept", 1.0, 100.0, False), ("reject_blowup",),
              ("accept", 1.0, 0.99, True), ("accept", 1.0, 1e-9, False),
              ("accept", 1.0, 0.5, True), ("reject_linfail",),
              ("accept", 2.0, 1.0, False), ("accept", 1.0, 0.0, False)]
    rng = np.random.default_rng(7)
    for _ in range(200):
        kind = rng.integers(0, 6)
        if kind == 0:
            script.append(("reject_blowup",))
        elif kind == 1:
            script.append(("reject_linfail",))
        else:
            a, b = np.exp(rng.normal(size=2) * 2)
            script.append(("accept", float(a), float(b), bool(kind == 2)))
    for args in (dict(dt0=1.0, growth=3.0, dt_max=100.0), dict(dt0=0.1),
                 dict(dt0=1e-9, dt_min=1e-10)):
        t, j = SERController(**args), JSER(**args)
        for name, *a in script:
            assert getattr(t, name)(*a) == getattr(j, name)(*a)
            assert (t.dt, t.dt_ceil) == (j.dt, j.dt_ceil)
    for const in ("SHRINK_BLOWUP", "SHRINK_LINFAIL", "RATIO_FLOOR",
                  "CEIL_RELAX", "NOPROGRESS"):
        assert getattr(SERController, const) == getattr(JSER, const)


def test_ptc_matches_jnk_and_reference():
    """PTC from zero (``precon='bj'``) lands on the JNK steady state (u, T
    within 1e-4: the residual tolerance 1e-8·√DOF admits ~1e-5 in state) and
    on sem_tpu's PTC state (1e-4), with equal MDA stats, step count and
    coupled GMRES iterations.  (With the PTC default ``'bgs'`` neither
    package's host path converges from zero on this coarse grid inside 300
    steps; ``test_ptc_first_steps_match_reference`` holds those
    preconditioners.)"""
    _, _, mda_j = build_coupled(1.0, 1.0, mode="JNK", device="cpu", **PTC_KW)
    s_jnk = mda_j.solve()
    _, _, mda = build_coupled(1.0, 1.0, mode="PTC", precon="bj",
                              device="cpu", **PTC_KW)
    s = mda.solve()
    assert float(torch.linalg.vector_norm(mda._residuals(s))) \
        <= mda.atol_nonlin
    np.testing.assert_allclose(s.u.numpy(), s_jnk.u.numpy(), atol=1e-4)
    np.testing.assert_allclose(s.T.numpy(), s_jnk.T.numpy(), atol=1e-4)
    _, _, jmda = _jax_build(mode="PTC", precon="bj", **PTC_KW)
    js = jmda.solve()
    assert mda.stats.as_list() == jmda.stats.as_list()
    assert mda.stats.gmres_iters == jmda.stats.gmres_iters
    np.testing.assert_allclose(s.u.numpy(), np.asarray(js.u), atol=1e-4)
    np.testing.assert_allclose(s.T.numpy(), np.asarray(js.T), atol=1e-4)


@pytest.fixture(scope="module")
def shifted_system():
    """A σ-shifted coupled tangent system at a non-trivial state, in both
    packages: the state is sem_tpu's loose Gauss-Seidel sweep from zero."""
    out = {}
    for pre in PRECONS:
        _, _, jmda = _jax_build(mode="PTC", precon=pre, **PTC_KW)
        _, _, mda = build_coupled(1.0, 1.0, mode="PTC", precon=pre,
                                  device="cpu", **PTC_KW)
        if not out:
            z, zn = jnp.zeros(jmda.N_cd), jnp.zeros(jmda.N_ns)
            js = jmda._gs_sweep(JState(z, zn, zn, zn), mtol=1e-4)
        s = state_from_numpy(js.T, js.u, js.v, js.p, device="cpu")
        dt = 0.25
        for m, st in ((jmda, js), (mda, s)):
            m._linearize(st, sigma_cd=m.cd_comp.cd._Pe / dt,
                         sigma_ns=m.ns_comp.ns._Re / dt)
        out[pre] = (jmda, mda, jmda._residuals(js), mda._residuals(s))
    return out


@pytest.mark.parametrize("precon", PRECONS)
def test_ptc_preconditioners_match_reference(precon, shifted_system):
    """One application of the ``bj`` / ``bgs`` / ``bgs2`` preconditioner on
    the shifted system (block solves to RMS 1e-8, best effort).  ``bj``:
    within 1e-5 relative of sem_tpu's.  ``bgs``/``bgs2``: the coupling RHS
    ``_bgs_rhs`` within 1e-10 of sem_tpu's and the CD part of ``bgs`` within
    1e-5; like sem_tpu's, that RHS also carries the buoyancy term on the NS
    Dirichlet rows, the NS block solve then floors on the continuity rows in
    both packages along its own roundoff path, so its result is held by its
    linear residual (no more than twice sem_tpu's), not entry by entry.
    Then the coupled FGMRES of one PTC step (block solves at
    ``mtol_precon=1e-4``, best effort, forecast exit on) to 1e-2·‖F‖: the
    true linear residual meets the tolerance and the iteration count is
    sem_tpu's within 1."""
    jmda, mda, jF, F = shifted_system[precon]
    assert rel_err(F, jF) <= 1e-10
    ref = jmda._block_jacobi(-jF, mtol=1e-8, best_effort=True)
    got = mda._block_jacobi(-F, mtol=1e-8, best_effort=True)
    N_cd = mda.N_cd
    if precon == "bj":
        assert rel_err(got, np.asarray(ref)) <= 1e-5
    else:
        rT, ru, rv, rp = mda._unpack(-F)
        dT = got[:N_cd] if precon == "bgs" else mda.cd_comp.solve_linear(
            rT, mtol=1e-8)
        if precon == "bgs":
            assert rel_err(dT, np.asarray(ref[:N_cd])) <= 1e-5
        rv_t = mda._bgs_rhs(dT, rv)
        rv_j = jmda._bgs_rhs(jnp.asarray(dT.numpy()), jnp.asarray(rv.numpy()))
        assert rel_err(rv_t, rv_j) <= 1e-10
        assert rel_err(rv_t, rv) > 1e-2             # the coupling is there
        zero = torch.zeros(N_cd, dtype=torch.float64)

        def ns_residual(x):
            du, dv, dp = mda._unpack(t64(np.asarray(x)))[1:]
            lhs = mda.ns_comp.apply_linear(du, dv, dp, zero)
            return float(torch.linalg.vector_norm(
                torch.cat(lhs) - torch.cat([ru, rv_t, rp])))

        assert ns_residual(got) <= 2 * ns_residual(ref)

    atol = 1e-2 * float(torch.linalg.vector_norm(F))
    _, it_j, ok_j = jax_fgmres(
        jmda._apply_linear,
        lambda r: jmda._block_jacobi(r, mtol=1e-4, best_effort=True), -jF,
        atol=atol, restart=jmda.restart, maxiter=100, forecast=True)
    dx, it, ok = _fgmres(
        mda._apply_linear,
        lambda r: mda._block_jacobi(r, mtol=1e-4, best_effort=True), -F,
        atol=atol, restart=mda.restart, maxiter=100, forecast=True)
    assert ok and ok_j and abs(it - it_j) <= 1
    assert float(torch.linalg.vector_norm(-F - mda._apply_linear(dx))) \
        <= 1.01 * atol


@pytest.mark.parametrize("precon", PRECONS)
def test_ptc_first_steps_match_reference(precon, tmp_path):
    """Three PTC steps from zero with each preconditioner, both packages
    checkpointing every step, then the march is cut by ``maxiter=3``.  Each
    package's checkpoint is read by the *other* package's loader: iteration
    counters equal; with ``bj`` the stored ``ptc_dt`` within 1e-6 relative,
    T, u, v within 1e-6 and p within 1e-4 (absolute); with ``bgs``/``bgs2``,
    whose NS block solves floor along their own roundoff paths (see
    ``test_ptc_preconditioners_match_reference``), ``ptc_dt`` within 1e-3 and
    T, u, v within 2e-3 (2.7e-4 and 1.3e-5 when the test was written; p,
    which those floored solves leave undetermined, is not compared).
    Longer marches on this coarse grid amplify that, so step counts of whole
    ``bgs`` solves are not compared."""
    files = {}
    for name, build in (("torch", lambda **kw: build_coupled(
            1.0, 1.0, device="cpu", **kw)), ("jax", lambda **kw: _jax_build(
                **kw))):
        files[name] = str(tmp_path / f"{name}.npz")
        cd, ns, mda = build(mode="PTC", precon=precon, maxiter=3,
                            checkpoint_path=files[name], checkpoint_every=1,
                            **PTC_KW)
        with pytest.raises(RuntimeError, match="no convergence in 3"):
            mda.solve()
        assert mda.checkpoint_config["mode"] == "PTC"
        assert mda.checkpoint_config["P_ns"] == 3
    js, jcfg, jit, jx = tckpt.load_checkpoint(files["jax"], with_extras=True,
                                              device="cpu")
    ts, tcfg, tit, tx = jckpt.load_checkpoint(files["torch"],
                                              with_extras=True)
    assert jcfg == tcfg and jit == tit and jit[2:] != [0, 0]
    loose = precon != "bj"
    assert abs(jx["ptc_dt"] - tx["ptc_dt"]) <= (
        1e-3 if loose else 1e-6) * tx["ptc_dt"]
    for a, b, tol in zip(state_to_numpy(js), (ts.T, ts.u, ts.v, ts.p),
                         (2e-3,) * 3 if loose else (1e-6, 1e-6, 1e-6, 1e-4)):
        np.testing.assert_allclose(a, np.asarray(b), atol=tol)


def test_ptc_constructor_arguments():
    """The bad-``precon`` ``ValueError`` (tests/test_coupling.py:409-411),
    the defaults that depend on the mode, and the PTC arguments stored."""
    with pytest.raises(ValueError, match="precon"):
        build_coupled(1.0, 1.0, mode="PTC", precon="bogus", device="cpu",
                      **PTC_KW)
    _, _, ptc = build_coupled(1.0, 1.0, mode="PTC", ptc_dt0=0.5,
                              ptc_growth=2.0, ptc_dt_max=50.0,
                              ptc_forcing=1e-3, device="cpu", **PTC_KW)
    _, _, jnk = build_coupled(1.0, 1.0, mode="JNK", device="cpu", **PTC_KW)
    assert (ptc.precon_type, ptc.maxiter) == ("bgs", 300)
    assert (jnk.precon_type, jnk.maxiter) == ("bj", 100)
    assert (ptc.ptc_dt0, ptc.ptc_growth, ptc.ptc_dt_max,
            ptc.ptc_forcing) == (0.5, 2.0, 50.0, 1e-3)
    assert ptc.checkpoint_path is None and ptc.checkpoint_config == {}


def test_ns_solve_ptc_matches_newton_and_reference():
    """Standalone NS pseudo-transient continuation (lid cavity Re=100, P=3
    4×4, Newton RMS 1e-9): the same step count as sem_tpu's ``solve_ptc``
    and u, v within 1e-6 of it; the steady residual meets the tolerance of
    the Newton solve, and u, v agree with the Newton solution within 1e-3
    (the near-spurious modes of the equal-order discretization, which a
    1e-9 residual pins no tighter; 3.4e-4 when the test was written); no
    escalation on the way (best-effort linear solves)."""
    kw = dict(Re=100.0, Gr=0.0, P=3, N_ex=4, N_ey=4, u_N=1.0, iprint=[],
              mtol=1e-11, mtol_newton=1e-9)
    ns = TNS(1.0, 1.0, device="cpu", **kw)
    z = torch.zeros(ns.N, dtype=torch.float64)
    u, v, p = ns.solve_ptc(z)
    steps = ns._k
    assert ns.f64_fallback_count == ns.flex_retry_count == 0
    un, vn, _ = ns._get_solution(z)
    jns = JNS(1.0, 1.0, **kw)
    ju, jv, _ = jns.solve_ptc(jnp.zeros(jns.N))
    assert steps == jns._k
    res = ns._residual_norm(*ns._get_residuals(u, v, p, z))
    assert res <= 1e-9 * np.sqrt(3 * ns.N)
    for a, b, c in ((u, un, ju), (v, vn, jv)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-6)
    with pytest.raises(RuntimeError, match="no convergence in 2 steps"):
        ns.solve_ptc(z, max_steps=2)


# ------------------------ checkpoints and budgets ------------------------- #
@pytest.mark.parametrize("writer", ["sem_tpu", "port"])
def test_checkpoints_cross_between_packages(writer, tmp_path):
    """A checkpoint written by either package loads in the other: the four
    arrays bit-equal (float64), the configuration, iteration counters and
    ``ptc_dt`` carried; a configuration mismatch raises in both; a
    checkpoint without stats or extras loads with ``None`` / ``{}``."""
    rng = np.random.default_rng(9)
    T, u, v, p = (rng.standard_normal(n) for n in (13, 29, 29, 29))
    cfg = dict(Re=1e3, Ra=1e5, P_cd=4, mode="PTC")
    path = str(tmp_path / "state.npz")
    if writer == "sem_tpu":
        jckpt.save_checkpoint(path, JState(*(jnp.asarray(f) for f in
                                             (T, u, v, p))), cfg,
                              JStats(3, 4, 5, 6), extras={"ptc_dt": 0.375})
    else:
        tckpt.save_checkpoint(path, state_from_numpy(T, u, v, p,
                                                     device="cpu"), cfg,
                              MDAStats(3, 4, 5, 6), extras={"ptc_dt": 0.375})
    ts, tcfg, tit, tx = tckpt.load_checkpoint(path, expect_config=cfg,
                                              with_extras=True, device="cpu")
    js, jcfg, jit, jx = jckpt.load_checkpoint(path, expect_config=cfg,
                                              with_extras=True)
    assert ts.T.dtype == torch.float64 and ts.T.device.type == "cpu"
    for a, b, c in zip(state_to_numpy(ts), (js.T, js.u, js.v, js.p),
                       (T, u, v, p)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)
    assert tcfg == jcfg == cfg and tit == jit == [3, 4, 5, 6]
    assert tx == jx == {"ptc_dt": 0.375}
    assert len(tckpt.load_checkpoint(path, device="cpu")) == 3
    for load, kw in ((tckpt.load_checkpoint, dict(device="cpu")),
                     (jckpt.load_checkpoint, {})):
        with pytest.raises(ValueError, match="config mismatch"):
            load(path, expect_config=dict(cfg, Ra=1e6), **kw)
    bare = str(tmp_path / "bare.npz")
    (jckpt if writer == "sem_tpu" else tckpt).save_checkpoint(
        bare, types.SimpleNamespace(T=ts.T if writer == "port" else js.T,
                                    u=ts.u if writer == "port" else js.u,
                                    v=ts.v if writer == "port" else js.v,
                                    p=ts.p if writer == "port" else js.p),
        cfg)
    assert tckpt.load_checkpoint(bare, with_extras=True,
                                 device="cpu")[2:] == (None, {})


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    """``load_checkpoint`` puts the state on the card unless asked for the
    CPU: without one it raises instead of loading onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path = str(tmp_path / "s.npz")
    s = state_from_numpy(*(np.zeros(3) for _ in range(4)), device="cpu")
    tckpt.save_checkpoint(path, s, {})
    with pytest.raises((RuntimeError, AssertionError)):
        tckpt.load_checkpoint(path)


def test_budget_exit_checkpoints_and_resumes(monkeypatch, tmp_path):
    """A PTC march (``precon='bj'``, Δt₀=1: 18 steps uninterrupted) under a
    wall-clock budget that trips after 3 steps (a stand-in clock that
    advances 1 s per reading): exactly the budget ``RuntimeError``, the
    iterate of step 3 in the checkpoint with its counters and ``ptc_dt``;
    resumed with the stored Δt it converges to the uninterrupted state (u, T
    within 1e-4) in fewer steps than from zero.  A deadline in the past
    stops before the first step; without a checkpoint path the message says
    nothing of one."""
    kw = dict(mode="PTC", precon="bj", ptc_dt0=1.0, device="cpu", **PTC_KW)
    _, _, full = build_coupled(1.0, 1.0, **kw)
    s_full = full.solve()
    path = str(tmp_path / "ptc.npz")
    _, _, mda = build_coupled(1.0, 1.0, checkpoint_path=path,
                              time_budget_s=3.5, **kw)
    ticks = itertools.count(1.0)
    monkeypatch.setattr(tmda, "time", types.SimpleNamespace(
        monotonic=lambda: float(next(ticks))))
    with pytest.raises(RuntimeError, match="wall-clock budget exhausted "
                                           "after 3 iterations.*checkpointed"):
        mda.solve()
    monkeypatch.undo()
    cfg = dict(PTC_KW, mode="PTC")
    cfg.pop("mtol_nonlin"), cfg.pop("iprint")
    s3, _, iters, extras = tckpt.load_checkpoint(
        path, expect_config=cfg, with_extras=True, device="cpu")
    assert iters[2] == 3 and iters[0] == mda.cd_comp.iter_count_solve > 0
    assert 0 < extras["ptc_dt"] != 1.0
    _, _, resumed = build_coupled(1.0, 1.0, **dict(
        kw, ptc_dt0=extras["ptc_dt"]))
    s = resumed.solve(s3)
    assert 0 < resumed.stats.nonlinear_iters < full.stats.nonlinear_iters
    np.testing.assert_allclose(s.u.numpy(), s_full.u.numpy(), atol=1e-4)
    np.testing.assert_allclose(s.T.numpy(), s_full.T.numpy(), atol=1e-4)

    _, _, late = build_coupled(1.0, 1.0, time_deadline=0.0, **kw)
    with pytest.raises(RuntimeError, match="after 0 iterations") as err:
        late.solve()
    assert "checkpointed" not in str(err.value)


def test_budget_exit_on_a_cadence_step_records_its_count(monkeypatch,
                                                         tmp_path):
    """The budget of ``test_budget_exit_checkpoints_and_resumes`` tripping
    after step 3 where ``checkpoint_every=3`` has just saved that step: the
    checkpoint still holds the step count 3, the discipline counters and
    ``ptc_dt`` (the cadence save alone holds ``nonlinear_iters`` 0)."""
    path = str(tmp_path / "ptc.npz")
    _, _, mda = build_coupled(1.0, 1.0, mode="PTC", precon="bj", ptc_dt0=1.0,
                              device="cpu", checkpoint_path=path,
                              checkpoint_every=3, time_budget_s=3.5, **PTC_KW)
    ticks = itertools.count(1.0)
    monkeypatch.setattr(tmda, "time", types.SimpleNamespace(
        monotonic=lambda: float(next(ticks))))
    with pytest.raises(RuntimeError, match="wall-clock budget exhausted "
                                           "after 3 iterations.*checkpointed"):
        mda.solve()
    _, _, iters, extras = tckpt.load_checkpoint(path, with_extras=True,
                                                device="cpu")
    assert iters[:3] == [mda.cd_comp.iter_count_solve,
                         mda.ns_comp.iter_count_solve, 3]
    assert iters[0] > 0 and iters[3] == mda.stats.gmres_iters > 0
    assert 0 < extras["ptc_dt"] != 1.0


@pytest.mark.slow
def test_ptc_reaches_ra_1e5_from_zero_port():
    """tests/test_ptc.py:203-220 on the port: steady Ra=1e5 from zero via
    PTC at P=4, CD 8×8, NS 16×16; v_max·RePr within 2.0 of the de Vahl Davis
    value 68.59."""
    cd, ns, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=1e5, Pr=0.71,
                                P_cd=4, N_ex_cd=8, N_ey_cd=8,
                                P_ns=4, N_ex_ns=16, N_ey_ns=16,
                                mode="PTC", mtol_nonlin=1e-8, iprint=False,
                                device="cpu")
    s = mda.solve()
    assert float(torch.linalg.vector_norm(mda._residuals(s))) \
        <= mda.atol_nonlin
    v_anchor = float(s.v.abs().max()) * 1e3 * 0.71
    assert abs(v_anchor - 68.59) < 2.0, v_anchor
