"""Port parity, solver building blocks: ``FDM2D`` against ``sem_tpu.fdm``
(≤ 1e-12 relative, incl. the σ shift and the pure-Neumann pseudo-inverse),
and GMRES / the mixed-precision refinement against ``sem_tpu.krylov`` on
small SEM systems with consistent right-hand sides ``b = A·x_smooth``
(random RHSs mislead Krylov diagnostics): iteration counts within ±1 of the
reference's, final residual under tolerance.  Also the MDA's host FGMRES and
its forecast exit against ``sem_tpu.coupling.mda``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu import krylov as jkry
from sem_tpu import operators as jops
from sem_tpu.fdm import FDM2D as JFDM2D
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu_torch import krylov as tkry
from sem_tpu_torch.fdm import FDM2D
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import apply_system_best

from tests.torch_parity import one_torch_thread, rel_err, t32, t64  # noqa: F401

CFG = (4, 6, 5, 1.0, 1.2)


@pytest.mark.parametrize("dx,dy,alpha", [
    ((True, True), (True, True), 0.0),
    ((True, True), (False, False), 0.0),    # CD pattern (W/E Dirichlet)
    ((False, True), (True, False), 2.5),
    ((False, False), (False, False), 0.0),  # pure Neumann: pseudo-inverse
])
@pytest.mark.parametrize("sigma", [None, 0.0, 3.0])
def test_fdm_matches_reference(dx, dy, alpha, sigma, monkeypatch):
    monkeypatch.setenv("SEM_TPU_CACHE", "0")
    jf = JFDM2D(JGrid2D(*CFG), dirichlet_x=dx, dirichlet_y=dy, alpha=alpha)
    tf = FDM2D(Grid2D(*CFG), dirichlet_x=dx, dirichlet_y=dy, alpha=alpha)
    r = np.random.default_rng(1).standard_normal((2, jf.grid.N))
    ref = np.asarray(jf(jnp.asarray(r), sigma=sigma))
    got = tf(t64(r), sigma=sigma).numpy()                  # batched RHS
    assert rel_err(got, ref) <= 1e-12
    assert rel_err(tf(t64(r[0]), sigma=sigma), ref[0]) <= 1e-12


def _cd_system(Pe=40.0):
    """A CD tangent system (masked W/E Dirichlet rows) in both packages,
    with a circular wind and the smooth solution x_smooth."""
    jg, tg = JGrid2D(*CFG), Grid2D(*CFG)
    x, y = jg.points
    u, v = y - 0.6, 0.5 - x
    mask = jg.side_mask("W") | jg.side_mask("E")
    x_s = np.sin(np.pi * x) * np.cos(2 * y) + x * y
    jfdm = JFDM2D(jg, dirichlet_x=(True, True), dirichlet_y=(False, False))
    tfdm = FDM2D(tg, dirichlet_x=(True, True), dirichlet_y=(False, False))

    def jmv(dtype):
        uu, vv, m = jnp.asarray(u, dtype), jnp.asarray(v, dtype), mask
        return lambda w: jnp.where(m, w, jops.apply_system(jg, uu, vv, w,
                                                           Pe))

    def tmv(dtype):
        uu = torch.as_tensor(u, dtype=dtype)
        vv = torch.as_tensor(v, dtype=dtype)
        m = torch.as_tensor(mask)
        return lambda w: torch.where(m, w, apply_system_best(tg, uu, vv, w,
                                                             Pe))

    b = np.asarray(jmv(jnp.float64)(jnp.asarray(x_s)))
    return jmv, tmv, jfdm, tfdm, b


def test_gmres_f64_right_preconditioned_matches_reference():
    jmv, tmv, jfdm, tfdm, b = _cd_system()
    atol = 1e-10 * np.linalg.norm(b)
    _, jinfo = jkry.gmres(jmv(jnp.float64), jnp.asarray(b), atol=atol,
                          restart=30, maxiter=300, precon=jfdm)
    x, info = tkry.gmres(tmv(torch.float64), t64(b), atol=atol, restart=30,
                         maxiter=300, precon=tfdm)
    assert bool(jinfo.converged) and info.converged
    assert abs(info.iterations - int(jinfo.iterations)) <= 1
    res = float(torch.linalg.vector_norm(t64(b) - tmv(torch.float64)(x)))
    assert res <= atol


@pytest.mark.parametrize("restart", [8, 40])
def test_gmres_f32_left_preconditioned_matches_reference(restart):
    """The f32 chunk form (left FDM preconditioner, plain-version B1 matvec
    on the CPU); restart=8 exercises restarts and the stall test."""
    jmv, tmv, jfdm, tfdm, b = _cd_system()
    f32 = jnp.float32
    jA, tA = jmv(f32), tmv(torch.float32)
    rp_j = jfdm(jnp.asarray(b, f32))
    rp_t = tfdm(t32(b))
    atol = 1e-5 * float(jnp.linalg.norm(rp_j))
    _, jinfo = jkry.gmres(lambda q: jfdm(jA(q)), rp_j, atol=atol,
                          restart=restart, maxiter=200)
    x, info = tkry.gmres(lambda q: tfdm(tA(q)), rp_t, atol=atol,
                         restart=restart, maxiter=200)
    assert bool(jinfo.converged) == info.converged
    assert abs(info.iterations - int(jinfo.iterations)) <= 1
    assert info.resnorm <= atol


def test_refined_gmres_matches_reference():
    """f32 chunks inside f64 refinement reach a 1e-11-relative f64 target
    (far below the f32 floor) in the reference's inner-iteration count ±1."""
    jmv, tmv, jfdm, tfdm, b = _cd_system()
    f32 = jnp.float32
    jA64, jA32 = jmv(jnp.float64), jmv(f32)
    tA64, tA32 = tmv(torch.float64), tmv(torch.float32)
    atol = 1e-11 * np.linalg.norm(b)
    bj, bt = jnp.asarray(b), t64(b)

    x_j, jinfo = jkry.refined_gmres_host(
        cres=lambda x: bj - jA64(x), pc_lp=jfdm,
        gmres_chunk=lambda r, x0, a: jkry.gmres(
            lambda q: jfdm(jA32(q)), r, x0=x0, atol=a, restart=30,
            maxiter=65),
        b=bj, x0=jnp.zeros_like(bj), atol=atol, maxiter=2000)
    x_t, info = tkry.refined_gmres_host(
        cres=lambda x: bt - tA64(x), pc_lp=tfdm,
        gmres_chunk=lambda r, x0, a: tkry.gmres(
            lambda q: tfdm(tA32(q)), r, x0=x0, atol=a, restart=30,
            maxiter=65),
        b=bt, x0=torch.zeros_like(bt), atol=atol, maxiter=2000)
    assert bool(jinfo.converged) and info.converged
    assert abs(info.iterations - int(jinfo.iterations)) <= 1
    assert float(torch.linalg.vector_norm(bt - tA64(x_t))) <= atol
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j),
                               atol=1e-9 * np.max(np.abs(np.asarray(x_j))))


def test_host_fgmres_matches_reference_and_scipy():
    """The MDA's host FGMRES (``coupling.mda._fgmres``): with an f64 basis
    it reproduces SciPy's restarted GMRES on a hard system to all digits
    (pins the Hessenberg/Givens wiring), with the default f32 basis the
    reference's iteration count, and it stall-exits like the reference."""
    from scipy.sparse.linalg import gmres as sp_gmres
    from sem_tpu.coupling.mda import _fgmres as jax_fgmres
    from sem_tpu_torch.coupling.mda import _fgmres

    rng = np.random.default_rng(0)
    n = 200
    A = np.eye(n) * 4 + 0.1 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    atol = 1e-10 * np.linalg.norm(b)
    At = torch.as_tensor(A)
    x, it, ok = _fgmres(lambda v: At @ v, lambda r: r, t64(b), atol=atol,
                        restart=10, maxiter=100)
    _, it_j, ok_j = jax_fgmres(lambda v: jnp.asarray(A) @ v, lambda r: r,
                               jnp.asarray(b), atol=atol, restart=10,
                               maxiter=100)
    assert ok and ok_j and abs(it - it_j) <= 1
    assert np.linalg.norm(A @ x.numpy() - b) <= 10 * atol

    A2 = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    A2t = torch.as_tensor(A2)
    x_sp, _ = sp_gmres(A2, b, rtol=1e-10, restart=10, maxiter=2)
    x2, _, _ = _fgmres(lambda v: A2t @ v, lambda r: r, t64(b), atol=atol,
                       restart=10, maxiter=20, basis_dtype=torch.float64)
    np.testing.assert_allclose(x2.numpy(), x_sp, rtol=1e-9, atol=1e-12)
    # a flat window followed by a < 2% true-residual restart exits early
    _, it3, ok3 = _fgmres(lambda v: A2t @ v, lambda r: r, t64(b), atol=atol,
                          restart=10, maxiter=1000)
    assert not ok3 and it3 <= 60


def test_forecast_exit_matches_reference():
    from sem_tpu.coupling.mda import _forecast_doomed as jax_doomed
    from sem_tpu_torch.coupling.mda import _forecast_doomed

    cases = [([0.6 * 0.9994 ** k for k in range(80)], 0.024, 160),
             ([0.6 * 0.9 ** k for k in range(80)], 1e-8, 160),
             ([0.6 * 0.9994 ** k for k in range(50)], 0.024, 200),
             ([0.6] * 80, 0.024, 10)]
    got = [_forecast_doomed(h, a, r) for h, a, r in cases]
    assert got == [jax_doomed(h, a, r) for h, a, r in cases]
    assert got == [True, False, False, True]


@pytest.mark.parametrize("restart", [30, 8])
def test_gmres_return_hist_matches_reference(restart):
    """``gmres(..., return_hist=True)`` on the f64 CD system (restart=8
    restarts twice): the third value has the reference's shape
    ``(maxiter,)``, its first ``iterations`` entries the reference's
    recurrence residuals within 1e-12 of the first one, the padding equal;
    without the flag the return stays ``(x, info)``."""
    jmv, tmv, jfdm, tfdm, b = _cd_system()
    atol = 1e-10 * np.linalg.norm(b)
    kw = dict(atol=atol, restart=restart, maxiter=60)
    _, jinfo, jhist = jkry.gmres(jmv(jnp.float64), jnp.asarray(b),
                                 precon=jfdm, return_hist=True, **kw)
    x, info, hist = tkry.gmres(tmv(torch.float64), t64(b), precon=tfdm,
                               return_hist=True, **kw)
    assert info.iterations == int(jinfo.iterations) > restart
    assert hist.shape == (60,) == np.asarray(jhist).shape
    assert hist.dtype == torch.float64 and hist.device.type == "cpu"
    assert rel_err(hist.numpy(), np.asarray(jhist)) <= 1e-12
    x2, info2 = tkry.gmres(tmv(torch.float64), t64(b), precon=tfdm, **kw)
    assert info2 == info and torch.equal(x2, x)


def test_fgmres_return_hist_matches_reference():
    """``fgmres(..., return_hist=True)`` against the history the reference's
    ``fgmres`` always returns, within 1e-12 of the first residual."""
    jmv, tmv, jfdm, tfdm, b = _cd_system()
    atol = 1e-10 * np.linalg.norm(b)
    kw = dict(atol=atol, restart=12, maxiter=50)
    _, jinfo, jhist = jkry.fgmres(jmv(jnp.float64), jnp.asarray(b),
                                  precon=jfdm, **kw)
    out = tkry.fgmres(tmv(torch.float64), t64(b), precon=tfdm, **kw)
    assert len(out) == 2
    _, info, hist = tkry.fgmres(tmv(torch.float64), t64(b), precon=tfdm,
                                return_hist=True, **kw)
    assert info.iterations == int(jinfo.iterations)
    assert rel_err(hist.numpy(), np.asarray(jhist)) <= 1e-12


@pytest.mark.parametrize("precon", [False, True], ids=["plain", "jacobi"])
def test_cg_matches_reference(precon):
    """``cg`` as tests/test_krylov_fdm.py:143 uses it (an SPD system with
    condition number 50, atol 1e-10), plain and Jacobi-preconditioned: the
    reference's iteration count, ``KrylovInfo`` fields of the same meaning,
    the solution within 1e-7."""
    rng = np.random.default_rng(5)
    n = 90
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, 50.0, n)) @ Q.T
    x_true = rng.standard_normal(n)
    b = A @ x_true
    d = np.diag(A).copy()
    Aj, At = jnp.asarray(A), t64(A)
    jpc = (lambda r: r / jnp.asarray(d)) if precon else None
    tpc = (lambda r: r / t64(d)) if precon else None
    _, jinfo = jkry.cg(lambda v: Aj @ v, jnp.asarray(b), atol=1e-10,
                       maxiter=2000, precon=jpc)
    x, info = tkry.cg(lambda v: At @ v, t64(b), atol=1e-10, maxiter=2000,
                      precon=tpc)
    assert info.converged and bool(jinfo.converged)
    assert info.iterations == int(jinfo.iterations)
    assert not info.stalled and info.resnorm <= 1e-10
    np.testing.assert_allclose(x.numpy(), x_true, rtol=1e-7, atol=1e-8)
    # the iteration cap: not converged, the count at the cap
    _, capped = tkry.cg(lambda v: At @ v, t64(b), atol=1e-10, maxiter=5)
    assert not capped.converged and capped.iterations == 5


@pytest.mark.parametrize("dx,dy", [((True, True), (False, False)),
                                   ((False, False), (False, False))])
def test_fdm_solve_matches_reference(dx, dy, monkeypatch):
    """``FDM2D.solve`` (the precomputed diagonal, one RHS and a batch)
    against ``sem_tpu``'s, ≤ 1e-12 relative, and equal to ``fdm(r)``."""
    monkeypatch.setenv("SEM_TPU_CACHE", "0")
    jf = JFDM2D(JGrid2D(*CFG), dirichlet_x=dx, dirichlet_y=dy, alpha=1.5)
    tf = FDM2D(Grid2D(*CFG), dirichlet_x=dx, dirichlet_y=dy, alpha=1.5)
    r = np.random.default_rng(2).standard_normal((3, jf.grid.N))
    ref = np.asarray(jf.solve(jnp.asarray(r)))
    got = tf.solve(t64(r))
    assert rel_err(got, ref) <= 1e-12
    assert rel_err(tf.solve(t64(r[1])), ref[1]) <= 1e-12
    assert torch.equal(got, tf(t64(r)))


@pytest.mark.parametrize("solver", ["gmres", "fgmres"])
@pytest.mark.parametrize("eta", [0.0, 0.25, 1.0])
def test_dgks_eta_matches_reference(solver, eta):
    """``dgks_eta=`` of ``gmres`` and ``fgmres`` on the f32 CD chunk (left
    FDM preconditioner): the reference's iterations ±1 and resweep counts
    ±1; η = 0 never resweeps, η = 1 resweeps every iteration, and the
    default equals η = 0.25 (``DGKS_ETA``) bit for bit."""
    jmv, tmv, jfdm, tfdm, b = _cd_system()
    f32 = jnp.float32
    jA, tA = jmv(f32), tmv(torch.float32)
    rp_j, rp_t = jfdm(jnp.asarray(b, f32)), tfdm(t32(b))
    atol = 1e-5 * float(jnp.linalg.norm(rp_j))
    kw = dict(atol=atol, restart=20, maxiter=200, dgks_eta=eta)
    if solver == "gmres":
        jinfo = jkry.gmres(lambda q: jfdm(jA(q)), rp_j, **kw)[1]
        x, info = tkry.gmres(lambda q: tfdm(tA(q)), rp_t, **kw)
        x0, info0 = tkry.gmres(lambda q: tfdm(tA(q)), rp_t,
                               **dict(kw, dgks_eta=None))
    else:
        ident = lambda r: r  # noqa: E731
        jinfo = jkry.fgmres(lambda q: jfdm(jA(q)), rp_j, precon=ident,
                            **kw)[1]
        x, info = tkry.fgmres(lambda q: tfdm(tA(q)), rp_t, precon=ident,
                              **kw)
        x0, info0 = tkry.fgmres(lambda q: tfdm(tA(q)), rp_t, precon=ident,
                                **dict(kw, dgks_eta=None))
    assert info.converged and bool(jinfo.converged)
    assert abs(info.iterations - int(jinfo.iterations)) <= 1
    assert abs(info.resweeps - int(jinfo.resweeps)) <= 1
    if eta == 0.0:
        assert info.resweeps == 0
    if eta == 1.0:
        assert info.resweeps == info.iterations
    if eta == tkry.DGKS_ETA:
        assert info0 == info and torch.equal(x0, x)


def test_package_exports_match_reference():
    """The port's top-level and ``models`` exports cover ``sem_tpu``'s:
    ``cg`` and the two solvers by the same names."""
    import sem_tpu
    import sem_tpu.models
    import sem_tpu_torch
    import sem_tpu_torch.models

    assert set(sem_tpu.__all__) <= set(sem_tpu_torch.__all__)
    assert sem_tpu_torch.models.__all__ == sem_tpu.models.__all__
    assert sem_tpu_torch.cg is tkry.cg
    for name in sem_tpu_torch.models.__all__:
        assert getattr(sem_tpu_torch.models, name) is getattr(sem_tpu_torch,
                                                              name)
