"""Port parity, the NS solver's options: ``linear_solver`` ∈ {``coupled``,
``uzawa``} × ``schur_precon`` ∈ {``spectral``, ``mass``, ``pcd``} of
``sem_tpu_torch.NavierStokesSolver`` (``device="cpu"``) against
``sem_tpu.NavierStokesSolver`` on the same inputs: whole Newton solves, single
linear updates on consistent right-hand sides ``b = J·x_smooth``, the coupled
preconditioner application alone, the iteration counts under mesh
refinement, the options inside coupled Boussinesq solves, the
``'LGMRES_iter'`` histories, and ``solve_continued`` with a tolerance the
prolonged state already meets.

Float64 paths (Uzawa, ``mixed_precision=False``) reproduce the reference's
iteration counts exactly or within ±1 and its fields to roundoff.  The mixed
path's f32 chunks end near the f32 floor of these saddle systems, where the
last restart cycle creeps and its length follows the summation order of the
two packages' f32 matmuls (seen: 109 against 146 iterations in one step,
the histories equal to 1e-5 until the recurrence residual first meets the
tolerance): there the counts are held within 50 % and the fields at the
accuracy the Newton tolerance gives.
"""
import contextlib
import io
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu import ConvectionDiffusionSolver as JCD
from sem_tpu import NavierStokesSolver as JNS
from sem_tpu.coupling import boussinesq as jbq
from sem_tpu.coupling.components import (
    ConvectionDiffusionComponent as JCDComp, NavierStokesComponent as JNSComp)
from sem_tpu.coupling.mda import BoussinesqMDA as JMDA
from sem_tpu_torch import ConvectionDiffusionSolver as TCD
from sem_tpu_torch import NavierStokesSolver as TNS
from sem_tpu_torch.coupling import build_coupled, solve_continued
from sem_tpu_torch.coupling.components import (ConvectionDiffusionComponent,
                                               NavierStokesComponent)
from sem_tpu_torch.coupling.mda import BoussinesqMDA

from tests.torch_parity import one_torch_thread, t32, t64  # noqa: F401
from tests.torch_parity import port_unfused  # noqa: F401

# the configuration of tests/test_ns_solver.py:90-96
KW = dict(Re=50.0, Gr=100.0, P=3, N_ex=3, N_ey=3, u_N=1.0, mtol=1e-11,
          mtol_newton=1e-9, iprint=[])
# (linear_solver, schur_precon, mixed_precision)
OPTIONS = [("uzawa", "mass", True), ("uzawa", "spectral", True),
           ("coupled", "mass", True), ("coupled", "pcd", True),
           ("coupled", "mass", False), ("coupled", "pcd", False)]
IDS = ["uzawa-mass", "uzawa-spectral", "coupled-mass-mixed",
       "coupled-pcd-mixed", "coupled-mass-f64", "coupled-pcd-f64"]
QUICK = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=3, N_ex_cd=3, N_ey_cd=3,
             P_ns=3, N_ex_ns=3, N_ey_ns=3, iprint=False)


def _is_f64_path(ls, mixed):
    return ls == "uzawa" or not mixed


def _record_updates(ns):
    """Wrap ``ns._get_update``: per call, the (Schur/coupled GMRES, last
    velocity solve) iteration counts."""
    its, update = [], ns._get_update

    def recorded(*a, **k):
        out = update(*a, **k)
        its.append((int(ns.last_schur_info.iterations),
                    int(ns.last_velo_info.iterations)))
        return out

    ns._get_update = recorded
    return its


def _counts_close(got, ref, exact):
    if exact:
        return abs(got - ref) <= 1
    return abs(got - ref) <= max(2, 0.5 * ref)


@pytest.mark.parametrize("ls,sp,mixed", OPTIONS, ids=IDS)
def test_newton_solve_matches_reference(ls, sp, mixed):
    """Lid cavity Re=50 Gr=100 P=3 3×3 with T = 0.3 sin(πx): equal Newton
    counts; GMRES iterations of each Newton step within ±1 (f64 paths) or
    50 % (mixed, see the module docstring); u, v within 1e-9 (f64) or 1e-7
    (mixed), p within 1e-6 (f64) or 1e-5 (mixed: p carries a ~20 scale)."""
    jns = JNS(1.0, 1.0, linear_solver=ls, schur_precon=sp,
              mixed_precision=mixed, **KW)
    tns = TNS(1.0, 1.0, linear_solver=ls, schur_precon=sp,
              mixed_precision=mixed, device="cpu", **KW)
    T = 0.3 * np.sin(np.pi * jns.points[0])
    jits, tits = _record_updates(jns), _record_updates(tns)
    ref = [np.asarray(f) for f in jns._get_solution(jnp.asarray(T))]
    got = [f.numpy() for f in tns._get_solution(T)]
    assert tns._k == jns._k
    exact = _is_f64_path(ls, mixed)
    for (a, av), (b, bv) in zip(tits, jits):
        assert _counts_close(a, b, exact), (tits, jits)
        assert _counts_close(av, bv, exact), (tits, jits)
    uv_tol, p_tol = (1e-9, 1e-6) if exact else (1e-7, 1e-5)
    np.testing.assert_allclose(got[0], ref[0], atol=uv_tol)
    np.testing.assert_allclose(got[1], ref[1], atol=uv_tol)
    np.testing.assert_allclose(got[2], ref[2], atol=p_tol)


def _linearization(seed=11, P=3, Ne=3):
    """A random linearization, a smooth update x_smooth and b = J·x_smooth
    (from the reference's tangent)."""
    rng = np.random.default_rng(seed)
    N = (P * Ne + 1) ** 2
    u, v, p, T = (rng.standard_normal(N) * 0.1 for _ in range(4))
    jns = JNS(1.0, 1.0, **dict(KW, P=P, N_ex=Ne, N_ey=Ne))
    x, y = jns.points
    interior = ~np.asarray(jns._mask_bound)
    xs = (np.sin(np.pi * x) * np.sin(2 * np.pi * y) * interior,
          np.sin(2 * np.pi * x) * np.sin(np.pi * y) * interior,
          np.cos(np.pi * x) * np.cos(np.pi * y))
    jns._get_residuals(u, v, p, T)
    jns._calc_jacobians(u, v)
    b = [np.asarray(r) for r in jns._get_dresiduals(*xs)]
    return (u, v, p, T), xs, b


# velo_inner is a knob of the coupled preconditioner only
UPDATE_CASES = [(*o, 0) for o in OPTIONS] + [(*o, 2) for o in OPTIONS[2:]]
UPDATE_IDS = IDS + [i + "-velo_inner2" for i in IDS[2:]]


@pytest.mark.parametrize("ls,sp,mixed,velo_inner", UPDATE_CASES,
                         ids=UPDATE_IDS)
def test_get_update_matches_reference(ls, sp, mixed, velo_inner):
    """One ``_get_update`` on ``b = J·x_smooth`` at a random linearization
    (the shape of tests/test_ns_solver.py:102-118), ``mtol=1e-10``: the
    port's update within 1e-9 of the reference's on the f64 paths (both
    within 1e-7 of x_smooth, p 1e-5, on every path), ``last_schur_info`` and
    ``last_velo_info`` iterations within ±1 (f64) or 50 % (mixed).  With
    ``velo_inner=2`` the coupled paths run their flexible loops."""
    (u, v, p, T), xs, b = _linearization()
    kw = dict(KW, mtol=1e-10, linear_solver=ls, schur_precon=sp,
              mixed_precision=mixed, velo_inner=velo_inner)
    jns = JNS(1.0, 1.0, **kw)
    tns = TNS(1.0, 1.0, device="cpu", **kw)
    for ns in (jns, tns):
        ns._get_residuals(u, v, p, T)
        ns._calc_jacobians(u, v)
    ref = [np.asarray(f) for f in jns._get_update(*b)]
    got = [f.numpy() for f in tns._get_update(*b)]
    exact = _is_f64_path(ls, mixed)
    for g, r, x, tol in zip(got, ref, xs, (1e-7, 1e-7, 1e-5)):
        if exact:
            np.testing.assert_allclose(g, r, atol=1e-9)
        np.testing.assert_allclose(g, x, atol=tol)
        np.testing.assert_allclose(r, x, atol=tol)
    assert _counts_close(tns.last_schur_info.iterations,
                         int(jns.last_schur_info.iterations), exact)
    assert _counts_close(tns.last_velo_info.iterations,
                         int(jns.last_velo_info.iterations), exact)
    assert tns.flex_retry_count == jns.flex_retry_count == 0
    assert tns.f64_fallback_count == jns.f64_fallback_count == 0


@pytest.mark.parametrize("sigma", [0.0, 0.7])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("sp", ["mass", "pcd"])
def test_coupled_pc_application_matches_reference(sp, f32, sigma):
    """The block preconditioner ``pc`` alone on ``r = J·x_smooth`` (P=4 5×4
    on 1.0×1.3, a wind in the ``'pcd'`` block): against the reference's
    ``_coupled_ops(...)[1]`` within 1e-12·max (f64) / 2e-5·max (f32).  The
    f32 ``'pcd'`` case holds the Neumann FDM's pseudo-inverted zero mode in
    f32 against ``sem_tpu.fdm``."""
    kw = dict(KW, P=4, N_ex=5, N_ey=4, schur_precon=sp)
    jns = JNS(1.0, 1.3, **kw)
    tns = TNS(1.0, 1.3, device="cpu", **kw)
    rng = np.random.default_rng(3)
    x, y = jns.points
    ul, vl = np.sin(np.pi * x) * np.cos(y), 0.5 - x * y
    jns._get_residuals(ul, vl, 0 * x, 0 * x)
    jns._calc_jacobians(ul, vl, sigma=sigma)
    r = np.concatenate([np.asarray(f) for f in jns._get_dresiduals(
        np.sin(np.pi * x) * y, x * np.cos(2 * y), np.cos(np.pi * x) + y)])
    r = r + 1e-3 * rng.standard_normal(r.shape)
    if f32:
        lp = jnp.float32
        ref = np.asarray(jns._pc32_jit(jnp.asarray(r, lp), jnp.asarray(ul, lp),
                                       jnp.asarray(vl, lp),
                                       jnp.asarray(sigma, lp)))
        to, tol = t32, 2e-5
    else:
        ref = np.asarray(jns._pc64_fn(jnp.asarray(r), jnp.asarray(ul),
                                      jnp.asarray(vl), jnp.asarray(sigma)))
        to, tol = t64, 1e-12
    zero = tuple(torch.zeros(tns.N, dtype=to(r).dtype) for _ in range(4))
    _, pc = tns._coupled_ops(to(ul), to(vl), zero, to(r).dtype)
    got = pc(to(r), sigma).numpy()
    assert got.dtype == ref.dtype
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


@pytest.mark.parametrize("precon", ["spectral", "mass"])
def test_schur_resolution_counts_match_reference(precon):
    """The port's analog of ``test_ns_spectral_schur_resolution_robust``
    (tests/test_ns_solver.py:140-159; Re=1e3, Gr=1e3/0.71, P=4, one update
    from zero with T = 0.5 - x on the mixed path): the coupled GMRES counts
    at Ne=8 and Ne=16 within 50 % of the reference's, ``'spectral'`` under
    2× per 2× refinement and ``'mass'`` growing faster than it."""
    counts = {}
    for Ne in (8, 16):
        kw = dict(Re=1e3, Gr=1e3 / 0.71, P=4, N_ex=Ne, N_ey=Ne, mtol=1e-9,
                  mtol_newton=1e-7, schur_precon=precon, iprint=[])
        jns = JNS(1.0, 1.0, **kw)
        tns = TNS(1.0, 1.0, device="cpu", **kw)
        T = 0.5 - jns.points[0]
        z = np.zeros(jns.N)
        for ns in (jns, tns):
            ru, rv, rc = ns._get_residuals(z, z, z, T)
            ns._calc_jacobians(z, z)
            ns._get_update(-ru, -rv, -rc)
            counts[type(ns), Ne] = int(ns.last_schur_info.iterations)
        assert _counts_close(counts[TNS, Ne], counts[JNS, Ne], False), counts
    if precon == "spectral":
        assert counts[TNS, 16] < 2 * counts[TNS, 8]
    else:
        assert counts[TNS, 16] > 1.5 * counts[TNS, 8]


def test_build_coupled_pcd_jnk_matches_reference(monkeypatch, port_unfused):
    """``build_coupled(..., schur_precon="pcd")``, JNK at the QUICK
    configuration, both packages pinned to the un-fused host FGMRES: MDA
    stats equal to the reference's, coupled GMRES iterations within ±1, T/u
    within 1e-7."""
    monkeypatch.setenv("SEM_TPU_FG_FUSED", "0")
    monkeypatch.setenv("SEM_TPU_FUSED_PC", "0")
    _, jns, jmda = jbq.build_coupled(1.0, 1.0, mode="JNK", schur_precon="pcd",
                                     device_krylov=False, **QUICK)
    js = jmda.solve()
    _, ns, mda = build_coupled(1.0, 1.0, mode="JNK", schur_precon="pcd",
                               device="cpu", **QUICK)
    s = mda.solve()
    assert ns._fdm_p is not None and ns._spec is None
    assert mda.stats.as_list() == jmda.stats.as_list()
    assert abs(mda.stats.gmres_iters - jmda.stats.gmres_iters) <= 1
    np.testing.assert_allclose(s.T.numpy(), np.asarray(js.T), atol=1e-7)
    np.testing.assert_allclose(s.u.numpy(), np.asarray(js.u), atol=1e-7)


def test_uzawa_ns_block_in_gs_matches_reference():
    """An Uzawa NS solver as the NS block of a Gauss-Seidel MDA, the solvers
    built by hand as ``build_coupled`` builds them (neither package's
    ``build_coupled`` has a ``linear_solver`` argument): equal MDA stats, T
    and u within 1e-8."""
    kw = dict(P=3, N_ex=3, N_ey=3)
    mt = 1e-13

    def make(CD, NS, CDComp, NSComp, MDA, **dev):
        cd = CD(L_x=1.0, L_y=1.0, Pe=1e3 * 0.71, T_W=0.5, T_E=-0.5, mtol=mt,
                **kw, **dev)
        ns = NS(L_x=1.0, L_y=1.0, Re=1e3, Gr=1e3 / 0.71, mtol=mt,
                mtol_newton=mt, linear_solver="uzawa", iprint=[], **kw,
                **dev)
        return ns, MDA(CDComp(cd, ns), NSComp(cd, ns), mode="GS",
                       iprint=False)

    jns, jmda = make(JCD, JNS, JCDComp, JNSComp, JMDA)
    tns, tmda = make(TCD, TNS, ConvectionDiffusionComponent,
                     NavierStokesComponent, BoussinesqMDA, device="cpu")
    js, s = jmda.solve(), tmda.solve()
    assert tmda.stats.as_list() == jmda.stats.as_list()
    assert tns.last_velo_info.iterations > 0
    np.testing.assert_allclose(s.T.numpy(), np.asarray(js.T), atol=1e-8)
    np.testing.assert_allclose(s.u.numpy(), np.asarray(js.u), atol=1e-8)


def test_uzawa_under_ptc_matches_reference():
    """``solve_ptc`` with the Uzawa solver: σ > 0 reaches the velocity
    solve's FDM and the Schur preconditioner, and the closures follow each
    step's linearization.  Equal step counts, u within 1e-8."""
    kw = dict(KW, linear_solver="uzawa", schur_precon="spectral")
    jns = JNS(1.0, 1.0, **kw)
    tns = TNS(1.0, 1.0, device="cpu", **kw)
    T = 0.3 * np.sin(np.pi * jns.points[0])
    ref = jns.solve_ptc(jnp.asarray(T))
    got = tns.solve_ptc(T)
    assert tns._k == jns._k > 1
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-8)


def _hist_lines(text, label):
    return [(int(n), float(v)) for n, v in re.findall(
        label + r" LGMRES: (\d+)\t(\S+)", text)]


@pytest.mark.parametrize("ls,sp,mixed", [("coupled", "mass", False),
                                         ("coupled", "spectral", True),
                                         ("uzawa", "spectral", True)],
                         ids=["coupled-f64", "coupled-mixed", "uzawa"])
def test_ns_lgmres_iter_output_matches_reference(ls, sp, mixed, capsys):
    """``'LGMRES_iter'`` of the NS solver on one update, ``b = J·x_smooth``,
    in the reference's format.  Float64 paths: as many lines as the
    reference prints, numbered alike, values within 1e-10 relative (of the
    first residual), and the same ``'VELO_suc'`` line.  Mixed path (the f32
    inner-loop residuals, numbered through the chunks): each package prints
    one line per iteration it ran, numbered 1..iterations, and the first 40
    values agree within 1e-4 (the reference prints f32 values, and past the
    f32 floor the two packages' cycles creep differently: module
    docstring)."""
    (u, v, p, T), xs, b = _linearization()
    kw = dict(KW, mtol=1e-10, linear_solver=ls, schur_precon=sp,
              mixed_precision=mixed, iprint=["LGMRES_iter", "VELO_suc"])
    out, its = {}, {}
    for name, ns in (("ref", JNS(1.0, 1.0, **kw)),
                     ("got", TNS(1.0, 1.0, device="cpu", **kw))):
        ns._get_residuals(u, v, p, T)
        ns._calc_jacobians(u, v)
        capsys.readouterr()
        ns._get_update(*b)
        out[name] = capsys.readouterr().out
        its[name] = int(ns.last_schur_info.iterations)
    ref, got = (_hist_lines(out[k], "NavierStokes") for k in ("ref", "got"))
    assert len(ref) > 5
    for lines, k in ((ref, "ref"), (got, "got")):
        assert [n for n, _ in lines] == list(range(1, its[k] + 1))
    velo = {k: [ln for ln in out[k].splitlines() if "velocity solve" in ln]
            for k in out}
    assert len(velo["got"]) == len(velo["ref"]) == 1
    if _is_f64_path(ls, mixed):
        assert len(got) == len(ref)
        assert velo["got"] == velo["ref"]
        n, rtol = len(ref), 1e-10
    else:
        n, rtol = 40, 1e-4
    assert max(abs(a - b_) for (_, a), (_, b_) in zip(got[:n], ref[:n])) \
        <= rtol * ref[0][1]


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_cd_lgmres_iter_output_matches_reference(mixed, capsys):
    """``'LGMRES_iter'`` of the CD solver (circular flow, Pe=40, P=4 4×4):
    line counts and numbering equal to the reference's, values within 1e-10
    relative (f64) / 1e-4 (mixed: f32 inner-loop residuals)."""
    kw = dict(Pe=40, P=4, N_ex=4, N_ey=4, T_W=0.5, T_E=-0.5,
              mixed_precision=mixed, iprint=["LGMRES_iter"])
    out = {}
    for name, cd in (("ref", JCD(1.0, 1.0, **kw)),
                     ("got", TCD(1.0, 1.0, device="cpu", **kw))):
        x, y = cd.points
        capsys.readouterr()
        cd._get_solution(y - 0.5, 0.5 - x)
        out[name] = capsys.readouterr().out
    ref, got = (_hist_lines(out[k], "ConvectionDiffusion")
                for k in ("ref", "got"))
    assert len(ref) > 5
    assert [n for n, _ in got] == [n for n, _ in ref]
    rtol = 1e-4 if mixed else 1e-10
    assert max(abs(a - b) for (_, a), (_, b) in zip(got, ref)) \
        <= rtol * ref[0][1]


def test_constructor_options():
    """Every combination constructs; the host constants of a Schur block are
    built only for that block; bad values raise ``ValueError`` as in the
    reference."""
    for ls in ("coupled", "uzawa"):
        for sp in ("spectral", "mass", "pcd"):
            ns = TNS(1.0, 1.0, Re=1.0, Gr=0.0, P=2, N_ex=2, N_ey=2,
                     linear_solver=ls, schur_precon=sp, device="cpu")
            assert (ns._spec is not None) == (sp == "spectral")
            assert (ns._fdm_p is not None) == (sp == "pcd")
    with pytest.raises(ValueError, match="linear_solver"):
        TNS(1.0, 1.0, Re=1.0, Gr=0.0, P=2, N_ex=2, N_ey=2,
            linear_solver="lu", device="cpu")
    with pytest.raises(ValueError, match="schur_precon"):
        TNS(1.0, 1.0, Re=1.0, Gr=0.0, P=2, N_ex=2, N_ey=2,
            schur_precon="diag", device="cpu")


def _level_stats(text):
    return [eval(s) for s in re.findall(r"stats=(\[[0-9, ]*\])", text)]


def test_solve_continued_level_already_converged_matches_reference(
        monkeypatch, port_unfused):
    """``solve_continued`` with ``mtol_nonlin`` loose enough (1e-4) that the
    prolonged P=4 state already meets it at P=8: the per-level stats of the
    two packages are equal, and the fine level does no nonlinear iteration
    in either (its stats count only the sweep that evaluates the state)."""
    monkeypatch.setenv("SEM_TPU_FG_FUSED", "0")
    monkeypatch.setenv("SEM_TPU_FUSED_PC", "0")
    kw = dict(Re=1e3, Ra=1e3, Pr=0.71, N_ex_cd=4, N_ey_cd=4, N_ex_ns=4,
              N_ey_ns=4, mode="JNK", mtol_nonlin=1e-4, iprint=False,
              P_cd=8, P_ns=8, levels=1, timing=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, _, mda, s = solve_continued(1.0, 1.0, device="cpu", **kw)
    got = _level_stats(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, _, jmda, js = jbq.solve_continued(1.0, 1.0, device_krylov=False,
                                             **kw)
    ref = _level_stats(buf.getvalue())
    assert len(got) == 2 and got == ref
    assert got[-1][2] == 0 and mda.stats.nonlinear_iters == 0
    np.testing.assert_allclose(s.u.numpy(), np.asarray(js.u), atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("sp", ["spectral", "pcd", "mass"])
def test_cuda_schur_blocks_match_cpu(sp):
    """On the card: the lid cavity Re=100 at P=8 8×8, Newton RMS 5e-12, with
    each Schur block (kernel B2 in the f32 chunks) against the same solver
    on the CPU (plain versions): equal Newton counts; the card's solution
    meets the Newton tolerance in the CPU solver's residual (×2 for the two
    devices' roundoff); u within 1e-4.  That last bound is what the
    discretization determines: its near-spurious pressure modes map a
    residual to ~1e4 times itself in u at a few nodes, so two converged runs
    sit up to 1.7e-5 apart (``'spectral'``, measured on an H100; ``'mass'``
    and ``'pcd'`` under 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sem_tpu_torch.ops import kernels

    kw = dict(Re=100.0, Gr=0.0, P=8, N_ex=8, N_ey=8, u_N=1.0, mtol=1e-12,
              mtol_newton=5e-12, schur_precon=sp, iprint=[])
    sol, solver = {}, {}
    before = kernels.LAUNCHES["apply_coupled_system"]
    for dev in ("cuda", "cpu"):
        solver[dev] = ns = TNS(1.0, 1.0, device=dev, **kw)
        sol[dev] = [f.cpu() for f in ns._get_solution(np.zeros(ns.N))]
    assert kernels.LAUNCHES["apply_coupled_system"] > before
    assert solver["cuda"]._k == solver["cpu"]._k
    cpu = solver["cpu"]
    resid = cpu._residual_norm(*cpu._get_residuals(*sol["cuda"],
                                                   np.zeros(cpu.N)))
    assert resid <= 2 * 5e-12 * np.sqrt(3 * cpu.N)
    np.testing.assert_allclose(sol["cuda"][0].numpy(), sol["cpu"][0].numpy(),
                               atol=1e-4)
