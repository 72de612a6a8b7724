"""Port parity, the implicit adjoints: ``sem_tpu_torch.coupling.implicit``
against ``sem_tpu.coupling.implicit`` (JAX on the CPU; its outer ``_fgmres``
un-fused, as ``implicit.py`` calls it) at the configuration of
tests/test_implicit.py, and the port's gradients against central finite
differences of its own re-solves.  The same NumPy state and parameters go to
both packages; the port runs with ``device="cpu"``.  Tolerances are stated
per test."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sem_tpu.coupling import build_coupled as jax_build_coupled
from sem_tpu.coupling import implicit as jimp
from sem_tpu_torch import NavierStokesSolver
from sem_tpu_torch.coupling import build_coupled
from sem_tpu_torch.coupling import implicit as timp
from sem_tpu_torch.coupling.mda import CoupledState
from sem_tpu_torch.ops import kernels

from tests.torch_parity import (_jax_probes, one_torch_thread,  # noqa: F401
                                rel_err, t64)

PARAMS = dict(Re=200.0, Ra=500.0, Pr=0.71)
KW = dict(P_cd=2, N_ex_cd=2, N_ey_cd=2, P_ns=2, N_ex_ns=3, N_ey_ns=3,
          mode="GS", mtol_nonlin=1e-11, mtol_internal=1e-13, iprint=False)


def _flat(s):
    return np.concatenate([np.asarray(f) for f in (s.T, s.u, s.v, s.p)])


def _port_solve(params, **kw):
    cd, ns, mda = build_coupled(1.0, 1.0, device="cpu",
                                **dict(KW, **kw), **params)
    s = mda.solve()
    return cd, ns, torch.cat([s.T, s.u, s.v, s.p])


@pytest.fixture(scope="module")
def both():
    """Both packages' solvers at PARAMS/KW and sem_tpu's converged state."""
    jcd, jns, jmda = jax_build_coupled(1.0, 1.0, device_krylov=False,
                                       **PARAMS, **KW)
    x = _flat(jmda.solve())
    cd, ns, _ = build_coupled(1.0, 1.0, device="cpu", **PARAMS, **KW)
    return dict(jcd=jcd, jns=jns, cd=cd, ns=ns, x=x)


def _pj(params):
    return {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}


def _pt(params):
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in
            params.items()}


def _kinetic(N_cd, N_ns, lib):
    """The reference's loss ``sum(u² + v²)`` over the NS nodes."""
    def loss(xf):
        u = xf[N_cd:N_cd + N_ns]
        v = xf[N_cd + N_ns:N_cd + 2 * N_ns]
        return lib.sum(u ** 2 + v ** 2)
    return loss


# ------------------------------- residual -------------------------------- #
@pytest.mark.parametrize("extra", [{}, dict(T_W=0.7, T_E=-0.2)])
def test_residual_matches_reference(both, extra):
    """F at a perturbed state equals sem_tpu's F (rel 1e-12), with the
    default and with explicit wall temperatures."""
    params = dict(PARAMS, **extra)
    y = both["x"] + 1e-2 * np.random.default_rng(0).standard_normal(
        both["x"].size)
    ref = jimp.coupled_residual_fn(both["jcd"], both["jns"])(
        jnp.asarray(y), _pj(params))
    got = timp.coupled_residual_fn(both["cd"], both["ns"])(t64(y),
                                                            _pt(params))
    assert got.dtype == torch.float64
    assert rel_err(got, ref) <= 1e-12


def test_residual_vanishes_at_port_solution(both):
    """F vanishes at the port's own converged state (RMS < 1e-10, as
    tests/test_implicit.py:31 holds sem_tpu's), and that state equals
    sem_tpu's within 1e-10."""
    cd, ns, x = _port_solve(PARAMS)
    r = timp.coupled_residual_fn(cd, ns)(x, _pt(PARAMS))
    assert float(torch.linalg.vector_norm(r)) / np.sqrt(r.numel()) < 1e-10
    assert float(np.abs(x.numpy() - both["x"]).max()) <= 1e-10


# ------------------------------ transposes ------------------------------- #
def _transposes(b, which, w_seed=1):
    """(port, reference) of one transposed product at the converged state,
    applied to the same random cotangent."""
    jcd, jns, cd, ns, x = (b[k] for k in ("jcd", "jns", "cd", "ns", "x"))
    N_cd, N_ns = cd.N, ns.N
    jF = jimp.coupled_residual_fn(jcd, jns)
    tF = timp.coupled_residual_fn(cd, ns)
    pj, pt = _pj(PARAMS), _pt(PARAMS)
    xj, xt = jnp.asarray(x), t64(x)
    rng = np.random.default_rng(w_seed)
    ul, vl = x[N_cd:N_cd + N_ns], x[N_cd + N_ns:N_cd + 2 * N_ns]
    if which == "J_x":
        w = rng.standard_normal(x.size)
        ref = jax.vjp(lambda q: jF(q, pj), xj)[1](jnp.asarray(w))[0]
        got = timp._vjp(lambda q: tF(q, pt), xt)(t64(w))
    elif which == "dF_dtheta":
        w = rng.standard_normal(x.size)
        dj = jax.vjp(lambda th: jF(xj, th), pj)[1](jnp.asarray(w))[0]
        ref = np.array([float(dj[k]) for k in sorted(PARAMS)])
        got = timp.parameter_gradients(cd, ns, xt, PARAMS, t64(w))
        got = -np.array([got[k] for k in sorted(PARAMS)])
    elif which == "C":
        w = rng.standard_normal(3 * N_ns)
        ref = jax.vjp(lambda T: jF(jnp.concatenate([T, xj[N_cd:]]), pj)[
            N_cd:], xj[:N_cd])[1](jnp.asarray(w))[0]
        got = timp._vjp(lambda T: tF(torch.cat([T, xt[N_cd:]]), pt)[N_cd:],
                        xt[:N_cd])(t64(w))
    else:   # the NS block preconditioner
        w = rng.standard_normal(3 * N_ns)
        ref = jax.vjp(lambda q: jns._pc64_fn(
            q, jnp.asarray(ul), jnp.asarray(vl), jnp.asarray(0.0)),
            jnp.zeros(3 * N_ns))[1](jnp.asarray(w))[0]
        got = timp._vjp(lambda q: ns._pc64_fn(q, t64(ul), t64(vl), 0.0),
                        torch.zeros(3 * N_ns, dtype=torch.float64))(t64(w))
    return got, ref


@pytest.mark.parametrize("which", ["J_x", "dF_dtheta", "C", "pc64"])
def test_transposed_products_match_jax_vjp(both, which):
    """J_xᵀ w, (∂F/∂θ)ᵀ w, Cᵀ w (C = ∂F_ns/∂T) and the transposed NS block
    preconditioner equal jax.vjp of sem_tpu's same functions (rel 1e-10)."""
    got, ref = _transposes(both, which)
    assert rel_err(got, ref) <= 1e-10


@pytest.mark.parametrize("inner_rtol", [None, 1e-4])
def test_block_precon_transposed_matches_reference(both, inner_rtol):
    """One application of the transposed block-Gauss-Seidel preconditioner,
    with the block approximations alone and with inner block solves to
    1e-4, equals sem_tpu's (rel 1e-10)."""
    x = both["x"]
    r = np.random.default_rng(2).standard_normal(x.size)
    ref = jimp._block_precon_transposed(both["jcd"], both["jns"], x, PARAMS,
                                        inner_rtol=inner_rtol)(
                                            jnp.asarray(r))
    got = timp._block_precon_transposed(both["cd"], both["ns"], x, PARAMS,
                                        inner_rtol=inner_rtol)(t64(r))
    assert rel_err(got, ref) <= 1e-10


@pytest.mark.parametrize("schur", ["spectral", "mass", "pcd"])
@pytest.mark.parametrize("sigma", [0.0, 3.0])
def test_pc64_transpose_dot_product(schur, sigma):
    """⟨pc(a), b⟩ = ⟨a, pcᵀ(b)⟩ (rel 1e-12) for the vector-Jacobian product
    of ``_pc64_fn`` under each Schur block: its in-place writes (the
    spectral block's boundary ring and pin row, the FDM's interior block)
    land in tensors autograd did not save."""
    ns = NavierStokesSolver(1.0, 1.0, Re=200.0, Gr=500 / 0.71, P=2, N_ex=3,
                            N_ey=3, iprint=[], schur_precon=schur,
                            device="cpu")
    rng = np.random.default_rng(5)
    ul, vl = (t64(rng.standard_normal(ns.N)) for _ in range(2))
    a, b = (t64(rng.standard_normal(3 * ns.N)) for _ in range(2))
    pcT = timp._vjp(lambda q: ns._pc64_fn(q, ul, vl, sigma),
                    torch.zeros(3 * ns.N, dtype=torch.float64))
    lhs = float(ns._pc64_fn(a, ul, vl, sigma) @ b)
    rhs = float(a @ pcT(b))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    assert torch.equal(pcT(b), pcT(b))      # the saved graph is reusable


# ----------------------------- adjoint solve ----------------------------- #
def test_solve_adjoint_matches_reference_on_its_probes(both):
    """Fed the probes JAX draws, solve_adjoint takes sem_tpu's outer
    iterations ±2, returns its λ within 1e-6 relative, and λ satisfies the
    raw transposed system to 1e-6·‖g‖ by an independent vector-Jacobian
    product (tests/test_implicit.py:55); no kernel is launched."""
    cd, ns, x = both["cd"], both["ns"], both["x"]
    g = np.random.default_rng(3).standard_normal(x.size)
    lam_j, its_j = jimp.solve_adjoint(both["jcd"], both["jns"], x, g, PARAMS,
                                      atol=1e-10)
    before = dict(kernels.LAUNCHES)
    lam, its = timp.solve_adjoint(cd, ns, x, g, PARAMS, atol=1e-10,
                                  probes=t64(_jax_probes(x.size,
                                                         jnp.float64)))
    assert kernels.LAUNCHES == before
    assert abs(its - its_j) <= 2, (its, its_j)
    assert rel_err(lam, lam_j) <= 1e-6
    F = timp.coupled_residual_fn(cd, ns)
    r = timp._vjp(lambda q: F(q, _pt(PARAMS)), t64(x))(lam).numpy() - g
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(g)
    assert not lam.requires_grad


def test_solve_adjoint_raises_or_returns_best_effort(both, capsys):
    """A budget of 2 outer iterations: ``raise_on_fail`` raises the
    reference's RuntimeError; without it the iterate comes back with the
    reference's best-effort line."""
    x = both["x"]
    g = np.random.default_rng(3).standard_normal(x.size)
    with pytest.raises(RuntimeError, match="adjoint FGMRES: no convergence"):
        timp.solve_adjoint(both["cd"], both["ns"], x, g, PARAMS, maxiter=2)
    _, its = timp.solve_adjoint(both["cd"], both["ns"], x, g, PARAMS,
                                maxiter=2, raise_on_fail=False, iprint=True)
    out = capsys.readouterr().out
    assert its == 2
    assert "adjoint FGMRES: best-effort exit after 2 iterations" in out
    assert out.count("   adjoint FGMRES: ") == 2


def test_gradients_match_reference(both):
    """gradients(): the loss equal and d/dRe, d/dRa, d/dPr within 1e-6
    relative of sem_tpu's (the port fed JAX's probes)."""
    cd, ns, x = both["cd"], both["ns"], both["x"]
    loss_j, ref = jimp.gradients(both["jcd"], both["jns"], x,
                                 _kinetic(cd.N, ns.N, jnp), PARAMS,
                                 atol=1e-12)
    loss, got = timp.gradients(cd, ns, x, _kinetic(cd.N, ns.N, torch),
                               PARAMS, atol=1e-12,
                               probes=t64(_jax_probes(x.size, jnp.float64)))
    assert isinstance(loss, float) and set(got) == set(ref)
    assert loss == pytest.approx(float(loss_j), rel=1e-12)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k


@pytest.fixture(scope="module")
def port_gradients():
    cd, ns, x = _port_solve(PARAMS)
    loss = _kinetic(cd.N, ns.N, torch)
    return loss, timp.gradients(cd, ns, x, loss, PARAMS, atol=1e-12)[1]


@pytest.mark.parametrize("pname", ["Ra", "Re", "Pr"])
def test_gradients_match_finite_differences(port_gradients, pname):
    """The port's adjoint gradient at its own converged state against
    central differences of two re-solves at relative step 1e-5 (rel 2e-4,
    tests/test_implicit.py:81)."""
    loss, grads = port_gradients
    h = PARAMS[pname] * 1e-5
    vals = []
    for sgn in (+1, -1):
        pp = dict(PARAMS)
        pp[pname] += sgn * h
        vals.append(float(loss(_port_solve(pp)[2])))
    fd = (vals[0] - vals[1]) / (2 * h)
    assert grads[pname] == pytest.approx(fd, rel=2e-4), (grads[pname], fd)


def test_inner_basis_dtype_gate(both, monkeypatch):
    """SEM_TPU_ADJ_INNER_F32_MIN_DOF: above it the inner block solves keep
    an f32 basis (and their window is capped at the f32 footprint), below
    it the working f64; an explicit dtype wins.  solve_adjoint hands the
    gate's choice to the inner GMRES."""
    cd, ns, x = both["cd"], both["ns"], both["x"]
    n = x.size
    n_in = 3 * ns.N
    monkeypatch.delenv("SEM_TPU_ADJ_INNER_F32_MIN_DOF", raising=False)
    assert timp.adjoint_windows(cd, ns, n) == (60, 60, None)
    monkeypatch.setenv("SEM_TPU_ADJ_INNER_F32_MIN_DOF", str(n_in - 1))
    assert timp.adjoint_windows(cd, ns, n) == (60, 60, torch.float32)
    # the caps (n = 172, n_in = 147): an 8-byte outer basis of 41.5
    # vectors of n (window 40), a 4-byte inner one of 97.1 vectors of n_in
    # (60 kept); an eighth of that budget: 5.2 (floor 8) and 12.1 (11)
    gb = 41.5 * 8 * n / 1e9
    assert (n, n_in) == (172, 147)
    assert timp.adjoint_windows(cd, ns, n, max_basis_gb=gb) == (
        40, 60, torch.float32)
    assert timp.adjoint_windows(cd, ns, n, max_basis_gb=gb / 8)[:2] == (8, 11)
    assert timp.adjoint_windows(cd, ns, n, inner_basis_dtype=torch.float64
                                )[2] == torch.float64

    seen = []
    gmres = timp.gmres

    def spy(*a, **k):
        seen.append(k["basis_dtype"])
        return gmres(*a, **k)

    monkeypatch.setattr(timp, "gmres", spy)
    g = np.random.default_rng(3).standard_normal(n)
    timp.solve_adjoint(cd, ns, x, g, PARAMS, maxiter=3, raise_on_fail=False)
    assert seen and set(seen) == {torch.float32}
    monkeypatch.setenv("SEM_TPU_ADJ_INNER_F32_MIN_DOF", "1e6")
    seen.clear()
    timp.solve_adjoint(cd, ns, x, g, PARAMS, maxiter=3, raise_on_fail=False)
    assert seen and set(seen) == {None}


@pytest.mark.slow
def test_adjoint_gradient_at_ptc_converged_ra1e5():
    """tests/test_implicit.py:84-126 on the port: d/dRa at its own
    PTC-converged Ra=1e5 state (P4 16×16 NS, P4 8×8 CD) against central
    differences of two warm-started JNK re-solves at relative step 1e-4
    (rel 1e-3)."""
    par = dict(Re=1e3, Ra=1e5, Pr=0.71)
    kw5 = dict(P_cd=4, N_ex_cd=8, N_ey_cd=8, P_ns=4, N_ex_ns=16,
               N_ey_ns=16, mtol_nonlin=1e-10, mtol_internal=1e-13,
               iprint=False, device="cpu")
    cd, ns, mda = build_coupled(1.0, 1.0, mode="PTC", **par, **kw5)
    s = mda.solve()
    x = torch.cat([s.T, s.u, s.v, s.p])
    loss = _kinetic(cd.N, ns.N, torch)
    _, grads = timp.gradients(cd, ns, x, loss, par, atol=1e-11,
                              inner_rtol=1e-4)
    h = par["Ra"] * 1e-4
    vals = []
    for sgn in (+1, -1):
        _, _, m = build_coupled(1.0, 1.0, mode="JNK",
                                **dict(par, Ra=par["Ra"] + sgn * h), **kw5)
        sp = m.solve(CoupledState(s.T, s.u, s.v, s.p))
        vals.append(float(loss(torch.cat([sp.T, sp.u, sp.v, sp.p]))))
    fd = (vals[0] - vals[1]) / (2 * h)
    assert grads["Ra"] == pytest.approx(fd, rel=1e-3), (grads["Ra"], fd)
