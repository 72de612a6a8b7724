"""Implicit-differentiation adjoints of the coupled Boussinesq solve.

Counterpart of ``sem_tpu.coupling.implicit``: gradients of any functional of
the converged coupled state with respect to the physics parameters (Re, Ra,
Pr, wall temperatures), by the implicit-function theorem::

    F(x*, θ) = 0   ⇒   dJ/dθ = ∂J/∂θ − λᵀ ∂F/∂θ,   J_xᵀ λ = (∂J/∂x)ᵀ

The coupled residual ``F`` is written here as a pure function of (state,
params) on torch tensors, with no in-place write on a differentiated value,
so the transposed products ``J_xᵀ v`` and ``∂F/∂θᵀ λ`` come from autograd
exactly.  The adjoint system is solved by flexible GMRES preconditioned by
the transposed block Gauss-Seidel of the forward solvers' preconditioner (NS
block first, then the transposed buoyancy coupling into the CD right-hand
side; the NS block is the exact transpose of the forward f64 coupled
preconditioner ``ns._pc64_fn``), strengthened by default by solving the true
transposed diagonal blocks to ``inner_rtol`` per application.

The solvers' forward paths run under ``torch.no_grad()``; only the functions
of this module record autograd graphs, and only of ``F`` and of the
preconditioner's linear apply.  Every operator here is the dense f64 path:
the CUDA kernels B1-B4 have no autograd rule and are not launched.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from sem_tpu_torch import operators as ops
from sem_tpu_torch.coupling.mda import _fgmres
from sem_tpu_torch.interp import apply_transfer
from sem_tpu_torch.krylov import gmres, rownorm_estimate

__all__ = ["coupled_residual_fn", "solve_adjoint", "gradients",
           "adjoint_windows", "parameter_gradients"]

_F64 = torch.float64


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F64, device=device).detach()


def _params(params: dict, device) -> dict:
    return {k: _f64(v, device) for k, v in params.items()}


def _vjp(fn, x):
    """``w ↦ (∂fn/∂x)ᵀ w`` at ``x``: ``fn`` runs once with autograd
    recording, and each call of the returned function walks the saved graph
    backwards (no graph is recorded by the call itself)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y = fn(x)

    def vjp(w):
        return torch.autograd.grad(y, x, w, retain_graph=True)[0]

    return vjp


def _residual_blocks(cd, ns):
    """The two discipline blocks of the coupled residual as pure functions
    ``f_cd(T, u, v, params)`` and ``f_ns(T, u, v, p, params) -> (ru, rv,
    rc)`` (the other discipline's fields enter through the cross-mesh
    transfer)."""
    dev = cd.device
    mask_cd, mb = cd._mask, ns._mb
    pin = torch.zeros(ns.N, dtype=torch.bool, device=dev)
    pin[ns._pin] = True
    dir_u, dir_v = ns._dir_u, ns._dir_v
    mask_W = torch.as_tensor(cd.grid.side_mask("W"), device=dev)
    mask_E = torch.as_tensor(cd.grid.side_mask("E"), device=dev)

    def f_cd(T, u, v, params):
        Pe = params["Re"] * params["Pr"]
        T_W = torch.as_tensor(params.get("T_W", 0.5), dtype=T.dtype,
                              device=dev)
        T_E = torch.as_tensor(params.get("T_E", -0.5), dtype=T.dtype,
                              device=dev)
        u_cd = apply_transfer(ns.grid, cd.grid, u)
        v_cd = apply_transfer(ns.grid, cd.grid, v)
        rT = Pe * ops.apply_convection(cd.grid, u_cd, v_cd, T) \
            + ops.apply_stiffness(cd.grid, T)
        dirichlet = torch.where(mask_W, T_W, 0.0) \
            + torch.where(mask_E, T_E, 0.0)
        return torch.where(mask_cd, T - dirichlet, rT)

    def f_ns(T, u, v, p, params):
        Re = params["Re"]
        GrRe = params["Ra"] / params["Pr"] / Re
        grid = ns.grid
        T_ns = apply_transfer(cd.grid, grid, T)

        def conv(w):
            return ops.apply_stiffness(grid, w) \
                + Re * ops.apply_convection(grid, u, v, w)

        ru = conv(u) + ops.apply_grad_x(grid, p)
        rv = conv(v) + ops.apply_grad_y(grid, p) \
            - GrRe * ops.apply_mass(grid, T_ns)
        rc = ops.apply_grad_x(grid, u) + ops.apply_grad_y(grid, v)
        ru = torch.where(mb, u - dir_u, ru)
        rv = torch.where(mb, v - dir_v, rv)
        rc = torch.where(mb, ops.apply_stiffness(grid, p), rc)
        rc = torch.where(pin, p, rc)
        return ru, rv, rc

    return f_cd, f_ns


def coupled_residual_fn(cd, ns):
    """Pure coupled residual ``F(x_flat, params) -> r_flat``.

    ``params`` is a dict with (any of) ``Re``, ``Ra``, ``Pr``, ``T_W``,
    ``T_E`` as 0-dim float64 tensors (``Re``, ``Ra`` and ``Pr`` required;
    the wall temperatures default to ±0.5).  Matches exactly the residual
    the MDA drives to zero (same operators, masks, pressure pin, cross-mesh
    transfers), written without in-place writes so that autograd
    differentiates it in ``x`` and in ``params``.
    """
    N_cd, N_ns = cd.N, ns.N
    f_cd, f_ns = _residual_blocks(cd, ns)

    def F(x, params):
        T, u, v, p = (x[:N_cd], x[N_cd:N_cd + N_ns],
                      x[N_cd + N_ns:N_cd + 2 * N_ns], x[N_cd + 2 * N_ns:])
        return torch.cat([f_cd(T, u, v, params), *f_ns(T, u, v, p, params)])

    return F


def _block_precon_transposed(cd, ns, x_star, params,
                             inner_rtol: float = None,
                             inner_restart: int = 60,
                             inner_maxiter: int = 600,
                             inner_basis_dtype=None):
    """Transposed block-Gauss-Seidel preconditioner of ``J_xᵀ``.

    The forward block Gauss-Seidel is lower block-triangular
    ``M = [[A_cd, 0], [C, A_ns]]`` (solve T, forward the coupling
    ``C = ∂F_ns/∂T`` into the NS right-hand side); the adjoint uses exactly
    ``Mᵀ``: solve the NS block first, then feed the transposed coupling into
    the CD right-hand side::

        z_ns = Â_nsᵀ⁻¹ r_ns
        z_T  = Â_cdᵀ⁻¹ (r_T − Cᵀ z_ns)

    with ``Cᵀ`` exact from autograd (buoyancy through the cross-mesh
    transfer, affine in T).  Block approximations:

    * CD block: the FDM inverse (self-adjoint);
    * NS block: the exact transpose of the forward solver's coupled block
      preconditioner (``ns._pc64_fn``, linear in its input) by a
      vector-Jacobian product;
    * ``inner_rtol = t > 0``: each application solves the true transposed
      diagonal blocks (convection included, from vector-Jacobian products of
      the block-restricted residuals at ``x_star``) to relative tolerance
      ``t`` by inner GMRES right-preconditioned by the approximations above,
      with at most ``inner_restart``/``inner_maxiter`` iterations and an
      ``inner_basis_dtype`` Krylov basis.  The applications then vary; the
      outer FGMRES absorbs that.

    Returns ``precon(r)`` on flat coupled vectors.
    """
    N_cd, N_ns = cd.N, ns.N
    dev = cd.device
    x_star = _f64(x_star, dev)
    pj = _params(params, dev)
    f_cd, f_ns = _residual_blocks(cd, ns)
    T_s = x_star[:N_cd]
    u_s, v_s, p_s = (x_star[N_cd + k * N_ns:N_cd + (k + 1) * N_ns]
                     for k in range(3))

    pcT = _vjp(lambda q: ns._pc64_fn(q, u_s, v_s, 0.0),
               torch.zeros(3 * N_ns, dtype=_F64, device=dev))
    CT = _vjp(lambda T: torch.cat(f_ns(T, u_s, v_s, p_s, pj)), T_s)

    if inner_rtol:
        ns_T = _vjp(lambda q: torch.cat(f_ns(
            T_s, q[:N_ns], q[N_ns:2 * N_ns], q[2 * N_ns:], pj)),
            x_star[N_cd:])
        cd_T = _vjp(lambda T: f_cd(T, u_s, v_s, pj), T_s)
        rt = float(inner_rtol)

        def block_solve(matvec, pc):
            def apply(r):
                q, _ = gmres(matvec, r,
                             atol=rt * float(torch.linalg.vector_norm(r)),
                             restart=inner_restart, maxiter=inner_maxiter,
                             precon=pc, basis_dtype=inner_basis_dtype)
                return q
            return apply

        ns_apply = block_solve(ns_T, pcT)
        cd_apply = block_solve(cd_T, cd._fdm)
    else:
        ns_apply, cd_apply = pcT, cd._fdm

    def precon(r):
        z_ns = ns_apply(r[N_cd:])
        z_T = cd_apply(r[:N_cd] - CT(z_ns))
        return torch.cat([z_T, z_ns])

    return precon


def adjoint_windows(cd, ns, n: int, restart: int = 60,
                    inner_restart: int = 60, max_basis_gb: float = 0.5,
                    inner_basis_dtype=None):
    """The outer and inner Krylov windows and the inner-basis dtype that
    :func:`solve_adjoint` uses for ``n`` coupled unknowns:
    ``(restart, inner_restart, inner_basis_dtype)``.

    Each basis is capped at ``max_basis_gb`` (the outer one at its f64
    footprint over ``n``, the inner ones at theirs over the larger block,
    ``max(3·N_ns, N_cd)``); small problems keep the full windows.  With
    ``inner_basis_dtype=None`` the inner blocks store their basis in float32
    above ``SEM_TPU_ADJ_INNER_F32_MIN_DOF`` block unknowns (default 1e6, as
    in ``sem_tpu``), else in the working float64.
    """
    cap = max(8, int(max_basis_gb * 1e9 / (8 * max(n, 1))) - 1)
    n_in = max(3 * ns.N, cd.N)
    if inner_basis_dtype is None:
        thresh = float(os.environ.get("SEM_TPU_ADJ_INNER_F32_MIN_DOF", "1e6")
                       or "1e6")
        inner_basis_dtype = torch.float32 if n_in > thresh else None
    bytes_in = 4 if inner_basis_dtype == torch.float32 else 8
    cap_in = max(8, int(max_basis_gb * 1e9 / (bytes_in * max(n_in, 1))) - 1)
    return min(restart, cap), min(inner_restart, cap_in), inner_basis_dtype


@torch.no_grad()
def solve_adjoint(cd, ns, x_star, gbar, params, atol=1e-10,
                  restart=60, maxiter=20000, inner_rtol: float = 1e-4,
                  inner_restart: int = 60, inner_maxiter: int = 600,
                  raise_on_fail: bool = True, max_basis_gb: float = 0.5,
                  iprint: bool = False, inner_basis_dtype=None,
                  probes=None):
    """Solve the adjoint system ``J_xᵀ λ = gbar`` at the converged state.

    The outer FGMRES (:func:`sem_tpu_torch.coupling.mda._fgmres`, float64
    basis) runs on the row-scaled transposed system ``E⁻¹ Jᵀ λ = E⁻¹ g``
    with ``E`` a stochastic row-norm estimate of ``Jᵀ`` (8 Rademacher probes
    from a CPU generator seeded 0), and its convergence test applies in that
    scaled norm: raw SEM rows mix stiffness- and unit-Dirichlet scales
    spanning ~1e7.  ``atol`` is the RMS tolerance on the scaled residual.

    :param inner_rtol: strength of the transposed block-Gauss-Seidel
        preconditioner: t > 0 (default 1e-4, the strength of the forward
        block solves) solves the true transposed diagonal blocks to relative
        tolerance t per application; None applies each block's
        approximation once
    :param restart, inner_restart, max_basis_gb, inner_basis_dtype: see
        :func:`adjoint_windows`
    :param raise_on_fail: raise ``RuntimeError`` when the outer FGMRES does
        not converge; else print a best-effort line and return its iterate
    :param iprint: print the outer residual and wall per iteration
    :param probes: optional ``(k, n)`` tensor of ±1 probes for the row-norm
        estimate, used as they are (e.g. the ones ``sem_tpu`` draws)
    :return: ``(λ, outer iterations)``
    """
    dev = cd.device
    F = coupled_residual_fn(cd, ns)
    x_star = _f64(x_star, dev)
    gbar = _f64(gbar, dev)
    params = _params(params, dev)
    n = x_star.shape[0]
    restart, inner_restart, inner_basis_dtype = adjoint_windows(
        cd, ns, n, restart, inner_restart, max_basis_gb, inner_basis_dtype)
    mv = _vjp(lambda x: F(x, params), x_star)

    gen = torch.Generator(device="cpu").manual_seed(0)
    e = rownorm_estimate(mv, n, _F64, gen,
                         probes=8 if probes is None else probes, device=dev)
    einv = 1.0 / e
    precon = _block_precon_transposed(cd, ns, x_star, params,
                                      inner_rtol=inner_rtol,
                                      inner_restart=inner_restart,
                                      inner_maxiter=inner_maxiter,
                                      inner_basis_dtype=inner_basis_dtype)

    cb = None
    if iprint:
        t_ip = [time.perf_counter()]

        def cb(it, res):
            now = time.perf_counter()
            print(f"   adjoint FGMRES: {it}\t{res:.6e}\t"
                  f"({now - t_ip[0]:.1f}s/it)", flush=True)
            t_ip[0] = now
    lam, iters, ok = _fgmres(
        lambda z: mv(z) * einv,
        lambda r: precon(r * e),
        gbar * einv, atol=atol * np.sqrt(n),
        restart=restart, maxiter=maxiter, callback=cb,
        # full-precision outer basis: the adjoint is held to 1e-6 raw-
        # relative in one solve, below the f32 refinement floor
        basis_dtype=_F64)
    if not ok:
        if raise_on_fail:
            raise RuntimeError(f"adjoint FGMRES: no convergence in {iters} "
                               f"iterations")
        print(f"adjoint FGMRES: best-effort exit after {iters} iterations "
              f"(gradient accuracy degraded)", flush=True)
    return lam, iters


@torch.no_grad()
def parameter_gradients(cd, ns, x_star, params, lam) -> dict:
    """``−λᵀ ∂F/∂θ`` for every parameter θ of ``params`` (one reverse pass
    of the coupled residual), as host floats."""
    dev = cd.device
    F = coupled_residual_fn(cd, ns)
    pj = {k: v.requires_grad_(True) for k, v in _params(params, dev).items()}
    with torch.enable_grad():
        r = F(_f64(x_star, dev), pj)
    dtheta = torch.autograd.grad(r, list(pj.values()), _f64(lam, dev))
    return {k: -float(g) for k, g in zip(pj, dtheta)}


@torch.no_grad()
def gradients(cd, ns, x_star, loss_fn, params, atol=1e-10,
              inner_rtol: float = 1e-4, **adjoint_kw):
    """Gradient of ``loss_fn(x)`` at the converged coupled state with
    respect to the physics parameters, by the implicit-function theorem.

    :param x_star: converged flat coupled state ``[T, u, v, p]`` (from
        ``BoussinesqMDA``)
    :param loss_fn: scalar torch function of the flat state (differentiated
        by autograd)
    :param params: dict of parameter values (``Re``, ``Ra``, ``Pr``, ...)
    :param inner_rtol: adjoint-preconditioner strength (see
        :func:`solve_adjoint`)
    :param adjoint_kw: forwarded to :func:`solve_adjoint` (restart,
        maxiter, inner_restart, inner_maxiter, raise_on_fail, max_basis_gb,
        probes, ...)
    :return: ``(loss value, {name: d loss / d param})`` as host floats
    """
    x = _f64(x_star, cd.device).requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(x)
    gbar = torch.autograd.grad(loss, x)[0]
    lam, _ = solve_adjoint(cd, ns, x.detach(), gbar, params, atol=atol,
                           inner_rtol=inner_rtol, **adjoint_kw)
    grads = parameter_gradients(cd, ns, x.detach(), params, lam)
    return float(loss.detach()), grads
