"""MDA engine: nonlinear block-Gauss-Seidel / Newton-block-Jacobi /
block-Jacobi-preconditioned Newton-Krylov for the Boussinesq coupling.

Counterpart of ``sem_tpu.coupling.mda`` for the modes of the solve path:

* ``'GS'``  — nonlinear block Gauss-Seidel with post-sweep residual
  evaluation;
* ``'NJ'``  — Newton whose linear solve is ONE linear block-Jacobi sweep,
  safeguarded by an Armijo-Goldstein backtracking line search;
* ``'JNK'`` — Newton with the coupled linear system solved by host-
  orchestrated *flexible* GMRES (:func:`_fgmres`), preconditioned by one
  block-Jacobi sweep of the disciplines' own (loose, best-effort) solves.

Both Newton modes start with one Gauss-Seidel sweep (the reference's
``solve_subsystems=True, max_sub_solves=0``).  Tolerances follow the RMS
convention: absolute tolerance = mtol·√DOF with DOF = 3·N_ns + N_cd.

Not ported yet: ``'PTC'``, the fused and on-device FGMRES programs of the
reference (``device_krylov=True``), the ``'bgs'``/``'bgs2'`` preconditioners,
checkpoints and wall-clock budgets.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sem_tpu_torch.coupling.components import (ConvectionDiffusionComponent,
                                               NavierStokesComponent)
from sem_tpu_torch.parallel.distributed import assert_replicated
from sem_tpu_torch.parallel.sharding import active_group

__all__ = ["BoussinesqMDA", "MDAStats", "CoupledState"]


@dataclasses.dataclass
class MDAStats:
    """Iteration counters ``[cd_linear_solves, ns_linear_solves,
    nonlinear_iters]`` (the reference study's benchmark), plus the total
    coupled GMRES iterations."""

    cd_solves: int = 0
    ns_solves: int = 0
    nonlinear_iters: int = 0
    gmres_iters: int = 0

    def as_list(self):
        return [self.cd_solves, self.ns_solves, self.nonlinear_iters]


@dataclasses.dataclass
class CoupledState:
    T: torch.Tensor   # CD temperature   (N_cd,)
    u: torch.Tensor   # NS x-velocity    (N_ns,)
    v: torch.Tensor   # NS y-velocity    (N_ns,)
    p: torch.Tensor   # NS pressure      (N_ns,)

    def copy(self):
        return CoupledState(self.T, self.u, self.v, self.p)


def _forecast_doomed(hist, atol, remaining, slack=1.5):
    """Whether a Krylov solve is hopeless within its remaining budget: the
    iterations still needed at the most optimistic recent contraction rate
    (best of the trailing 20- and 40-iteration windows of ``hist``) exceed
    ``slack``× ``remaining``.  Pure host arithmetic."""
    res = hist[-1]
    if len(hist) < 60 or res <= 0:
        return False
    rho = max(min((res / hist[-21]) ** (1 / 20.0),
                  (res / hist[-41]) ** (1 / 40.0)), 1e-12)
    if rho >= 1.0:
        return True
    need = np.log(res / atol) / -np.log(rho)
    return need > slack * remaining


def _fgmres(matvec, precon, b, atol, restart, maxiter, callback=None,
            basis_dtype=torch.float32, forecast=False):
    """Host-orchestrated flexible GMRES with device-resident vectors.

    Control flow, the Hessenberg recurrence and the Givens rotations run on
    the host (float64); the bases ``V`` (Arnoldi) and ``Z`` (flexible) live on
    the device in buffers allocated once per window, in ``basis_dtype``
    (float32 by default: every window restarts from the TRUE f64 residual,
    so basis roundoff bounds only the per-window reduction, far below the
    inexact-Newton tolerances).  Orthogonalization is CGS2 over the live
    rows.  Per iteration the host reads back the new Hessenberg column.

    Exits: converged; the cross-restart stall (a window whose estimate moved
    < 2% and whose update left the true residual essentially unchanged);
    ``forecast`` (see :func:`_forecast_doomed`); the iteration budget.

    :return: ``(x, iterations, ok)``
    """
    lp = basis_dtype
    x = torch.zeros_like(b)
    it = 0
    normb = float(torch.linalg.vector_norm(b))
    if normb <= atol:
        return x, 0, True
    m = restart
    n = b.shape[0]
    V = torch.empty((m + 1, n), dtype=lp, device=b.device)
    Z = torch.empty((m, n), dtype=lp, device=b.device)
    beta_prev = None    # true residual at the previous restart
    stalled_in = False  # last window ended on the in-window plateau test
    hist = []           # estimated residual per iteration (forecast exit)
    doomed = False
    while it < maxiter:
        r = b - matvec(x)
        beta = float(torch.linalg.vector_norm(r))
        if not np.isfinite(beta):
            return x, it, False     # inner solve diverged/NaN — fail fast
        if beta <= atol:
            return x, it, True
        if stalled_in and beta_prev is not None and beta > 0.98 * beta_prev:
            return x, it, False
        beta_prev = beta
        stalled_in = False
        V[0] = r / beta
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.zeros(m)
        sn = np.zeros(m)
        resw = np.zeros(m)  # per-iteration residual estimates (plateau test)
        k_used = 0
        res = beta
        for k in range(m):
            z = precon(V[k].to(b.dtype))
            w = matvec(z)
            Z[k] = z
            # CGS2 against the live rows 0..k
            Vk = V[:k + 1]
            wl = w.to(lp)
            h1 = Vk @ wl
            wl = wl - Vk.T @ h1
            h2 = Vk @ wl
            wl = wl - Vk.T @ h2
            nw = torch.linalg.vector_norm(wl)
            hfull = torch.cat([h1 + h2, nw[None]]).tolist()
            V[k + 1] = wl / hfull[-1] if hfull[-1] > 0.0 else 0.0
            H[:k + 2, k] = hfull
            for j in range(k):
                t1 = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                t2 = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                H[j, k], H[j + 1, k] = t1, t2
            d = np.hypot(H[k, k], H[k + 1, k])
            cs[k], sn[k] = ((H[k, k] / d, H[k + 1, k] / d) if d > 0
                            else (1, 0))
            H[k, k] = d
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            res = abs(g[k + 1])
            it += 1
            k_used = k + 1
            if callback is not None:
                callback(it, res)
            hist.append(res)
            if res <= atol or it >= maxiter:
                break
            # in-window plateau (< 2% estimated progress over 40 iterations)
            if k + 1 >= 40 and res > 0.98 * resw[k - 39]:
                stalled_in = True
                break
            resw[k] = res
            if forecast and _forecast_doomed(hist, atol, maxiter - it):
                doomed = True
                break
        if res > atol and res > 0.98 * beta:
            stalled_in = True
        # Arnoldi breakdown guard: solve only the leading nonsingular block
        diag = np.abs(np.diag(H[:k_used, :k_used]))
        tol_d = max(1e-14 * diag.max(initial=0.0), 1e-300)
        bad = np.nonzero(diag <= tol_d)[0]
        if bad.size:
            k_used = int(bad[0])
            if k_used == 0:
                return x, it, False
        y = np.linalg.solve(np.triu(H[:k_used, :k_used]), g[:k_used])
        x = x + (Z[:k_used].T @ torch.as_tensor(y, dtype=lp,
                                                device=b.device)).to(x.dtype)
        if abs(g[k_used]) <= atol:
            return x, it, True
        if doomed:
            return x, it, False
    return x, it, False


class BoussinesqMDA:
    """Coupled CD↔NS (Boussinesq) multidisciplinary solver.

    :param cd_comp / ns_comp: the two discipline components
    :param mode: 'GS' | 'NJ' | 'JNK'
    :param mtol_nonlin: RMS tolerance of the coupled nonlinear residual
    :param AGi/AGr/AGc: Armijo-Goldstein line-search max iterations /
        contraction factor / slope factor (NJ mode)
    :param mtol_gmres: RMS tolerance of the coupled Krylov solve (JNK)
    :param restart: coupled GMRES restart (JNK)
    :param maxiter: nonlinear iteration cap (default 100 for JNK, else 1000)
    :param gmres_maxiter: coupled GMRES iteration cap per Newton step
    :param mtol_precon: RMS tolerance of the block-Jacobi preconditioner
        solves inside JNK's flexible GMRES (None = solver internal)
    :param mtol_subsolve: RMS tolerance of the Newton modes' iteration-0
        Gauss-Seidel sweep (None = solver internal tolerances)
    :param iprint: True ⇒ per-iteration residual lines
    :param forcing: inexact-Newton forcing factor η of the coupled JNK GMRES
        (atol = max(mtol_gmres·√DOF, η·‖F‖)); None = fixed tolerance
    :param device_krylov: only ``None``/``False`` (the host-orchestrated
        FGMRES) is ported
    """

    def __init__(self, cd_comp: ConvectionDiffusionComponent,
                 ns_comp: NavierStokesComponent, mode: str = "JNK",
                 mtol_nonlin: float = 1e-9,
                 AGi: int = 8, AGr: float = 0.8, AGc: float = 0.2,
                 mtol_gmres: float = 1e-10, restart: int = 20,
                 maxiter: int = None, gmres_maxiter: int = 5000,
                 mtol_precon: float = 1e-4, mtol_subsolve: float = 1e-6,
                 iprint: bool = True, device_krylov: bool = None,
                 forcing: float = 1e-3):
        if mode == "PTC":
            raise NotImplementedError(
                "mode='PTC' is not ported to sem_tpu_torch yet")
        if mode not in ("GS", "NJ", "JNK"):
            raise ValueError("Unknown method")
        if device_krylov:
            raise NotImplementedError(
                "device_krylov=True (the fused on-device FGMRES) is not "
                "ported to sem_tpu_torch; the host FGMRES runs instead when "
                "it is None or False")
        self.cd_comp = cd_comp
        self.ns_comp = ns_comp
        self.mode = mode
        self.N_cd = cd_comp.cd.N
        self.N_ns = ns_comp.ns.N
        self.device = cd_comp.cd.device
        self.DOF = 3 * self.N_ns + self.N_cd
        self.atol_nonlin = mtol_nonlin * np.sqrt(self.DOF)
        self.atol_gmres = mtol_gmres * np.sqrt(self.DOF)
        self.AGi, self.AGr, self.AGc = AGi, AGr, AGc
        self.restart = restart
        self.gmres_maxiter = gmres_maxiter
        self.mtol_precon = mtol_precon
        self.mtol_subsolve = mtol_subsolve
        self.maxiter = maxiter if maxiter is not None else (
            100 if mode == "JNK" else 1000)
        self.forcing = None if forcing is None else float(forcing)
        self.iprint = iprint
        self.stats = MDAStats()

    # ------------------------- plumbing ------------------------- #
    def _pack(self, rT, ru, rv, rp):
        return torch.cat([rT, ru, rv, rp])

    def _unpack(self, x):
        Ncd, Nns = self.N_cd, self.N_ns
        return (x[:Ncd], x[Ncd:Ncd + Nns], x[Ncd + Nns:Ncd + 2 * Nns],
                x[Ncd + 2 * Nns:])

    def _residuals(self, s: CoupledState) -> torch.Tensor:
        rT = self.cd_comp.apply_nonlinear(s.T, s.u, s.v)
        ru, rv, rp = self.ns_comp.apply_nonlinear(s.u, s.v, s.p, s.T)
        return self._pack(rT, ru, rv, rp)

    def _linearize(self, s: CoupledState):
        self.cd_comp.linearize(s.T)
        self.ns_comp.linearize(s.u, s.v)

    def _apply_linear(self, dx: torch.Tensor) -> torch.Tensor:
        dT, du, dv, dp = self._unpack(dx)
        drT = self.cd_comp.apply_linear(dT, du, dv)
        dru, drv, drp = self.ns_comp.apply_linear(du, dv, dp, dT)
        return self._pack(drT, dru, drv, drp)

    def _block_jacobi(self, r: torch.Tensor, mtol=None,
                      best_effort=False) -> torch.Tensor:
        """One linear block-Jacobi sweep: each discipline inverts its own
        Jacobian block.  ``best_effort`` (preconditioner applications):
        block solves return their best iterate instead of escalating or
        raising."""
        rT, ru, rv, rp = self._unpack(r)
        dT = self.cd_comp.solve_linear(rT, mtol=mtol,
                                       best_effort=best_effort)
        du, dv, dp = self.ns_comp.solve_linear(ru, rv, rp, mtol=mtol,
                                               best_effort=best_effort)
        return self._pack(dT, du, dv, dp)

    def _gs_sweep(self, s: CoupledState, mtol=None) -> CoupledState:
        """One nonlinear Gauss-Seidel sweep: CD first, then NS."""
        T = self.cd_comp.solve_nonlinear(s.u, s.v, T0=s.T, mtol=mtol)
        u, v, p = self.ns_comp.solve_nonlinear(T, u0=s.u, v0=s.v, p0=s.p,
                                               mtol=mtol)
        return CoupledState(T, u, v, p)

    def _print(self, tag, k, norm):
        if self.iprint:
            print(f"Boussinesq {tag}: {k}\t{norm}")

    # --------------------------- modes --------------------------- #
    @torch.no_grad()
    def solve(self, s0: CoupledState = None) -> CoupledState:
        f64 = torch.float64
        zcd = torch.zeros(self.N_cd, dtype=f64, device=self.device)
        zns = torch.zeros(self.N_ns, dtype=f64, device=self.device)
        s = s0.copy() if s0 is not None else CoupledState(zcd, zns, zns, zns)
        self.stats = MDAStats()
        warm = s0 is not None
        if self.mode == "GS":
            s = self._solve_gs(s)
        else:
            s = self._solve_newton(s, krylov=self.mode == "JNK", warm=warm)
        self.stats.cd_solves = self.cd_comp.iter_count_solve
        self.stats.ns_solves = self.ns_comp.iter_count_solve
        group = active_group()
        if group is not None and group.world > 1:
            self._assert_ranks_agree(group, s)
        return s

    def _assert_ranks_agree(self, group, s: CoupledState):
        """Every rank of a decomposed solve must end with the same stats and
        the same fields: all-gather them (f64 checksums of each field) and
        raise on any difference."""
        values = {k: float(v) for k, v in
                  dataclasses.asdict(self.stats).items()}
        for name in ("T", "u", "v", "p"):
            f = getattr(s, name)
            values[f"sum({name})"] = f.sum()
            values[f"sum(|{name}|)"] = f.abs().sum()
        assert_replicated(group, values)

    def _solve_gs(self, s: CoupledState) -> CoupledState:
        for k in range(1, self.maxiter + 1):
            s = self._gs_sweep(s)
            norm = float(torch.linalg.vector_norm(self._residuals(s)))
            self._print("GS", k, norm)
            self.stats.nonlinear_iters = k
            if norm <= self.atol_nonlin:
                return s
        raise RuntimeError(
            f"Boussinesq GS: no convergence in {self.maxiter} iterations")

    def _solve_newton(self, s: CoupledState, krylov: bool,
                      warm: bool = False) -> CoupledState:
        # iteration-0 subsystem sweep, run loosely (mtol_subsolve); a warm
        # start already at least as good as its target skips it
        if warm:
            norm0 = float(torch.linalg.vector_norm(self._residuals(s)))
            if norm0 > self.mtol_subsolve * np.sqrt(self.DOF):
                s = self._gs_sweep(s, mtol=self.mtol_subsolve)
        else:
            s = self._gs_sweep(s, mtol=self.mtol_subsolve)
        F = self._residuals(s)
        norm = float(torch.linalg.vector_norm(F))
        for k in range(1, self.maxiter + 1):
            self._print("NEWTON", k - 1, norm)
            if norm <= self.atol_nonlin:
                self.stats.nonlinear_iters = k - 1
                return s
            self._linearize(s)
            if krylov:
                atol_k = self.atol_gmres
                if self.forcing is not None:
                    atol_k = max(atol_k, self.forcing * norm)
                dx, iters, ok = _fgmres(
                    self._apply_linear,
                    lambda r: self._block_jacobi(r, mtol=self.mtol_precon,
                                                 best_effort=True),
                    -F, atol=atol_k, restart=self.restart,
                    maxiter=self.gmres_maxiter,
                    callback=(lambda it, res: print(
                        f"   JNK GMRES: {it}\t{res}")) if self.iprint
                    else None)
                self.stats.gmres_iters += iters
                if not ok:
                    raise RuntimeError(
                        f"Boussinesq JNK GMRES: no convergence in {iters} "
                        f"iterations")
            else:
                dx = self._block_jacobi(-F)

            # Armijo-Goldstein backtracking (NJ only; JNK takes full steps)
            alpha = 1.0
            s_new, F_new, norm_new = self._try_step(s, dx, alpha)
            if not krylov:
                ls = 0
                while (norm_new > (1.0 - self.AGc * alpha) * norm
                       and ls < self.AGi):
                    alpha *= self.AGr
                    s_new, F_new, norm_new = self._try_step(s, dx, alpha)
                    ls += 1
            s, F, norm = s_new, F_new, norm_new
        raise RuntimeError(
            f"Boussinesq NEWTON: no convergence in {self.maxiter} iterations")

    def _try_step(self, s, dx, alpha):
        dT, du, dv, dp = self._unpack(alpha * dx)
        s_new = CoupledState(s.T + dT, s.u + du, s.v + dv, s.p + dp)
        F_new = self._residuals(s_new)
        return s_new, F_new, float(torch.linalg.vector_norm(F_new))
