"""Steady convection-diffusion solver on torch tensors.

Solves, for T(x,y) on [0,L_x]×[0,L_y] given velocities u, v::

    Pe [u, v]∘∇T = ∇²T

with per-side Dirichlet (value) or homogeneous Neumann (``None``) boundary
conditions.  Counterpart of ``sem_tpu.models.convection_diffusion``: the same
seven-method discipline protocol (``_get_residuals``, ``_calc_jacobians``,
``_get_dresiduals``, ``_get_update``, ``_get_solution``, ``_get_vector``,
``_get_interpol``) plus ``run``.  The linear solve is FDM-preconditioned
GMRES: by default float32 chunks whose matvec is kernel B1
(:func:`sem_tpu_torch.ops.apply_system_best`) inside float64 iterative
refinement; ``mixed_precision=False`` runs one float64 GMRES.  Under an
active group (:func:`sem_tpu_torch.parallel.use_group`) of more than one
rank, each f32 chunk is decomposed into row strips, whose matvec is kernel B3
(:func:`sem_tpu_torch.ops.apply_system_sharded`); everything else stays
replicated.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from sem_tpu_torch import build_cache
from sem_tpu_torch import operators as ops
from sem_tpu_torch.interp import PointEvaluator
from sem_tpu_torch.krylov import (CapturedOperator, gmres,
                                  hist_printing_chunk, print_hist,
                                  refined_gmres_host, strip_chunk)
from sem_tpu_torch.ops import (RowStrips, apply_system_best,
                               apply_system_sharded)
from sem_tpu_torch.parallel.sharding import active_group, row_strips
from sem_tpu_torch.utils.profiling import read, span

__all__ = ["ConvectionDiffusionSolver"]


class ConvectionDiffusionSolver:
    def __init__(self, L_x: float, L_y: float, Pe: float, P: int,
                 N_ex: int, N_ey: int,
                 T_W: float = None, T_E: float = None,
                 T_S: float = None, T_N: float = None,
                 mtol: float = 1e-7, iprint: list = (),
                 restart: int = None, maxiter: int = 5000,
                 mixed_precision: bool = True,
                 dtype=torch.float64, device="cuda"):
        """
        :param L_x, L_y: domain lengths
        :param Pe: Peclet number
        :param P: polynomial order
        :param N_ex, N_ey: elements per direction
        :param T_W/T_E/T_S/T_N: Dirichlet value or None ⇒ homogeneous Neumann
        :param mtol: RMS tolerance of the linear solve (atol = mtol·√N)
        :param iprint: diagnostics tags: 'LGMRES_suc' (one line per solve)
            and 'LGMRES_iter' (one line per GMRES iteration: the f64
            recurrence residuals, or on the mixed path the f32 chunks')
        :param restart: GMRES window (None ⇒ sized from a ~2 GB f32 basis,
            between 60 and 200, as in the reference)
        :param maxiter: GMRES max total iterations
        :param mixed_precision: float32 Krylov chunks inside float64
            refinement (default) or one float64 GMRES
        :param dtype: dtype of the fields and the outer solve
        :param device: torch device of every tensor of the solver
        """
        self._iprint = list(iprint)
        self._Pe = float(Pe)
        self._mtol = float(mtol)
        Nn = (N_ex * P + 1) * (N_ey * P + 1)
        if restart is None:
            restart = min(200, max(60, int(2e9 / (4 * Nn))))
        self._restart = int(restart)
        self._maxiter = int(maxiter)
        self._mixed_precision = bool(mixed_precision)
        self._dtype = dtype
        self.device = torch.device(device)

        with span("build.host"):
            self.grid = build_cache.grid(P, N_ex, N_ey, L_x, L_y)
            self.points = self.grid.points
        self.N = self.grid.N
        group = active_group()
        if group is not None and group.world > 1:
            row_strips(self.grid.Ngx, group.world, P)  # raises if one is empty

        dirichlet = np.full(self.N, np.nan)
        for side, val in (("W", T_W), ("E", T_E), ("S", T_S), ("N", T_N)):
            if val is not None:
                dirichlet[self.grid.side_mask(side)] = val
        dev = self.device
        self._mask = torch.as_tensor(~np.isnan(dirichlet), device=dev)
        self._dirichlet = torch.as_tensor(np.nan_to_num(dirichlet),
                                          device=dev).to(dtype)
        self._md = {dt: ops.grid_const(self.grid, "mass_diag", dt, dev)
                    for dt in (dtype, torch.float32)}
        with span("build.host"):
            self._fdm = build_cache.fdm(
                self.grid, dirichlet_x=(T_W is not None, T_E is not None),
                dirichlet_y=(T_S is not None, T_N is not None))

        # linearization state: wind of the last _get_residuals, velocity
        # Jacobian diagonals of the last _calc_jacobians
        self._u = None
        self._v = None
        self._lin32_cache = None
        self._jac_diag_u = None
        self._jac_diag_v = None
        self._sigma = 0.0   # T-block mass shift of the last _calc_jacobians

        self.iter_count_solve = 0   # number of _get_update calls
        self.last_info = None       # KrylovInfo of the last linear solve

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self._dtype)

    # ------------------------------ kernels ------------------------------ #
    def _mv(self, u, v, sigma, strips: RowStrips = None):
        """Masked tangent matvec ``(K + Pe(u∂x + v∂y) + σM) dT`` in the dtype
        of ``u``/``v`` (float32 → kernel B1, float64 → the dense path); with
        ``strips``, on this rank's f32 strip of ``dT`` (halo exchange, then
        kernel B3)."""
        md = self._md[u.dtype]
        mask, grid, Pe = self._mask, self.grid, self._Pe
        if strips is None:
            def apply(dT):
                return apply_system_best(grid, u, v, dT, Pe)
        else:
            u, v, md, mask = (strips.local(a) for a in (u, v, md, mask))

            def apply(dT):
                return apply_system_sharded(grid, strips.rows, u, v,
                                            strips.exchange(dT), Pe)

        def mv(dT):
            r = apply(dT)
            if sigma != 0.0:
                r = r + sigma * md * dT
            return torch.where(mask, dT, r)

        return mv

    def _residual(self, T, u, v):
        r = self._Pe * ops.apply_convection(self.grid, u, v, T) \
            + ops.apply_stiffness(self.grid, T)
        return torch.where(self._mask, T - self._dirichlet, r)

    # ---------------- seven-method discipline protocol ---------------- #
    def _get_residuals(self, T, u, v):
        """Residual of the masked system."""
        self._u = self._t(u)
        self._v = self._t(v)
        return self._residual(self._t(T), self._u, self._v)

    def _calc_jacobians(self, T, sigma: float = 0.0):
        """Precompute the ∂res/∂(u,v) diagonals at ``T``; ``sigma`` is the
        pseudo-transient mass shift σ of the T-block until the next call."""
        T = self._t(T)
        self._jac_diag_u = self._Pe * ops.conv_diag_x(self.grid, T)
        self._jac_diag_v = self._Pe * ops.conv_diag_y(self.grid, T)
        self._sigma = float(sigma)

    def _get_dresiduals(self, dT, du=None, dv=None):
        """Tangent residual with the stored linearization."""
        return self._tangent(self._t(dT), self._u, self._v, self._jac_diag_u,
                             self._jac_diag_v,
                             None if du is None else self._t(du),
                             None if dv is None else self._t(dv), self._sigma)

    def _tangent(self, dT, u, v, jdu, jdv, du, dv, sigma):
        """The masked tangent residual on the dense path at the wind
        ``(u, v)`` and the velocity Jacobian diagonals ``jdu``/``jdv``:
        ``(K + Pe(u∂x + v∂y) + σM) dT + jdu·du + jdv·dv`` (``du``/``dv``
        None drop their term).  ``sigma`` is a float, or a 0-d tensor: the
        captured fused programs of the MDA take σ as data, so that a graph
        captured at one pseudo-time step serves every other."""
        r = self._Pe * ops.apply_convection(self.grid, u, v, dT) \
            + ops.apply_stiffness(self.grid, dT)
        if du is not None:
            r = r + jdu * du
        if dv is not None:
            r = r + jdv * dv
        if isinstance(sigma, torch.Tensor) or sigma != 0.0:
            r = r + sigma * self._md[dT.dtype] * dT
        return torch.where(self._mask, dT, r)

    @torch.no_grad()
    def _get_update(self, dres, dT0=None, mtol=None, best_effort=False):
        """Solve the tangent system for dT; raises RuntimeError on genuine
        non-convergence unless ``best_effort``.

        :param mtol: per-call RMS tolerance override
        :param best_effort: never raise — return the best iterate
            (preconditioner applications inside a flexible outer Krylov loop)
        """
        dT0 = (torch.zeros(self.N, dtype=self._dtype, device=self.device)
               if dT0 is None else self._t(dT0))
        drhs = self._t(dres)
        mtol_f = float(self._mtol if mtol is None else mtol)
        eps = float(torch.finfo(self._dtype).eps)
        if self._mixed_precision:
            dT, info = self._update_mixed(drhs, dT0, mtol_f, eps)
        else:
            want_hist = "LGMRES_iter" in self._iprint
            dT, info, *hist = self._update_f64(drhs, dT0, mtol_f, self._sigma,
                                               return_hist=want_hist)
            if want_hist:
                print_hist("ConvectionDiffusion", hist[0], info.iterations)
        self.last_info = info
        self.iter_count_solve += 1
        if not info.converged and not info.stalled and not best_effort:
            raise RuntimeError(
                f"ConvectionDiffusion GMRES: failed to converge in "
                f"{info.iterations} iterations (resnorm {info.resnorm:.3e})")
        if "LGMRES_suc" in self._iprint:
            print(f"ConvectionDiffusion GMRES: converged in "
                  f"{info.iterations} iterations with resnorm "
                  f"{info.resnorm:.3e}")
        return dT

    def _ops64(self, sigma, captured=False, lin=None):
        """``(mv, pc)`` of :meth:`_update_f64` at the mass shift ``sigma``:
        the tangent matvec and the FDM, on the current wind or on ``lin =
        (u, v)``.  With ``captured``, each is a
        :class:`sem_tpu_torch.krylov.CapturedOperator`, one CUDA graph on
        the card: for a caller that solves many times on one linearization,
        or on a copy of it that it refreshes in place."""
        u, v = (self._u, self._v) if lin is None else lin
        mv = self._mv(u, v, sigma)
        fdm = self._fdm

        def pc(r):
            return fdm(r, sigma=sigma)

        if captured:
            return CapturedOperator(mv), CapturedOperator(pc)
        return mv, pc

    def _update_f64(self, drhs, dT0, mtol, sigma, return_hist=False,
                    ops=None, basis_rows: int = None):
        """One float64 FDM-preconditioned GMRES on the tangent system
        (``mixed_precision=False``, and the preconditioner solves of the
        MDA's device windows), to the absolute RMS tolerance or ``mtol``
        relative to the RHS scale, whichever is larger.  ``ops``: the
        :meth:`_ops64` at ``sigma``, made once by a caller that solves many
        times; ``basis_rows``: as in :func:`sem_tpu_torch.krylov.gmres`.

        :return: ``(dT, KrylovInfo)``, plus the history with ``return_hist``
        """
        eps = float(torch.finfo(self._dtype).eps)
        atol = max(mtol * np.sqrt(self.N), max(mtol, 50 * eps)
                   * read(torch.linalg.vector_norm(drhs), "cd.tol"))
        mv, pc = self._ops64(sigma) if ops is None else ops
        return gmres(mv, drhs, x0=dT0, atol=atol, restart=self._restart,
                     maxiter=self._maxiter, precon=pc,
                     return_hist=return_hist, basis_rows=basis_rows)

    def _lin32(self):
        """f32 casts of the current wind, made once per linearization
        (invalidated by identity of the stored wind fields)."""
        src = (self._u, self._v)
        cached = self._lin32_cache
        if (cached is None or cached[0][0] is not src[0]
                or cached[0][1] is not src[1]):
            self._lin32_cache = (src, (src[0].to(torch.float32),
                                       src[1].to(torch.float32)))
        return self._lin32_cache[1]

    def _refinement_parts(self):
        """The pieces of the mixed-precision solve at the current
        linearization: ``(mv64, pc_lp, chunk)``, the f64 tangent matvec of
        the refinement residual, the f32 FDM preconditioner of each pass and
        the bounded f32 FDM-left-preconditioned GMRES chunk (kernel B1; on
        this rank's row strip under a group, kernel B3).  Shared by
        :meth:`_update_mixed` and the MDA's fused two-round preconditioner.
        The chunk returns the f32 history too under ``'LGMRES_iter'``.  On
        one card without a group, the chunk's operator is one CUDA graph,
        captured at the first chunk and replayed by every chunk of these
        parts (:class:`sem_tpu_torch.krylov.CapturedOperator`)."""
        ul32, vl32 = self._lin32()
        sigma, fdm = self._sigma, self._fdm
        restart = self._restart
        want_hist = "LGMRES_iter" in self._iprint
        group = active_group()
        if group is None or group.world == 1:
            mv32 = self._mv(ul32, vl32, sigma)
            # one CUDA graph of B1 and the FDM for every chunk at this
            # linearization
            op = CapturedOperator(lambda q: fdm(mv32(q), sigma=sigma))

            def chunk(rp, x0, atol_lp):
                return gmres(op, rp, x0=x0, atol=atol_lp, restart=restart,
                             maxiter=2 * restart + 5, return_hist=want_hist)
        else:
            # row strips: B3 matvec on this rank's strip, the FDM replicated
            st = RowStrips(self.grid, group)
            chunk = strip_chunk(st, 1, self._mv(ul32, vl32, sigma, st),
                                lambda r: fdm(r, sigma=sigma),
                                restart=restart, maxiter=2 * restart + 5,
                                return_hist=want_hist)
        def timed(rp, x0, atol_lp):
            with span("cd.chunk"):
                return chunk(rp, x0, atol_lp)

        return (self._mv(self._u, self._v, sigma),
                lambda r32: fdm(r32, sigma=sigma), timed)

    def _update_mixed(self, drhs, dT0, mtol, eps):
        """f64 refinement around bounded f32 FDM-left-preconditioned GMRES
        chunks (:func:`sem_tpu_torch.krylov.refined_gmres_host`)."""
        mv64, pc_lp, chunk = self._refinement_parts()
        if "LGMRES_iter" in self._iprint:
            chunk = hist_printing_chunk(chunk, "ConvectionDiffusion")

        return refined_gmres_host(
            cres=lambda x: drhs - mv64(x), pc_lp=pc_lp,
            gmres_chunk=chunk, b=drhs, x0=dT0,
            atol_fn=lambda bn: max(mtol * np.sqrt(self.N),
                                   max(mtol, 50 * eps) * bn),
            maxiter=self._maxiter)

    @torch.no_grad()
    def _get_solution(self, u, v, T0=None, mtol=None):
        """Single Newton step — the problem is linear in T."""
        self._sigma = 0.0
        T = (torch.zeros(self.N, dtype=self._dtype, device=self.device)
             if T0 is None else self._t(T0))
        res = self._get_residuals(T, u, v)
        return T + self._get_update(-res, mtol=mtol)

    def _get_vector(self, f_func: typing.Callable) -> np.ndarray:
        """Evaluate a callable at the global nodes (a copy: never the
        shared grid's read-only points themselves)."""
        return np.array(f_func(self.points[0], self.points[1]), dtype=float)

    def _get_interpol(self, f, points_plot) -> np.ndarray:
        """Evaluate the SEM interpolant at plot points."""
        return PointEvaluator(self.grid, points_plot)(self._t(f))

    def run(self, u_func, v_func, points_plot) -> np.ndarray:
        """End-to-end solve: velocities → T at plot points."""
        u = self._t(self._get_vector(u_func))
        v = self._t(self._get_vector(v_func))
        T = self._get_solution(u, v)
        return self._get_interpol(T, points_plot)
