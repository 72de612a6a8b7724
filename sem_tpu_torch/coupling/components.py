"""Discipline components: the coupling-facing wrappers of the PDE solvers.

Counterpart of ``sem_tpu.coupling.components``: each component exposes
``apply_nonlinear``, ``linearize``, ``apply_linear`` (incl. the
cross-discipline terms through the mesh transfer), ``solve_linear`` (the
block-Jacobi building block) and ``solve_nonlinear``, mapped onto the
seven-method solver protocol, and counts its linear solves in
``iter_count_solve``.  The cross-mesh re-basis is the precomputed pair of 1D
interpolation matrices of :func:`sem_tpu_torch.interp.apply_transfer`.
"""
from __future__ import annotations

from sem_tpu_torch.interp import apply_transfer
from sem_tpu_torch.models.convection_diffusion import ConvectionDiffusionSolver
from sem_tpu_torch.models.navier_stokes import NavierStokesSolver

__all__ = ["ConvectionDiffusionComponent", "NavierStokesComponent"]


class ConvectionDiffusionComponent:
    """CD discipline: output ``T_cd``; inputs ``u_ns``, ``v_ns``."""

    def __init__(self, solver_cd: ConvectionDiffusionSolver,
                 solver_ns: NavierStokesSolver):
        self.cd = solver_cd
        self.ns = solver_ns
        self.iter_count_solve = 0

    def change_inputs(self, u_ns, v_ns):
        """Re-basis (u, v) from the NS grid onto the CD grid (linear map)."""
        return (apply_transfer(self.ns.grid, self.cd.grid, u_ns),
                apply_transfer(self.ns.grid, self.cd.grid, v_ns))

    def apply_nonlinear(self, T_cd, u_ns, v_ns):
        return self.cd._get_residuals(T_cd, *self.change_inputs(u_ns, v_ns))

    def linearize(self, T_cd, sigma: float = 0.0):
        self.cd._calc_jacobians(T_cd, sigma=sigma)

    def apply_linear(self, dT_cd, du_ns, dv_ns):
        return self.cd._get_dresiduals(dT_cd,
                                       *self.change_inputs(du_ns, dv_ns))

    def solve_linear(self, d_residual, dT0=None, mtol=None,
                     best_effort=False):
        out = self.cd._get_update(d_residual, dT0=dT0, mtol=mtol,
                                  best_effort=best_effort)
        self.iter_count_solve += 1
        return out

    def solve_nonlinear(self, u_ns, v_ns, T0=None, mtol=None):
        out = self.cd._get_solution(*self.change_inputs(u_ns, v_ns), T0=T0,
                                    mtol=mtol)
        self.iter_count_solve += 1  # problem linear: one update per solve
        return out


class NavierStokesComponent:
    """NS discipline: outputs ``u_ns``, ``v_ns``, ``p_ns``; input ``T_cd``."""

    def __init__(self, solver_cd: ConvectionDiffusionSolver,
                 solver_ns: NavierStokesSolver):
        self.cd = solver_cd
        self.ns = solver_ns
        self.iter_count_solve = 0

    def change_inputs(self, T_cd):
        """Re-basis T from the CD grid onto the NS grid (linear map)."""
        return apply_transfer(self.cd.grid, self.ns.grid, T_cd)

    def apply_nonlinear(self, u_ns, v_ns, p_ns, T_cd):
        return self.ns._get_residuals(u_ns, v_ns, p_ns,
                                      self.change_inputs(T_cd))

    def linearize(self, u_ns, v_ns, sigma: float = 0.0):
        self.ns._calc_jacobians(u_ns, v_ns, sigma=sigma)

    def apply_linear(self, du_ns, dv_ns, dp_ns, dT_cd):
        return self.ns._get_dresiduals(du_ns, dv_ns, dp_ns,
                                       self.change_inputs(dT_cd))

    def solve_linear(self, dres_u, dres_v, dres_cont,
                     du0=None, dv0=None, dp0=None, mtol=None,
                     best_effort=False):
        out = self.ns._get_update(dres_u, dres_v, dres_cont,
                                  du0=du0, dv0=dv0, dp0=dp0, mtol=mtol,
                                  best_effort=best_effort)
        self.iter_count_solve += 1
        return out

    def solve_nonlinear(self, T_cd, u0=None, v0=None, p0=None, mtol=None):
        out = self.ns._get_solution(self.change_inputs(T_cd),
                                    u0=u0, v0=v0, p0=p0, mtol=mtol)
        self.iter_count_solve += self.ns._k  # inner-Newton update count
        return out
