"""Boussinesq coupler drivers — counterparts of ``build_coupled`` and ``run``
of ``sem_tpu.coupling.boussinesq``, with the same signatures plus a
``device`` argument (default ``"cuda"``; the CPU only when asked for).

Solves the dimensionless steady Boussinesq equations on [0,L_x]×[0,L_y]::

    Re ([u,v]∘∇)[u,v] = -∇p + ∇²[u,v] + Gr/Re [0, T]
    ∇∘[u,v] = 0
    Pe [u,v]∘∇T = ∇²T

with isothermal vertical walls T(0,y)=+0.5, T(L_x,y)=-0.5, adiabatic
floor/ceiling and no-slip velocity everywhere; Pe = Re·Pr, Gr = Ra/Pr.
"""
from __future__ import annotations

import typing

import numpy as np

from sem_tpu_torch.coupling.components import (ConvectionDiffusionComponent,
                                               NavierStokesComponent)
from sem_tpu_torch.coupling.mda import BoussinesqMDA
from sem_tpu_torch.models.convection_diffusion import ConvectionDiffusionSolver
from sem_tpu_torch.models.navier_stokes import NavierStokesSolver

__all__ = ["run", "build_coupled"]


def build_coupled(L_x: float, L_y: float,
                  Re=1.e3, Ra=1.e3, Pr=0.71,
                  P_cd=4, N_ex_cd=8, N_ey_cd=8,
                  P_ns=4, N_ex_ns=8, N_ey_ns=8,
                  mode="JNK",
                  mtol_nonlin=1e-9, AGi=8, AGr=0.8, AGc=0.2,
                  mtol_gmres=1e-10, restart=20,
                  mtol_internal=1e-13, mtol_precon=1e-4, iprint=True,
                  device_krylov=None, forcing=1e-3, mtol_subsolve=1e-6,
                  velo_inner=0, schur_precon=None, device="cuda",
                  **mda_kwargs):
    """Construct solvers, components and the MDA for the Boussinesq problem.

    Parameter names and defaults are those of ``sem_tpu``'s
    ``build_coupled``; the two disciplines may use different polynomial
    orders and element counts.  Extra keyword arguments pass through to
    :class:`BoussinesqMDA`.  Options not ported yet (``mode='PTC'``,
    ``device_krylov=True``, ``velo_inner>0``, a non-spectral
    ``schur_precon``) raise ``NotImplementedError``.
    """
    cd = ConvectionDiffusionSolver(L_x=L_x, L_y=L_y, Pe=Re * Pr,
                                   P=P_cd, N_ex=N_ex_cd, N_ey=N_ey_cd,
                                   T_W=0.5, T_E=-0.5,
                                   mtol=mtol_internal, device=device)
    ns = NavierStokesSolver(L_x=L_x, L_y=L_y, Re=Re, Gr=Ra / Pr,
                            P=P_ns, N_ex=N_ex_ns, N_ey=N_ey_ns,
                            mtol=mtol_internal, mtol_newton=mtol_internal,
                            velo_inner=velo_inner,
                            **({"schur_precon": schur_precon}
                               if schur_precon is not None else {}),
                            iprint=["NEWTON_suc"] if iprint else [],
                            device=device)
    cd_comp = ConvectionDiffusionComponent(cd, ns)
    ns_comp = NavierStokesComponent(cd, ns)
    mda = BoussinesqMDA(cd_comp, ns_comp, mode=mode,
                        mtol_nonlin=mtol_nonlin,
                        AGi=AGi, AGr=AGr, AGc=AGc,
                        mtol_gmres=mtol_gmres, restart=restart,
                        mtol_precon=mtol_precon, iprint=iprint,
                        device_krylov=device_krylov, forcing=forcing,
                        mtol_subsolve=mtol_subsolve, **mda_kwargs)
    return cd, ns, mda


def run(points_plot: typing.Tuple[np.ndarray, np.ndarray],
        L_x: float, L_y: float,
        Re=1.e3, Ra=1.e3, Pr=0.71,
        P_cd=4, N_ex_cd=8, N_ey_cd=8,
        P_ns=4, N_ex_ns=8, N_ey_ns=8,
        mode="JNK",
        mtol_nonlin=1e-9, AGi=8, AGr=0.8, AGc=0.2,
        mtol_gmres=1e-10, restart=20,
        mtol_internal=1e-13, mtol_precon=1e-4, iprint=True,
        return_state=False, device_krylov=None, device="cuda"):
    """Solve the coupled Boussinesq problem; return (T, u, v) at plot points
    as NumPy arrays (plus the state and the MDA stats with
    ``return_state``)."""
    cd, ns, mda = build_coupled(L_x, L_y, Re, Ra, Pr,
                                P_cd, N_ex_cd, N_ey_cd,
                                P_ns, N_ex_ns, N_ey_ns,
                                mode, mtol_nonlin, AGi, AGr, AGc,
                                mtol_gmres, restart, mtol_internal,
                                mtol_precon, iprint,
                                device_krylov=device_krylov, device=device)
    state = mda.solve()
    T_plot = cd._get_interpol(state.T, points_plot)
    u_plot = ns._get_interpol(state.u, points_plot)
    v_plot = ns._get_interpol(state.v, points_plot)
    if return_state:
        return T_plot, u_plot, v_plot, state, mda.stats
    return T_plot, u_plot, v_plot
