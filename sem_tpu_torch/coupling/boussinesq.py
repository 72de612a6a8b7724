"""Boussinesq coupler entry points — counterparts of ``build_coupled``,
``run``, ``run_parallel``, ``solve_continued`` and ``solve_ra_continued`` of
``sem_tpu.coupling.boussinesq``, with the same signatures plus a ``device``
argument (default ``"cuda"``; the CPU only when asked for).

Solves the dimensionless steady Boussinesq equations on [0,L_x]×[0,L_y]::

    Re ([u,v]∘∇)[u,v] = -∇p + ∇²[u,v] + Gr/Re [0, T]
    ∇∘[u,v] = 0
    Pe [u,v]∘∇T = ∇²T

with isothermal vertical walls T(0,y)=+0.5, T(L_x,y)=-0.5, adiabatic
floor/ceiling and no-slip velocity everywhere; Pe = Re·Pr, Gr = Ra/Pr.
"""
from __future__ import annotations

import time
import typing
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sem_tpu_torch.coupling.components import (ConvectionDiffusionComponent,
                                               NavierStokesComponent)
from sem_tpu_torch.coupling.mda import BoussinesqMDA, CoupledState
from sem_tpu_torch.interp import apply_transfer
from sem_tpu_torch.models.convection_diffusion import ConvectionDiffusionSolver
from sem_tpu_torch.models.navier_stokes import NavierStokesSolver

__all__ = ["run", "run_parallel", "build_coupled", "solve_continued",
           "solve_ra_continued"]


def solve_continued(L_x, L_y, levels: int = 2, state0: CoupledState = None,
                    grids0=None, ladder=None, **kwargs):
    """p-continuation solve of the coupled Boussinesq problem.

    Solves the problem on a ladder of ``levels`` coarser polynomial orders
    (P halved per level, floored at 2; element counts fixed), prolonging
    each level's solution to the next through the cross-mesh transfer
    (:func:`sem_tpu_torch.interp.apply_transfer`) and warm-starting the MDA
    with it.  For the smooth cavity flows a P/2 solution prolonged to order
    P already satisfies the coupled equations to near its truncation error,
    so the fine level converges in 1-2 iterations instead of from scratch.
    The fine level's convergence test is unchanged, so the result meets the
    same tolerances as a direct solve.

    While level i solves (device-bound), level i+1's solvers are built in a
    worker thread (host-LAPACK-bound: eigendecompositions, spectral Schur
    constants), which hides most of the fine level's construction.

    :param levels: number of coarser levels below the target order
    :param state0: optional warm-start state, on the coarsest ladder level's
        grids or, with ``grids0=(cd_grid, ns_grid)``, on those grids (it is
        then transferred to the coarsest level; the way to chain an earlier
        fine-grid solve into a continuation run).  Mismatched sizes raise
    :param grids0: optional ``(cd_grid, ns_grid)`` pair (``Grid2D``) that
        ``state0`` lives on
    :param ladder: optional explicit ladder, a list of ``(P_cd, P_ns)``
        pairs ending at the target order, overriding ``levels`` and the
        halving schedule (e.g. ``[(4, 4), (16, 16)]`` skips the P8 level)
    :param kwargs: forwarded to :func:`build_coupled` (``P_cd``/``P_ns``,
        ``device``, ``fused``, ``device_krylov``, ...); each level builds its
        own MDA, so with ``device_krylov=None`` each level picks its program
        by its own DOF; ``timing=True`` prints per level the build wait
        (what the worker thread did not hide), the solve wall and the stats
    :return: (cd, ns, mda, state) of the finest level
    """
    P_cd = kwargs.pop("P_cd", 4)
    P_ns = kwargs.pop("P_ns", 4)
    iprint = kwargs.get("iprint", True)
    timing = kwargs.pop("timing", False)
    if ladder is None:
        ladder = [(max(2, P_cd >> k), max(2, P_ns >> k))
                  for k in range(levels, 0, -1)] + [(P_cd, P_ns)]
        # drop duplicate coarse levels created by the floor
        ladder = [lv for i, lv in enumerate(ladder)
                  if i == 0 or lv != ladder[i - 1]]
    else:
        ladder = [tuple(lv) for lv in ladder]

    state = state0
    src = grids0  # grids the current ``state`` lives on (None = this level's)
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(build_coupled, L_x, L_y,
                          P_cd=ladder[0][0], P_ns=ladder[0][1], **kwargs)
        for i, (Pc, Pn) in enumerate(ladder):
            t_lv = time.perf_counter()
            cd, ns, mda = fut.result()
            t_build = time.perf_counter() - t_lv
            if i + 1 < len(ladder):
                fut = pool.submit(build_coupled, L_x, L_y,
                                  P_cd=ladder[i + 1][0],
                                  P_ns=ladder[i + 1][1], **kwargs)
            if state is not None and src is not None:
                cd_g, ns_g = src
                state = CoupledState(
                    T=apply_transfer(cd_g, cd.grid, state.T),
                    u=apply_transfer(ns_g, ns.grid, state.u),
                    v=apply_transfer(ns_g, ns.grid, state.v),
                    p=apply_transfer(ns_g, ns.grid, state.p))
            elif state is not None and (state.T.shape[0] != cd.N
                                        or state.u.shape[0] != ns.N):
                raise ValueError(
                    f"state0 sizes (T {state.T.shape[0]}, "
                    f"u {state.u.shape[0]}) do not match the coarsest ladder "
                    f"level (N_cd={cd.N}, N_ns={ns.N}); pass "
                    f"grids0=(cd_grid, ns_grid) to have it transferred from "
                    f"its own grids")
            if iprint:
                print(f"Boussinesq continuation level P_cd={Pc} P_ns={Pn}")
            t_sv = time.perf_counter()
            state = mda.solve(state)
            if timing:
                print(f"  [ttfs] level P_cd={Pc} P_ns={Pn}: build-wait "
                      f"{t_build:.2f}s solve "
                      f"{time.perf_counter() - t_sv:.2f}s "
                      f"stats={mda.stats.as_list()}", flush=True)
            src = (cd.grid, ns.grid)
    return cd, ns, mda, state


def solve_ra_continued(L_x, L_y, Ra, decades: int = None,
                       ptc_above: float = 1.0e4, **kwargs):
    """Ra-continuation solve of the coupled Boussinesq problem.

    At high Rayleigh number the from-zero solve fails: the iteration-0
    subsystem sweep asks the NS discipline for a full nonlinear solve under
    the entire buoyancy forcing at once, which is convection-dominated
    beyond what the FDM(Laplacian)-preconditioned Krylov can handle.
    Parameter continuation fixes this: solve at a lower Ra, then re-solve at
    each ladder level warm-started by the previous solution.  Above
    ``ptc_above`` even the warm-started coupled JNK fails (its GMRES
    flat-lines at Ra=1e5); those levels run in ``'PTC'`` mode, whose decade
    steps are robust, so the ladder uses full decades there.

    :param Ra: target Rayleigh number
    :param decades: ``None`` (default) — automatic ladder from Ra=1e3 with
        decade steps up to 1e4, √10 (half-decade) steps in the JNK band
        above 1e4, and full decades in the PTC band; an int gives the
        fixed-decade ladder
    :param ptc_above: Rayleigh number above which levels switch to PTC
        (``None`` disables the switch)
    :param kwargs: forwarded to :func:`build_coupled` (``fused`` and
        ``device_krylov`` unchanged: each level picks its own program)
    :return: (cd, ns, mda, state) at the target Ra
    """
    def use_ptc(Ra_k):
        return ptc_above is not None and Ra_k > ptc_above * 1.00001

    if decades is None:
        ladder = [Ra]
        while ladder[0] > 1.5e3:
            prev = ladder[0]
            step = (10.0 if use_ptc(prev / 3.0) else
                    10.0 ** 0.5 if prev > 1.00001e4 else 10.0)
            ladder.insert(0, max(1e3, prev / step))
    else:
        ladder = [Ra / 10 ** k for k in range(decades, 0, -1)
                  if Ra / 10 ** k >= 1e3] + [Ra]
    iprint = kwargs.get("iprint", True)
    base_mode = kwargs.pop("mode", "JNK")
    state = None
    for Ra_k in ladder:
        mode_k = "PTC" if use_ptc(Ra_k) else base_mode
        if iprint:
            print(f"Boussinesq Ra-continuation level Ra={Ra_k:.1e} "
                  f"({mode_k})")
        cd, ns, mda = build_coupled(L_x, L_y, Ra=Ra_k, mode=mode_k, **kwargs)
        state = mda.solve(state)
    return cd, ns, mda, state


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
                  fused=None, **mda_kwargs):
    """Construct solvers, components and the MDA for the Boussinesq problem.

    Parameter names and defaults are those of ``sem_tpu``'s
    ``build_coupled``; the two disciplines may use different polynomial
    orders and element counts.  Extra keyword arguments pass through to
    :class:`BoussinesqMDA` (``ptc_dt0``, ``precon``, ``checkpoint_path``,
    ``time_budget_s``, ...); with a ``checkpoint_path`` the configuration
    stamp that checkpoints are verified against on resume is filled in.
    ``velo_inner`` and ``schur_precon`` (``'spectral'``, ``'mass'`` or
    ``'pcd'``) pass through to the NS solver; like the reference's, this
    function has no ``linear_solver`` argument (an Uzawa NS block is built
    by hand: the two solvers, their components, :class:`BoussinesqMDA`).
    ``device_krylov`` and ``fused`` choose the program of the coupled linear
    solves (:class:`BoussinesqMDA`); their defaults (``None``) make the
    reference's choice: the device windows up to
    :data:`~sem_tpu_torch.coupling.mda.DEVICE_KRYLOV_MAX_DOF` coupled DOF,
    else the fused host FGMRES (``fused=False``: the un-fused one).
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
    if "checkpoint_path" in mda_kwargs:
        mda_kwargs.setdefault("checkpoint_config", dict(
            Re=Re, Ra=Ra, Pr=Pr, P_cd=P_cd, N_ex_cd=N_ex_cd,
            N_ey_cd=N_ey_cd, P_ns=P_ns, N_ex_ns=N_ex_ns, N_ey_ns=N_ey_ns,
            mode=mode))
    mda = BoussinesqMDA(cd_comp, ns_comp, mode=mode,
                        mtol_nonlin=mtol_nonlin,
                        AGi=AGi, AGr=AGr, AGc=AGc,
                        mtol_gmres=mtol_gmres, restart=restart,
                        mtol_precon=mtol_precon, iprint=iprint,
                        device_krylov=device_krylov, forcing=forcing,
                        mtol_subsolve=mtol_subsolve, fused=fused,
                        **mda_kwargs)
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
        return_state=False, device_krylov=None, device="cuda", fused=None,
        velo_inner=0, **mda_kwargs):
    """Solve the coupled Boussinesq problem; return (T, u, v) at plot points
    as NumPy arrays (plus the state and the MDA stats with
    ``return_state``).  ``velo_inner`` and the extra keyword arguments
    (``precon``, ``ptc_dt0``, ...) pass through to :func:`build_coupled`."""
    cd, ns, mda = build_coupled(L_x, L_y, Re, Ra, Pr,
                                P_cd, N_ex_cd, N_ey_cd,
                                P_ns, N_ex_ns, N_ey_ns,
                                mode, mtol_nonlin, AGi, AGr, AGc,
                                mtol_gmres, restart, mtol_internal,
                                mtol_precon, iprint,
                                device_krylov=device_krylov, device=device,
                                fused=fused, velo_inner=velo_inner,
                                **mda_kwargs)
    state = mda.solve()
    T_plot = cd._get_interpol(state.T, points_plot)
    u_plot = ns._get_interpol(state.u, points_plot)
    v_plot = ns._get_interpol(state.v, points_plot)
    if return_state:
        return T_plot, u_plot, v_plot, state, mda.stats
    return T_plot, u_plot, v_plot


def run_parallel(points_plot, L_x, L_y, *args, devices=None, **kwargs):
    """:func:`run` decomposed over the ranks ``devices`` (all by default) of
    the process group of :func:`sem_tpu_torch.parallel.init_distributed`.

    Counterpart of ``sem_tpu.coupling.run_parallel``: every rank of the
    process group calls it with the same arguments, each f32 Krylov chunk of
    the CD and NS solves runs on row strips over the ranks of ``devices``
    (kernels B3/B4, halo exchanges, all-reduced GMRES), and each of them
    returns the same replicated results; a rank outside ``devices`` returns
    ``None`` without solving.  Pass each rank its own ``device`` (the one
    ``init_distributed`` returns).  ``fused`` and ``device_krylov`` pass
    through to :func:`run` unchanged (default: the reference's choice).
    """
    from sem_tpu_torch.parallel import make_group, use_group

    group = make_group(devices)
    if group is None:
        return None
    with use_group(group):
        return run(points_plot, L_x, L_y, *args, **kwargs)
