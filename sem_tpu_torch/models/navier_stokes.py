"""Steady Navier-Stokes (+ Boussinesq buoyancy) solver on torch tensors.

Solves, for (u, v, p) on [0,L_x]×[0,L_y] given a temperature field T::

    Re ([u,v]∘∇)[u,v] = -∇p + ∇²[u,v] + Gr/Re [0, T]
    ∇∘[u,v] = 0

with no-normal-flow + tangential-Dirichlet walls, a pinned reference pressure
at the centre node and artificial homogeneous-Neumann pressure rows on the
boundary.  Counterpart of ``sem_tpu.models.navier_stokes``: Newton on the
full residual with inexact-Newton forcing.  With ``linear_solver='coupled'``
each linear solve is GMRES on the stacked ``(du, dv, dp)`` system with a
block upper-triangular preconditioner: FDM velocity blocks and one of three
Schur blocks, ``'spectral'`` (tensor solve in the eigenbasis of the
consistent pressure Poisson pencil + exact boundary-ring elimination),
``'mass'`` (inverse diagonal GLL mass) or ``'pcd'`` (pressure convection-
diffusion, ``M⁻¹ F_p A_p⁻¹`` with the Neumann FDM pseudo-inverse as
``A_p⁻¹``).  With ``linear_solver='uzawa'`` each linear solve is float64
GMRES on the pressure-Schur complement, whose every matvec inverts the
2N×2N velocity Jacobian by an FDM-preconditioned GMRES of its own (it runs no
kernel).
By default the coupled Krylov loop runs as float32 chunks, whose matvec is
kernel B2 (:func:`sem_tpu_torch.ops.apply_coupled_system_best`), inside
float64 iterative refinement; a chunk that floors far above tolerance
escalates like the reference.  Under an active group
(:func:`sem_tpu_torch.parallel.use_group`) of more than one rank, each f32
chunk is decomposed into row strips of (du, dv, dp), whose matvec is kernel B4
(:func:`sem_tpu_torch.ops.apply_coupled_system_sharded`); everything else
stays replicated.

``velo_inner=k > 0`` strengthens the preconditioner's velocity block with
``k`` FDM-preconditioned GMRES steps on the true shifted velocity Jacobian
(kernel B2 again, ``k`` more times per application); the outer loop is then
flexible: :func:`sem_tpu_torch.krylov.fgmres` on the f64 path, row-scaled
right-preconditioned flexible f32 chunks on the mixed path.  Under a group
the flexible chunk runs on the strips too: the outer ``fgmres(group=)`` and
the ``k`` inner velocity steps on B4, the Schur block and the FDM on
all-gathered full fields.
:meth:`NavierStokesSolver.solve_ptc` is the pseudo-transient continuation
solve and :func:`solve_ns_continued` the p-continuation one.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from sem_tpu_torch import build_cache
from sem_tpu_torch import operators as ops
from sem_tpu_torch.interp import PointEvaluator, apply_transfer
from sem_tpu_torch.krylov import (CapturedOperator, fgmres, gmres,
                                  hist_printing_chunk, print_hist,
                                  refined_gmres_host, rownorm_estimate,
                                  strip_chunk)
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import (RowStrips, apply_coupled_system_best,
                               apply_coupled_system_sharded)
from sem_tpu_torch.ops.sharded import strip_maps
from sem_tpu_torch.parallel.sharding import active_group, row_strips
from sem_tpu_torch.ptc import SERController
from sem_tpu_torch.utils.profiling import COUNTERS, read, span
from sem_tpu_torch.utils.tensors import device_const

__all__ = ["NavierStokesSolver", "solve_ns_continued"]


def solve_ns_continued(L_x, L_y, Re, Gr, P, N_ex, N_ey, T_func=None,
                       levels: int = 2, **kwargs):
    """p-continuation solve of a standalone NS problem.

    Solves on a ladder of halved polynomial orders (floored at 2, element
    counts fixed), prolonging (u, v, p) through the cross-mesh transfer and
    warm-starting each level's Newton iteration: the fine level starts near
    the solution, and at convection-dominated parameters the warm-started
    linear systems need far less residual reduction per solve.  The NS
    analog of :func:`sem_tpu_torch.coupling.boussinesq.solve_continued`.

    :param T_func: temperature field callable (None ⇒ zero buoyancy source)
    :param levels: number of coarser levels below the target order
    :param kwargs: forwarded to every level's :class:`NavierStokesSolver`
        (``device`` among them; the card by default)
    :return: (ns, u, v, p) — the finest-level solver and solution vectors
    """
    ladder = [max(2, P >> k) for k in range(levels, 0, -1)] + [P]
    ladder = [p_ for i, p_ in enumerate(ladder)
              if i == 0 or p_ != ladder[i - 1]]
    uvp = None
    prev = None
    for P_level in ladder:
        ns = NavierStokesSolver(L_x, L_y, Re=Re, Gr=Gr, P=P_level,
                                N_ex=N_ex, N_ey=N_ey, **kwargs)
        T = (torch.zeros(ns.N, dtype=ns._dtype, device=ns.device)
             if T_func is None else ns._t(ns._get_vector(T_func)))
        if uvp is not None:
            uvp = tuple(apply_transfer(prev.grid, ns.grid, f) for f in uvp)
            u, v, p = ns._get_solution(T, u0=uvp[0], v0=uvp[1], p0=uvp[2])
        else:
            u, v, p = ns._get_solution(T)
        uvp = (u, v, p)
        prev = ns
    return ns, u, v, p


def _spectral_schur_data(grid: Grid2D):
    """Host constants of the ``'spectral'`` Schur-block preconditioner,
    computed exactly as ``sem_tpu.models.navier_stokes._spectral_schur_data``
    (and disk-cached under the same key).

    The consistent pressure Poisson ``E = B M⁻¹ G`` factorizes on the tensor
    grid; in the M-orthonormal eigenbasis of the per-direction pencils
    ``(Ex, M1x)`` the Schur complement is approximately diagonal with per-mode
    value ``(εx+εy)/(λ̂x+λ̂y)``.  The boundary rows of S are exactly the
    pressure-stiffness rows, eliminated with the dense inverse of the static
    boundary-ring block.  Returns Zx, Zy, esum, ksum (per-mode pencil values
    and stiffness Rayleigh quotients) and Kbb_inv.
    """
    import scipy.linalg
    from concurrent.futures import ThreadPoolExecutor

    from sem_tpu_torch.utils.diskcache import npz_cached

    def pencil(G1, m1, K1):
        E1 = G1.T @ (G1 / m1[:, None])
        s = 1.0 / np.sqrt(m1)
        A1 = (E1 * s[:, None]) * s[None, :]
        A1 = 0.5 * (A1 + A1.T)
        lam, Q = scipy.linalg.eigh(A1)
        Z = s[:, None] * Q
        lhat = (Z * (K1 @ Z)).sum(axis=0)  # per-mode Rayleigh quotients
        return lam, lhat, Z

    def ring_inverse():
        # boundary-ring stiffness block in edge-slice order (W row, E row,
        # S column sans corners, N column sans corners)
        Ngx, Ngy = grid.Ngx, grid.Ngy
        ixb = np.concatenate([np.zeros(Ngy, int), np.full(Ngy, Ngx - 1),
                              np.arange(1, Ngx - 1), np.arange(1, Ngx - 1)])
        iyb = np.concatenate([np.arange(Ngy), np.arange(Ngy),
                              np.zeros(Ngx - 2, int),
                              np.full(Ngx - 2, Ngy - 1)])
        Kbb = (grid.K1x[np.ix_(ixb, ixb)] * grid.m1y[iyb][:, None]
               * (iyb[:, None] == iyb[None, :])
               + grid.K1y[np.ix_(iyb, iyb)] * grid.m1x[ixb][:, None]
               * (ixb[:, None] == ixb[None, :]))
        return np.linalg.inv(Kbb)

    def build():
        with ThreadPoolExecutor(max_workers=3) as pool:
            fx = pool.submit(pencil, grid.G1x, grid.m1x, grid.K1x)
            fy = pool.submit(pencil, grid.G1y, grid.m1y, grid.K1y)
            fb = pool.submit(ring_inverse)
            ex, lx, Zx = fx.result()
            ey, ly, Zy = fy.result()
            Kbb_inv = fb.result()
        esum = ex[:, None] + ey[None, :]
        ksum = lx[:, None] + ly[None, :]
        return {"Zx": Zx, "Zy": Zy, "esum": esum, "ksum": ksum,
                "Kbb_inv": Kbb_inv}

    return npz_cached(f"spectral_v2_{grid.P}_{grid.N_ex}_{grid.N_ey}"
                      f"_{grid.L_x}_{grid.L_y}", build)


class SpectralSchur:
    """The host constants of one grid's ``'spectral'`` Schur block
    (:func:`_spectral_schur_data`, and what :meth:`NavierStokesSolver.
    _spectral` derives from them), read-only, and their device copies
    (:func:`device_const` caches them here): one per grid configuration,
    shared by every solver built on it (:mod:`sem_tpu_torch.build_cache`).
    """

    def __init__(self, grid: Grid2D):
        data = _spectral_schur_data(grid)
        esum = data["esum"]
        nz = np.abs(esum) > 1e-14 * float(np.max(np.abs(esum)))
        host = dict(Zx=data["Zx"], Zy=data["Zy"], ksum=data["ksum"],
                    Kbb_inv=data["Kbb_inv"], nz=nz,
                    esafe=np.where(nz, esum, 1.0),
                    # K(dp_z) on the boundary ring from two thin matmuls
                    K1e=grid.K1x[[0, -1], :], K1yTe=grid.K1y[[0, -1], :].T)
        for a in host.values():
            a.setflags(write=False)
        self.host = host

    def const(self, name: str, dtype, device) -> torch.Tensor:
        return device_const(self, name, lambda: self.host[name], dtype,
                            device)


def _counted_chunk(chunk):
    """``chunk`` timed as span ``ns.chunk``, its iterations counted under
    ``ns.inner_its``."""
    def counted(rp, x0, atol_lp):
        with span("ns.chunk"):
            out = chunk(rp, x0, atol_lp)
        COUNTERS["ns.inner_its"] += out[1].iterations
        return out

    return counted


def _edges_get(Rg):
    """Boundary-ring values in W/E/S/N edge-slice order."""
    return torch.cat([Rg[0, :], Rg[-1, :], Rg[1:-1, 0], Rg[1:-1, -1]])


def _edges_set_(Rg, vb):
    """Write ring values (edge-slice order) into ``Rg`` in place."""
    Ngx, Ngy = Rg.shape
    Rg[0, :] = vb[:Ngy]
    Rg[-1, :] = vb[Ngy:2 * Ngy]
    Rg[1:-1, 0] = vb[2 * Ngy:2 * Ngy + Ngx - 2]
    Rg[1:-1, -1] = vb[2 * Ngy + Ngx - 2:]
    return Rg


class NavierStokesSolver:
    def __init__(self, L_x: float, L_y: float, Re: float, Gr: float, P: int,
                 N_ex: int, N_ey: int,
                 v_W: float = 0, v_E: float = 0, u_S: float = 0, u_N: float = 0,
                 mtol: float = 1e-7, mtol_newton: float = 1e-5,
                 iprint: list = ("NEWTON_suc", "NEWTON_iter"),
                 restart: int = None, maxiter: int = 5000,
                 restart_velo: int = 60, maxiter_velo: int = 4000,
                 max_newton: int = 100, linear_solver: str = "coupled",
                 mixed_precision: bool = True, max_refine: int = 12,
                 schur_precon: str = "spectral", forcing: float = 1e-3,
                 velo_inner: int = 0, basis_dtype=None,
                 dtype=torch.float64, device="cuda"):
        """
        :param Re: Reynolds number; :param Gr: Grashof number
        :param v_W/v_E/u_S/u_N: tangential Dirichlet wall values
        :param mtol: RMS tolerance of the coupled / pressure-Schur GMRES
        :param mtol_newton: RMS tolerance of the Newton iteration
        :param iprint: tags among {'NEWTON_iter','NEWTON_suc','LGMRES_suc',
            'LGMRES_iter','VELO_suc'}
        :param restart/maxiter: GMRES window (None ⇒ sized from a ~2 GB f32
            basis, between 60 and 200) / total-iteration cap
        :param restart_velo/maxiter_velo: velocity-block GMRES parameters of
            the Uzawa path
        :param max_newton: safety cap on Newton iterations
        :param linear_solver: ``'coupled'``: one GMRES on the full
            (du, dv, dp) saddle system with the block upper-triangular
            preconditioner; ``'uzawa'``: pressure-Schur GMRES with (nearly)
            exact inner velocity solves, all float64 whatever
            ``mixed_precision`` says
        :param mixed_precision: float32 chunks inside float64 refinement
            (default) or one float64 GMRES
        :param max_refine: soft floor on the refinement passes (the budget
            follows ``maxiter``; see :func:`refined_gmres_host`)
        :param schur_precon: Schur-block approximation: ``'spectral'``
            (iteration counts flat in resolution), ``'mass'`` (inverse
            diagonal GLL mass; counts grow about linearly with 1/h) or
            ``'pcd'`` (pressure convection-diffusion; under ``'uzawa'`` it
            falls to the mass block)
        :param forcing: inexact-Newton forcing factor η: each linear system is
            solved to RMS tolerance max(mtol, η·‖F‖/√(3N)); None = fixed mtol
        :param velo_inner: inner velocity-solve strength of the coupled
            preconditioner: 0 = one FDM(Laplacian+σ) apply per application;
            k > 0 = ``k`` iterations of FDM-right-preconditioned GMRES on the
            true shifted velocity Jacobian (kernel B2), inside a flexible
            outer loop.  Even at 0, a mixed solve that floors far above
            tolerance retries once on the flexible k=5 path before the f64
            solve (``flex_retry_count``)
        :param basis_dtype: storage dtype of the f32 chunks' Krylov basis
        :param dtype: dtype of the fields and the outer solve
        :param device: torch device of every tensor of the solver
        """
        if linear_solver not in ("uzawa", "coupled"):
            raise ValueError("linear_solver must be 'uzawa' or 'coupled'")
        self._linear_solver = linear_solver
        if schur_precon not in ("mass", "pcd", "spectral"):
            raise ValueError(
                "schur_precon must be 'mass', 'pcd' or 'spectral'")
        self._schur_precon = schur_precon
        self._iprint = list(iprint)
        self._Re = float(Re)
        self._Gr = float(Gr)
        if self._Re == 0 and self._Gr != 0:
            raise ValueError("Cannot have Re == 0 and Gr != 0")
        self._Gr_over_Re = self._Gr / self._Re if self._Re != 0 else 0.0
        self._mtol = float(mtol)
        self._mtol_newton = float(mtol_newton)
        N3 = 3 * (N_ex * P + 1) * (N_ey * P + 1)
        if restart is None:
            restart = min(200, max(60, int(2e9 / (4 * N3))))
        self._restart = int(restart)
        self._maxiter = int(maxiter)
        self._restart_velo = int(restart_velo)
        self._maxiter_velo = int(maxiter_velo)
        self._velo_inner = max(0, int(velo_inner))
        self._max_newton = int(max_newton)
        self._forcing = None if forcing is None else float(forcing)
        self._mixed_precision = bool(mixed_precision)
        self._max_refine = int(max_refine)
        self._basis_dtype = basis_dtype
        self._dtype = dtype
        self.device = torch.device(device)

        with span("build.host"):
            self.grid = build_cache.grid(P, N_ex, N_ey, L_x, L_y)
            self.points = self.grid.points
        self.N = self.grid.N
        group = active_group()
        if group is not None and group.world > 1:
            row_strips(self.grid.Ngx, group.world, P)  # raises if one is empty

        # Dirichlet values and masks: no normal flow on all walls, tangential
        # values per side, pressure pinned at the centre node
        dir_u = np.full(self.N, np.nan)
        dir_v = np.full(self.N, np.nan)
        for side, du_, dv_ in (("W", 0.0, v_W), ("E", 0.0, v_E),
                               ("S", u_S, 0.0), ("N", u_N, 0.0)):
            m = self.grid.side_mask(side)
            dir_u[m] = du_
            dir_v[m] = dv_
        dev = self.device
        mb_np = ~np.isnan(dir_u)
        self._pin = int(self.N / 2)
        pin_np = np.zeros(self.N, dtype=bool)
        pin_np[self._pin] = True
        self._mb = torch.as_tensor(mb_np, device=dev)
        self._mb_or_pin = torch.as_tensor(mb_np | pin_np, device=dev)
        self._dir_u = torch.as_tensor(np.nan_to_num(dir_u), device=dev).to(
            dtype)
        self._dir_v = torch.as_tensor(np.nan_to_num(dir_v), device=dev).to(
            dtype)

        with span("build.host"):
            # exact masked-Laplacian inverse for the velocity blocks
            self._fdm = build_cache.fdm(self.grid, dirichlet_x=(True, True),
                                        dirichlet_y=(True, True))
            # pure-Neumann pressure Laplacian pseudo-inverse (PCD Schur
            # block)
            self._fdm_p = (build_cache.fdm(self.grid,
                                           dirichlet_x=(False, False),
                                           dirichlet_y=(False, False))
                           if schur_precon == "pcd" else None)
            # spectrally-matched Schur block (see _spectral_schur_data)
            self._spec = (build_cache.get(self.grid._config(),
                                          "spectral_schur",
                                          lambda: SpectralSchur(self.grid))
                          if schur_precon == "spectral" else None)
        # shared zero field of the Uzawa closures: read, never written
        self._zero = torch.zeros(self.N, dtype=dtype, device=dev)

        # linearization state (u, v of the last _calc_jacobians; convection
        # Jacobian diagonals; their f32 casts)
        self._lin32_cache = None
        self._dinv32 = None       # cached row-norm scaling (flexible chunks)
        self._u_lin = None
        self._v_lin = None
        self._jac = None   # (jxx, jxy, jyx, jyy) diagonal vectors
        self._sigma = 0.0  # velocity-block mass shift of the last linearization

        self._k = 0                  # Newton iterations of the last solve
        self.iter_count_solve = 0    # number of _get_update calls
        self.f64_fallback_count = 0   # f64 rescues of the mixed path
        self.flex_retry_count = 0     # floored plain-f32 solves retried on
        #                               the flexible velo_inner=5 path
        self.besteffort_floor_count = 0  # floored best-effort (precon) calls
        self.last_schur_info = None
        self.last_velo_info = None

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self._dtype)

    def _g(self, name, dtype):
        return ops.grid_const(self.grid, name, dtype, self.device)

    # --------------------------- residual maps --------------------------- #
    def _sys_apply(self, u, v, w):
        """K w + Re (u∂x + v∂y) w."""
        return ops.apply_stiffness(self.grid, w) \
            + self._Re * ops.apply_convection(self.grid, u, v, w)

    def _residual(self, u, v, p, T):
        grid, mb = self.grid, self._mb
        ru = self._sys_apply(u, v, u) + ops.apply_grad_x(grid, p)
        rv = self._sys_apply(u, v, v) + ops.apply_grad_y(grid, p) \
            - self._Gr_over_Re * ops.apply_mass(grid, T)
        rc = ops.apply_grad_x(grid, u) + ops.apply_grad_y(grid, v)
        ru = torch.where(mb, u - self._dir_u, ru)
        rv = torch.where(mb, v - self._dir_v, rv)
        rc = torch.where(mb, ops.apply_stiffness(grid, p), rc)  # ∂ₙp = 0 rows
        rc[self._pin] = p[self._pin]                            # pressure pin
        return ru, rv, rc

    def _dres(self, du, dv, dp, dT):
        return self._tangent(du, dv, dp, dT, self._u_lin, self._v_lin,
                             self._jac)

    def _tangent(self, du, dv, dp, dT, u_lin, v_lin, jac):
        """The tangent residuals at the linearization ``(u_lin, v_lin,
        jac)`` (dense path; the captured fused programs of the MDA pass
        their own copies of it)."""
        grid, mb = self.grid, self._mb
        jxx, jxy, jyx, jyy = jac
        dru = self._sys_apply(u_lin, v_lin, du) + jxx * du + jxy * dv \
            + ops.apply_grad_x(grid, dp)
        drv = self._sys_apply(u_lin, v_lin, dv) + jyx * du + jyy * dv \
            + ops.apply_grad_y(grid, dp) \
            - self._Gr_over_Re * ops.apply_mass(grid, dT)
        drc = ops.apply_grad_x(grid, du) + ops.apply_grad_y(grid, dv)
        dru = torch.where(mb, du, dru)
        drv = torch.where(mb, dv, drv)
        drc = torch.where(mb, ops.apply_stiffness(grid, dp), drc)
        drc[self._pin] = dp[self._pin]
        return dru, drv, drc

    # ------------------- coupled saddle operator + pc ------------------- #
    def _spectral(self, dtype):
        """Ŝ⁻¹ apply of the 'spectral' Schur block in ``dtype``: tensor solve
        on the interior rows + exact elimination of the boundary stiffness
        rows (see ``sem_tpu.models.navier_stokes._make_spectral``)."""
        grid = self.grid
        Ngx, Ngy = grid.Ngx, grid.Ngy

        def c(name, dtype=dtype):
            return self._spec.const(name, dtype, self.device)

        Zx, Zy = c("Zx"), c("Zy")
        # K(dp_z) on the boundary ring from two thin matmuls (dp_z is zero
        # on every edge, so the cross-direction terms vanish)
        K1e, K1yTe = c("K1e"), c("K1yTe")
        m1y = self._g("m1y", dtype)
        m1x_in = self._g("m1x", dtype)[1:-1]
        nz = c("nz", torch.bool)
        esafe, ksum, Kbb_inv = c("esafe"), c("ksum"), c("Kbb_inv")
        mb_or_pin, pin = self._mb_or_pin, self._pin

        def apply_(rp, sigma):
            ginv = torch.where(nz, (ksum + sigma) / esafe, 0.0)
            r_int = torch.where(mb_or_pin, 0.0, rp).reshape(Ngx, Ngy)
            W = Zx.T @ (r_int @ Zy)
            dp_z = Zx @ ((ginv * W) @ Zy.T)
            _edges_set_(dp_z, torch.zeros(2 * Ngy + 2 * (Ngx - 2),
                                          dtype=dtype, device=rp.device))
            zrows = (K1e @ dp_z) * m1y[None, :]
            zcols = (dp_z[1:-1, :] @ K1yTe) * m1x_in[:, None]
            zb = torch.cat([zrows[0], zrows[1], zcols[:, 0], zcols[:, 1]])
            rb = _edges_get(rp.reshape(Ngx, Ngy))
            dp = _edges_set_(dp_z, Kbb_inv @ (rb - zb)).reshape(-1)
            dp[pin] = rp[pin]
            return dp

        return apply_

    def _coupled_ops(self, u_lin, v_lin, jac, dtype, strips: RowStrips = None,
                     velo_inner: int = 0):
        """Coupled saddle matvec + block-triangular preconditioner in
        ``dtype`` (float32 → kernel B2, float64 → the dense path).  With
        ``strips``, the matvec takes and returns this rank's f32 strips of
        (du, dv, dp) (one halo exchange, then kernel B4); the preconditioner
        takes and returns full fields.  With ``velo_inner=k > 0`` the
        preconditioner's velocity block is ``k`` GMRES steps on the true
        shifted velocity Jacobian (the matvec on (du, dv, 0)),
        FDM-preconditioned; it then varies per application and needs a
        flexible outer loop.  With ``strips`` those steps run on this rank's
        (du, dv) strips (``gmres(group=)``, kernel B4 with one halo exchange
        per step), the FDM on the all-gathered full fields."""
        grid, mb, N, Re = self.grid, self._mb, self.N, self._Re
        ul, vl = u_lin.to(dtype), v_lin.to(dtype)
        jac = tuple(j.to(dtype) for j in jac)
        pin = 2 * N + self._pin
        fdm = self._fdm
        if self._schur_precon == "spectral":
            # handles its own boundary and pin rows
            schur = self._spectral(dtype)
        else:
            md = self._g("mass_diag", dtype)
            sd = self._g("stiff_diag", dtype)
            mb_or_pin, pin_p, fdm_p = self._mb_or_pin, self._pin, self._fdm_p

            def schur(rp, sigma):
                if fdm_p is not None:
                    # pressure convection-diffusion: Ŝ⁻¹ ≈ M⁻¹ F_p A_p⁻¹
                    # (Elman-Silvester-Wathen), A_p⁻¹ the FDM pseudo-inverse
                    # of the Neumann pressure Laplacian, F_p = K + Re(u∂x +
                    # v∂y) on pressure (the dense two-matmul apply, as in the
                    # reference).  The masked rows (∂ₙp = 0 rows, pin) carry a
                    # different scale and stay out of the Poisson solve.
                    t = fdm_p(torch.where(mb_or_pin, 0.0, rp))
                    dp = ops.apply_system(grid, ul, vl, t, Re) / md
                else:
                    dp = rp / md          # diagonal GLL mass
                # the ∂ₙp = 0 rows carry stiffness scale; the pin row is the
                # identity
                dp = torch.where(mb, rp / sd, dp)
                dp[pin_p] = rp[pin_p]
                return dp

        if strips is None:
            def mv(q):
                out = apply_coupled_system_best(grid, q, ul, vl, jac, mb, Re)
                out[pin] = q[pin]
                return out
        else:
            ul_s, vl_s, mb_s = (strips.local(a) for a in (ul, vl, mb))
            jac_s = tuple(strips.local(j) for j in jac)
            # the pin row is set by the rank that owns it (local index)
            pin_s = strips.local_index(self._pin)
            if pin_s is not None:
                pin_s += 2 * strips.nrows * grid.Ngy

            def mv(q):
                out = apply_coupled_system_sharded(
                    grid, strips.rows, strips.exchange(q, 3), ul_s, vl_s,
                    jac_s, mb_s, Re)
                if pin_s is not None:
                    out[pin_s] = q[pin_s]
                return out

        def pc(r, sigma):
            ru, rv, rp = r[:N], r[N:2 * N], r[2 * N:]
            dp = schur(rp, sigma)
            gx = torch.where(mb, 0.0, ops.apply_grad_x(grid, dp))
            gy = torch.where(mb, 0.0, ops.apply_grad_y(grid, dp))
            bu, bv = ru - gx, rv - gy
            if velo_inner == 0:
                # both velocity FDM solves as one batched apply
                duv = fdm(torch.stack([bu, bv]), sigma=sigma)
                return torch.cat([duv[0], duv[1], dp])
            # the true shifted velocity Jacobian (convection + reaction
            # diagonals; mv carries σ inside jxx/jyy, matching fdm's σ) by a
            # bounded inner GMRES with the FDM as right preconditioner
            b2 = torch.cat([bu, bv])
            cut, gather = strip_maps(strips, 2)
            n2 = cut(b2).shape[0]
            zp = torch.zeros(n2 // 2, dtype=dtype, device=r.device)

            def mv_velo(q2):
                return mv(torch.cat([q2, zp]))[:n2]

            def pc_velo(q2):
                return cut(fdm(gather(q2).reshape(2, N),
                               sigma=sigma).reshape(-1))

            q2, _ = gmres(mv_velo, cut(b2), atol=0.0, restart=velo_inner,
                          maxiter=velo_inner, precon=pc_velo,
                          group=None if strips is None else strips.group)
            return torch.cat([gather(q2), dp])

        return mv, pc

    def _pc64_fn(self, r, ul, vl, sigma):
        """The f64 coupled block preconditioner as a standalone linear apply
        (Schur block + batched FDM velocity, zero Jacobian diagonals) at the
        linearization ``(ul, vl)`` and mass shift ``sigma``.  Differentiable
        in ``r`` by autograd: the implicit adjoints
        (:mod:`sem_tpu_torch.coupling.implicit`) apply its exact transpose
        by a vector-Jacobian product."""
        z = torch.zeros(self.N, dtype=self._dtype, device=r.device)
        _, pc = self._coupled_ops(ul, vl, (z,) * 4, self._dtype)
        return pc(r, sigma)

    def _ops64(self, captured=False, lin=None):
        """``(mv, pc)`` of :meth:`_update_coupled_f64`: the saddle matvec
        and the block preconditioner at the current σ, on the current
        linearization or on ``lin = (u_lin, v_lin, jxx, jxy, jyx, jyy)``.
        With ``captured`` and a fixed preconditioner (``velo_inner`` 0),
        each is a :class:`sem_tpu_torch.krylov.CapturedOperator`, one CUDA
        graph on the card: for a caller that solves many times on one
        linearization, or on a copy of it that it refreshes in place."""
        u, v, *jac = ((self._u_lin, self._v_lin, *self._jac) if lin is None
                      else lin)
        mv, pc = self._coupled_ops(u, v, tuple(jac), self._dtype,
                                   velo_inner=self._velo_inner)
        sigma = self._sigma

        def pc_sigma(r):
            return pc(r, sigma)

        if captured and self._velo_inner == 0:
            return CapturedOperator(mv), CapturedOperator(pc_sigma)
        return mv, pc_sigma

    def _update_coupled_f64(self, b, dp0, mtol, hist_out: list = None,
                            ops=None, basis_rows: int = None):
        """Single-level float64 saddle solve (``mixed_precision=False``, and
        escalation step 2 of a floored mixed solve); flexible GMRES when
        ``velo_inner > 0``.  With a list ``hist_out`` the per-iteration
        recurrence residuals are appended to it.  ``ops``: the
        :meth:`_ops64` of the current linearization, made once by a caller
        that solves many times; ``basis_rows``: as in
        :func:`sem_tpu_torch.krylov.gmres`."""
        N = self.N
        eps = float(torch.finfo(self._dtype).eps)
        atol = max(mtol * np.sqrt(3 * N), max(mtol, 50 * eps)
                   * read(torch.linalg.vector_norm(b), "ns.tol"))
        mv, pc = self._ops64() if ops is None else ops
        z = torch.zeros(2 * N, dtype=self._dtype, device=self.device)
        solver = fgmres if self._velo_inner > 0 else gmres
        x, info, *hist = solver(mv, b, x0=torch.cat([z, dp0]), atol=atol,
                                restart=self._restart, maxiter=self._maxiter,
                                precon=pc, return_hist=hist_out is not None,
                                basis_rows=basis_rows)
        if hist_out is not None:
            hist_out.extend(hist)
        return x, info

    # ------------------------- Uzawa linear solve ------------------------- #
    def _velo_rows(self, du, dv):
        """The velocity rows of the tangent residual at ``dp = 0, dT = 0``:
        the masked 2N×2N velocity Jacobian applied to ``(du, dv)``
        (:meth:`_dres` without its terms in ``dp`` and ``dT``, which add
        exact zeros there, and without the continuity row)."""
        mb = self._mb
        jxx, jxy, jyx, jyy = self._jac
        u_lin, v_lin = self._u_lin, self._v_lin
        dru = self._sys_apply(u_lin, v_lin, du) + jxx * du + jxy * dv
        drv = self._sys_apply(u_lin, v_lin, dv) + jyx * du + jyy * dv
        return torch.where(mb, du, dru), torch.where(mb, dv, drv)

    def _solve_velo(self, bu, bv, q0):
        """Invert the masked 2N×2N velocity Jacobian of the current
        linearization: GMRES right-preconditioned by the FDM(σ) inverse of
        the masked Laplacian on the stacked pair, solved (nearly) exactly, to
        a tight tolerance with a machine-precision floor."""
        N, fdm, sigma = self.N, self._fdm, self._sigma
        b = torch.cat([bu, bv])

        def mv(q):
            return torch.cat(self._velo_rows(q[:N], q[N:]))

        def pc(q):
            return fdm(q.reshape(2, N), sigma=sigma).reshape(-1)

        eps = float(torch.finfo(self._dtype).eps)
        atol = max(1e-2 * self._mtol * np.sqrt(2 * N),
                   10 * eps * read(torch.linalg.vector_norm(b), "ns.tol"))
        return gmres(mv, b, x0=q0, atol=atol, restart=self._restart_velo,
                     maxiter=self._maxiter_velo, precon=pc)

    def _precon_schur(self, c):
        """Schur preconditioner of the Uzawa path: the ``'spectral'`` block,
        else the inverse diagonal mass with the pin row passed through."""
        if self._schur_precon == "spectral":
            return self._spectral(self._dtype)(c, self._sigma)
        dp = c / self._g("mass_diag", self._dtype)
        dp[self._pin] = c[self._pin]
        return dp

    def _update_uzawa(self, res_u, res_v, res_cont, dp0, mtol):
        """Full Uzawa update: velocity pre-solve, GMRES on the pressure-Schur
        operator (every matvec a velocity solve from zero), velocity
        back-substitution warm-started at the pre-solve.  Float64 throughout.

        :return: ``(du, dv, dp, schur_info, velo_info)``, the last that of
            the back-substitution
        """
        N, z = self.N, self._zero
        q0 = torch.zeros(2 * N, dtype=self._dtype, device=self.device)
        q_star, _ = self._solve_velo(res_u, res_v, q0)
        b_schur = res_cont - self._dres(q_star[:N], q_star[N:], z, z)[2]

        def schur_mv(dp):
            bu, bv, _ = self._dres(z, z, dp, z)
            f, _ = self._solve_velo(bu, bv, q0)
            return self._dres(-f[:N], -f[N:], dp, z)[2]

        # convergence floor: the absolute RMS tolerance or mtol relative to
        # the RHS scale, whichever is larger (the nested velocity solves'
        # f64 noise makes absolute targets below roundoff·‖b‖ unreachable)
        eps = float(torch.finfo(self._dtype).eps)
        atol = max(mtol * np.sqrt(N), max(mtol, 50 * eps)
                   * read(torch.linalg.vector_norm(b_schur), "ns.tol"))
        want_hist = "LGMRES_iter" in self._iprint
        dp, schur_info, *hist = gmres(
            schur_mv, b_schur, x0=dp0, atol=atol, restart=self._restart,
            maxiter=self._maxiter, precon=self._precon_schur,
            return_hist=want_hist)
        if want_hist:
            print_hist("NavierStokes", hist[0], schur_info.iterations)

        bu, bv, _ = self._dres(z, z, dp, z)
        q, velo_info = self._solve_velo(res_u - bu, res_v - bv, q_star)
        return q[:N], q[N:], dp, schur_info, velo_info

    def _update_coupled_mixed(self, b, dp0, mtol, velo_inner=None,
                              x0_full=None):
        """Float64 iterative refinement around bounded float32 GMRES chunks
        (kernel B2 matvec).  Two chunk flavors, both held to the true f64
        residual by the refinement loop, which keeps the best iterate:

        * ``velo_inner == 0``: left-preconditioned plain-GMRES chunks (raw
          SEM row scales span ~1e7, beyond f32 resolution; in the
          preconditioned norm the rows are O(1)); needs a fixed linear
          preconditioner;
        * ``velo_inner == k > 0``: row-scaled right-preconditioned flexible
          chunks: solve ``D⁻¹A x = D⁻¹r`` with ``D`` a stochastic row-norm
          estimate (cached per linearization) and the varying block
          preconditioner (``k`` inner GMRES steps on the velocity Jacobian)
          applied flexibly on the right; the refinement pass scales its
          residual by ``D⁻¹`` instead of preconditioning it.

        :param velo_inner: per-call override of the constructor's value
        :param x0_full: optional stacked (3N,) warm start (e.g. the floored
            iterate of a previous attempt); the result is never worse
        """
        N = self.N
        eps = float(torch.finfo(self._dtype).eps)
        k_inner = self._velo_inner if velo_inner is None else int(velo_inner)
        mv64, pc_lp, chunk = self._refinement_parts(k_inner)
        if "LGMRES_iter" in self._iprint:   # the f32 inner-loop residuals
            chunk = hist_printing_chunk(chunk, "NavierStokes")

        if x0_full is None:
            x0_full = torch.cat([torch.zeros(2 * N, dtype=self._dtype,
                                             device=self.device), dp0])
        return refined_gmres_host(
            cres=lambda x: b - mv64(x), pc_lp=pc_lp, gmres_chunk=chunk, b=b,
            x0=x0_full,
            atol_fn=lambda bn: max(mtol * np.sqrt(3 * N),
                                   max(mtol, 50 * eps) * bn),
            maxiter=self._maxiter, max_refine=self._max_refine)

    def _refinement_parts(self, k_inner: int):
        """The pieces of the mixed-precision solve at the current
        linearization: ``(mv64, pc_lp, chunk)``, the f64 saddle matvec of the
        refinement residual, the f32 prep of each pass's residual and the
        bounded f32 chunk (kernel B2; kernel B4 on this rank's row strips
        under a group, for both flavors) of :meth:`_update_coupled_mixed`'s
        docstring, for ``velo_inner = k_inner``.  Shared with the MDA's
        fused two-round preconditioner.  On one card without a group, the
        plain chunks' operator is one CUDA graph, captured at the first
        chunk and replayed by every chunk of these parts
        (:class:`sem_tpu_torch.krylov.CapturedOperator`).  The chunk returns
        the f32 history too under ``'LGMRES_iter'``."""
        N = self.N
        f32 = torch.float32
        ul32, vl32, jac32 = self._lin32()
        sigma = self._sigma
        mv64, _ = self._coupled_ops(self._u_lin, self._v_lin, self._jac,
                                    self._dtype)
        restart, basis_dtype = self._restart, self._basis_dtype
        want_hist = "LGMRES_iter" in self._iprint
        group = active_group()
        decomposed = group is not None and group.world > 1
        st = RowStrips(self.grid, group) if decomposed else None
        if k_inner > 0:
            # under a group: the outer loop on this rank's strips of
            # (du, dv, dp) (B4 matvec), the preconditioner on the gathered
            # full residual, its inner velocity steps on (du, dv) strips
            mv32, pc32 = self._coupled_ops(ul32, vl32, jac32, f32, st,
                                           velo_inner=k_inner)
            if self._dinv32 is None:
                # the same ±1 probes for every linearization
                gen = torch.Generator(device="cpu").manual_seed(0)
                self._dinv32 = 1.0 / rownorm_estimate(
                    mv32, 3 * N, f32, gen, device=self.device, strips=st,
                    nf=3)
            dinv32 = self._dinv32
            cut, gather = strip_maps(st, 3)
            dinv_s = cut(dinv32)

            def pc_lp(r32):
                return r32 * dinv32

            def chunk(rp, x0, atol_lp):
                x, *rest = fgmres(
                    lambda q: mv32(q) * dinv_s, cut(rp), cut(x0),
                    atol=atol_lp, restart=restart, maxiter=2 * restart + 5,
                    basis_dtype=basis_dtype,
                    precon=lambda r: cut(pc32(gather(r) / dinv32, sigma)),
                    return_hist=want_hist,
                    group=group if decomposed else None)
                return (gather(x), *rest)
        elif not decomposed:
            mv32, pc32 = self._coupled_ops(ul32, vl32, jac32, f32)
            # one CUDA graph of B2, the pin row and the preconditioner for
            # every chunk at this linearization
            op = CapturedOperator(lambda q: pc32(mv32(q), sigma))

            def pc_lp(r32):
                return pc32(r32, sigma)

            def chunk(rp, x0, atol_lp):
                return gmres(op, rp, x0=x0, atol=atol_lp, restart=restart,
                             maxiter=2 * restart + 5,
                             basis_dtype=basis_dtype, return_hist=want_hist)
        else:
            # row strips of (du, dv, dp): B4 matvec on this rank's strips,
            # the preconditioner replicated
            mv32, pc32 = self._coupled_ops(ul32, vl32, jac32, f32, st)

            def pc_lp(r32):
                return pc32(r32, sigma)

            chunk = strip_chunk(st, 3, mv32, pc_lp, restart=restart,
                                maxiter=2 * restart + 5,
                                basis_dtype=basis_dtype,
                                return_hist=want_hist)
        return mv64, pc_lp, _counted_chunk(chunk)

    def _lin32(self):
        """f32 casts of the current linearization, made once per
        linearization (invalidated by identity of the stored tensors)."""
        src = (self._u_lin, self._v_lin, self._jac)
        cached = self._lin32_cache
        if cached is None or any(a is not b for a, b in zip(cached[0], src)):
            f32 = torch.float32
            self._lin32_cache = (src, (src[0].to(f32), src[1].to(f32),
                                       tuple(j.to(f32) for j in src[2])))
            self._dinv32 = None   # row-norm scaling follows the linearization
        return self._lin32_cache[1]

    # ---------------- seven-method discipline protocol ---------------- #
    def _get_residuals(self, u, v, p, T):
        """Momentum + continuity residuals."""
        u, v = self._t(u), self._t(v)
        self._u_lin, self._v_lin = u, v
        return self._residual(u, v, self._t(p), self._t(T))

    def _calc_jacobians(self, u, v, sigma: float = 0.0):
        """Convection Jacobian diagonals at (u, v), plus the pseudo-transient
        mass shift σ·diag(M) on the (u,u) and (v,v) blocks (GLL mass is
        diagonal); σ also steers the preconditioners of ``_get_update``."""
        with span("ns.linearize"):
            u, v = self._t(u), self._t(v)
            self._u_lin, self._v_lin = u, v
            self._sigma = float(sigma)
            grid, Re = self.grid, self._Re
            md = self._g("mass_diag", self._dtype)
            self._jac = (Re * ops.conv_diag_x(grid, u) + self._sigma * md,
                         Re * ops.conv_diag_y(grid, u),
                         Re * ops.conv_diag_x(grid, v),
                         Re * ops.conv_diag_y(grid, v) + self._sigma * md)
            self._dinv32 = None   # row-norm scaling follows the linearization

    def _get_dresiduals(self, du, dv, dp, dT=None):
        """Tangent residuals with the stored linearization."""
        dT = (torch.zeros(self.N, dtype=self._dtype, device=self.device)
              if dT is None else self._t(dT))
        return self._dres(self._t(du), self._t(dv), self._t(dp), dT)

    @torch.no_grad()
    def _get_update(self, dres_u, dres_v, dres_cont,
                    du0=None, dv0=None, dp0=None, mtol=None,
                    best_effort=False):
        """Linear solve for (du, dv, dp).

        :param mtol: per-call RMS tolerance override
        :param best_effort: return the best iterate instead of escalating or
            raising (preconditioner applications inside flexible outer
            Krylov loops)
        """
        with span("ns.update"):
            return self._update(dres_u, dres_v, dres_cont, dp0, mtol,
                                best_effort)

    def _update(self, dres_u, dres_v, dres_cont, dp0, mtol, best_effort):
        N = self.N
        dp0 = (torch.zeros(N, dtype=self._dtype, device=self.device)
               if dp0 is None else self._t(dp0))
        mtol_f = float(self._mtol if mtol is None else mtol)
        b = torch.cat([self._t(dres_u), self._t(dres_v), self._t(dres_cont)])
        velo_info = None
        if self._linear_solver == "uzawa":
            # float64 whatever mixed_precision says: no chunks, no ladder
            du, dv, dp, info, velo_info = self._update_uzawa(
                b[:N], b[N:2 * N], b[2 * N:], dp0, mtol_f)
            x = torch.cat([du, dv, dp])
        elif self._mixed_precision:
            x, info = self._update_coupled_mixed(b, dp0, mtol_f)
            if not info.converged:
                # a plateau near the tolerance is the f32 floor — accepted;
                # one far above it (or with ~no progress on the RHS) needs
                # the escalation ladder
                eps = float(torch.finfo(self._dtype).eps)
                nb = info.bnorm
                atol_eff = max(mtol_f * np.sqrt(3 * N),
                               max(mtol_f, 50 * eps) * nb)

                def needs_rescue(inf):
                    return (inf.resnorm > 100 * atol_eff
                            or inf.resnorm > 0.9 * nb)

                if needs_rescue(info) and best_effort:
                    # preconditioner application: the floored iterate is a
                    # usable (weaker) preconditioner; never pay for f64
                    self.besteffort_floor_count += 1
                elif needs_rescue(info):
                    if self._velo_inner == 0:
                        # escalation step 1: retry on the flexible row-scaled
                        # f32 path with a k=5 inner velocity solve (the
                        # regime where the plain chunks floor is convection-
                        # dominated), warm-started at the floored iterate
                        self.flex_retry_count += 1
                        x_f, info_f = self._update_coupled_mixed(
                            b, dp0, mtol_f, velo_inner=5, x0_full=x)
                        adopted = info_f.resnorm < info.resnorm
                        if "LGMRES_suc" in self._iprint:
                            print("NavierStokes linear solve: plain f32 "
                                  "chunks floored; flexible velo_inner=5 "
                                  f"retry reached resnorm "
                                  f"{info_f.resnorm:.3e} "
                                  + ("(adopted)" if adopted else
                                     "(worse — kept plain-chunk iterate)"))
                        if adopted:
                            x, info = x_f, info_f
                    if not info.converged and (needs_rescue(info)
                                               or not info.stalled):
                        # escalation step 2: the single-level f64 solve; also
                        # when the (possibly retried) iterate sits below the
                        # rescue thresholds but is neither converged nor
                        # stalled, which would raise below
                        self.f64_fallback_count += 1
                        x, info = self._update_coupled_f64(b, dp0, mtol_f)
                        if "LGMRES_suc" in self._iprint:
                            print("NavierStokes linear solve: mixed-"
                                  "precision path floored far above "
                                  "tolerance; retried in f64")
        else:
            hist = [] if "LGMRES_iter" in self._iprint else None
            x, info = self._update_coupled_f64(b, dp0, mtol_f, hist)
            if hist:
                print_hist("NavierStokes", hist[0], info.iterations)
        self.last_schur_info = info
        self.last_velo_info = info if velo_info is None else velo_info
        self.iter_count_solve += 1
        if not info.converged and not info.stalled and not best_effort:
            raise RuntimeError(
                f"NavierStokes Schur GMRES: failed to converge in "
                f"{info.iterations} iterations (resnorm {info.resnorm:.3e})")
        if "LGMRES_suc" in self._iprint:
            status = ("converged" if info.converged
                      else "stalled (roundoff plateau)")
            print(f"NavierStokes Schur GMRES: {status} in {info.iterations} "
                  f"iterations ({info.resweeps} DGKS resweeps) with resnorm "
                  f"{info.resnorm:.3e}")
        if "VELO_suc" in self._iprint or "LU_suc" in self._iprint:
            vi = self.last_velo_info
            print(f"NavierStokes velocity solve: {vi.iterations} "
                  f"iterations, resnorm {vi.resnorm:.3e}, "
                  f"converged={vi.converged}")
        return x[:N], x[N:2 * N], x[2 * N:]

    @torch.no_grad()
    def _get_solution(self, T, u0=None, v0=None, p0=None, mtol=None):
        """Newton iteration to RMS tolerance.

        :param mtol: optional RMS tolerance override (Newton test and inner
            linear solves)
        """
        z = torch.zeros(self.N, dtype=self._dtype, device=self.device)
        u = z if u0 is None else self._t(u0)
        v = z if v0 is None else self._t(v0)
        p = z if p0 is None else self._t(p0)
        T = self._t(T)
        atol = (self._mtol_newton if mtol is None else mtol) \
            * np.sqrt(self.N * 3)
        self._k = 0
        stag = 0
        best = float("inf")
        while True:
            ru, rv, rc = self._get_residuals(u, v, p, T)
            norm = self._residual_norm(ru, rv, rc)
            if "NEWTON_iter" in self._iprint:
                print(f"NavierStokes NEWTON: {self._k}\t{norm}")
            if norm <= atol:
                if "NEWTON_suc" in self._iprint:
                    mx = read(torch.max(torch.cat([ru.abs(), rv.abs(),
                                                   rc.abs()])), "ns.maxnorm")
                    print(f"NavierStokes NEWTON: Converged in {self._k} "
                          f"iterations with max-norm {mx}")
                break
            # fail fast on stagnation (8 flat iterations)
            stag = stag + 1 if norm > 0.999 * best else 0
            best = min(best, norm)
            if stag >= 8 or self._k >= self._max_newton:
                raise RuntimeError(
                    f"NavierStokes NEWTON: no convergence in {self._k} "
                    f"iterations (residual {norm:.3e}, target {atol:.3e}"
                    + (", stagnated" if stag >= 8 else "") + ")")
            with span("ns.newton"):
                self._calc_jacobians(u, v)
                mtol_k = mtol
                if self._forcing is not None:
                    floor = self._mtol if mtol is None else mtol
                    mtol_k = max(floor,
                                 self._forcing * norm / np.sqrt(3 * self.N))
                du, dv, dp = self._get_update(-ru, -rv, -rc, mtol=mtol_k)
                u = u + du
                v = v + dv
                p = p + dp
            self._k += 1
        return u, v, p

    def _residual_norm(self, ru, rv, rc) -> float:
        return float(np.sqrt(sum(
            read(torch.stack([ru @ ru, rv @ rv, rc @ rc]), "ns.norm"))))

    @torch.no_grad()
    def solve_ptc(self, T, u0=None, v0=None, p0=None, mtol=None,
                  dt0: float = 0.1, growth: float = 3.0,
                  dt_max: float = 1e12, forcing_ptc: float = 1e-2,
                  max_steps: int = 300):
        """Pseudo-transient continuation solve: the globally convergent path
        to steady states where the from-zero Newton fails (convection-
        dominated regimes, e.g. the Re ≥ 400 lid cavity on fine grids).

        Each step solves the implicit-Euler system ``(J + σM)δ = −F`` with
        σ = Re/Δt carried in the Jacobian diagonals
        (``_calc_jacobians(sigma=...)``) and matched by the shifted FDM and
        Schur preconditioners, so the linear systems stay diagonally
        dominant, inside the mixed path's attainable range.  The Δt schedule
        is the shared :class:`sem_tpu_torch.ptc.SERController`.  As Δt→∞ the
        step is exact Newton; convergence is tested on the unchanged steady
        residual at the RMS tolerance of :meth:`_get_solution`.

        :return: (u, v, p)
        """
        z = torch.zeros(self.N, dtype=self._dtype, device=self.device)
        u = z if u0 is None else self._t(u0)
        v = z if v0 is None else self._t(v0)
        p = z if p0 is None else self._t(p0)
        T = self._t(T)
        rt3n = np.sqrt(self.N * 3)
        atol = (self._mtol_newton if mtol is None else mtol) * rt3n
        ctrl = SERController(dt0, growth=growth, dt_max=dt_max)
        self._k = 0
        ru, rv, rc = self._get_residuals(u, v, p, T)
        norm = self._residual_norm(ru, rv, rc)
        linfail_rejects = 0
        for k in range(max_steps):
            if "NEWTON_iter" in self._iprint:
                print(f"NavierStokes PTC: {k}\t{norm}\tdt={ctrl.dt:.3g}")
            if norm <= atol:
                if "NEWTON_suc" in self._iprint:
                    print(f"NavierStokes PTC: Converged in {k} steps")
                return u, v, p
            self._calc_jacobians(u, v, sigma=self._Re / ctrl.dt)
            floor = self._mtol if mtol is None else mtol
            mtol_k = max(floor, forcing_ptc * norm / rt3n)
            # best_effort: the Δt controller owns recovery; a floored or
            # failed linear solve feeds back as ``lin_failed`` (a Δt cut
            # restores preconditioner dominance) instead of raising or
            # paying the escalation ladder against a shift the controller
            # is about to strengthen anyway
            du, dv, dp = self._get_update(-ru, -rv, -rc, mtol=mtol_k,
                                          best_effort=True)
            info = self.last_schur_info
            lin_failed = (not info.converged
                          and info.resnorm > 10 * mtol_k * rt3n)
            un, vn, pn = u + du, v + dv, p + dp
            run_, rvn, rcn = self._get_residuals(un, vn, pn, T)
            norm_new = self._residual_norm(run_, rvn, rcn)
            self._k += 1
            collapsed = (f"NavierStokes PTC: pseudo-time step collapsed at "
                         f"residual {norm:.3e}")
            if not np.isfinite(norm_new) or norm_new > 1e3 * max(norm, 1.0):
                if not ctrl.reject_blowup():
                    raise RuntimeError(collapsed)
                continue
            if lin_failed and norm_new > norm and linfail_rejects < 3:
                # a dx that failed its linear solve AND raised the residual
                # is not a pseudo-time step: re-solve about the same state
                # at the damped Δt (bounded)
                linfail_rejects += 1
                if not ctrl.reject_linfail():
                    raise RuntimeError(collapsed)
                continue
            linfail_rejects = 0
            ctrl.accept(norm, norm_new, lin_failed)
            u, v, p = un, vn, pn
            ru, rv, rc = run_, rvn, rcn
            norm = norm_new
        raise RuntimeError(
            f"NavierStokes PTC: no convergence in {max_steps} steps "
            f"(residual {norm:.3e}, target {atol:.3e})")

    def _get_vector(self, f_func: typing.Callable) -> np.ndarray:
        """Evaluate a callable at the global nodes (a copy: never the
        shared grid's read-only points themselves)."""
        return np.array(f_func(self.points[0], self.points[1]), dtype=float)

    def _get_interpol(self, f, points_plot) -> np.ndarray:
        """Evaluate the SEM interpolant at plot points."""
        return PointEvaluator(self.grid, points_plot)(self._t(f))

    def run(self, T_func, points_plot):
        """End-to-end solve: temperature → (u, v, p) at plot points."""
        T = self._t(self._get_vector(T_func))
        u, v, p = self._get_solution(T)
        return (self._get_interpol(u, points_plot),
                self._get_interpol(v, points_plot),
                self._get_interpol(p, points_plot))
