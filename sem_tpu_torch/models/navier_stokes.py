"""Steady Navier-Stokes (+ Boussinesq buoyancy) solver on torch tensors.

Solves, for (u, v, p) on [0,L_x]×[0,L_y] given a temperature field T::

    Re ([u,v]∘∇)[u,v] = -∇p + ∇²[u,v] + Gr/Re [0, T]
    ∇∘[u,v] = 0

with no-normal-flow + tangential-Dirichlet walls, a pinned reference pressure
at the centre node and artificial homogeneous-Neumann pressure rows on the
boundary.  Counterpart of the coupled-saddle path of
``sem_tpu.models.navier_stokes``: Newton on the full residual with inexact-
Newton forcing; each linear solve is GMRES on the stacked ``(du, dv, dp)``
system with a block upper-triangular preconditioner — the ``'spectral'``
Schur block (tensor solve in the eigenbasis of the consistent pressure
Poisson pencil + exact boundary-ring elimination) and FDM velocity blocks.
By default the Krylov loop runs as float32 chunks, whose matvec is kernel B2
(:func:`sem_tpu_torch.ops.apply_coupled_system_best`), inside float64
iterative refinement; a chunk that floors far above tolerance escalates like
the reference.

Not ported yet (they raise ``NotImplementedError``): the Uzawa linear
solver, the ``'mass'``/``'pcd'`` Schur blocks, ``velo_inner > 0`` and the
flexible ``velo_inner=5`` retry (escalation step 1), ``solve_ptc`` and
``solve_ns_continued``.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from sem_tpu_torch import operators as ops
from sem_tpu_torch.fdm import FDM2D
from sem_tpu_torch.interp import PointEvaluator
from sem_tpu_torch.krylov import gmres, refined_gmres_host
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import apply_coupled_system_best
from sem_tpu_torch.utils.tensors import device_const

__all__ = ["NavierStokesSolver"]


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
                 max_newton: int = 100, linear_solver: str = "coupled",
                 mixed_precision: bool = True, max_refine: int = 12,
                 schur_precon: str = "spectral", forcing: float = 1e-3,
                 velo_inner: int = 0, basis_dtype=None,
                 dtype=torch.float64, device="cuda"):
        """
        :param Re: Reynolds number; :param Gr: Grashof number
        :param v_W/v_E/u_S/u_N: tangential Dirichlet wall values
        :param mtol: RMS tolerance of the coupled linear solves
        :param mtol_newton: RMS tolerance of the Newton iteration
        :param iprint: tags among {'NEWTON_iter','NEWTON_suc','LGMRES_suc'}
        :param restart/maxiter: GMRES window (None ⇒ sized from a ~2 GB f32
            basis, between 60 and 200) / total-iteration cap
        :param max_newton: safety cap on Newton iterations
        :param linear_solver: ``'coupled'`` (the only one ported)
        :param mixed_precision: float32 chunks inside float64 refinement
            (default) or one float64 GMRES
        :param max_refine: soft floor on the refinement passes (the budget
            follows ``maxiter``; see :func:`refined_gmres_host`)
        :param schur_precon: ``'spectral'`` (the only one ported)
        :param forcing: inexact-Newton forcing factor η: each linear system is
            solved to RMS tolerance max(mtol, η·‖F‖/√(3N)); None = fixed mtol
        :param velo_inner: 0 (the only value ported)
        :param basis_dtype: storage dtype of the f32 chunks' Krylov basis
        :param dtype: dtype of the fields and the outer solve
        :param device: torch device of every tensor of the solver
        """
        if linear_solver != "coupled":
            raise NotImplementedError(
                "linear_solver='uzawa' is not ported to sem_tpu_torch yet")
        if schur_precon != "spectral":
            raise NotImplementedError(
                f"schur_precon={schur_precon!r} is not ported to "
                f"sem_tpu_torch yet (only 'spectral')")
        if velo_inner != 0:
            raise NotImplementedError(
                "velo_inner > 0 (flexible row-scaled chunks) is not ported "
                "to sem_tpu_torch yet")
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
        self._max_newton = int(max_newton)
        self._forcing = None if forcing is None else float(forcing)
        self._mixed_precision = bool(mixed_precision)
        self._max_refine = int(max_refine)
        self._basis_dtype = basis_dtype
        self._dtype = dtype
        self.device = torch.device(device)

        self.grid = Grid2D(P, N_ex, N_ey, L_x, L_y)
        self.points = self.grid.points
        self.N = self.grid.N

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

        # exact masked-Laplacian inverse for the velocity blocks
        self._fdm = FDM2D(self.grid, dirichlet_x=(True, True),
                          dirichlet_y=(True, True))
        self._spec = _spectral_schur_data(self.grid)
        self._spec_nz = np.abs(self._spec["esum"]) > 1e-14 * float(
            np.max(np.abs(self._spec["esum"])))

        # linearization state (u, v of the last _calc_jacobians; convection
        # Jacobian diagonals; their f32 casts)
        self._lin32_cache = None
        self._u_lin = None
        self._v_lin = None
        self._jac = None   # (jxx, jxy, jyx, jyy) diagonal vectors
        self._sigma = 0.0  # velocity-block mass shift of the last linearization

        self._k = 0                  # Newton iterations of the last solve
        self.iter_count_solve = 0    # number of _get_update calls
        # f64 rescues of the mixed path; stays 0 until escalation step 1 is
        # ported (the rescue only follows it)
        self.f64_fallback_count = 0
        self.last_schur_info = None

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
        grid, mb = self.grid, self._mb
        jxx, jxy, jyx, jyy = self._jac
        u_lin, v_lin = self._u_lin, self._v_lin
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
        grid, spec = self.grid, self._spec
        Ngx, Ngy = grid.Ngx, grid.Ngy

        def c(name, host):
            return device_const(self, ("spec", name), host, dtype,
                                self.device)

        Zx = c("Zx", lambda: spec["Zx"])
        Zy = c("Zy", lambda: spec["Zy"])
        # K(dp_z) on the boundary ring from two thin matmuls (dp_z is zero
        # on every edge, so the cross-direction terms vanish)
        K1e = c("K1e", lambda: grid.K1x[[0, -1], :])
        K1yTe = c("K1yTe", lambda: grid.K1y[[0, -1], :].T)
        m1y = self._g("m1y", dtype)
        m1x_in = self._g("m1x", dtype)[1:-1]
        nz = device_const(self, ("spec", "nz"), lambda: self._spec_nz,
                          torch.bool, self.device)
        esafe = c("esafe", lambda: np.where(self._spec_nz, spec["esum"], 1.0))
        ksum = c("ksum", lambda: spec["ksum"])
        Kbb_inv = c("Kbb_inv", lambda: spec["Kbb_inv"])
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

    def _coupled_ops(self, u_lin, v_lin, jac, dtype):
        """Coupled saddle matvec + block-triangular preconditioner in
        ``dtype`` (float32 → kernel B2, float64 → the dense path)."""
        grid, mb, N, Re = self.grid, self._mb, self.N, self._Re
        ul, vl = u_lin.to(dtype), v_lin.to(dtype)
        jac = tuple(j.to(dtype) for j in jac)
        pin = 2 * N + self._pin
        spectral = self._spectral(dtype)
        fdm = self._fdm

        def mv(q):
            out = apply_coupled_system_best(grid, q, ul, vl, jac, mb, Re)
            out[pin] = q[pin]
            return out

        def pc(r, sigma):
            ru, rv, rp = r[:N], r[N:2 * N], r[2 * N:]
            dp = spectral(rp, sigma)
            gx = torch.where(mb, 0.0, ops.apply_grad_x(grid, dp))
            gy = torch.where(mb, 0.0, ops.apply_grad_y(grid, dp))
            # both velocity FDM solves as one batched apply
            duv = fdm(torch.stack([ru - gx, rv - gy]), sigma=sigma)
            return torch.cat([duv[0], duv[1], dp])

        return mv, pc

    def _update_coupled_f64(self, b, dp0, mtol):
        """Single-level float64 saddle solve (``mixed_precision=False``).

        The reference also runs it as escalation step 2 of a floored mixed
        solve; with ``velo_inner=0`` that step only follows step 1 (the
        flexible retry), which is not ported, so here the ladder raises
        before reaching it."""
        N = self.N
        eps = float(torch.finfo(self._dtype).eps)
        atol = max(mtol * np.sqrt(3 * N), max(mtol, 50 * eps)
                   * float(torch.linalg.vector_norm(b)))
        mv, pc = self._coupled_ops(self._u_lin, self._v_lin, self._jac,
                                   self._dtype)
        z = torch.zeros(2 * N, dtype=self._dtype, device=self.device)
        sigma = self._sigma
        return gmres(mv, b, x0=torch.cat([z, dp0]), atol=atol,
                     restart=self._restart, maxiter=self._maxiter,
                     precon=lambda r: pc(r, sigma))

    def _update_coupled_mixed(self, b, dp0, mtol):
        """Float64 iterative refinement around bounded float32
        left-preconditioned GMRES chunks (kernel B2 matvec)."""
        N = self.N
        eps = float(torch.finfo(self._dtype).eps)
        ul32, vl32, jac32 = self._lin32()
        sigma = self._sigma
        mv64, _ = self._coupled_ops(self._u_lin, self._v_lin, self._jac,
                                    self._dtype)
        mv32, pc32 = self._coupled_ops(ul32, vl32, jac32, torch.float32)
        restart, basis_dtype = self._restart, self._basis_dtype

        def chunk(rp, x0, atol_lp):
            return gmres(lambda q: pc32(mv32(q), sigma), rp, x0=x0,
                         atol=atol_lp, restart=restart,
                         maxiter=2 * restart + 5, basis_dtype=basis_dtype)

        z = torch.zeros(2 * N, dtype=self._dtype, device=self.device)
        return refined_gmres_host(
            cres=lambda x: b - mv64(x),
            pc_lp=lambda r32: pc32(r32, sigma),
            gmres_chunk=chunk, b=b, x0=torch.cat([z, dp0]),
            atol_fn=lambda bn: max(mtol * np.sqrt(3 * N),
                                   max(mtol, 50 * eps) * bn),
            maxiter=self._maxiter, max_refine=self._max_refine)

    def _lin32(self):
        """f32 casts of the current linearization, made once per
        linearization (invalidated by identity of the stored tensors)."""
        src = (self._u_lin, self._v_lin, self._jac)
        cached = self._lin32_cache
        if cached is None or any(a is not b for a, b in zip(cached[0], src)):
            f32 = torch.float32
            self._lin32_cache = (src, (src[0].to(f32), src[1].to(f32),
                                       tuple(j.to(f32) for j in src[2])))
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
        u, v = self._t(u), self._t(v)
        self._u_lin, self._v_lin = u, v
        self._sigma = float(sigma)
        grid, Re = self.grid, self._Re
        md = self._g("mass_diag", self._dtype)
        self._jac = (Re * ops.conv_diag_x(grid, u) + self._sigma * md,
                     Re * ops.conv_diag_y(grid, u),
                     Re * ops.conv_diag_x(grid, v),
                     Re * ops.conv_diag_y(grid, v) + self._sigma * md)

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
        N = self.N
        dp0 = (torch.zeros(N, dtype=self._dtype, device=self.device)
               if dp0 is None else self._t(dp0))
        mtol_f = float(self._mtol if mtol is None else mtol)
        b = torch.cat([self._t(dres_u), self._t(dres_v), self._t(dres_cont)])
        if self._mixed_precision:
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

                if needs_rescue(info) and not best_effort:
                    # escalation step 1 of the reference: retry on flexible
                    # row-scaled f32 chunks with velo_inner=5 — not ported
                    raise NotImplementedError(
                        "NavierStokes linear solve floored far above "
                        "tolerance: escalation step 1 (the flexible "
                        "velo_inner=5 retry) is not ported to sem_tpu_torch")
        else:
            x, info = self._update_coupled_f64(b, dp0, mtol_f)
        self.last_schur_info = info
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
            r2 = torch.stack([ru @ ru, rv @ rv, rc @ rc]).tolist()
            norm = float(np.sqrt(sum(r2)))
            if "NEWTON_iter" in self._iprint:
                print(f"NavierStokes NEWTON: {self._k}\t{norm}")
            if norm <= atol:
                if "NEWTON_suc" in self._iprint:
                    mx = float(torch.max(torch.cat([ru.abs(), rv.abs(),
                                                    rc.abs()])))
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
            self._calc_jacobians(u, v)
            mtol_k = mtol
            if self._forcing is not None:
                floor = self._mtol if mtol is None else mtol
                mtol_k = max(floor, self._forcing * norm / np.sqrt(3 * self.N))
            du, dv, dp = self._get_update(-ru, -rv, -rc, mtol=mtol_k)
            u = u + du
            v = v + dv
            p = p + dp
            self._k += 1
        return u, v, p

    def _get_vector(self, f_func: typing.Callable) -> np.ndarray:
        """Evaluate a callable at the global nodes."""
        return np.asarray(f_func(self.points[0], self.points[1]), dtype=float)

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
