"""MDA engine: nonlinear block-Gauss-Seidel / Newton-block-Jacobi /
block-Jacobi-preconditioned Newton-Krylov / pseudo-transient continuation
for the Boussinesq coupling.

Counterpart of ``sem_tpu.coupling.mda``:

* ``'GS'``  — nonlinear block Gauss-Seidel with post-sweep residual
  evaluation;
* ``'NJ'``  — Newton whose linear solve is ONE linear block-Jacobi sweep,
  safeguarded by an Armijo-Goldstein backtracking line search;
* ``'JNK'`` — Newton with the coupled linear system solved by host-
  orchestrated *flexible* GMRES (:func:`_fgmres`), preconditioned by one
  block-Jacobi sweep of the disciplines' own (loose, best-effort) solves;
* ``'PTC'`` — pseudo-transient continuation: SER-ramped implicit-Euler steps
  through the JNK machinery with mass-shifted Jacobians and spectrally
  matched shifted preconditioners, the globally convergent path to
  high-Rayleigh steady states where from-zero JNK diverges
  (:meth:`BoussinesqMDA._solve_ptc`).

The preconditioner of the coupled Krylov loop is block Jacobi (``'bj'``),
block Gauss-Seidel (``'bgs'``: the CD solve feeds the buoyancy correction
into the NS right-hand side) or its symmetric variant (``'bgs2'``).  The
coupled iterate can be checkpointed every few iterations and the solve ended
gracefully on a wall-clock budget (:mod:`sem_tpu_torch.utils.checkpoint`).

Both Newton modes start with one Gauss-Seidel sweep (the reference's
``solve_subsystems=True, max_sub_solves=0``).  Tolerances follow the RMS
convention: absolute tolerance = mtol·√DOF with DOF = 3·N_ns + N_cd.

The coupled linear systems are solved by one of three programs, chosen as
the reference chooses them:

* ``device_krylov`` (default: coupled DOF ≤ :data:`DEVICE_KRYLOV_MAX_DOF`):
  the JNK (and, up to :data:`PTC_DEVICE_MAX_DOF`, the PTC) linear solves run
  as warm-started windows of :func:`sem_tpu_torch.krylov.fgmres` with
  float64 nested discipline solves (:meth:`BoussinesqMDA._fgmres_device`);
* otherwise the host FGMRES, by default fused (the reference's
  ``SEM_TPU_FG_FUSED=1`` with ``SEM_TPU_FUSED_PC=1``): one fused step per
  iteration (coupled matvec, flexible-basis write, f32 CGS2 and the Givens
  recurrence on the device; on a CUDA device captured once as a CUDA graph)
  that reads back one scalar, preconditioned by the fixed two-round policy
  (:meth:`BoussinesqMDA._build_pc_fused`) where both solvers are mixed
  precision and the NS solver is ``'coupled'``, else by the block-Jacobi
  sweep;
* ``fused=False``: the un-fused host FGMRES with the adaptive block-Jacobi
  sweep (the reference with both variables ``0``).

Under a process group (:func:`sem_tpu_torch.parallel.use_group`) every
program runs.  The coupled vectors, the fused step and the device windows'
f64 nested solves stay replicated on every rank; the disciplines' f32
chunks (the preconditioners' and the Gauss-Seidel sweeps') run on row
strips.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from sem_tpu_torch import operators as ops
from sem_tpu_torch.coupling.components import (ConvectionDiffusionComponent,
                                               NavierStokesComponent)
from sem_tpu_torch.interp import apply_transfer
from sem_tpu_torch.krylov import (CapturedProgram, _givens_update_device,
                                  fgmres)
from sem_tpu_torch.parallel.distributed import assert_replicated
from sem_tpu_torch.parallel.sharding import active_group
from sem_tpu_torch.ptc import SERController
from sem_tpu_torch.utils.checkpoint import save_checkpoint
from sem_tpu_torch.utils.profiling import COUNTERS, read, span

__all__ = ["BoussinesqMDA", "MDAStats", "CoupledState"]

#: outer iterations in one on-device JNK window (``device_krylov=True``):
#: the reference's default ``SEM_TPU_FUSED_WINDOW``; windows are
#: warm-started, so the size bounds a window without changing convergence
FUSED_WINDOW = 10
#: largest coupled DOF at which ``device_krylov=None`` picks the device
#: windows: the reference's default ``SEM_TPU_DEVICE_KRYLOV_MAX_DOF``
DEVICE_KRYLOV_MAX_DOF = 1_000_000
#: rows of the Krylov bases of the windows' nested float64 solves allocated
#: up front (``krylov.gmres`` ``basis_rows``): at ``mtol_precon`` they take
#: a few iterations each, and a basis of ``restart + 1`` rows (201 at NS P16
#: 32×32, 1.27 GB) would sit unused
PRECON_BASIS_ROWS = 17
#: largest coupled DOF at which PTC takes the device windows: the
#: reference's default ``SEM_TPU_PTC_DEVICE_MAX_DOF``
PTC_DEVICE_MAX_DOF = 150_000
#: chunk tolerance of the fused preconditioner's rounds, relative to the
#: pass's preconditioned residual (``refined_gmres_host``'s ``inner_rtol``)
_PC_RTOL = 1e-5
#: chunk tolerance of a round whose discipline tolerance is already met:
#: above every f32 residual, so that the chunk ends before its first
#: iteration
_PC_BIG = 3e38
#: a PTC step attempt's outcomes (counters ``ptc.<outcome>``) and the
#: :class:`MDAStats` field each adds to: a step taken, a step taken whose
#: linear solve ended above 10× its target, a step rejected for a blow-up
#: of the residual or for a failed linear solve that raised it
_PTC_STATS = {"accepted": "ptc_accepted", "partial": "ptc_partial",
              "rejects.blowup": "ptc_rejected",
              "rejects.linfail": "ptc_rejected"}


@dataclasses.dataclass
class MDAStats:
    """Iteration counters ``[cd_linear_solves, ns_linear_solves,
    nonlinear_iters]`` (the reference study's benchmark), plus the total
    coupled GMRES iterations and, in PTC, the step attempts by outcome:
    ``ptc_accepted`` steps taken, ``ptc_rejected`` attempts rejected (blow-up
    or failed linear solve; ``nonlinear_iters`` counts both kinds), and
    ``ptc_partial`` accepted steps whose linear solve ended above 10× its
    target (zero outside PTC)."""

    cd_solves: int = 0
    ns_solves: int = 0
    nonlinear_iters: int = 0
    gmres_iters: int = 0
    ptc_accepted: int = 0
    ptc_rejected: int = 0
    ptc_partial: int = 0

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
            basis_dtype=torch.float32, fused=None, forecast=False):
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

    :param fused: optional ``(start, step, precon_split)`` triple
        (:meth:`BoussinesqMDA._fg_fused`) that replaces the per-iteration
        glue with one fused step and one scalar read per iteration:

        * ``start(x, b) -> (V, Z, H, cs, sn, g, *v_pieces, beta)``: the
          window's residual, its norm, the zeroed f32 bases (``V``'s row 0
          the normalized residual), the f64 Hessenberg, rotations and
          ``g = β e₀``, and the lp-rounded row 0 split into the four fields
          (what the preconditioner sees);
        * ``step(V, Z, H, cs, sn, g, k, *z_pieces) -> (V, Z, H, cs, sn, g,
          *v_pieces, res)``: the coupled matvec of ``z``, its write into
          ``Z``, f32 CGS2 against ``V`` and the Givens update on the
          device;
        * ``precon_split(*v_pieces) -> z_pieces``: the block preconditioner
          on split fields.

        ``matvec``/``precon``/``basis_dtype`` are ignored then.  ``H`` and
        ``g`` are read back once per window, for the triangular solve.
    :param forecast: the convergence-forecast exit: once ≥ 60 iterations
        are in and even the best recent contraction rate cannot reach
        ``atol`` within 1.5× the remaining budget, finish the window and
        return the partial iterate with ``ok=False``
    :return: ``(x, iterations, ok)``
    """
    lp = basis_dtype
    if fused is not None:
        f_start, f_step, f_precon = fused
    x = torch.zeros_like(b)
    it = 0
    normb = read(torch.linalg.vector_norm(b), "mda.normb")
    if normb <= atol:
        return x, 0, True
    m = restart
    n = b.shape[0]
    if fused is None:
        V = torch.empty((m + 1, n), dtype=lp, device=b.device)
        Z = torch.empty((m, n), dtype=lp, device=b.device)
    beta_prev = None    # true residual at the previous restart
    stalled_in = False  # last window ended on the in-window plateau test
    hist = []           # estimated residual per iteration (forecast exit)
    doomed = False
    while it < maxiter:
        if fused is not None:
            out = f_start(x, b)
            V, Z, Hd, csd, snd, gd = out[:6]
            if V.shape[0] != m + 1:
                raise ValueError(
                    f"fused FGMRES programs were built for restart="
                    f"{V.shape[0] - 1}, called with restart={m} (a window "
                    f"mismatch would silently clamp the padded-buffer "
                    f"updates)")
            vp = out[6:-1]
            beta = read(out[-1], "mda.beta")   # the window's one read
        else:
            r = b - matvec(x)
            beta = read(torch.linalg.vector_norm(r), "mda.beta")
        if not np.isfinite(beta):
            return x, it, False     # inner solve diverged/NaN — fail fast
        if beta <= atol:
            return x, it, True
        if stalled_in and beta_prev is not None and beta > 0.98 * beta_prev:
            return x, it, False
        beta_prev = beta
        stalled_in = False
        if fused is None:
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
            if fused is not None:
                with span("mda.precon"):
                    zp = f_precon(*vp)
                out = f_step(V, Z, Hd, csd, snd, gd, k, *zp)
                V, Z, Hd, csd, snd, gd = out[:6]
                vp = out[6:-1]
                res = read(out[-1], "mda.res")    # the iteration's one read
            else:
                with span("mda.precon"):
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
                hfull = read(torch.cat([h1 + h2, nw[None]]), "mda.hcol")
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
        if fused is not None:
            # the rotated H and g live on the device: one read per window
            hg = np.array(read(torch.cat([Hd.reshape(-1), gd]), "mda.hg"))
            H, g = hg[:-(m + 1)].reshape(m + 1, m), hg[-(m + 1):]
        # Arnoldi breakdown guard: solve only the leading nonsingular block
        diag = np.abs(np.diag(H[:k_used, :k_used]))
        tol_d = max(1e-14 * diag.max(initial=0.0), 1e-300)
        bad = np.nonzero(diag <= tol_d)[0]
        if bad.size:
            k_used = int(bad[0])
            if k_used == 0:
                return x, it, False
        y = np.linalg.solve(np.triu(H[:k_used, :k_used]), g[:k_used])
        x = x + (Z[:k_used].T @ torch.as_tensor(y, dtype=Z.dtype,
                                                device=b.device)).to(x.dtype)
        if abs(g[k_used]) <= atol:
            return x, it, True
        if doomed:
            return x, it, False
    return x, it, False


def _two_rounds(mv64, pc_lp, chunk, b, mtol):
    """Best-effort mixed-precision solve of ``A x = b`` by the fixed
    two-round policy of the reference's fused preconditioner: twice a f64
    refinement pass (``r = b − A x``, ``rp = pc_lp(r)``) followed by one
    bounded f32 chunk to ``1e-5·‖rp‖``.  Once a pass's true residual meets
    the tolerance ``max(mtol·√n, max(mtol, 50ε)·‖b‖)``, the chunks that
    follow get a tolerance above every f32 residual and end before their
    first iteration.  That decision stays a device tensor: the chunk reads
    it together with its first residual norm, so the policy adds no host
    read to the chunks' own (one per GMRES iteration).

    :param mv64, pc_lp, chunk: a solver's ``_refinement_parts``
    :return: ``(x, f32 iterations)``
    """
    eps = float(torch.finfo(b.dtype).eps)
    norm = torch.linalg.vector_norm
    atol = torch.clamp_min(max(mtol, 50 * eps) * norm(b),
                           mtol * np.sqrt(b.shape[0]))
    zlp = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    x, xin = torch.zeros_like(b), zlp
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    its = 0
    for _ in range(2):
        x = x + xin.to(x.dtype)
        r = b - mv64(x)
        rp = pc_lp(r.to(torch.float32))
        done = done | (norm(r) <= atol)
        xin, info = chunk(rp, zlp, torch.where(done, _PC_BIG,
                                               _PC_RTOL * norm(rp)))[:2]
        its += info.iterations
    return x + xin.to(x.dtype), its


class BoussinesqMDA:
    """Coupled CD↔NS (Boussinesq) multidisciplinary solver.

    :param cd_comp / ns_comp: the two discipline components
    :param mode: 'GS' | 'NJ' | 'JNK' | 'PTC'
    :param mtol_nonlin: RMS tolerance of the coupled nonlinear residual
    :param AGi/AGr/AGc: Armijo-Goldstein line-search max iterations /
        contraction factor / slope factor (NJ mode)
    :param mtol_gmres: RMS tolerance of the coupled Krylov solve (JNK)
    :param restart: coupled GMRES restart (JNK)
    :param maxiter: nonlinear iteration cap (default 100 for JNK, 300 for
        PTC, else 1000)
    :param gmres_maxiter: coupled GMRES iteration cap per Newton step
    :param mtol_precon: RMS tolerance of the block-Jacobi preconditioner
        solves inside JNK's flexible GMRES (None = solver internal)
    :param mtol_subsolve: RMS tolerance of the Newton modes' iteration-0
        Gauss-Seidel sweep (None = solver internal tolerances)
    :param iprint: True ⇒ per-iteration residual lines
    :param forcing: inexact-Newton forcing factor η of the coupled JNK GMRES
        (atol = max(mtol_gmres·√DOF, η·‖F‖)); None = fixed tolerance
    :param device_krylov: ``True``: the JNK linear solves (and PTC's, up
        to :data:`PTC_DEVICE_MAX_DOF` coupled DOF) run as warm-started
        windows of :func:`sem_tpu_torch.krylov.fgmres` with float64 nested
        discipline solves (:meth:`_fgmres_device`); ``False``: the host
        FGMRES; ``None`` (default): the windows up to
        :data:`DEVICE_KRYLOV_MAX_DOF` coupled DOF, as in the reference
    :param fused: ``True`` or ``None`` (default): the host FGMRES takes the
        fused programs of :meth:`_fg_fused` (one fused step and one scalar
        read per iteration, CUDA graphs on a CUDA device) and, where
        :meth:`_pc_fused` applies, the fixed two-round preconditioner of
        :meth:`_build_pc_fused`: the reference's default
        (``SEM_TPU_FG_FUSED=1``, ``SEM_TPU_FUSED_PC=1``); ``False``: the
        un-fused host FGMRES with the adaptive block-Jacobi sweep
    :param ptc_dt0/ptc_growth/ptc_dt_max: initial pseudo-time step, SER
        growth cap per step and Δt ceiling (PTC)
    :param ptc_forcing: forcing factor of the PTC steps' coupled GMRES
        (atol = max(mtol_gmres·√DOF, ptc_forcing·‖F‖))
    :param precon: preconditioner of the coupled Krylov loop: ``'bj'`` (block
        Jacobi; default for JNK), ``'bgs'`` (block Gauss-Seidel: the CD
        solve's dT feeds the buoyancy block into the NS right-hand side, the
        coupling that dominates at high Ra; default for PTC) or ``'bgs2'``
        (symmetric: the CD block is solved again against the
        velocity-advection coupling of the NS update)
    :param checkpoint_path: ``.npz`` path the coupled iterate is written to
        every ``checkpoint_every`` accepted nonlinear iterations / PTC steps
        (resume with ``solve(load_checkpoint(...)[0])``)
    :param checkpoint_config: configuration stamp stored in the checkpoint
        and verified on load
    :param time_budget_s: wall-clock budget of one ``solve()``; when it is
        spent the iterate is checkpointed and ``RuntimeError`` raised before
        the next nonlinear iteration starts
    :param time_deadline: the same as an absolute ``time.monotonic()``
        timestamp shared across solves (continuation ladders build a fresh
        MDA per level)
    """

    def __init__(self, cd_comp: ConvectionDiffusionComponent,
                 ns_comp: NavierStokesComponent, mode: str = "JNK",
                 mtol_nonlin: float = 1e-9,
                 AGi: int = 8, AGr: float = 0.8, AGc: float = 0.2,
                 mtol_gmres: float = 1e-10, restart: int = 20,
                 maxiter: int = None, gmres_maxiter: int = 5000,
                 mtol_precon: float = 1e-4, mtol_subsolve: float = 1e-6,
                 iprint: bool = True, device_krylov: bool = None,
                 forcing: float = 1e-3,
                 ptc_dt0: float = 0.1, ptc_growth: float = 3.0,
                 ptc_dt_max: float = 1e12, ptc_forcing: float = 1e-2,
                 precon: str = None, checkpoint_path: str = None,
                 checkpoint_every: int = 5, checkpoint_config: dict = None,
                 time_budget_s: float = None, time_deadline: float = None,
                 fused: bool = None):
        if mode not in ("GS", "NJ", "JNK", "PTC"):
            raise ValueError("Unknown method")
        if precon is None:
            precon = "bgs" if mode == "PTC" else "bj"
        if precon not in ("bj", "bgs", "bgs2"):
            raise ValueError("precon must be 'bj', 'bgs' or 'bgs2'")
        self.precon_type = precon
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
            100 if mode == "JNK" else 300 if mode == "PTC" else 1000)
        self.forcing = None if forcing is None else float(forcing)
        self.ptc_dt0 = float(ptc_dt0)
        self.ptc_growth = float(ptc_growth)
        self.ptc_dt_max = float(ptc_dt_max)
        self.ptc_forcing = float(ptc_forcing)
        self.iprint = iprint
        if device_krylov is None:
            device_krylov = self.DOF <= DEVICE_KRYLOV_MAX_DOF
        self.device_krylov = bool(device_krylov)
        self.fused = True if fused is None else bool(fused)
        self._fg = None   # (start, step, lin): _fused_programs
        self._wops = None   # (shifts, lin, cd ops, ns ops): _window_ops
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_config = checkpoint_config or {}
        self.time_budget_s = (None if time_budget_s is None
                              else float(time_budget_s))
        self.time_deadline = (None if time_deadline is None
                              else float(time_deadline))
        self._t_start = None
        self._ptc_dt_current = None  # live PTC Δt, persisted in checkpoints
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

    def _linearize(self, s: CoupledState, sigma_cd: float = 0.0,
                   sigma_ns: float = 0.0):
        """Linearize both disciplines; the optional mass shifts (σ_T = Pe/Δt
        on the CD block, σ_v = Re/Δt on the NS velocity blocks) turn the
        coupled Jacobian into the pseudo-transient implicit-Euler one."""
        self.cd_comp.linearize(s.T, sigma=sigma_cd)
        self.ns_comp.linearize(s.u, s.v, sigma=sigma_ns)

    def _apply_linear(self, dx: torch.Tensor) -> torch.Tensor:
        dT, du, dv, dp = self._unpack(dx)
        drT = self.cd_comp.apply_linear(dT, du, dv)
        dru, drv, drp = self.ns_comp.apply_linear(du, dv, dp, dT)
        return self._pack(drT, dru, drv, drp)

    def _block_jacobi(self, r: torch.Tensor, mtol=None,
                      best_effort=False) -> torch.Tensor:
        """One linear block-Jacobi sweep: each discipline inverts its own
        Jacobian block; with ``precon_type`` ``'bgs'``/``'bgs2'`` the block
        Gauss-Seidel variants (class docstring).  ``best_effort``
        (preconditioner applications): block solves return their best
        iterate instead of escalating or raising."""
        return self._pack(*self._block_jacobi_split(
            *self._unpack(r), mtol=mtol, best_effort=best_effort))

    def _block_jacobi_split(self, rT, ru, rv, rp, mtol=None,
                            best_effort=False):
        """:meth:`_block_jacobi` on split fields: ``(dT, du, dv, dp)``."""
        dT = self.cd_comp.solve_linear(rT, mtol=mtol,
                                       best_effort=best_effort)
        if self.precon_type in ("bgs", "bgs2"):
            rv = self._bgs_rhs(dT, rv)
        du, dv, dp = self.ns_comp.solve_linear(ru, rv, rp, mtol=mtol,
                                               best_effort=best_effort)
        if self.precon_type == "bgs2":
            # with dT = 0 the CD tangent residual is exactly the
            # off-diagonal block J_{T,(u,v)}·(du, dv)
            corr = self.cd_comp.apply_linear(torch.zeros_like(rT), du, dv)
            dT = self.cd_comp.solve_linear(rT - corr, mtol=mtol,
                                           best_effort=best_effort)
        return dT, du, dv, dp

    def _bgs_rhs(self, dT, rv):
        """Block-Gauss-Seidel coupling RHS: forward the buoyancy block
        J_{v,T} = −(Gr/Re)·M (through the cross-mesh transfer) into the NS
        velocity RHS."""
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        dT_ns = apply_transfer(cd_s.grid, ns_s.grid, dT)
        return rv + ns_s._Gr_over_Re * ops.apply_mass(ns_s.grid, dT_ns)

    def _gs_sweep(self, s: CoupledState, mtol=None) -> CoupledState:
        """One nonlinear Gauss-Seidel sweep: CD first, then NS."""
        T = self.cd_comp.solve_nonlinear(s.u, s.v, T0=s.T, mtol=mtol)
        u, v, p = self.ns_comp.solve_nonlinear(T, u0=s.u, v0=s.v, p0=s.p,
                                               mtol=mtol)
        return CoupledState(T, u, v, p)

    def _print(self, tag, k, norm):
        if self.iprint:
            print(f"Boussinesq {tag}: {k}\t{norm}")

    def _maybe_checkpoint(self, s: CoupledState, k: int, force=False):
        """Persist the coupled iterate every ``checkpoint_every`` accepted
        nonlinear iterations (no-op unless ``checkpoint_path`` is set; under
        a process group rank 0 alone writes)."""
        if self.checkpoint_path and (force or k % self.checkpoint_every == 0):
            self.stats.cd_solves = self.cd_comp.iter_count_solve
            self.stats.ns_solves = self.ns_comp.iter_count_solve
            group = active_group()
            if group is not None and group.rank != 0:
                return    # the iterate is replicated: rank 0 writes it
            extras = ({"ptc_dt": float(self._ptc_dt_current)}
                      if self._ptc_dt_current is not None else None)
            save_checkpoint(self.checkpoint_path, s, self.checkpoint_config,
                            self.stats, extras=extras)

    def _check_budget(self, s: CoupledState, k: int, norm: float):
        """Graceful wall-clock-budget exit: checkpoint the iterate and raise
        before starting another nonlinear iteration (checked between
        iterations only)."""
        if self.time_deadline is not None:
            exhausted = time.monotonic() >= self.time_deadline
        elif self.time_budget_s is not None and self._t_start is not None:
            exhausted = (time.monotonic() - self._t_start
                         >= self.time_budget_s)
        else:
            return
        if exhausted:
            self.stats.nonlinear_iters = k
            # saved even where the cadence has just saved this iterate: that
            # save holds no iteration count (``stats.nonlinear_iters`` is set
            # only here and at convergence)
            self._maybe_checkpoint(s, k, force=True)
            where = (f"; state checkpointed to {self.checkpoint_path}"
                     if self.checkpoint_path else "")
            raise RuntimeError(
                f"Boussinesq {self.mode}: wall-clock budget exhausted "
                f"after {k} iterations at residual {norm:.3e} (target "
                f"{self.atol_nonlin:.3e}){where}")

    # ------------- fused host FGMRES and on-device windows ------------- #
    def _build_fg_fused(self):
        """The fused programs of the host FGMRES (see :func:`_fgmres`
        ``fused``) as eager functions of explicit tensors: ``start(x, b,
        *lin)`` and ``step(V, Z, H, cs, sn, g, k, zT, zu, zv, zp, *lin)``,
        ``lin = (cd_u, cd_v, cd_jdu, cd_jdv, ns_ul, ns_vl, jxx, jxy, jyx,
        jyy, cd_sigma)`` the linearization (σ a 0-d f64 tensor).  ``step``
        updates the bases, ``H``, the rotations and ``g`` in place: the
        coupled f64 matvec, the flexible-basis write, f32 CGS2 (TF32 is
        off) and the Givens update with
        :func:`sem_tpu_torch.krylov._givens_update_device`.  Nothing is read
        back inside either, so a CUDA graph captures each
        (:meth:`_fused_programs`, ``k`` a 0-d tensor); on the CPU they run as
        they are (``k`` an int, CGS2 on the live rows of ``V``)."""
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        Ncd, Nns = self.N_cd, self.N_ns
        m = self.restart
        lp, hdt = torch.float32, torch.float64

        def split(v):
            return (v[:Ncd], v[Ncd:Ncd + Nns], v[Ncd + Nns:Ncd + 2 * Nns],
                    v[Ncd + 2 * Nns:])

        def mv(zT, zu, zv, zp, cd_u, cd_v, cd_jdu, cd_jdv, ns_ul, ns_vl,
               jxx, jxy, jyx, jyy, cd_sigma):
            du_cd = apply_transfer(ns_s.grid, cd_s.grid, zu)
            dv_cd = apply_transfer(ns_s.grid, cd_s.grid, zv)
            dT_ns = apply_transfer(cd_s.grid, ns_s.grid, zT)
            drT = cd_s._tangent(zT, cd_u, cd_v, cd_jdu, cd_jdv, du_cd, dv_cd,
                                cd_sigma)
            dru, drv, drp = ns_s._tangent(zu, zv, zp, dT_ns, ns_ul, ns_vl,
                                          (jxx, jxy, jyx, jyy))
            return torch.cat([drT, dru, drv, drp])

        def start(x, b, *lin):
            r = b - mv(*split(x), *lin)
            beta = torch.linalg.vector_norm(r)
            # the preconditioner sees the lp-rounded basis row, as on the
            # un-fused path
            v0 = torch.where(beta > 0.0, r / torch.clamp_min(beta, 1e-300),
                             0.0).to(lp)
            n, dev = b.shape[0], b.device
            V = torch.zeros((m + 1, n), dtype=lp, device=dev)
            V[0] = v0
            Z = torch.zeros((m, n), dtype=lp, device=dev)
            H = torch.zeros((m + 1, m), dtype=hdt, device=dev)
            cs = torch.ones(m, dtype=hdt, device=dev)   # identity slots
            sn = torch.zeros(m, dtype=hdt, device=dev)
            g = torch.zeros(m + 1, dtype=hdt, device=dev)
            g[0] = beta
            return (V, Z, H, cs, sn, g) + split(v0.to(b.dtype)) + (beta,)

        def step(V, Z, H, cs, sn, g, k, zT, zu, zv, zp, *lin):
            kt = torch.as_tensor(k, device=V.device)
            w = mv(zT, zu, zv, zp, *lin)
            Z.index_copy_(0, kt.reshape(1),
                          torch.cat([zT, zu, zv, zp]).to(lp)[None])
            # CGS2: off the card on the live rows 0..k, the un-fused loop's
            # bits; on the card on the whole zero-padded V, whose rows past
            # k add nothing, so that the captured graph (whose shapes
            # cannot follow k) and an eager call run the same shapes
            Vk = V if V.is_cuda else V[:k + 1]
            wl = w.to(lp)
            h1 = Vk @ wl
            wl = wl - Vk.T @ h1
            h2 = Vk @ wl
            wl = wl - Vk.T @ h2
            nw = torch.linalg.vector_norm(wl)
            vk1 = torch.where(nw > 1e-30, wl / torch.clamp_min(nw, 1e-30),
                              0.0)
            V.index_copy_(0, (kt + 1).reshape(1), vk1[None])
            # the Hessenberg column: projections 0..k (zero past k), the
            # subdiagonal ‖w‖ at k+1; rotations in f64
            h = torch.zeros(m + 1, dtype=hdt, device=V.device)
            h[:Vk.shape[0]] = h1 + h2
            hcol = torch.where(torch.arange(m + 1, device=V.device) == kt + 1,
                               nw.to(hdt), h)
            hrot, cs_, sn_, g_, res = _givens_update_device(hcol, cs, sn, g,
                                                            kt, m)
            H.index_copy_(1, kt.reshape(1), hrot[:, None])
            cs.copy_(cs_)
            sn.copy_(sn_)
            g.copy_(g_)
            return (V, Z, H, cs, sn, g) + split(vk1.to(zT.dtype)) + (res,)

        return start, step

    def _fused_programs(self, lin):
        """The programs of :meth:`_build_fg_fused` as two
        :class:`sem_tpu_torch.krylov.CapturedProgram` (prefix ``mda``) on
        ``lin_s``, a copy of the linearization ``lin`` that
        :meth:`_fg_fused` binds anew for each linearization: ``(start,
        step, lin_s)``.  On a CUDA device both are captured here, ``step``
        on ``start``'s own outputs (V, Z, H, cs, sn and g are never copied)
        and a 0-d ``k``, into ``start``'s pool."""
        start, step = (CapturedProgram(f, "mda")
                       for f in self._build_fg_fused())
        lin_s = tuple(t.clone() for t in lin)
        if self.device.type == "cuda":
            def zeros(*shape, dtype=torch.float64):
                return torch.zeros(shape, dtype=dtype, device=self.device)

            start.capture(zeros(self.DOF), zeros(self.DOF), *lin_s)
            if start.graph is not None:
                step.pool = start.pool
                step.capture(*start.out[:6], zeros(dtype=torch.int64),
                             *(zeros(n) for n in
                               (self.N_cd,) + (self.N_ns,) * 3), *lin_s)
        return start, step, lin_s

    def _fg_fused(self, mtol=None, best_effort=True):
        """Bind the fused host-FGMRES programs to the current linearization:
        the ``(start, step, precon_split)`` triple of :func:`_fgmres`.
        ``start`` and ``step`` are :meth:`_fused_programs`, made on the
        first call; each call copies the linearization into their static
        copy of it.  ``precon_split`` is the fused preconditioner
        (:meth:`_pc_fused`) where it applies and ``best_effort``, else
        :meth:`_block_jacobi_split`."""
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        lin = (cd_s._u, cd_s._v, cd_s._jac_diag_u, cd_s._jac_diag_v,
               ns_s._u_lin, ns_s._v_lin, *ns_s._jac,
               torch.tensor(cd_s._sigma, dtype=torch.float64,
                            device=self.device))
        if self._fg is None:
            self._fg = self._fused_programs(lin)
        else:
            for dst, src in zip(self._fg[2], lin):
                dst.copy_(src)
        startp, stepp, lin_s = self._fg

        def start(x, b):
            return startp(x, b, *lin_s)

        def step(*a):
            return stepp(*a, *lin_s)

        precon_split = self._pc_fused(mtol=mtol) if best_effort else None
        if precon_split is None:
            def precon_split(rT, ru, rv, rp):
                return self._block_jacobi_split(rT, ru, rv, rp, mtol=mtol,
                                                best_effort=best_effort)

        return start, step, precon_split

    def _build_pc_fused(self, k_inner: int):
        """The fused block-Jacobi/BGS preconditioner at the current
        linearization: ``pc_apply(rT, ru, rv, rp, mtol_cd, mtol_ns) -> (dT,
        du, dv, dp, its_cd, its_ns)``.

        For preconditioner applications the reference replaces the adaptive
        refinement loop (plateau detection, learned floors, escalation) by a
        fixed policy, since a flexible outer FGMRES tolerates any inexact
        application: per discipline, two rounds of (f64 refinement pass → one
        bounded f32 chunk), :func:`_two_rounds`, on the chunks of the
        solvers' ``_refinement_parts`` (CD: kernel B1; NS: kernel B2, the
        plain left-preconditioned chunks for ``k_inner = 0``, the row-scaled
        flexible ones with ``k_inner`` inner velocity steps otherwise).
        ``'bgs'`` forwards the buoyancy block into the NS right-hand side,
        ``'bgs2'`` then solves the CD block again.  The chunks' GMRES stays
        host-driven (one read per iteration); the policy adds no read."""
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        Nns = self.N_ns
        cd_parts = cd_s._refinement_parts()
        ns_parts = ns_s._refinement_parts(k_inner)

        def pc_apply(rT, ru, rv, rp, mtol_cd, mtol_ns):
            dT, its_cd = _two_rounds(*cd_parts, rT, mtol_cd)
            if self.precon_type in ("bgs", "bgs2"):
                rv = self._bgs_rhs(dT, rv)
            xn, its_ns = _two_rounds(*ns_parts, torch.cat([ru, rv, rp]),
                                     mtol_ns)
            du, dv, dp = xn[:Nns], xn[Nns:2 * Nns], xn[2 * Nns:]
            if self.precon_type == "bgs2":
                corr = self.cd_comp.apply_linear(torch.zeros_like(rT), du, dv)
                dT, its2 = _two_rounds(*cd_parts, rT - corr, mtol_cd)
                its_cd += its2
            return dT, du, dv, dp, its_cd, its_ns

        return pc_apply

    def _pc_fused(self, mtol=None):
        """Bind the fused preconditioner (:meth:`_build_pc_fused`) to the
        current linearization as ``precon_split(rT, ru, rv, rp)``, or None
        where it does not apply: an NS linear solver other than
        ``'coupled'``, or either solver not mixed precision.  Each
        application counts one linear solve of each discipline."""
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        if (ns_s._linear_solver != "coupled" or not ns_s._mixed_precision
                or not cd_s._mixed_precision):
            return None
        pc_apply = self._build_pc_fused(ns_s._velo_inner)
        mtol_cd = cd_s._mtol if mtol is None else mtol
        mtol_ns = ns_s._mtol if mtol is None else mtol

        def precon_split(rT, ru, rv, rp):
            out = pc_apply(rT, ru, rv, rp, mtol_cd, mtol_ns)
            self.cd_comp.iter_count_solve += 1
            self.ns_comp.iter_count_solve += 1
            return out[:4]

        return precon_split

    def _window_ops(self):
        """The nested solves' operators of :meth:`_window_precon`: the CD
        and NS ``_ops64`` (the NS ones None under ``'uzawa'``), captured,
        on a copy of the linearization made at the first call and at each
        change of the mass shifts; every other call copies the current
        linearization into it, so that one CUDA graph of each serves all
        of the MDA's coupled linear solves at those shifts."""
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        uzawa = ns_s._linear_solver == "uzawa"
        shifts = (cd_s._sigma, ns_s._sigma)
        lin = (cd_s._u, cd_s._v) + (
            () if uzawa else (ns_s._u_lin, ns_s._v_lin, *ns_s._jac))
        if self._wops is None or self._wops[0] != shifts:
            lin_s = tuple(t.clone() for t in lin)
            cd_ops = cd_s._ops64(cd_s._sigma, captured=True, lin=lin_s[:2])
            ns_ops = (None if uzawa
                      else ns_s._ops64(captured=True, lin=lin_s[2:]))
            self._wops = (shifts, lin_s, cd_ops, ns_ops)
        else:
            for dst, src in zip(self._wops[1], lin):
                dst.copy_(src)
        return self._wops[2:]

    def _window_precon(self):
        """The preconditioner of the device windows at the current
        linearization: the disciplines' float64 solves from zero at
        ``mtol_precon`` (the CD ``_update_f64``, the ``'bgs'`` buoyancy
        right-hand side, the NS ``_update_coupled_f64`` or, under
        ``'uzawa'``, ``_update_uzawa``, and the ``'bgs2'`` CD re-solve), as
        the reference's on-device window nests them.  Float64 throughout:
        it launches no kernel.  The nested solves' operators are
        :meth:`_window_ops`, each one CUDA graph on the card
        (:class:`sem_tpu_torch.krylov.CapturedOperator`: the host launches
        a graph where it launched their dozens of operations), and their
        bases start at :data:`PRECON_BASIS_ROWS` rows.  The nested solves'
        GMRES iterations are counted under ``mda.window_precon.cd_its``
        (both CD solves of ``'bgs2'``) and ``mda.window_precon.ns_its``
        (under ``'uzawa'`` the pressure-Schur GMRES's)."""
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        Nns = self.N_ns
        mtol_cd = cd_s._mtol if self.mtol_precon is None else self.mtol_precon
        mtol_ns = ns_s._mtol if self.mtol_precon is None else self.mtol_precon
        f64 = torch.float64
        zcd = torch.zeros(self.N_cd, dtype=f64, device=self.device)
        zns = torch.zeros(Nns, dtype=f64, device=self.device)
        cd_ops, ns_ops = self._window_ops()

        def pc(r):
            with span("mda.precon"):
                return pc_apply(r)

        def cd_solve(rhs):
            dT, info = cd_s._update_f64(rhs, zcd, mtol_cd, cd_s._sigma,
                                        ops=cd_ops,
                                        basis_rows=PRECON_BASIS_ROWS)
            COUNTERS["mda.window_precon.cd_its"] += info.iterations
            return dT

        def pc_apply(r):
            rT, ru, rv, rp = self._unpack(r)
            dT = cd_solve(rT)
            if self.precon_type in ("bgs", "bgs2"):
                rv = self._bgs_rhs(dT, rv)
            if ns_ops is None:
                du, dv, dp, info, _ = ns_s._update_uzawa(ru, rv, rp, zns,
                                                         mtol_ns)
            else:
                q, info = ns_s._update_coupled_f64(
                    torch.cat([ru, rv, rp]), zns, mtol_ns, ops=ns_ops,
                    basis_rows=PRECON_BASIS_ROWS)
                du, dv, dp = q[:Nns], q[Nns:2 * Nns], q[2 * Nns:]
            COUNTERS["mda.window_precon.ns_its"] += info.iterations
            if self.precon_type == "bgs2":
                corr = self.cd_comp.apply_linear(torch.zeros_like(rT), du, dv)
                dT = cd_solve(rT - corr)
            return torch.cat([dT, du, dv, dp])

        return pc

    def _jnk_window(self, x, b, atol, window, precon):
        """One device window: ``window`` iterations of
        :func:`sem_tpu_torch.krylov.fgmres` on the coupled tangent system
        from ``x`` (the counterpart of the reference's ``_build_jnk_cycle``
        program).  Returns ``(x, KrylovInfo, hist)``."""
        return fgmres(self._apply_linear, b, x0=x, atol=atol,
                      restart=self.restart, maxiter=window, precon=precon,
                      return_hist=True)

    def _fgmres_device(self, b, atol=None, maxiter=None):
        """Drive windows of :func:`sem_tpu_torch.krylov.fgmres` on the
        coupled tangent system until converged, each ``min(restart,
        FUSED_WINDOW)`` iterations long and warm-started at the last
        iterate, preconditioned by :meth:`_window_precon`.

        The reference compiles each window, nested discipline solves
        included, into one XLA program (one dispatch per window).  The
        nested solves here stop on their data (a host read per inner
        iteration), so a window is no single graph: the algorithm is the
        reference's, the dispatch is per operation.

        Each window is one span ``mda.window`` and one count of the
        counter ``mda.windows``.

        Exits: converged; stalled or an empty window (accepted: the Newton
        loop's test on the true residual decides); two flat windows in a
        row (< 2 % each); the iteration cap.

        :param maxiter: per-call iteration cap overriding ``gmres_maxiter``
        :return: ``(x, iterations, ok, resnorm)``, ``resnorm`` the last
            window's true residual
        """
        atol = self.atol_gmres if atol is None else atol
        cap = self.gmres_maxiter if maxiter is None else maxiter
        window = min(self.restart, FUSED_WINDOW)
        pc = self._window_precon()
        x = torch.zeros_like(b)
        total = 0
        prev_res = None
        flat_windows = 0
        while True:
            COUNTERS["mda.windows"] += 1
            with span("mda.window"):
                x, info, hist = self._jnk_window(x, b, atol, window, pc)
            done = info.iterations
            if self.iprint:
                for j, h in enumerate(hist[:done].tolist()):
                    print(f"   JNK GMRES: {total + j + 1}\t{h}")
            total += done
            # block preconditioner applications = discipline solves
            self.cd_comp.iter_count_solve += done
            self.ns_comp.iter_count_solve += done
            res = info.resnorm
            if info.converged:
                return x, total, True, res
            if info.stalled or done == 0:
                if self.iprint:
                    print(f"   JNK GMRES: stalled at resnorm {res:.3e} "
                          f"(roundoff plateau)")
                return x, total, True, res
            if prev_res is not None and res > 0.98 * prev_res:
                flat_windows += 1
                if flat_windows >= 2:
                    if self.iprint:
                        print(f"   JNK GMRES: stalled at resnorm {res:.3e} "
                              f"(cross-window plateau)")
                    return x, total, True, res
            else:
                flat_windows = 0
            prev_res = res
            if total >= cap:
                return x, total, False, res

    # --------------------------- modes --------------------------- #
    @torch.no_grad()
    def solve(self, s0: CoupledState = None) -> CoupledState:
        f64 = torch.float64
        zcd = torch.zeros(self.N_cd, dtype=f64, device=self.device)
        zns = torch.zeros(self.N_ns, dtype=f64, device=self.device)
        s = s0.copy() if s0 is not None else CoupledState(zcd, zns, zns, zns)
        self.stats = MDAStats()
        self._t_start = time.monotonic()
        warm = s0 is not None
        if self.mode == "GS":
            s = self._solve_gs(s)
        elif self.mode == "PTC":
            s = self._solve_ptc(s)
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
            norm = read(torch.linalg.vector_norm(self._residuals(s)),
                        "mda.norm")
            self._print("GS", k, norm)
            self.stats.nonlinear_iters = k
            if norm <= self.atol_nonlin:
                return s
            self._maybe_checkpoint(s, k)
            self._check_budget(s, k, norm)
        raise RuntimeError(
            f"Boussinesq GS: no convergence in {self.maxiter} iterations")

    def _solve_newton(self, s: CoupledState, krylov: bool,
                      warm: bool = False) -> CoupledState:
        # iteration-0 subsystem sweep, run loosely (mtol_subsolve); a warm
        # start already at least as good as its target skips it
        if warm:
            norm0 = read(torch.linalg.vector_norm(self._residuals(s)),
                         "mda.norm")
            if norm0 > self.mtol_subsolve * np.sqrt(self.DOF):
                with span("mda.sweep"):
                    s = self._gs_sweep(s, mtol=self.mtol_subsolve)
        else:
            with span("mda.sweep"):
                s = self._gs_sweep(s, mtol=self.mtol_subsolve)
        F = self._residuals(s)
        norm = read(torch.linalg.vector_norm(F), "mda.norm")
        for k in range(1, self.maxiter + 1):
            self._print("NEWTON", k - 1, norm)
            if norm <= self.atol_nonlin:
                self.stats.nonlinear_iters = k - 1
                return s
            self._check_budget(s, k - 1, norm)
            with span("mda.newton"):
                s, F, norm = self._newton_step(s, F, norm, krylov)
            self._maybe_checkpoint(s, k)
        raise RuntimeError(
            f"Boussinesq NEWTON: no convergence in {self.maxiter} iterations")

    def _newton_step(self, s: CoupledState, F, norm: float, krylov: bool):
        """One nonlinear iteration of :meth:`_solve_newton`: linearize at
        ``s``, solve the coupled tangent system (JNK: flexible GMRES; NJ: one
        block-Jacobi sweep) and take the step (NJ: Armijo-Goldstein
        backtracking).  Returns the new ``(s, F, norm)``."""
        with span("mda.linearize"):
            self._linearize(s)
        if krylov:
            atol_k = self.atol_gmres
            if self.forcing is not None:
                atol_k = max(atol_k, self.forcing * norm)
            with span("mda.fgmres"):
                if self.device_krylov:
                    dx, iters, ok, _ = self._fgmres_device(-F, atol=atol_k)
                else:
                    dx, iters, ok = _fgmres(
                        self._apply_linear,
                        lambda r: self._block_jacobi(
                            r, mtol=self.mtol_precon, best_effort=True),
                        -F, atol=atol_k, restart=self.restart,
                        maxiter=self.gmres_maxiter,
                        callback=(lambda it, res: print(
                            f"   JNK GMRES: {it}\t{res}")) if self.iprint
                        else None,
                        fused=(self._fg_fused(mtol=self.mtol_precon)
                               if self.fused else None))
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
        return s_new, F_new, norm_new

    def _solve_ptc(self, s: CoupledState) -> CoupledState:
        """Pseudo-transient continuation: globally convergent steady solve
        for regimes where the from-zero Newton/JNK iteration fails (from-zero
        coupled solves diverge above Ra ≈ 1e4, and the block-Jacobi-
        preconditioned coupled GMRES flat-lines at Ra = 1e5).

        Each step solves the lagged-Jacobian implicit-Euler system
        ``(J + S(Δt)) δ = −F(x)`` with the block-diagonal mass shift
        ``S = diag(Pe/Δt·M_cd, Re/Δt·M_ns, Re/Δt·M_ns, 0)`` (continuity and
        Dirichlet rows unshifted), reusing the JNK machinery: the shift rides
        in the solvers' Jacobian diagonals (GLL mass is diagonal) and every
        preconditioner matches it spectrally (FDM ``1/(λ+σ)`` diagonals,
        spectral Schur ``(λ̂+σ)/ε`` modes), so the coupled tangent systems
        are block-diagonally dominant exactly when the steady ones are
        intractable.  The Δt schedule is the shared
        :class:`sem_tpu_torch.ptc.SERController`.  As Δt→∞ the step is exact
        Newton, so convergence is tested on the unchanged steady residual
        and the result meets the same tolerances as JNK.
        """
        Pe = self.cd_comp.cd._Pe
        Re = self.ns_comp.ns._Re
        ctrl = SERController(self.ptc_dt0, growth=self.ptc_growth,
                             dt_max=self.ptc_dt_max)
        F = self._residuals(s)
        norm = read(torch.linalg.vector_norm(F), "mda.norm")
        linfail_rejects = 0
        collapsed = ("Boussinesq PTC: pseudo-time step collapsed at residual "
                     "{:.3e} (target " + f"{self.atol_nonlin:.3e})")
        for k in range(1, self.maxiter + 1):
            dt = ctrl.dt
            self._ptc_dt_current = dt   # persisted by _maybe_checkpoint
            self._print("PTC", k - 1, f"{norm}\tdt={dt:.3g}")
            if norm <= self.atol_nonlin:
                self.stats.nonlinear_iters = k - 1
                return s
            self._check_budget(s, k - 1, norm)
            with span("mda.ptc_step"):
                with span("mda.linearize"):
                    self._linearize(s, sigma_cd=Pe / dt, sigma_ns=Re / dt)
                atol_k = max(self.atol_gmres, self.ptc_forcing * norm)
                # bound the per-step linear effort: a hard tangent system
                # (large Δt) returns a partial step instead of grinding; the
                # smaller contraction feeds back through SER, so Δt
                # equilibrates against what the coupled solver can crack
                # cheaply
                step_maxiter = min(self.gmres_maxiter, 12 * self.restart)
                with span("mda.fgmres"):
                    dx, iters, lin_res = self._ptc_linear_solve(
                        F, atol_k, step_maxiter)
                self.stats.gmres_iters += iters
                lin_failed = lin_res > 10 * atol_k
                s_new, F_new, norm_new = self._try_step(s, dx, 1.0)
                if (not np.isfinite(norm_new)
                        or norm_new > 1e3 * max(norm, 1.0)):
                    # genuine blowup: reject, damp hard, re-solve about
                    # the same x
                    self._count_ptc("rejects.blowup")
                    if not ctrl.reject_blowup():
                        raise RuntimeError(collapsed.format(norm))
                    continue
                if lin_failed and norm_new > norm and linfail_rejects < 3:
                    # the update did not solve the implicit-Euler system AND
                    # it raised the residual: not a pseudo-time step;
                    # re-solve about the same state at smaller Δt (after 3
                    # rejections in a row fall back to SER's always-accept,
                    # so a rough transient cannot deadlock)
                    linfail_rejects += 1
                    self._count_ptc("rejects.linfail")
                    if not ctrl.reject_linfail():
                        raise RuntimeError(collapsed.format(norm))
                    continue
                linfail_rejects = 0
                ctrl.accept(norm, norm_new, lin_failed)
                self._count_ptc("accepted")
                if lin_failed:
                    self._count_ptc("partial")
                s, F, norm = s_new, F_new, norm_new
            self._maybe_checkpoint(s, k)
        raise RuntimeError(
            f"Boussinesq PTC: no convergence in {self.maxiter} iterations")

    def _ptc_linear_solve(self, F, atol_k: float, maxiter: int):
        """One PTC step's coupled linear solve of ``J_σ dx = −F``, bounded by
        ``maxiter``: ``(dx, iterations, ‖−F − J_σ dx‖)``."""
        if self.device_krylov and self.DOF <= PTC_DEVICE_MAX_DOF:
            dx, iters, _, lin_res = self._fgmres_device(
                -F, atol=atol_k, maxiter=maxiter)
            return dx, iters, lin_res
        fused = (self._fg_fused(mtol=self.mtol_precon) if self.fused
                 else None)
        dx, iters, _ = _fgmres(
            self._apply_linear,
            lambda r: self._block_jacobi(r, mtol=self.mtol_precon,
                                         best_effort=True),
            -F, atol=atol_k, restart=self.restart, maxiter=maxiter,
            callback=(lambda it, res: print(
                f"   PTC GMRES: {it}\t{res}")) if self.iprint else None,
            fused=fused, forecast=True)
        if fused is not None:
            # the fused window start computes exactly ‖b − A·x‖
            lin_res = read(fused[0](dx, -F)[-1], "mda.linres")
        else:
            lin_res = read(torch.linalg.vector_norm(
                -F - self._apply_linear(dx)), "mda.linres")
        return dx, iters, lin_res

    def _count_ptc(self, what: str):
        """Count one PTC step attempt, ``what`` one of :data:`_PTC_STATS`,
        under ``ptc.<what>`` of the program's counters and in :attr:`stats`
        (the caller counts a partial step as ``'accepted'``, then as
        ``'partial'``)."""
        COUNTERS["ptc." + what] += 1
        name = _PTC_STATS[what]
        setattr(self.stats, name, getattr(self.stats, name) + 1)

    def _try_step(self, s, dx, alpha):
        with span("mda.step"):
            dT, du, dv, dp = self._unpack(alpha * dx)
            s_new = CoupledState(s.T + dT, s.u + du, s.v + dv, s.p + dp)
            F_new = self._residuals(s_new)
            return s_new, F_new, read(torch.linalg.vector_norm(F_new),
                                      "mda.norm")
