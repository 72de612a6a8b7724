"""Offline coupled-saddle preconditioner diagnostics (real wind, true norm),
on the port.

Counterpart of the JAX package's ``study/coupled_pc_diag.py``, which does
its work at import; here it runs under :func:`main`, at the module
constants ``P``, ``Ne``, ``Re``.  Measures FGMRES iteration counts on the
FULL coupled Newton saddle system under production-style block
upper-triangular preconditioners, linearized at the ACTUAL converged Re=400
lid-cavity solution (the port's ``NavierStokesSolver`` on ``--device``),
with a CONSISTENT smooth RHS ``b = J x_smooth``.  The blocks are host SciPy
(:func:`sem_tpu_torch.study.schur_spectrum.build_blocks`).

**The RHS choice is load-bearing**: with a raw random ``b`` every candidate
appears to stall near rel ~3e-3–1 (pcd and augmented-Lagrangian at "no
progress"), because a random RHS excites rough / near-spurious components
that actual Newton residuals never contain.  With the consistent RHS the
same candidates converge and rank completely differently.

Findings of the JAX package's study at Re=400, P=8 8x8, rtol 1e-6
(consistent RHS): spectral + plain FDM velocity apply 1000 its (rel
4.7e-6); spectral + GMRES(5)-FDM inner velocity 376 its (rel 9.4e-7, the
win); GMRES(20) 382 its; pcd Schur 1000 its (rel 8.5e-5); augmented
Lagrangian γ=0.3 961 its, γ=1 diverges.  Hence the flexible coupled loop
with ~5 inner velocity iterations per preconditioner application
(``velo_inner``) and the spectral Schur block, not a Schur-block swap and
not AL.

Usage::

    python -m sem_tpu_torch.study.coupled_pc_diag [--synthetic]
        [--random-rhs] [--device cpu]

``--synthetic``: an O(1) vortex wind instead of the converged solution (no
solve, no device); ``--random-rhs``: reproduce the misleading random-RHS
numbers.
"""
import argparse

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from sem_tpu_torch.study.schur_spectrum import build_blocks

P, Ne, Re = 8, 8, 400.0


def converged_wind(grid, device):
    """(u, v) of the converged lid-driven cavity at ``Re`` on ``grid``'s
    configuration, solved by the port's NS solver on ``device``."""
    import torch

    from sem_tpu_torch import NavierStokesSolver

    ns = NavierStokesSolver(1.0, 1.0, Re=Re, Gr=0.0, P=grid.P,
                            N_ex=grid.N_ex, N_ey=grid.N_ey, u_N=1.0,
                            iprint=[], device=device)
    u, v, _ = ns._get_solution(torch.zeros(grid.N, dtype=torch.float64,
                                           device=device))
    return u.cpu().numpy(), v.cpu().numpy()


def _e_pencil(G1, m1):
    Ex = G1.T @ np.diag(1.0 / m1) @ G1
    s = 1.0 / np.sqrt(m1)
    A1 = (Ex * s[:, None]) * s[None, :]
    A1 = 0.5 * (A1 + A1.T)
    lam, Q = scipy.linalg.eigh(A1)
    return lam, s[:, None] * Q


class Blocks:
    """The coupled Jacobian blocks at the wind ``(u, v)`` and the candidate
    Schur blocks, velocity solves and preconditioners."""

    def __init__(self, grid, u, v):
        self.grid = grid
        self.N = grid.N
        (self.A, self.G, self.B, self.C, self.K, self.mb,
         self.pin) = build_blocks(grid, Re=Re, u=u, v=v)
        self.md, self.sd = grid.mass_diag, grid.stiff_diag
        # diffusion-only velocity block (what the production FDM inverts)
        Kd = build_blocks(grid, Re=Re, u=None, v=None)[0]
        self.lu_Kd = spla.splu(Kd.tocsc())

        # spectral Schur block (+ boundary-ring elimination), as production
        ex, self.Zx = _e_pencil(grid.G1x, grid.m1x)
        ey, self.Zy = _e_pencil(grid.G1y, grid.m1y)
        lx = np.einsum("ij,ik,kj->j", self.Zx, grid.K1x, self.Zx)
        ly = np.einsum("ij,ik,kj->j", self.Zy, grid.K1y, self.Zy)
        esum = ex[:, None] + ey[None, :]
        ksum = lx[:, None] + ly[None, :]
        scale = np.max(np.abs(esum))
        self.ginv = np.where(np.abs(esum) > 1e-14 * scale, ksum / esum, 0.0)
        self.ib = np.where(self.mb)[0]
        self.K_bb_inv = np.linalg.inv(
            self.K[np.ix_(self.ib, self.ib)].toarray())

        # pcd Schur block (production-equivalent formulation)
        Gxp = sp.kron(sp.csr_matrix(grid.G1x), sp.diags(grid.m1y)).tocsr()
        Gyp = sp.kron(sp.diags(grid.m1x), sp.csr_matrix(grid.G1y)).tocsr()
        self.Fp = (self.K + Re * (sp.diags(u) @ Gxp
                                  + sp.diags(v) @ Gyp)).tocsr()
        Kpin = self.K.tolil(copy=True)
        ip = int(np.where(self.pin)[0][0])
        Kpin[ip, :] = 0.0
        Kpin[ip, ip] = 1.0
        self.lup = spla.splu(Kpin.tocsc())

    def J_mv(self, q):
        N2 = 2 * self.N
        du, dp = q[:N2], q[N2:]
        return np.concatenate([self.A @ du + self.G @ dp,
                               self.B @ du + self.C @ dp])

    def shat_spec(self, rp):
        mb, pin, ib, g = self.mb, self.pin, self.ib, self.grid
        r_int = np.where(mb | pin, 0.0, rp).reshape(g.Ngx, g.Ngy)
        dp = (self.Zx @ (self.ginv * (self.Zx.T @ r_int @ self.Zy))
              @ self.Zy.T).reshape(-1)
        dp = np.where(mb, rp / self.sd, dp)
        dp_b = self.K_bb_inv @ (rp[ib] - (self.K[ib]
                                          @ np.where(mb, 0.0, dp)))
        dp = dp.copy()
        dp[ib] = dp_b
        return np.where(pin, rp, dp)

    def shat_pcd(self, rp):
        mb, pin = self.mb, self.pin
        t = self.lup.solve(np.where(mb | pin, 0.0, rp))
        dp = (self.Fp @ t) / self.md
        dp = np.where(mb, rp / self.sd, dp)
        return np.where(pin, rp, dp)

    def velo_gmres(self, b2, steps):
        """``steps`` of FDM(diffusion)-right-preconditioned GMRES on the
        TRUE Newton velocity block: the flexible inner solve a production
        candidate would run (nonlinear per application, so FGMRES
        outer)."""
        xg = np.zeros(2 * self.N)
        r = b2.copy()
        beta = np.linalg.norm(r)
        if beta == 0:
            return xg
        V = [r / beta]
        Zs = []
        m = steps
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.zeros(m)
        sn = np.zeros(m)
        kk = 0
        for k in range(m):
            z = self.lu_Kd.solve(V[k])
            w = self.A @ z
            Zs.append(z)
            for j in range(k + 1):
                H[j, k] = V[j] @ w
                w = w - H[j, k] * V[j]
            H[k + 1, k] = np.linalg.norm(w)
            V.append(w / max(H[k + 1, k], 1e-300))
            for j in range(k):
                t1 = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                t2 = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                H[j, k], H[j + 1, k] = t1, t2
            d = np.hypot(H[k, k], H[k + 1, k])
            cs[k], sn[k] = H[k, k] / d, H[k + 1, k] / d
            H[k, k] = d
            H[k + 1, k] = 0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            kk = k + 1
        yv = np.linalg.solve(np.triu(H[:kk, :kk]), g[:kk])
        return np.stack(Zs[:kk], axis=1) @ yv

    def make_pc(self, shat, vsteps=0):
        N2 = 2 * self.N

        def pc(r):
            ru2, rp = r[:N2], r[N2:]
            dp = shat(rp)
            b2 = ru2 - (self.G @ dp)
            duv = (self.lu_Kd.solve(b2) if vsteps == 0
                   else self.velo_gmres(b2, vsteps))
            return np.concatenate([duv, dp])
        return pc

    def make_al_pc(self, gamma):
        """Augmented Lagrangian (Benzi-Olshanskii) with an exact A_γ solve."""
        mb, pin, md, sd = self.mb, self.pin, self.md, self.sd
        GD = (self.G @ sp.diags(1.0 / md) @ self.B).tolil()
        GD[np.where(np.concatenate([mb, mb]))[0], :] = 0.0
        lu_Ag = spla.splu((self.A + gamma * GD.tocsr()).tocsc())
        N2 = 2 * self.N

        def pc(r):
            ru2, rp = r[:N2], r[N2:]
            dp = (1.0 + gamma) * rp / md
            dp = np.where(mb, rp / sd, dp)
            dp = np.where(pin, rp, dp)
            duv = lu_Ag.solve(ru2 - (self.G @ dp))
            return np.concatenate([duv, dp])
        return pc


def fgmres_count(mv, pc, b, rtol=1e-6, maxiter=1000, restart=200):
    """Right-preconditioned flexible GMRES from zero to ``rtol``:
    ``(iterations, final relative residual)``."""
    bn = np.linalg.norm(b)
    n = b.shape[0]
    x = np.zeros(n)
    it = 0
    while it < maxiter:
        r = b - mv(x)
        beta = np.linalg.norm(r)
        if beta <= rtol * bn:
            return it, beta / bn
        m = min(restart, maxiter - it)
        V = [r / beta]
        Zs = []
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.zeros(m)
        sn = np.zeros(m)
        kk = 0
        for k in range(m):
            z = pc(V[k])
            w = mv(z)
            Zs.append(z)
            for j in range(k + 1):
                H[j, k] = V[j] @ w
                w = w - H[j, k] * V[j]
            H[k + 1, k] = np.linalg.norm(w)
            V.append(w / max(H[k + 1, k], 1e-300))
            for j in range(k):
                t1 = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                t2 = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                H[j, k], H[j + 1, k] = t1, t2
            d = np.hypot(H[k, k], H[k + 1, k])
            cs[k], sn[k] = H[k, k] / d, H[k + 1, k] / d
            H[k, k] = d
            H[k + 1, k] = 0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            it += 1
            kk = k + 1
            if abs(g[k + 1]) <= rtol * bn:
                break
        yv = np.linalg.solve(np.triu(H[:kk, :kk]), g[:kk])
        x = x + np.stack(Zs[:kk], axis=1) @ yv
    r = b - mv(x)
    return it, np.linalg.norm(r) / bn


def main(argv=None):
    """Run the diagnostics; returns ``{label: (iterations, rel)}``."""
    from sem_tpu_torch.mesh import Grid2D

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="O(1) vortex wind instead of the converged solution")
    ap.add_argument("--random-rhs", action="store_true",
                    help="reproduce the misleading random-RHS numbers")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the converged-wind solve (default "
                         "cuda; cpu only when asked)")
    a = ap.parse_args(argv)

    grid = Grid2D(P, Ne, Ne, 1.0, 1.0)
    N = grid.N
    if a.synthetic:
        x, y = grid.points
        u = np.sin(np.pi * x) ** 2 * np.sin(2 * np.pi * y)
        v = -np.sin(2 * np.pi * x) * np.sin(np.pi * y) ** 2
        print("wind: synthetic O(1) vortex")
    else:
        import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
        from sem_tpu_torch.utils import cli_device

        u, v = converged_wind(grid, cli_device(a.device))
        print(f"wind: converged lid-cavity solution "
              f"(|u|max={np.abs(u).max():.3f})")

    blk = Blocks(grid, u, v)
    if a.random_rhs:
        b0 = np.random.default_rng(3).standard_normal(3 * N)
        print("RHS: raw random (MISLEADING — see module docstring)")
    else:
        x, y = grid.points
        sm = lambda kx, ky: np.sin(kx * np.pi * x) * np.cos(ky * np.pi * y)
        x_true = np.concatenate([sm(2, 1) + 0.5 * sm(3, 2),
                                 sm(1, 2) - 0.5 * sm(2, 3),
                                 sm(1, 1) + sm(2, 2)])
        b0 = blk.J_mv(x_true)
        print("RHS: consistent smooth (b = J x_smooth)")

    out = {}
    for label, pc in (
            ("spectral + FDM velocity      ", blk.make_pc(blk.shat_spec)),
            ("spectral + GMRES(5) velocity ", blk.make_pc(blk.shat_spec, 5)),
            ("spectral + GMRES(20) velocity",
             blk.make_pc(blk.shat_spec, 20)),
            ("pcd      + FDM velocity      ", blk.make_pc(blk.shat_pcd))):
        it, res = out[label.strip()] = fgmres_count(blk.J_mv, pc, b0)
        print(f"{label}: iters={it:5d} rel={res:.2e}", flush=True)

    # augmented Lagrangian, exact A_gamma solve: measured NOT competitive in
    # the JAX package's study (gamma=0.3: ~960 its; gamma=1 diverges with
    # the artificial pressure-boundary rows of this discretization)
    for gamma in (0.3, 1.0):
        it, res = out[f"AL gamma={gamma:g}"] = fgmres_count(
            blk.J_mv, blk.make_al_pc(gamma), b0)
        print(f"AL gamma={gamma:3g} (exact A_g)     : iters={it:5d} "
              f"rel={res:.2e}", flush=True)
    return out


if __name__ == "__main__":
    main()
