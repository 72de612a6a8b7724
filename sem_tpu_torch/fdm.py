"""Fast-diagonalization (FDM) direct solver for the masked global Laplacian.

Counterpart of ``sem_tpu.fdm.FDM2D``.  On the uniform tensor-product mesh the
Dirichlet-restricted operator keeps its tensor structure; with the generalized
eigendecompositions ``K1 Z = M1 Z Λ`` (M1-orthonormal ``Z``) per dimension::

    (K1x ⊗ M1y + M1x ⊗ K1y + α M1x ⊗ M1y)⁻¹
        = (Zx ⊗ Zy) diag(1/(λx ⊕ λy + α)) (Zxᵀ ⊗ Zyᵀ)

so one apply is four dense matmuls.  The pencils are decomposed once on the
host (``scipy.linalg.eigh``, disk-cached per 1D configuration); the device
constants are built per dtype and device on first use.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.operators import grid_const
from sem_tpu_torch.utils.tensors import device_const

__all__ = ["FDM2D"]


def _eig_1d(K1: np.ndarray, m1: np.ndarray, interior: np.ndarray,
            cache_key: str = None):
    """Generalized eigendecomposition of the restricted 1D pencil (K, M).

    M is diagonal (GLL mass lumping), so with S = diag(1/√m) the problem is
    the symmetric S K S = Q Λ Qᵀ and Z = S Q satisfies ZᵀKZ = Λ, ZᵀMZ = I.
    Disk-cached per 1D configuration when ``cache_key`` is given (same keys
    and arrays as the reference package).
    """
    def build():
        Kii = K1[np.ix_(interior, interior)]
        mii = m1[interior]
        s = 1.0 / np.sqrt(mii)
        A = (Kii * s[:, None]) * s[None, :]
        A = 0.5 * (A + A.T)
        lam, Q = scipy.linalg.eigh(A)
        return {"lam": lam, "Z": s[:, None] * Q}

    if cache_key is not None:
        from sem_tpu_torch.utils.diskcache import npz_cached
        out = npz_cached(cache_key, build)
    else:
        out = build()
    return out["lam"], out["Z"]


class FDM2D:
    """Exact inverse of the Dirichlet-masked operator ``K + α M``.

    The masked system solved is ``u[dir] = r[dir]``, ``(K+αM)u|int = r[int]``
    (identity rows on Dirichlet nodes, columns into Dirichlet nodes kept).

    :param grid: the SEM grid
    :param dirichlet_x: (west, east) — whether those sides carry Dirichlet rows
    :param dirichlet_y: (south, north)
    :param alpha: mass-shift coefficient α (0 ⇒ pure stiffness)

    With no Dirichlet side the operator is singular (pure Neumann Laplacian);
    the zero eigenvalue is pseudo-inverted (solution orthogonal to constants).
    """

    def __init__(self, grid: Grid2D, dirichlet_x=(True, True),
                 dirichlet_y=(True, True), alpha: float = 0.0):
        self.grid = grid
        self.alpha = float(alpha)
        ix = np.arange(grid.Ngx)
        iy = np.arange(grid.Ngy)
        if dirichlet_x[0]:
            ix = ix[1:]
        if dirichlet_x[1]:
            ix = ix[:-1]
        if dirichlet_y[0]:
            iy = iy[1:]
        if dirichlet_y[1]:
            iy = iy[:-1]
        self._has_boundary = (len(ix) < grid.Ngx) or (len(iy) < grid.Ngy)
        # whole-side Dirichlet masks ⇒ the interior is a contiguous block
        self._x0, self._x1 = int(ix[0]), int(ix[-1]) + 1
        self._y0, self._y1 = int(iy[0]), int(iy[-1]) + 1

        def key(P, Ne, L, ii):
            return (f"fdm1d_v1_P{P}_Ne{Ne}_L{L}_i{int(ii[0])}_{int(ii[-1])}"
                    if len(ii) else None)

        # the two 1D eigendecompositions are independent; scipy's eigh
        # releases the GIL inside LAPACK
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=2) as pool:
            fx = pool.submit(_eig_1d, grid.K1x, grid.m1x, ix,
                             key(grid.P, grid.N_ex, grid.L_x, ix))
            fy = pool.submit(_eig_1d, grid.K1y, grid.m1y, iy,
                             key(grid.P, grid.N_ey, grid.L_y, iy))
            self._lx, self._Zx = fx.result()
            self._ly, self._Zy = fy.result()
        denom = self._lx[:, None] + self._ly[None, :] + self.alpha
        # pseudo-inverse of (near-)zero modes (pure-Neumann nullspace guard)
        self._denom_scale = max(1.0, float(np.max(np.abs(denom))))
        self._ginv = np.where(np.abs(denom) > 1e-12 * self._denom_scale,
                              1.0 / denom, 0.0)
        bm = np.ones((grid.Ngx, grid.Ngy), dtype=bool)
        bm[np.ix_(ix, iy)] = False
        self._bmask = bm
        for a in (self._lx, self._Zx, self._ly, self._Zy, self._ginv,
                  self._bmask):
            a.setflags(write=False)

    def _const(self, name, like):
        return device_const(self, name, lambda: getattr(self, "_" + name),
                            like.dtype, like.device)

    def _ginv_t(self, sigma, like):
        """``1/(λx ⊕ λy + α + σ)`` (pseudo-inverted), computed in the field
        dtype like the reference's traced σ path; the precomputed f64
        diagonal when ``sigma`` is None."""
        if sigma is None:
            return self._const("ginv", like)
        lx, ly = self._const("lx", like), self._const("ly", like)
        denom = lx[:, None] + ly[None, :] + self.alpha + float(sigma)
        return torch.where(denom.abs() > 1e-12 * self._denom_scale,
                           1.0 / torch.where(denom == 0.0, 1.0, denom), 0.0)

    def __call__(self, r: torch.Tensor, sigma=None) -> torch.Tensor:
        """Solve for one RHS ``(N,)`` or a stacked batch ``(..., N)``.

        :param sigma: optional extra mass shift σ: solves
            ``(K + (α+σ) M) u = r`` (the eigenbasis is σ-independent; only the
            diagonal changes).  ``None`` uses the precomputed diagonal.
        """
        grid = self.grid
        batch = r.shape[:-1]
        R = r.reshape(batch + (grid.Ngx, grid.Ngy))
        x0, x1, y0, y1 = self._x0, self._x1, self._y0, self._y1

        if self._has_boundary:
            bmask = device_const(self, "bmask", lambda: self._bmask,
                                 torch.bool, r.device)
            Rb = torch.where(bmask, R, 0.0)
            # interior RHS minus the coupling through the Dirichlet slabs:
            # on the interior product set this is ≤ 4 rank-1 outer products,
            # one per Dirichlet side (the αM term is ring-supported and
            # vanishes under the restriction)
            K1x = grid_const(grid, "K1x", r.dtype, r.device)
            K1y = grid_const(grid, "K1y", r.dtype, r.device)
            m1x_i = grid_const(grid, "m1x", r.dtype, r.device)[x0:x1]
            m1y_i = grid_const(grid, "m1y", r.dtype, r.device)[y0:y1]
            Rint = R[..., x0:x1, y0:y1].clone()
            if x0 == 1:                      # West Dirichlet row
                Rint -= (K1x[x0:x1, 0][:, None] * R[..., 0:1, y0:y1]) * m1y_i
            if x1 == grid.Ngx - 1:           # East
                Rint -= (K1x[x0:x1, grid.Ngx - 1][:, None]
                         * R[..., grid.Ngx - 1:grid.Ngx, y0:y1]) * m1y_i
            if y0 == 1:                      # South Dirichlet column
                Rint -= (R[..., x0:x1, 0:1] * K1y[y0:y1, 0][None, :]) \
                    * m1x_i[:, None]
            if y1 == grid.Ngy - 1:           # North
                Rint -= (R[..., x0:x1, grid.Ngy - 1:grid.Ngy]
                         * K1y[y0:y1, grid.Ngy - 1][None, :]) \
                    * m1x_i[:, None]
        else:
            Rint = R

        Zx, Zy = self._const("Zx", r), self._const("Zy", r)
        W = Zx.T @ (Rint @ Zy)
        W = W * self._ginv_t(sigma, r)
        Uint = Zx @ (W @ Zy.T)
        if not self._has_boundary:
            return Uint.reshape(batch + (grid.N,))
        Rb[..., x0:x1, y0:y1] = Uint
        return Rb.reshape(batch + (grid.N,))

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        """Solve the masked system for RHS ``r`` (flat, or stacked batch)
        with the precomputed diagonal: ``self(r)``."""
        return self(r)
