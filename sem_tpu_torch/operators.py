"""Matrix-free global SEM operators on torch tensors.

Counterparts of ``sem_tpu.operators``.  With a field in grid form
``U (Ngx, Ngy)`` every linear global operator factorizes into 1D products:

- mass:       ``(M u)   = m1x[:,None] * U * m1y[None,:]``           (diagonal)
- stiffness:  ``(K u)   = (K1x @ U) * m1y + m1x[:,None] * (U @ K1y.T)``
- gradient-x: ``(Gx p)  = (G1x @ U) * m1y``
- gradient-y: ``(Gy p)  = m1x[:,None] * (U @ G1y.T)``

and the assembled convection operator is exactly ``u∘(Gx w) + v∘(Gy w)``
(super-diagonal GLL product tensor; see ``sem_tpu.operators.apply_convection``).
These applies are dense ``torch.matmul`` products, as the reference leaves
them to XLA; the hot f32 Krylov matvecs go through the hand-written kernels
of :mod:`sem_tpu_torch.ops.kernels` instead, at orders up to the kernels'
``P_MAX``.  Above it they take these products, as the reference's
dispatcher does off the TPU (``*_rows``: on one rank's row strip).  Every
function takes the ``Grid2D`` and builds its constants in the field's dtype
on the field's device (cached on the grid).
"""
from __future__ import annotations

import numpy as np
import torch

from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.utils.tensors import device_const

__all__ = [
    "grid_const", "gather", "scatter_sum", "grid_form", "flat_form",
    "apply_mass", "apply_stiffness", "apply_grad_x", "apply_grad_y",
    "apply_convection", "apply_system", "apply_coupled_system",
    "apply_system_rows", "apply_coupled_system_rows",
    "conv_diag_x", "conv_diag_y",
]


def grid_const(grid: Grid2D, name: str, dtype, device) -> torch.Tensor:
    """The grid's NumPy constant ``name`` as a cached tensor."""
    return device_const(grid, name, lambda: getattr(grid, name), dtype,
                        device)


def grid_form(grid: Grid2D, u: torch.Tensor) -> torch.Tensor:
    """Reshape a flat global vector ``(N,)`` to grid form ``(Ngx, Ngy)``."""
    return u.reshape(grid.Ngx, grid.Ngy)


def flat_form(u: torch.Tensor) -> torch.Tensor:
    """Reshape a grid-form field back to a flat global vector."""
    return u.reshape(-1)


def _c(grid: Grid2D, name: str, like: torch.Tensor) -> torch.Tensor:
    return grid_const(grid, name, like.dtype, like.device)


def gather(grid: Grid2D, u: torch.Tensor) -> torch.Tensor:
    """Global vector → element coefficient array ``(N_e, P+1, P+1)``.

    Reshapes and strided slices only: per axis, entries i<P come from
    ``x[:N_e·P]`` reshaped to (N_e, P); the shared i=P entry is ``x[P::P]``.
    """
    P, Nex, Ney = grid.P, grid.N_ex, grid.N_ey
    U = u.reshape(grid.Ngx, grid.Ngy)
    a = U[:Nex * P, :].reshape(Nex, P, grid.Ngy)
    b = U[P::P, :][:, None, :]
    rows = torch.cat([a, b], dim=1)                       # (Nex, P+1, Ngy)
    c = rows[:, :, :Ney * P].reshape(Nex, P + 1, Ney, P)
    d = rows[:, :, P::P][:, :, :, None]
    cols = torch.cat([c, d], dim=3)                       # (Nex, P+1, Ney, P+1)
    return cols.permute(0, 2, 1, 3).reshape(grid.N_e, P + 1, P + 1)


def scatter_sum(grid: Grid2D, u_e: torch.Tensor) -> torch.Tensor:
    """Element array ``(N_e, P+1, P+1)`` → global vector by duplicate-sum.

    The exact transpose of :func:`gather`: two slice-adds per axis (interior
    block + P-strided shared-node line); interface nodes receive both
    neighbours' contributions, which is the C0 assembly sum.
    """
    P, Nex, Ney = grid.P, grid.N_ex, grid.N_ey
    t = u_e.reshape(Nex, Ney, P + 1, P + 1).permute(0, 2, 1, 3)
    colpart = torch.zeros((Nex, P + 1, grid.Ngy), dtype=u_e.dtype,
                          device=u_e.device)
    colpart[:, :, :Ney * P] += t[:, :, :, :P].reshape(Nex, P + 1, Ney * P)
    colpart[:, :, P::P] += t[:, :, :, P]
    out = torch.zeros((grid.Ngx, grid.Ngy), dtype=u_e.dtype,
                      device=u_e.device)
    out[:Nex * P, :] += colpart[:, :P, :].reshape(Nex * P, grid.Ngy)
    out[P::P, :] += colpart[:, P, :]
    return out.reshape(-1)


def apply_mass(grid: Grid2D, u: torch.Tensor) -> torch.Tensor:
    """Global (lumped, diagonal) mass operator."""
    U = u.reshape(grid.Ngx, grid.Ngy)
    return (_c(grid, "m1x", u)[:, None] * U
            * _c(grid, "m1y", u)[None, :]).reshape(-1)


def apply_stiffness(grid: Grid2D, u: torch.Tensor) -> torch.Tensor:
    """Global stiffness ``K = K1x ⊗ diag(m1y) + diag(m1x) ⊗ K1y``."""
    U = u.reshape(grid.Ngx, grid.Ngy)
    KU = (_c(grid, "K1x", u) @ U) * _c(grid, "m1y", u)[None, :]
    UK = (U @ _c(grid, "K1y", u).T) * _c(grid, "m1x", u)[:, None]
    return (KU + UK).reshape(-1)


def apply_grad_x(grid: Grid2D, p: torch.Tensor) -> torch.Tensor:
    """Global weak x-derivative ``Gx = G1x ⊗ diag(m1y)``."""
    U = p.reshape(grid.Ngx, grid.Ngy)
    return ((_c(grid, "G1x", p) @ U)
            * _c(grid, "m1y", p)[None, :]).reshape(-1)


def apply_grad_y(grid: Grid2D, p: torch.Tensor) -> torch.Tensor:
    """Global weak y-derivative ``Gy = diag(m1x) ⊗ G1y``."""
    U = p.reshape(grid.Ngx, grid.Ngy)
    return ((U @ _c(grid, "G1y", p).T)
            * _c(grid, "m1x", p)[:, None]).reshape(-1)


def apply_convection(grid: Grid2D, u, v, w) -> torch.Tensor:
    """Assembled convection ``(u@Cx + v@Cy) w = u∘(Gx w) + v∘(Gy w)``."""
    return u * apply_grad_x(grid, w) + v * apply_grad_y(grid, w)


def _x_rows(grid: Grid2D, rows, like: torch.Tensor) -> torch.Tensor:
    """Rows ``r0..r1-1`` of ``[K1x; G1x]`` over the columns ``r0-P ..
    r1+P-1``, zero where a column leaves the grid (``(2(r1-r0), r1-r0+2P)``):
    the x operators of one row strip, applied to the strip with its ``P``
    halo rows per side (every nonzero of the C0 operators lies within ``P``
    of the diagonal)."""
    P, (r0, r1) = grid.P, rows

    def host():
        cols = np.arange(r0 - P, r1 + P)
        ok = (cols >= 0) & (cols < grid.Ngx)
        out = np.zeros((2, r1 - r0, cols.size))
        for k, A in enumerate((grid.K1x, grid.G1x)):
            out[k][:, ok] = A[r0:r1][:, cols[ok]]
        return out.reshape(2 * (r1 - r0), cols.size)

    return device_const(grid, ("KG1x_rows", r0, r1), host, like.dtype,
                        like.device)


def _system(grid: Grid2D, Lx, Wx, W, m1x, u, v, coef) -> torch.Tensor:
    """``(K + coef·(u∂x + v∂y)) w`` on the rows of ``W (n, Ngy)``: ``Lx``
    (the stacked x operators of those rows) applied to ``Wx`` (``W`` with
    the rows they read), ``[K1yᵀ, G1yᵀ]`` to ``W``; ``m1x`` the rows'
    masses."""
    n, Ngy = W.shape
    m1x, m1y = m1x[:, None], _c(grid, "m1y", W)[None, :]
    L = Lx @ Wx                          # [K1x@W ; G1x@W]
    R = W @ _c(grid, "KG1yT", W)         # [W@K1yᵀ , W@G1yᵀ]
    K2d = L[:n] * m1y + m1x * R[:, :Ngy]
    gx = (L[n:] * m1y).reshape(-1)
    gy = (m1x * R[:, Ngy:]).reshape(-1)
    return K2d.reshape(-1) + coef * (u * gx + v * gy)


def apply_system(grid: Grid2D, u, v, w, coef) -> torch.Tensor:
    """``(K + coef·(u∂x + v∂y)) w`` from two matmuls with the stacked
    operators ``[K1x; G1x]`` and ``[K1yᵀ, G1yᵀ]`` (the dense path; the f64
    fields of the solvers take it, and every field at orders above the
    kernels' ``P_MAX``)."""
    W = w.reshape(grid.Ngx, grid.Ngy)
    return _system(grid, _c(grid, "KG1x", w), W, W, _c(grid, "m1x", w), u,
                   v, coef)


def apply_system_rows(grid: Grid2D, rows, u, v, w_ext, coef
                      ) -> torch.Tensor:
    """Rows ``r0..r1-1`` of :func:`apply_system` from ``w_ext`` (the strip
    with ``P`` halo rows per side, as the halo exchange delivers it) and the
    strip's ``u``, ``v``: the dense path on one row strip, which the strip
    wrapper of kernel B3 takes at orders above the kernels' ``P_MAX``."""
    P, (r0, r1) = grid.P, rows
    Wx = w_ext.reshape(r1 - r0 + 2 * P, grid.Ngy)
    return _system(grid, _x_rows(grid, rows, w_ext), Wx, Wx[P:Wx.shape[0] - P],
                   _c(grid, "m1x", w_ext)[r0:r1], u, v, coef)


def _coupled(grid: Grid2D, Lx, Qx, Q, m1x, ul, vl, jac, mb, coef
             ) -> torch.Tensor:
    """The NS saddle matvec on the rows of the three fields ``Q (3, n,
    Ngy)``: ``Lx`` (the stacked x operators of those rows) applied to ``Qx``
    (``Q`` with the rows they read), ``[K1yᵀ, G1yᵀ]`` to ``Q``; ``m1x`` the
    rows' masses; ``ul``, ``vl``, ``jac``, ``mb`` cover the same rows."""
    n, Ngy = Q.shape[1:]
    m1x, m1y = m1x[:, None], _c(grid, "m1y", Q)[None, :]
    L = Lx @ torch.cat(list(Qx), dim=1)                        # (2n, 3Ngy)
    R = torch.cat(list(Q), dim=0) @ _c(grid, "KG1yT", Q)       # (3n, 2Ngy)

    def parts(f):  # f = 0:du, 1:dv, 2:dp
        Kx = L[:n, f * Ngy:(f + 1) * Ngy]
        Gx = L[n:, f * Ngy:(f + 1) * Ngy] * m1y
        Ky = R[f * n:(f + 1) * n, :Ngy]
        Gy = R[f * n:(f + 1) * n, Ngy:] * m1x
        return (Kx * m1y + m1x * Ky).reshape(-1), Gx.reshape(-1), \
            Gy.reshape(-1)

    Ku, gxu, gyu = parts(0)
    Kv, gxv, gyv = parts(1)
    Kp, gxp, gyp = parts(2)
    du, dv = Q[0].reshape(-1), Q[1].reshape(-1)
    jxx, jxy, jyx, jyy = jac
    dru = Ku + coef * (ul * gxu + vl * gyu) + jxx * du + jxy * dv + gxp
    drv = Kv + coef * (ul * gxv + vl * gyv) + jyx * du + jyy * dv + gyp
    drc = gxu + gyv
    return torch.cat([torch.where(mb, du, dru), torch.where(mb, dv, drv),
                      torch.where(mb, Kp, drc)])


def apply_coupled_system(grid: Grid2D, q, ul, vl, jac, mb, coef
                         ) -> torch.Tensor:
    """NS tangent saddle matvec ``(dru, drv, drc)`` for ``q = (du, dv, dp)``
    from exactly two matmuls (the dense path of
    ``sem_tpu.models.navier_stokes`` ``_coupled_ops.mv``).

    ``dru = K du + coef(ul·Gx du + vl·Gy du) + jxx du + jxy dv + Gx dp`` and
    likewise ``drv``; ``drc = Gx du + Gy dv``.  Dirichlet rows (``mb``) carry
    ``du``, ``dv`` and the pressure-stiffness rows ``K dp``.  The pressure-pin
    row is left to the caller, as in the kernel.
    """
    Q = q.reshape(3, grid.Ngx, grid.Ngy)
    return _coupled(grid, _c(grid, "KG1x", q), Q, Q, _c(grid, "m1x", q), ul,
                    vl, jac, mb, coef)


def apply_coupled_system_rows(grid: Grid2D, rows, q_ext, ul, vl, jac, mb,
                              coef) -> torch.Tensor:
    """Rows ``r0..r1-1`` of :func:`apply_coupled_system`'s three outputs
    from ``q_ext`` (the du, dv, dp strips with ``P`` halo rows per side,
    stacked) and the strip's ``ul``, ``vl``, ``jac``, ``mb``: the dense path
    on one row strip, which the strip wrapper of kernel B4 takes at orders
    above the kernels' ``P_MAX``.  The pressure-pin row is the caller's."""
    P, (r0, r1) = grid.P, rows
    Qx = q_ext.reshape(3, r1 - r0 + 2 * P, grid.Ngy)
    return _coupled(grid, _x_rows(grid, rows, q_ext), Qx,
                    Qx[:, P:Qx.shape[1] - P], _c(grid, "m1x", q_ext)[r0:r1],
                    ul, vl, jac, mb, coef)


def conv_diag_x(grid: Grid2D, f) -> torch.Tensor:
    """Diagonal (as a vector) of the global operator ``Cx @ f`` (right
    slot) — equal to the assembled weak x-derivative ``Gx f``."""
    return apply_grad_x(grid, f)


def conv_diag_y(grid: Grid2D, f) -> torch.Tensor:
    """Diagonal (as a vector) of the global operator ``Cy @ f``."""
    return apply_grad_y(grid, f)
