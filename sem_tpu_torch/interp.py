"""Field evaluation at tensor-product points + cross-mesh transfer.

Counterpart of ``sem_tpu.interp``.  For tensor-product query points
``(xq ⊗ yq)`` the evaluation of a SEM field ``U`` (grid form) is
``Ex @ U @ Eyᵀ`` with precomputed global 1D evaluation matrices (host NumPy,
built once); the CD↔NS re-basis of the coupling layer is the same pair of
matmuls between two grids.
"""
from __future__ import annotations

import numpy as np
import torch

from sem_tpu_torch import gll
from sem_tpu_torch.mesh import Grid2D, x2xi
from sem_tpu_torch.utils.tensors import device_const

__all__ = ["eval_matrix_1d", "PointEvaluator", "eval_field",
           "transfer_matrices", "apply_transfer"]


def eval_matrix_1d(P: int, N_e: int, d: float, xq: np.ndarray) -> np.ndarray:
    """Global 1D evaluation matrix ``(len(xq), N_e·P+1)``: row ``a`` evaluates
    a 1D SEM interpolant at ``xq[a]`` (owning element per the reference's
    boundary-ownership shift, Lagrange row scattered into its columns)."""
    xq = np.asarray(xq, dtype=np.float64)
    e, xi = x2xi(xq, d, N_e=N_e)   # validates xq ∈ [0, N_e·d]
    e = np.clip(e, 0, N_e - 1)
    S = gll.standard_evaluation_matrix(P, xi)
    E = np.zeros((xq.size, N_e * P + 1))
    for a in range(xq.size):
        E[a, e[a] * P:e[a] * P + P + 1] = S[a]
    return E


class PointEvaluator:
    """Precomputed evaluator of grid fields at fixed tensor-product points.

    :param grid: source grid
    :param points_plot: ``(X, Y)`` ij-indexed meshgrid arrays
    """

    def __init__(self, grid: Grid2D, points_plot):
        X, Y = (np.asarray(a) for a in points_plot)
        self.shape = X.shape
        self._Ex = eval_matrix_1d(grid.P, grid.N_ex, grid.dx, X[:, 0])
        self._Ey = eval_matrix_1d(grid.P, grid.N_ey, grid.dy, Y[0, :])
        self._grid = grid

    def __call__(self, f: torch.Tensor) -> np.ndarray:
        U = f.reshape(self._grid.Ngx, self._grid.Ngy)
        Ex = device_const(self, "Ex", lambda: self._Ex, f.dtype, f.device)
        Ey = device_const(self, "Ey", lambda: self._Ey, f.dtype, f.device)
        return (Ex @ U @ Ey.T).cpu().numpy()


def eval_field(grid: Grid2D, f: torch.Tensor, points_plot) -> np.ndarray:
    """One-shot evaluation of the field ``f`` at the points (builds the
    evaluator; prefer :class:`PointEvaluator` for repeated use)."""
    return PointEvaluator(grid, points_plot)(f)


def _transfer_1d(src: Grid2D, dst: Grid2D, axis: str) -> np.ndarray:
    if axis == "x":
        return eval_matrix_1d(src.P, src.N_ex, src.dx, dst.x_1d)
    return eval_matrix_1d(src.P, src.N_ey, src.dy, dst.y_1d)


def transfer_matrices(src: Grid2D, dst: Grid2D):
    """1D transfer matrices ``(Ex, Ey)`` re-basing a field from ``src`` onto
    ``dst`` nodes, shapes ``(dst.Ngx, src.Ngx)``, ``(dst.Ngy, src.Ngy)``."""
    return _transfer_1d(src, dst, "x"), _transfer_1d(src, dst, "y")


def apply_transfer(src: Grid2D, dst: Grid2D, f: torch.Tensor) -> torch.Tensor:
    """Re-basis a flat global vector from ``src`` to ``dst`` (linear map);
    the matrices are device constants of ``src``, so they are built once
    per pair of grids that :mod:`sem_tpu_torch.build_cache` holds."""
    key = ("transfer", dst._config())
    Ex, Ey = (device_const(src, key + (axis,),
                           lambda: _transfer_1d(src, dst, axis), f.dtype,
                           f.device)
              for axis in ("x", "y"))
    return (Ex @ f.reshape(src.Ngx, src.Ngy) @ Ey.T).reshape(-1)
