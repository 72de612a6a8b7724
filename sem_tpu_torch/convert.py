"""Carry state across packages: the coupled iterate as NumPy arrays.

The solve has no weights; its state is the coupled iterate ``(T, u, v, p)``.
These helpers move it between ``sem_tpu`` (whose ``CoupledState`` fields
convert with ``np.asarray``) and this package, so both can start from the
same state, and check that a port grid reproduces a reference grid exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from sem_tpu_torch.coupling.mda import CoupledState
from sem_tpu_torch.mesh import Grid2D

__all__ = ["state_from_numpy", "state_to_numpy", "grid_from_sem_tpu_config",
           "GRID_ARRAYS"]

#: the Grid2D arrays the port must reproduce bit-for-bit
GRID_ARRAYS = ("x_1d", "y_1d", "gidx", "m1x", "m1y", "K1x", "K1y", "G1x",
               "G1y", "wq2d", "points", "mass_diag", "stiff_diag", "KG1x",
               "KG1yT", "boundary_mask")


def state_from_numpy(T, u, v, p, *, device,
                     dtype=torch.float64) -> CoupledState:
    """A :class:`CoupledState` on ``device`` from four array-likes."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return CoupledState(t(T), t(u), t(v), t(p))


def state_to_numpy(state: CoupledState):
    """``(T, u, v, p)`` of a :class:`CoupledState` as host NumPy arrays."""
    return tuple(f.detach().cpu().numpy()
                 for f in (state.T, state.u, state.v, state.p))


def grid_from_sem_tpu_config(P, N_ex, N_ey, L_x, L_y,
                             reference=None) -> Grid2D:
    """The port's ``Grid2D`` for a reference grid configuration.

    :param reference: optional grid object with the reference package's
        ``Grid2D`` attributes (e.g. a ``sem_tpu.mesh.Grid2D``); every array
        in :data:`GRID_ARRAYS` must then be exactly equal, else ValueError
    """
    grid = Grid2D(P, N_ex, N_ey, L_x, L_y)
    if reference is not None:
        for name in GRID_ARRAYS:
            mine, ref = getattr(grid, name), np.asarray(getattr(reference,
                                                                name))
            if mine.shape != ref.shape or not np.array_equal(mine, ref):
                raise ValueError(f"Grid2D.{name} differs from the reference "
                                 f"grid's")
    return grid
