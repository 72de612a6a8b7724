"""Kernels B3/B4: the system applies on one rank's row strip, the halo
exchange that feeds them, and the strip helpers of the decomposed Krylov
chunks.

* **B3** ``apply_system_sharded``: rows ``r0..r1-1`` of kernel B1's output,
  by B1's kernel on a row window (``csrc/apply_system.cu``; replaces
  ``sem_tpu.ops.pallas_kernels.apply_system_pallas_sharded``).
* **B4** ``apply_coupled_system_sharded``: the same for kernel B2
  (``csrc/coupled_system.cu``; replaces
  ``apply_coupled_system_pallas_sharded``).

Both read the strip of their Krylov field(s) with ``P`` halo rows on each
side, the half-width of the C0 band, and the linearization fields of the
strip alone.  As for B1/B2, a wrapper launches its kernel for CUDA float32
tensors and raises for any other dtype on the card; only CPU tensors take the
plain version (``*_sharded_plain``).  Each launch adds one to
``kernels.LAUNCHES`` under the wrapper's own name.

:class:`RowStrips` holds one grid's layout over the ranks of a group and the
three collectives of a decomposed chunk: the halo exchange (one all-gather
of each rank's first and last ``P`` rows per matvec), the all-gather of the
strips into the full field (for the replicated preconditioners), and the
all-reduce of Krylov dot products.  :data:`COLLECTIVES` counts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops.kernels import (_band_ptrs, _check, _coupled_plain,
                                       _launch, _system_plain,
                                       row_window_tiles)
from sem_tpu_torch.parallel.sharding import row_strips

__all__ = ["COLLECTIVES", "RowStrips", "all_reduce", "strip_with_halo",
           "apply_system_sharded", "apply_system_sharded_plain",
           "apply_coupled_system_sharded",
           "apply_coupled_system_sharded_plain"]

#: collectives since the counts were last reset (by kind)
COLLECTIVES = {"halo_exchange": 0, "strip_gather": 0, "all_reduce": 0}


def all_reduce(group, t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` (a fresh tensor, reduced in place) over ``group``."""
    COLLECTIVES["all_reduce"] += 1
    return group.all_reduce(t)


def strip_with_halo(grid: Grid2D, rows, x: torch.Tensor, nf: int = 1):
    """Rows ``r0-P .. r1+P-1`` of each of the ``nf`` stacked full fields
    ``x (nf·N,)``, zero beyond the grid: what the halo exchange delivers,
    cut from the full field (tests and kernel checks)."""
    P, (r0, r1) = grid.P, rows
    X = F.pad(x.reshape(nf, grid.Ngx, grid.Ngy), (0, 0, P, P))
    return X[:, r0:r1 + 2 * P].reshape(-1)


class RowStrips:
    """The row-strip layout of ``grid`` over the ranks of ``group``
    (:func:`sem_tpu_torch.parallel.row_strips`), and this rank's strip
    ``rows = (r0, r1)``.  A local vector of ``nf`` fields is the ``nf``
    strips concatenated."""

    def __init__(self, grid: Grid2D, group):
        self.grid, self.group = grid, group
        self.bounds = row_strips(grid.Ngx, group.world, grid.P)
        self.rows = self.bounds[group.rank]
        self.nrows = self.rows[1] - self.rows[0]
        # all-gather needs equal sizes: strips are padded to the thickest
        self.pad_rows = max(b - a for a, b in self.bounds)

    def local(self, x: torch.Tensor, nf: int = 1) -> torch.Tensor:
        """This rank's strip of each of the ``nf`` stacked full fields."""
        g = self.grid
        return x.reshape(nf, g.Ngx, g.Ngy)[:, self.rows[0]:self.rows[1]
                                           ].reshape(-1)

    def local_index(self, n: int):
        """Index of global node ``n`` of the first field in a local vector,
        or None when another rank owns it."""
        lo = self.rows[0] * self.grid.Ngy
        return n - lo if lo <= n < self.rows[1] * self.grid.Ngy else None

    def exchange(self, x_loc: torch.Tensor, nf: int = 1) -> torch.Tensor:
        """The local strips extended by ``P`` halo rows on each side, from
        the neighbours (zeros at the grid's edges): one all-gather of every
        rank's first and last ``P`` rows."""
        P, Ngy = self.grid.P, self.grid.Ngy
        rank, world = self.group.rank, self.group.world
        X = x_loc.reshape(nf, self.nrows, Ngy)
        slabs = self.group.all_gather(torch.stack([X[:, :P], X[:, -P:]]))
        COLLECTIVES["halo_exchange"] += 1
        zero = torch.zeros_like(slabs[0][0])
        top = slabs[rank - 1][1] if rank > 0 else zero
        bot = slabs[rank + 1][0] if rank < world - 1 else zero
        return torch.cat([top, X, bot], dim=1).reshape(-1)

    def gather(self, x_loc: torch.Tensor, nf: int = 1) -> torch.Tensor:
        """The full ``nf`` fields from every rank's strips: one all-gather."""
        Ngy = self.grid.Ngy
        X = F.pad(x_loc.reshape(nf, self.nrows, Ngy),
                  (0, 0, 0, self.pad_rows - self.nrows))
        parts = self.group.all_gather(X)
        COLLECTIVES["strip_gather"] += 1
        return torch.cat([p[:, :b - a] for p, (a, b) in
                          zip(parts, self.bounds)], dim=1).reshape(-1)


# ----------------------------- plain versions ----------------------------- #
def apply_system_sharded_plain(grid: Grid2D, rows, u, v, w_ext, coef
                               ) -> torch.Tensor:
    """Plain PyTorch version of kernel B3: rows ``r0..r1-1`` of B1's output
    from ``w_ext`` (the strip with ``P`` halo rows per side) and the strip's
    ``u``, ``v``."""
    n = rows[1] - rows[0] + 2 * grid.P
    return _system_plain(grid, u, v, w_ext.reshape(1, n, grid.Ngy), coef,
                         rows)


def apply_coupled_system_sharded_plain(grid: Grid2D, rows, q_ext, ul, vl,
                                       jac, mb, coef) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: rows ``r0..r1-1`` of B2's three
    outputs from ``q_ext`` (du, dv, dp strips with halos, stacked) and the
    strip's ``ul``, ``vl``, ``jac``, ``mb``."""
    n = rows[1] - rows[0] + 2 * grid.P
    return _coupled_plain(grid, q_ext.reshape(3, n, grid.Ngy), ul, vl, jac,
                          mb, coef, rows)


# -------------------------------- wrappers -------------------------------- #
def apply_system_sharded(grid: Grid2D, rows, u, v, w_ext, coef
                         ) -> torch.Tensor:
    """Kernel B3 on CUDA tensors (float32 only); the plain version for
    tensors on the CPU."""
    if w_ext.device.type == "cpu":
        return apply_system_sharded_plain(grid, rows, u, v, w_ext, coef)
    r0, r1 = rows
    n = (r1 - r0) * grid.Ngy
    _check("apply_system_sharded", (w_ext, u, v),
           [(n + 2 * grid.P * grid.Ngy,), (n,), (n,)], [torch.float32] * 3)
    out = torch.empty_like(u)
    _launch("apply_system_sharded", "sem_apply_system_strip_f32",
            w_ext.device, out.data_ptr(), u.data_ptr(), v.data_ptr(),
            w_ext.data_ptr(), *_band_ptrs(grid, w_ext.device), float(coef),
            r0, r1 - r0, *row_window_tiles(r0, r1), grid.Ngx, grid.Ngy,
            grid.P)
    return out


def apply_coupled_system_sharded(grid: Grid2D, rows, q_ext, ul, vl, jac, mb,
                                 coef) -> torch.Tensor:
    """Kernel B4 on CUDA tensors (float32 fields, bool mask); the plain
    version for tensors on the CPU.  The pressure-pin row is the caller's."""
    if q_ext.device.type == "cpu":
        return apply_coupled_system_sharded_plain(grid, rows, q_ext, ul, vl,
                                                  jac, mb, coef)
    r0, r1 = rows
    n = (r1 - r0) * grid.Ngy
    f32 = torch.float32
    _check("apply_coupled_system_sharded", (q_ext, ul, vl, *jac, mb),
           [(3 * (n + 2 * grid.P * grid.Ngy),)] + [(n,)] * 7,
           [f32] * 7 + [torch.bool])
    out = q_ext.new_empty(3 * n)
    _launch("apply_coupled_system_sharded",
            "sem_apply_coupled_system_strip_f32", q_ext.device,
            out.data_ptr(), q_ext.data_ptr(), ul.data_ptr(), vl.data_ptr(),
            *(j.data_ptr() for j in jac), mb.data_ptr(),
            *_band_ptrs(grid, q_ext.device), float(coef), r0, r1 - r0,
            *row_window_tiles(r0, r1), grid.Ngx, grid.Ngy, grid.P)
    return out
