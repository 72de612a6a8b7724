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
or bfloat16 fields (one dtype per call; at bf16 the reference kernel's bf16
function, :mod:`sem_tpu_torch.ops.kernels`) and raises for any other dtype
on the card; only CPU tensors take the plain version (``*_sharded_plain``).
Each launch adds one to ``kernels.LAUNCHES`` under the wrapper's own name, a
bf16 launch under that name with ``_bf16`` appended.  At orders above
``kernels.P_MAX`` both wrappers take the dense path on the strip
(``operators.apply_*_rows``) and launch nothing, as the dispatchers of
B1/B2 do.

:class:`RowStrips` holds one grid's layout over the ranks of a group and the
three collectives of a decomposed chunk: the halo exchange (one all-gather
of each rank's first and last ``P`` rows per matvec, cut across several
ranks where strips are thinner than ``P``), the all-gather of the
strips into the full field (for the replicated preconditioners), and the
all-reduce of Krylov dot products.  :data:`COLLECTIVES` counts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sem_tpu_torch import operators as ops
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops.kernels import (P_MAX, _band_ptrs, _check,
                                       _coupled_plain, _launch,
                                       _system_plain, row_window_tiles)
from sem_tpu_torch.parallel.sharding import row_strips

__all__ = ["COLLECTIVES", "RowStrips", "all_reduce", "strip_maps",
           "strip_with_halo",
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
        """The local strips extended by ``P`` halo rows on each side (zeros
        beyond the grid's edges): one all-gather of every rank's first and
        last ``min(P, nrows)`` rows, padded to ``P``.  A halo takes its rows
        from the nearest ranks outward until it has ``P`` of them, so a
        strip thinner than ``P`` passes on its neighbours' rows as well."""
        P, Ngy = self.grid.P, self.grid.Ngy
        X = x_loc.reshape(nf, self.nrows, Ngy)
        m = min(P, self.nrows)
        first, last = X[:, :m], X[:, self.nrows - m:]
        if m < P:      # each slab's rows at its inner end, zeros beyond
            first = F.pad(first, (0, 0, 0, P - m))
            last = F.pad(last, (0, 0, P - m, 0))
        slabs = self.group.all_gather(torch.stack([first, last]))
        COLLECTIVES["halo_exchange"] += 1
        rank = self.group.rank
        top = self._halo(slabs, range(rank - 1, -1, -1), 1)
        bot = self._halo(slabs, range(rank + 1, self.group.world), 0)
        return torch.cat([top, X, bot], dim=1).reshape(-1)

    def _halo(self, slabs, ranks, side: int) -> torch.Tensor:
        """``P`` rows beside this strip from the gathered ``slabs``, walking
        ``ranks`` outward: their last rows above it (``side`` 1), their
        first rows below it (``side`` 0); zeros past the grid's edge."""
        P = self.grid.P
        parts, have = [], 0
        for k in ranks:
            n = min(P, self.bounds[k][1] - self.bounds[k][0])
            s = slabs[k][side]
            parts.append(s[:, P - n:] if side else s[:, :n])
            have += n
            if have >= P:
                break
        else:
            zero = slabs[0][0]
            parts.append(zero.new_zeros(zero.shape[0], P - have,
                                        zero.shape[2]))
        if side:       # above: the outermost rows first
            parts = parts[::-1]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return out[:, -P:] if side else out[:, :P]

    def gather(self, x_loc: torch.Tensor, nf: int = 1) -> torch.Tensor:
        """The full ``nf`` fields from every rank's strips: one all-gather."""
        Ngy = self.grid.Ngy
        X = F.pad(x_loc.reshape(nf, self.nrows, Ngy),
                  (0, 0, 0, self.pad_rows - self.nrows))
        parts = self.group.all_gather(X)
        COLLECTIVES["strip_gather"] += 1
        return torch.cat([p[:, :b - a] for p, (a, b) in
                          zip(parts, self.bounds)], dim=1).reshape(-1)


def strip_maps(strips, nf: int = 1):
    """``(cut, gather)``: this rank's strips of ``nf`` stacked full fields
    (:meth:`RowStrips.local`) and the full fields back from every rank's
    (:meth:`RowStrips.gather`); both the identity where ``strips`` is
    None."""
    if strips is None:
        return (lambda x: x), (lambda x: x)
    return (lambda x: strips.local(x, nf)), (lambda x: strips.gather(x, nf))


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
    """Kernel B3 on CUDA tensors (float32 or bfloat16 fields, one dtype);
    the plain version for tensors on the CPU.  At orders above ``P_MAX``,
    which the kernel does not take, the dense path on the strip
    (:func:`sem_tpu_torch.operators.apply_system_rows`) on any device, with
    no launch."""
    if grid.P > P_MAX:
        return ops.apply_system_rows(grid, rows, u, v, w_ext, coef)
    if w_ext.device.type == "cpu":
        return apply_system_sharded_plain(grid, rows, u, v, w_ext, coef)
    r0, r1 = rows
    n = (r1 - r0) * grid.Ngy
    dt = w_ext.dtype
    sfx = _check("apply_system_sharded", (w_ext, u, v),
                 [(n + 2 * grid.P * grid.Ngy,), (n,), (n,)])
    out = torch.empty_like(u)
    _launch("apply_system_sharded", "sem_apply_system_strip", sfx,
            w_ext.device, out.data_ptr(), u.data_ptr(), v.data_ptr(),
            w_ext.data_ptr(), *_band_ptrs(grid, w_ext.device, dt),
            float(coef), r0, r1 - r0, *row_window_tiles(r0, r1),
            grid.Ngx, grid.Ngy, grid.P)
    return out


def apply_coupled_system_sharded(grid: Grid2D, rows, q_ext, ul, vl, jac, mb,
                                 coef) -> torch.Tensor:
    """Kernel B4 on CUDA tensors (float32 or bfloat16 fields, one dtype;
    bool mask); the plain version for tensors on the CPU.  At orders above
    ``P_MAX``, the dense path on the strip
    (:func:`sem_tpu_torch.operators.apply_coupled_system_rows`) on any
    device, with no launch.  The pressure-pin row is the caller's."""
    if grid.P > P_MAX:
        return ops.apply_coupled_system_rows(grid, rows, q_ext, ul, vl, jac,
                                             mb, coef)
    if q_ext.device.type == "cpu":
        return apply_coupled_system_sharded_plain(grid, rows, q_ext, ul, vl,
                                                  jac, mb, coef)
    r0, r1 = rows
    n = (r1 - r0) * grid.Ngy
    dt = q_ext.dtype
    sfx = _check("apply_coupled_system_sharded", (q_ext, ul, vl, *jac, mb),
                 [(3 * (n + 2 * grid.P * grid.Ngy),)] + [(n,)] * 7, masks=1)
    out = q_ext.new_empty(3 * n)
    _launch("apply_coupled_system_sharded", "sem_apply_coupled_system_strip",
            sfx, q_ext.device, out.data_ptr(), q_ext.data_ptr(),
            ul.data_ptr(), vl.data_ptr(), *(j.data_ptr() for j in jac),
            mb.data_ptr(),
            *_band_ptrs(grid, q_ext.device, dt), float(coef),
            r0, r1 - r0, *row_window_tiles(r0, r1), grid.Ngx, grid.Ngy,
            grid.P)
    return out
