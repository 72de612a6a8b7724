"""The two hand-written CUDA kernels of the solve path, their plain PyTorch
versions, and the dispatchers the solvers call.

* **B1** ``apply_system_kernel``: ``(K + c·(u∂x + v∂y)) w`` — the CD matvec
  of every f32 Krylov iteration (``csrc/apply_system.cu``; replaces
  ``sem_tpu.ops.pallas_kernels.apply_system_pallas``).
* **B2** ``apply_coupled_system_kernel``: the NS tangent saddle matvec of
  every f32 coupled Krylov iteration (``csrc/coupled_system.cu``; replaces
  ``apply_coupled_system_pallas``).

Both kernels read the assembled 1D operators in compact band storage
(:func:`tile_coefficients`), which is exact because every nonzero of the C0
operators lies within half-band P of the diagonal (checked when built), and
run only the taps of :func:`band_tap_ranges`, outside of which every
coefficient is a structural zero.  They take orders ``1 ≤ P ≤ 64``
(:data:`P_MAX`, the reference's limit) and raise for others.  The row-strip
kernels B3/B4 of :mod:`sem_tpu_torch.ops.sharded` are the same kernels on a
row window, launched on the tiles of :func:`row_window_tiles`.

A wrapper launches its kernel for a CUDA float32 tensor and raises for any
other dtype on the card; a build or launch failure raises.  Only a tensor on
the CPU takes the plain version (``*_plain``), which computes the same
function with plain tensor ops in the compact band form.  Each launch adds one
to :data:`LAUNCHES`, which also counts the row-strip kernels B3/B4 of
:mod:`sem_tpu_torch.ops.sharded`, each under its own name.  The dispatchers
``apply_system_best`` / ``apply_coupled_system_best`` send float64 fields to
the dense two-matmul path of :mod:`sem_tpu_torch.operators`, as the reference
does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sem_tpu_torch import operators as ops
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.utils.tensors import device_const

__all__ = ["LAUNCHES", "P_MAX", "TILE", "band_storage", "band_operators",
           "band_tap_ranges", "tile_coefficients", "row_window_tiles",
           "apply_system_kernel",
           "apply_system_plain", "apply_system_best",
           "apply_coupled_system_kernel", "apply_coupled_system_plain",
           "apply_coupled_system_best"]

#: kernel launches since the counts were last reset (by name); the plain
#: versions and the dense path never add to them
LAUNCHES = {"apply_system": 0, "apply_coupled_system": 0,
            "apply_system_sharded": 0, "apply_coupled_system_sharded": 0}

#: the largest order the kernels B1-B4 take (the reference's limit;
#: ``P_MAX`` in ``csrc/tile.cuh``)
P_MAX = 64
#: rows and columns of the output tile of B1-B4 (``TI``, ``TJ`` in
#: ``csrc/tile.cuh``)
TILE = 32


def band_storage(A: np.ndarray, P: int) -> np.ndarray:
    """Compact band form ``AB[i, t] = A[i, i-P+t]`` (t ∈ [0, 2P]) of a square
    matrix, zero where ``i-P+t`` leaves the matrix.

    Raises if ``A`` has a nonzero outside the band, since the compact form
    would then drop it.
    """
    n = A.shape[0]
    i = np.arange(n)[:, None]
    k = i - P + np.arange(2 * P + 1)[None, :]
    valid = (k >= 0) & (k < n)
    AB = np.where(valid, A[i, np.clip(k, 0, n - 1)], 0.0)
    outside = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) > P
    if np.any(A[outside] != 0.0):
        raise ValueError(f"matrix has entries outside half-band {P}")
    return AB


def band_tap_ranges(n: int, P: int) -> tuple[np.ndarray, np.ndarray]:
    """Per row ``i`` of an ``n``-node 1D operator of order ``P``, the band
    taps ``t0[i] <= t < t1[i]`` (``AB[i, t] = A[i, i-P+t]``) whose
    coefficients can be nonzero: the ``P+1`` nodes of the row's element for a
    node inside an element (``i mod P != 0``), the ``2P+1`` nodes of both
    elements for an interface node, cut at the grid's edges.  The formula of
    ``tap_span`` in ``csrc/tile.cuh``."""
    i = np.arange(n)
    l = i % P
    k0 = np.where(l == 0, np.maximum(0, i - P), i - l)
    k1 = np.where(l == 0, np.minimum(n - 1, i + P), i - l + P)
    return k0 - i + P, k1 - i + P + 1


def band_operators(grid: Grid2D, dtype, device) -> dict:
    """Band-stored ``K1x, G1x`` (``(Ngx, 2P+1)``), transposed band-stored
    ``K1y, G1y`` (``(2P+1, Ngy)``) and the 1D mass vectors; cached on the
    grid per dtype and device.  The plain versions read the band tables (no
    kernel does: the kernels read :func:`tile_coefficients`), the kernels
    the mass vectors."""
    P = grid.P

    def const(name, host):
        return device_const(grid, ("band", name), host, dtype, device)

    return {
        "kxb": const("kxb", lambda: band_storage(grid.K1x, P)),
        "gxb": const("gxb", lambda: band_storage(grid.G1x, P)),
        "kybT": const("kybT", lambda: band_storage(grid.K1y, P).T),
        "gybT": const("gybT", lambda: band_storage(grid.G1y, P).T),
        "m1x": ops.grid_const(grid, "m1x", dtype, device),
        "m1y": ops.grid_const(grid, "m1y", dtype, device),
    }


def tile_coefficients(grid: Grid2D, device) -> dict:
    """The f32 coefficient tables of the tiled kernels B1-B4: the interleaved
    pairs ``kgx[i, t] = (K1x, G1x)[i, i-P+t]`` (``(Ngx + TILE, 2P+1, 2)``)
    and ``kgy`` of the y operators, with :data:`TILE` rows of zeros at the
    end (a tile's reads past the grid's edge stay inside them); cached on the
    grid per device."""
    P = grid.P

    def pairs(K, G):
        kg = np.stack([band_storage(K, P), band_storage(G, P)], axis=-1)
        return np.concatenate([kg, np.zeros((TILE,) + kg.shape[1:])])

    return {name: device_const(grid, ("tile", name), lambda: pairs(K, G),
                               torch.float32, device)
            for name, K, G in (("kgx", grid.K1x, grid.G1x),
                               ("kgy", grid.K1y, grid.G1y))}


def row_window_tiles(r0: int, r1: int) -> tuple[int, int]:
    """First tile row and number of tile rows of a launch of B1-B4 on grid
    rows ``r0..r1-1`` (``Window`` in ``csrc/tile.cuh``).  The tiles stay on
    the global :data:`TILE`-row lattice, where the compile-time tap loops
    find a warp's nodes inside one element; a strip that starts inside a
    tile shares it with the strip before it, each writing its own rows."""
    t0 = r0 // TILE
    return t0, (r1 - 1) // TILE - t0 + 1

# ----------------------------- plain versions ----------------------------- #
def _band_products(grid: Grid2D, Fs: torch.Tensor, rows=None):
    """``(K1x F, G1x F, F K1yᵀ, F G1yᵀ)`` for a batch ``Fs (B, Ngx, Ngy)``
    from the band form: each direction is one contraction of the band
    coefficients with the (2P+1)-tap windows of the zero-padded field.

    With ``rows=(r0, r1)``, ``Fs (B, r1-r0+2P, Ngy)`` is a row strip with
    ``P`` halo rows on each side (zeros beyond the grid), and the products
    are those of the global rows ``r0..r1-1``."""
    P = grid.P
    c = band_operators(grid, Fs.dtype, Fs.device)
    if rows is None:
        r0, r1 = 0, grid.Ngx
        Fc, Fs = Fs, F.pad(Fs, (0, 0, P, P))
    else:
        r0, r1 = rows
        Fc = Fs[:, P:Fs.shape[1] - P]
    wx = Fs.unfold(1, 2 * P + 1, 1)                  # [b,i,j,t]=F[i-P+t,j]
    wy = F.pad(Fc, (P, P)).unfold(2, 2 * P + 1, 1)   # [b,i,j,t]=F[i,j-P+t]
    X = torch.einsum("oit,bijt->obij",
                     torch.stack([c["kxb"][r0:r1], c["gxb"][r0:r1]]), wx)
    Y = torch.einsum("otj,bijt->obij", torch.stack([c["kybT"], c["gybT"]]),
                     wy)
    return X[0], X[1], Y[0], Y[1], c["m1x"][r0:r1, None], c["m1y"][None, :]


def _system_plain(grid: Grid2D, u, v, Fs, coef, rows=None):
    """B1's function on the rows of ``Fs`` (see :func:`_band_products`)."""
    Kx, Gx, Ky, Gy, m1x, m1y = _band_products(grid, Fs, rows)
    K2d = Kx[0] * m1y + m1x * Ky[0]
    shape = K2d.shape
    return (K2d + coef * (u.reshape(shape) * (Gx[0] * m1y)
                          + v.reshape(shape) * (m1x * Gy[0]))).reshape(-1)


def _coupled_plain(grid: Grid2D, Qs, ul, vl, jac, mb, coef, rows=None):
    """B2's function on the rows of the three fields ``Qs`` (see
    :func:`_band_products`); ``ul``, ``vl``, ``jac``, ``mb`` and the output
    cover the same rows."""
    Kx, Gx, Ky, Gy, m1x, m1y = _band_products(grid, Qs, rows)
    n = Kx.shape[1] * Kx.shape[2]
    K2d = (Kx * m1y + m1x * Ky).reshape(3, n)
    gx = (Gx * m1y).reshape(3, n)
    gy = (m1x * Gy).reshape(3, n)
    P = grid.P
    Qc = Qs if rows is None else Qs[:, P:Qs.shape[1] - P]
    du, dv = Qc[0].reshape(-1), Qc[1].reshape(-1)
    jxx, jxy, jyx, jyy = jac
    dru = K2d[0] + coef * (ul * gx[0] + vl * gy[0]) + jxx * du + jxy * dv \
        + gx[2]
    drv = K2d[1] + coef * (ul * gx[1] + vl * gy[1]) + jyx * du + jyy * dv \
        + gy[2]
    drc = gx[0] + gy[1]
    return torch.cat([torch.where(mb, du, dru), torch.where(mb, dv, drv),
                      torch.where(mb, K2d[2], drc)])


def apply_system_plain(grid: Grid2D, u, v, w, coef) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (same function, band form)."""
    return _system_plain(grid, u, v, w.reshape(1, grid.Ngx, grid.Ngy), coef)


def apply_coupled_system_plain(grid: Grid2D, q, ul, vl, jac, mb, coef
                               ) -> torch.Tensor:
    """Plain PyTorch version of kernel B2 (same function, band form; the
    three Krylov fields form one batch)."""
    return _coupled_plain(grid, q.reshape(3, grid.Ngx, grid.Ngy), ul, vl, jac,
                          mb, coef)


# -------------------------------- wrappers -------------------------------- #
def _check(name: str, tensors, shapes, dtypes):
    dev = tensors[0].device
    for t, shape, dt in zip(tensors, shapes, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: the CUDA kernel takes {dt}, got "
                            f"{t.dtype}")
        if t.device != dev or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors on {dev} "
                             f"of shape {shape}, got {tuple(t.shape)} on "
                             f"{t.device}")


_FNS = {}   # the library's C entry points, looked up once


def _launch(name: str, fn_name: str, device, *args):
    """Call the C entry point ``fn_name`` on ``device``'s current stream
    (the raw handle: building a ``torch.cuda.Stream`` object costs more host
    time than the launch); raise if the launch failed."""
    fn = _FNS.get(fn_name)
    if fn is None:
        from sem_tpu_torch.ops import _build

        fn = _FNS[fn_name] = getattr(_build.library(), fn_name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    LAUNCHES[name] += 1


def _band_ptrs(grid: Grid2D, device) -> tuple:
    """Device addresses of the f32 constants of B1-B4 (kgx, kgy, m1x,
    m1y), cached on the grid beside the tensors that own them."""
    cache = grid.__dict__.setdefault("_band_ptrs", {})
    ptrs = cache.get(device)
    if ptrs is None:
        if not 1 <= grid.P <= P_MAX:
            raise ValueError(f"the CUDA kernels B1-B4 take orders 1 <= P <= "
                             f"{P_MAX}, got P={grid.P}")
        t = tile_coefficients(grid, device)
        c = band_operators(grid, torch.float32, device)
        ptrs = cache[device] = (t["kgx"].data_ptr(), t["kgy"].data_ptr(),
                                c["m1x"].data_ptr(), c["m1y"].data_ptr())
    return ptrs


def apply_system_kernel(grid: Grid2D, u, v, w, coef) -> torch.Tensor:
    """Kernel B1 on a CUDA tensor (float32 only); the plain version for a
    tensor on the CPU."""
    if w.device.type == "cpu":
        return apply_system_plain(grid, u, v, w, coef)
    f32, shape = torch.float32, (grid.N,)
    _check("apply_system", (w, u, v), (shape,) * 3, (f32,) * 3)
    out = torch.empty_like(w)
    _launch("apply_system", "sem_apply_system_f32", w.device,
            out.data_ptr(), u.data_ptr(), v.data_ptr(), w.data_ptr(),
            *_band_ptrs(grid, w.device), float(coef), grid.Ngx, grid.Ngy,
            grid.P)
    return out


def apply_coupled_system_kernel(grid: Grid2D, q, ul, vl, jac, mb, coef
                                ) -> torch.Tensor:
    """Kernel B2 on CUDA tensors (float32 fields, bool mask); the plain
    version for tensors on the CPU.  The pressure-pin row is the caller's."""
    if q.device.type == "cpu":
        return apply_coupled_system_plain(grid, q, ul, vl, jac, mb, coef)
    f32, N = torch.float32, grid.N
    _check("apply_coupled_system", (q, ul, vl, *jac, mb),
           ((3 * N,),) + ((N,),) * 7, (f32,) * 7 + (torch.bool,))
    out = torch.empty_like(q)
    _launch("apply_coupled_system", "sem_apply_coupled_system_f32", q.device,
            out.data_ptr(), q.data_ptr(), ul.data_ptr(), vl.data_ptr(),
            *(j.data_ptr() for j in jac), mb.data_ptr(),
            *_band_ptrs(grid, q.device), float(coef), grid.Ngx, grid.Ngy,
            grid.P)
    return out


# ------------------------------- dispatchers ------------------------------ #
def apply_system_best(grid: Grid2D, u, v, w, coef) -> torch.Tensor:
    """float64 → the dense path; otherwise kernel B1 (plain on the CPU)."""
    if w.dtype == torch.float64:
        return ops.apply_system(grid, u, v, w, coef)
    return apply_system_kernel(grid, u, v, w, coef)


def apply_coupled_system_best(grid: Grid2D, q, ul, vl, jac, mb, coef
                              ) -> torch.Tensor:
    """float64 → the dense path; otherwise kernel B2 (plain on the CPU)."""
    if q.dtype == torch.float64:
        return ops.apply_coupled_system(grid, q, ul, vl, jac, mb, coef)
    return apply_coupled_system_kernel(grid, q, ul, vl, jac, mb, coef)
