"""The two hand-written CUDA kernels of the solve path, their plain PyTorch
versions, and the dispatchers the solvers call.

* **B1** ``apply_system_kernel``: ``(K + c·(u∂x + v∂y)) w`` — the CD matvec
  of every f32 Krylov iteration (``csrc/apply_system.cu``; replaces
  ``sem_tpu.ops.pallas_kernels.apply_system_pallas``).
* **B2** ``apply_coupled_system_kernel``: the NS tangent saddle matvec of
  every f32 coupled Krylov iteration (``csrc/coupled_system.cu``; replaces
  ``apply_coupled_system_pallas``).

Both kernels read the assembled 1D operators in compact band storage
(:func:`band_operators`), which is exact because every nonzero of the C0
operators lies within half-band P of the diagonal (checked when built).

A wrapper launches its kernel for a CUDA float32 tensor and raises for any
other dtype on the card; a build or launch failure raises.  Only a tensor on
the CPU takes the plain version (``*_plain``), which computes the same
function with plain tensor ops in the compact band form.  Each launch adds one
to :data:`LAUNCHES`.  The dispatchers ``apply_system_best`` /
``apply_coupled_system_best`` send float64 fields to the dense two-matmul
path of :mod:`sem_tpu_torch.operators`, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sem_tpu_torch import operators as ops
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.utils.tensors import device_const

__all__ = ["LAUNCHES", "band_storage", "band_operators",
           "apply_system_kernel", "apply_system_plain", "apply_system_best",
           "apply_coupled_system_kernel", "apply_coupled_system_plain",
           "apply_coupled_system_best"]

#: kernel launches since the counts were last reset (by name); the plain
#: versions and the dense path never add to them
LAUNCHES = {"apply_system": 0, "apply_coupled_system": 0}


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


def band_operators(grid: Grid2D, dtype, device) -> dict:
    """Band-stored ``K1x, G1x`` (``(Ngx, 2P+1)``), transposed band-stored
    ``K1y, G1y`` (``(2P+1, Ngy)``, the layout the kernels read coalesced)
    and the 1D mass vectors, cached on the grid per dtype and device."""
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


# ----------------------------- plain versions ----------------------------- #
def _band_products(grid: Grid2D, Fs: torch.Tensor):
    """``(K1x F, G1x F, F K1yᵀ, F G1yᵀ)`` for a batch ``Fs (B, Ngx, Ngy)``
    from the band form: each direction is one contraction of the band
    coefficients with the (2P+1)-tap windows of the zero-padded field."""
    P = grid.P
    c = band_operators(grid, Fs.dtype, Fs.device)
    wx = F.pad(Fs, (0, 0, P, P)).unfold(1, 2 * P + 1, 1)   # [b,i,j,t]=F[i-P+t,j]
    wy = F.pad(Fs, (P, P)).unfold(2, 2 * P + 1, 1)         # [b,i,j,t]=F[i,j-P+t]
    X = torch.einsum("oit,bijt->obij", torch.stack([c["kxb"], c["gxb"]]), wx)
    Y = torch.einsum("otj,bijt->obij", torch.stack([c["kybT"], c["gybT"]]),
                     wy)
    return X[0], X[1], Y[0], Y[1], c["m1x"][:, None], c["m1y"][None, :]


def apply_system_plain(grid: Grid2D, u, v, w, coef) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (same function, band form)."""
    Kx, Gx, Ky, Gy, m1x, m1y = _band_products(
        grid, w.reshape(1, grid.Ngx, grid.Ngy))
    K2d = Kx[0] * m1y + m1x * Ky[0]
    return (K2d + coef * (u.reshape(grid.Ngx, grid.Ngy) * (Gx[0] * m1y)
                          + v.reshape(grid.Ngx, grid.Ngy) * (m1x * Gy[0]))
            ).reshape(-1)


def apply_coupled_system_plain(grid: Grid2D, q, ul, vl, jac, mb, coef
                               ) -> torch.Tensor:
    """Plain PyTorch version of kernel B2 (same function, band form; the
    three Krylov fields form one batch)."""
    N = grid.N
    Kx, Gx, Ky, Gy, m1x, m1y = _band_products(
        grid, q.reshape(3, grid.Ngx, grid.Ngy))
    K2d = (Kx * m1y + m1x * Ky).reshape(3, N)
    gx = (Gx * m1y).reshape(3, N)
    gy = (m1x * Gy).reshape(3, N)
    du, dv = q[:N], q[N:2 * N]
    jxx, jxy, jyx, jyy = jac
    dru = K2d[0] + coef * (ul * gx[0] + vl * gy[0]) + jxx * du + jxy * dv \
        + gx[2]
    drv = K2d[1] + coef * (ul * gx[1] + vl * gy[1]) + jyx * du + jyy * dv \
        + gy[2]
    drc = gx[0] + gy[1]
    return torch.cat([torch.where(mb, du, dru), torch.where(mb, dv, drv),
                      torch.where(mb, K2d[2], drc)])


# -------------------------------- wrappers -------------------------------- #
def _check(name: str, tensors, shapes, dtypes):
    dev = tensors[0].device
    for t, shape, dt in zip(tensors, shapes, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: the CUDA kernel takes {dt}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor of shape "
                             f"{shape}, got {tuple(t.shape)}")


def _launch(name: str, fn_name: str, device, *args):
    from sem_tpu_torch.ops import _build

    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    LAUNCHES[name] += 1


def apply_system_kernel(grid: Grid2D, u, v, w, coef) -> torch.Tensor:
    """Kernel B1 on a CUDA tensor (float32 only); the plain version for a
    tensor on the CPU."""
    if w.device.type == "cpu":
        return apply_system_plain(grid, u, v, w, coef)
    f32 = torch.float32
    _check("apply_system", (w, u, v), [(grid.N,)] * 3, [f32] * 3)
    c = band_operators(grid, f32, w.device)
    out = torch.empty_like(w)
    _launch("apply_system", "sem_apply_system_f32", w.device,
            out.data_ptr(), u.data_ptr(), v.data_ptr(), w.data_ptr(),
            c["kxb"].data_ptr(), c["gxb"].data_ptr(), c["kybT"].data_ptr(),
            c["gybT"].data_ptr(), c["m1x"].data_ptr(), c["m1y"].data_ptr(),
            float(coef), grid.Ngx, grid.Ngy, grid.P)
    return out


def apply_coupled_system_kernel(grid: Grid2D, q, ul, vl, jac, mb, coef
                                ) -> torch.Tensor:
    """Kernel B2 on CUDA tensors (float32 fields, bool mask); the plain
    version for tensors on the CPU.  The pressure-pin row is the caller's."""
    if q.device.type == "cpu":
        return apply_coupled_system_plain(grid, q, ul, vl, jac, mb, coef)
    f32, N = torch.float32, grid.N
    _check("apply_coupled_system", (q, ul, vl, *jac, mb),
           [(3 * N,)] + [(N,)] * 7, [f32] * 7 + [torch.bool])
    c = band_operators(grid, f32, q.device)
    out = torch.empty_like(q)
    _launch("apply_coupled_system", "sem_apply_coupled_system_f32", q.device,
            out.data_ptr(), q.data_ptr(), ul.data_ptr(), vl.data_ptr(),
            *(j.data_ptr() for j in jac), mb.data_ptr(),
            c["kxb"].data_ptr(), c["gxb"].data_ptr(), c["kybT"].data_ptr(),
            c["gybT"].data_ptr(), c["m1x"].data_ptr(), c["m1y"].data_ptr(),
            float(coef), grid.Ngx, grid.Ngy, grid.P)
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
