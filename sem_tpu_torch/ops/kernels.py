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
coefficient is a structural zero; at bfloat16 they read them as the dense
band blocks of their 32-node tiles (:func:`band_blocks`) and run only the
16-wide k chunks that hold such taps.  They take orders ``1 ≤ P ≤ 64``
(:data:`P_MAX`, the reference's limit) and raise for others.  The row-strip
kernels B3/B4 of :mod:`sem_tpu_torch.ops.sharded` are the same kernels on a
row window, launched on the tiles of :func:`row_window_tiles`.

Field dtypes.  Like the reference's Pallas kernels, B1-B4 take float32 or
bfloat16 fields (every floating operand of a call in one dtype; B2's mask
is bool).  At bfloat16 they compute the reference kernel's bf16 function:
the fields, the band coefficients, the 1D masses and ``coef`` rounded to
bf16, every product exact and every sum in f32, one rounding to bf16 at the
output (:func:`band_operators` holds the rounded masses as f32).  B1-B4 at
bf16 run their band products on the tensor cores (``csrc/mma.cuh``: bf16
operands, f32 accumulation), reading the band blocks of :func:`band_blocks`
in bf16.  The solvers' chunks are f32; bf16 serves speed runs.

A wrapper launches its kernel for CUDA tensors of those dtypes and raises
for any other dtype on the card; a build or launch failure raises.  Only a
tensor on the CPU takes the plain version (``*_plain``), which computes the
same function with plain tensor ops in the compact band form.  Each launch
adds one to :data:`LAUNCHES` under the wrapper's name, and a bf16 launch
under that name with ``_bf16`` appended (``apply_system_bf16``, ...); the
row-strip kernels B3/B4 of :mod:`sem_tpu_torch.ops.sharded` count there
too, each under its own name.  The dispatchers ``apply_system_best`` /
``apply_coupled_system_best`` send float64 fields, and every field at
orders above :data:`P_MAX`, to the dense two-matmul path of
:mod:`sem_tpu_torch.operators`, as the reference's dispatcher does off the
TPU (:func:`_dense_route`); the strip wrappers of B3/B4 do the same above
:data:`P_MAX`.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch
import torch.nn.functional as F

from sem_tpu_torch import operators as ops
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.utils.tensors import device_const

__all__ = ["LAUNCHES", "P_MAX", "TILE", "band_storage", "band_operators",
           "band_tap_ranges", "tile_coefficients", "mma_geometry",
           "library_mma_geometry", "band_blocks", "row_window_tiles",
           "apply_system_kernel",
           "apply_system_plain", "apply_system_best",
           "apply_coupled_system_kernel", "apply_coupled_system_plain",
           "apply_coupled_system_best"]

#: kernel launches since the counts were last reset (by name); the plain
#: versions and the dense path never add to them
LAUNCHES = {name + sfx: 0 for sfx in ("", "_bf16") for name in (
    "apply_system", "apply_coupled_system", "apply_system_sharded",
    "apply_coupled_system_sharded")}
# the split and merge passes of the FDM and spectral Schur transforms in
# even-odd form (:mod:`sem_tpu_torch.ops.gemm`), two a transform
LAUNCHES["evenodd_pass"] = 0

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


def _field_const(grid: Grid2D, key, host, dtype, device) -> torch.Tensor:
    """The grid constant ``host()`` as B1-B4 read it for fields of
    ``dtype``, cached on the grid: in ``dtype`` for float32 and float64; for
    bfloat16 rounded to bf16 (as the reference's kernel casts its constants
    to the field dtype) and held as float32, in which its arithmetic runs."""
    if dtype != torch.bfloat16:
        return device_const(grid, key, host, dtype, device)
    return device_const(
        grid, (key, "bf16"),
        lambda: torch.tensor(np.ascontiguousarray(host())).to(
            torch.bfloat16).float().numpy(),
        torch.float32, device)


def band_operators(grid: Grid2D, dtype, device) -> dict:
    """Band-stored ``K1x, G1x`` (``(Ngx, 2P+1)``), transposed band-stored
    ``K1y, G1y`` (``(2P+1, Ngy)``) and the 1D mass vectors for fields of
    ``dtype`` (bfloat16: bf16-rounded float32 values, :func:`_field_const`);
    cached on the grid per dtype and device.  The plain versions read the
    band tables (no kernel does: the kernels read :func:`tile_coefficients`
    at f32 and :func:`band_blocks` at bf16), the kernels the mass
    vectors."""
    P = grid.P

    def const(name, host):
        return _field_const(grid, ("band", name), host, dtype, device)

    return {
        "kxb": const("kxb", lambda: band_storage(grid.K1x, P)),
        "gxb": const("gxb", lambda: band_storage(grid.G1x, P)),
        "kybT": const("kybT", lambda: band_storage(grid.K1y, P).T),
        "gybT": const("gybT", lambda: band_storage(grid.G1y, P).T),
        "m1x": _field_const(grid, "m1x", lambda: grid.m1x, dtype, device),
        "m1y": _field_const(grid, "m1y", lambda: grid.m1y, dtype, device),
    }


def tile_coefficients(grid: Grid2D, device) -> dict:
    """The f32 coefficient tables of the tiled kernels B1-B4 on f32 fields:
    the interleaved pairs ``kgx[i, t] = (K1x, G1x)[i, i-P+t]``
    (``(Ngx + TILE, 2P+1, 2)``) and ``kgy`` of the y operators, with
    :data:`TILE` rows of zeros at the end (a tile's reads past the grid's
    edge stay inside them); cached on the grid per device."""
    P = grid.P

    def pairs(K, G):
        kg = np.stack([band_storage(K, P), band_storage(G, P)], axis=-1)
        return np.concatenate([kg, np.zeros((TILE,) + kg.shape[1:])])

    return {name: device_const(grid, ("tile", name), lambda: pairs(K, G),
                               torch.float32, device)
            for name, K, G in (("kgx", grid.K1x, grid.G1x),
                               ("kgy", grid.K1y, grid.G1y))}


def mma_geometry(P: int) -> tuple[int, int, int]:
    """``(Q, nk, pitch)`` of the tensor-core kernels at order ``P``
    (``halo``, ``chunks``, ``pitch`` in ``csrc/mma.cuh``): the left halo
    ``Q`` (P rounded up to 8) of a staged tile, the ``nk`` 16-wide k chunks
    that cover ``Q + TILE + P`` nodes, and the row pitch ``16·nk + 8`` (in
    values) of every staged block.  :func:`band_blocks` checks it against
    the library's (:func:`library_mma_geometry`) before it builds blocks on
    the card."""
    Q = -(-P // 8) * 8
    nk = -(-(Q + TILE + P) // 16)
    return Q, nk, 16 * nk + 8


def library_mma_geometry(P: int) -> tuple[int, int, int]:
    """``(Q, nk, pitch)`` at order ``P`` as the built kernels stage it
    (``sem_mma_geometry``; builds the library at first use)."""
    from sem_tpu_torch.ops import _build

    out = (ctypes.c_int * 3)()
    _build.library().sem_mma_geometry(P, out)
    return tuple(out)


def band_blocks(grid: Grid2D, device) -> dict:
    """The bf16 band blocks of the tensor-core kernels B1-B4 at bf16
    (``csrc/mma.cuh``), in the layout a block copies flat into shared
    memory: ``bx[t, 0, r, c] = K1x[t·TILE + r, t·TILE − Q + c]`` and
    ``bx[t, 1, r, c]`` the same of ``G1x`` for each tile row ``t``
    (``(ceil(Ngx/TILE), 2, TILE, pitch)``), ``by`` the same of ``K1y``,
    ``G1y`` for each tile column; zero outside the grid and in the pitch's
    last 8 values (:func:`mma_geometry`).  The values are the operators
    rounded to bf16 as the reference's kernel rounds its band blocks
    (``astype``) and as the plain versions' bf16 tables hold them; cached on
    the grid per device."""
    P = grid.P
    Q, nk, pitch = mma_geometry(P)

    def blocks(K, G):
        n = K.shape[0]
        t0 = TILE * np.arange(-(-n // TILE))[:, None, None]
        r = t0 + np.arange(TILE)[None, :, None]
        k = t0 - Q + np.arange(pitch)[None, None, :]
        ok = (r < n) & (k >= 0) & (k < n) & (k - t0 + Q < 16 * nk)
        r, k = np.clip(r, 0, n - 1), np.clip(k, 0, n - 1)
        out = np.stack([np.where(ok, A[r, k], 0.0) for A in (K, G)], axis=1)
        return torch.tensor(out).to(torch.bfloat16)

    cache = grid.__dict__.setdefault("_band_blocks", {})
    device = torch.device(device)
    if device not in cache:
        if device.type == "cuda" and library_mma_geometry(P) != (Q, nk,
                                                                 pitch):
            raise RuntimeError(
                f"band_blocks: the kernels stage P={P} as (Q, nk, pitch) = "
                f"{library_mma_geometry(P)}, mma_geometry gives "
                f"{(Q, nk, pitch)}")
        cache[device] = {
            "bx": blocks(grid.K1x, grid.G1x).to(device),
            "by": blocks(grid.K1y, grid.G1y).to(device)}
    return cache[device]


def row_window_tiles(r0: int, r1: int) -> tuple[int, int]:
    """First tile row and number of tile rows of a launch of B1-B4 on grid
    rows ``r0..r1-1`` (``Window`` in ``csrc/tile.cuh``).  The tiles stay on
    the global :data:`TILE`-row lattice, where the compile-time tap loops
    find a warp's nodes inside one element; a strip that starts inside a
    tile shares it with the strip before it, each writing its own rows."""
    t0 = r0 // TILE
    return t0, (r1 - 1) // TILE - t0 + 1

# ----------------------------- plain versions ----------------------------- #
def _widen(t: torch.Tensor) -> torch.Tensor:
    """A pointwise operand of a bf16 call as the reference's kernel reads
    it: rounded to bf16, computed on in f32."""
    return t.to(torch.bfloat16).float()


def _bf16_coef(coef) -> float:
    """``coef`` rounded to bf16 as torch's cast rounds (through f32, to
    nearest even), as the reference's kernel passes it, on the scalar's
    bits (the plain versions; a bf16 entry point rounds the f32 ``coef`` it
    is given with ``bf16_round``, ``csrc/tile.cuh``)."""
    try:
        b = struct.unpack("<I", struct.pack("<f", float(coef)))[0]
    except OverflowError:            # rounds to ±inf in f32
        b = 0xFF800000 if coef < 0 else 0x7F800000
    if b & 0x7FFFFFFF > 0x7F800000:
        return float("nan")
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", b))[0]


def _band_products(grid: Grid2D, Fs: torch.Tensor, rows=None, dtype=None):
    """``(K1x F, G1x F, F K1yᵀ, F G1yᵀ)`` for a batch ``Fs (B, Ngx, Ngy)``
    from the band form: each direction is one contraction of the band
    coefficients with the (2P+1)-tap windows of the zero-padded field.

    With ``rows=(r0, r1)``, ``Fs (B, r1-r0+2P, Ngy)`` is a row strip with
    ``P`` halo rows on each side (zeros beyond the grid), and the products
    are those of the global rows ``r0..r1-1``.  ``dtype`` is the fields'
    dtype of the call (default ``Fs.dtype``): for bfloat16, ``Fs`` is the
    fields upcast to f32 and the coefficients are rounded to bf16."""
    P = grid.P
    c = band_operators(grid, dtype or Fs.dtype, Fs.device)
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
    """B1's function on the rows of ``Fs`` (see :func:`_band_products`); at
    bfloat16 the reference kernel's bf16 function (module docstring)."""
    dt = Fs.dtype
    if dt == torch.bfloat16:
        u, v, Fs, coef = _widen(u), _widen(v), Fs.float(), _bf16_coef(coef)
    Kx, Gx, Ky, Gy, m1x, m1y = _band_products(grid, Fs, rows, dt)
    K2d = Kx[0] * m1y + m1x * Ky[0]
    shape = K2d.shape
    return (K2d + coef * (u.reshape(shape) * (Gx[0] * m1y)
                          + v.reshape(shape) * (m1x * Gy[0]))
            ).reshape(-1).to(dt)


def _coupled_plain(grid: Grid2D, Qs, ul, vl, jac, mb, coef, rows=None):
    """B2's function on the rows of the three fields ``Qs`` (see
    :func:`_band_products`); ``ul``, ``vl``, ``jac``, ``mb`` and the output
    cover the same rows.  At bfloat16 the reference kernel's bf16 function
    (module docstring)."""
    dt = Qs.dtype
    if dt == torch.bfloat16:
        ul, vl, jac = _widen(ul), _widen(vl), tuple(map(_widen, jac))
        Qs, coef = Qs.float(), _bf16_coef(coef)
    Kx, Gx, Ky, Gy, m1x, m1y = _band_products(grid, Qs, rows, dt)
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
                      torch.where(mb, K2d[2], drc)]).to(dt)


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
#: the C entry points' suffix by field dtype
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(name: str, tensors, shapes, masks: int = 0) -> str:
    """Check a launch's operands: contiguous, on one device, of the given
    shapes; the fields float32 or bfloat16, all in the first one's dtype;
    the last ``masks`` tensors bool.  Returns the dtype's suffix of the C
    entry points (:data:`_SUFFIX`)."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in _SUFFIX:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16 "
                        f"fields, got {dt}")
    nf = len(tensors) - masks
    for k, (t, shape) in enumerate(zip(tensors, shapes)):
        want = dt if k < nf else torch.bool
        if t.dtype != want:
            raise TypeError(f"{name}: the CUDA kernel takes {want} there "
                            f"(the fields' dtype, or a bool mask), got "
                            f"{t.dtype}")
        if t.device != dev or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors on {dev} "
                             f"of shape {shape}, got {tuple(t.shape)} on "
                             f"{t.device}")
    return _SUFFIX[dt]


_FNS = {}   # the library's C entry points, looked up once


def _launch(name: str, entry: str, sfx: str, device, *args):
    """Call the C entry point ``{entry}_{sfx}`` (``sfx`` from :func:`_check`)
    on ``device``'s current stream (the raw handle: building a
    ``torch.cuda.Stream`` object costs more host time than the launch);
    raise if the launch failed.  Counts one launch under ``name``, or
    ``{name}_bf16`` for a bf16 one."""
    fn_name = f"{entry}_{sfx}"
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
    LAUNCHES[name if sfx == "f32" else f"{name}_{sfx}"] += 1


def _band_ptrs(grid: Grid2D, device, dtype=torch.float32) -> tuple:
    """Device addresses of the constants of B1-B4 for fields of ``dtype``:
    the f32 coefficient pairs (kgx, kgy; :func:`tile_coefficients`) or, at
    bfloat16 (the tensor-core kernels), the bf16 band blocks (bx, by;
    :func:`band_blocks`), then the masses (m1x, m1y; f32, bf16-rounded at
    bfloat16); cached on the grid beside the tensors that own them."""
    cache = grid.__dict__.setdefault("_band_ptrs", {})
    key = (device, dtype)
    ptrs = cache.get(key)
    if ptrs is None:
        if not 1 <= grid.P <= P_MAX:
            raise ValueError(f"the CUDA kernels B1-B4 take orders 1 <= P <= "
                             f"{P_MAX}, got P={grid.P}")
        t = (band_blocks(grid, device) if dtype == torch.bfloat16
             else tile_coefficients(grid, device))
        c = band_operators(grid, dtype, device)
        ptrs = cache[key] = tuple(a.data_ptr() for a in (
            *t.values(), c["m1x"], c["m1y"]))
    return ptrs


def apply_system_kernel(grid: Grid2D, u, v, w, coef) -> torch.Tensor:
    """Kernel B1 on CUDA tensors (float32 or bfloat16 fields, one dtype);
    the plain version for tensors on the CPU."""
    if w.device.type == "cpu":
        return apply_system_plain(grid, u, v, w, coef)
    sfx = _check("apply_system", (w, u, v), ((grid.N,),) * 3)
    out = torch.empty_like(w)
    _launch("apply_system", "sem_apply_system", sfx, w.device,
            out.data_ptr(), u.data_ptr(), v.data_ptr(), w.data_ptr(),
            *_band_ptrs(grid, w.device, w.dtype), float(coef), grid.Ngx,
            grid.Ngy, grid.P)
    return out


def apply_coupled_system_kernel(grid: Grid2D, q, ul, vl, jac, mb, coef
                                ) -> torch.Tensor:
    """Kernel B2 on CUDA tensors (float32 or bfloat16 fields, one dtype;
    bool mask); the plain version for tensors on the CPU.  The pressure-pin
    row is the caller's."""
    if q.device.type == "cpu":
        return apply_coupled_system_plain(grid, q, ul, vl, jac, mb, coef)
    N = grid.N
    sfx = _check("apply_coupled_system", (q, ul, vl, *jac, mb),
                 ((3 * N,),) + ((N,),) * 7, masks=1)
    out = torch.empty_like(q)
    _launch("apply_coupled_system", "sem_apply_coupled_system", sfx,
            q.device, out.data_ptr(), q.data_ptr(), ul.data_ptr(),
            vl.data_ptr(), *(j.data_ptr() for j in jac), mb.data_ptr(),
            *_band_ptrs(grid, q.device, q.dtype), float(coef),
            grid.Ngx, grid.Ngy, grid.P)
    return out


# ------------------------------- dispatchers ------------------------------ #
def _dense_route(grid: Grid2D, dtype) -> bool:
    """Whether an apply takes the dense path of :mod:`sem_tpu_torch.operators`
    and launches no kernel: float64 fields, or any fields at orders above
    :data:`P_MAX`, which the kernels do not take (the reference's
    dispatcher takes the dense path there off the TPU), on whatever device
    the fields are."""
    return dtype == torch.float64 or grid.P > P_MAX


def apply_system_best(grid: Grid2D, u, v, w, coef) -> torch.Tensor:
    """float64 fields, and every field at ``P > P_MAX`` → the dense path (B1
    launches 0 times there); float32 and bfloat16 → kernel B1 (plain on the
    CPU)."""
    if _dense_route(grid, w.dtype):
        return ops.apply_system(grid, u, v, w, coef)
    return apply_system_kernel(grid, u, v, w, coef)


def apply_coupled_system_best(grid: Grid2D, q, ul, vl, jac, mb, coef
                              ) -> torch.Tensor:
    """float64 fields, and every field at ``P > P_MAX`` → the dense path (B2
    launches 0 times there); float32 and bfloat16 → kernel B2 (plain on the
    CPU)."""
    if _dense_route(grid, q.dtype):
        return ops.apply_coupled_system(grid, q, ul, vl, jac, mb, coef)
    return apply_coupled_system_kernel(grid, q, ul, vl, jac, mb, coef)
