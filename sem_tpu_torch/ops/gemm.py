"""The f32 eigenbasis transform of the FDM preconditioner on the card, in
even-odd form: four batched cuBLAS products of half the depth and width
between two hand-written passes (``csrc/evenodd_passes.cu``).

:func:`transform` computes, for each field ``F`` of a batch,

    U = Zx · (D ∘ (Zxᵀ · R · Zy)) · Zyᵀ

with ``R`` a window of ``F`` less ``FDM2D``'s Dirichlet corrections, and
writes ``U`` into that window of the output field, ``F``'s values around it.

**Even-odd form.**  On a grid symmetric about its midlines (every main-path
grid) each 1D basis splits into even and odd columns (:func:`parity`).
With ``Ẑ[a]`` the first half of the rows of the columns of parity ``a``
and ``R̂[a, b]`` the sums (even) or differences (odd) of mirrored rows and
columns of ``R``,

    Zxᵀ R Zy = Σ over (a, b) of the modes of parity (a, b): Ẑx[a]ᵀ R̂[a, b] Ẑy[b]

so each product becomes four of half the depth and width, half the
operations of the plain ones.  The split pass writes ``R̂``, the merge pass
adds the four results back into the window's mirrored quarters.

**Layouts.**  Each product is one ``torch.bmm`` batched over the two
parities of the basis it contracts with, every other index folded into the
rows or columns of its operand, so that no product copies its operands
(``Pp``, ``Sp``, ``Qp``, ``Tp``: the half-window's rows and columns and the
modes per parity in x and y, each padded with zeros to a multiple of 4
floats, so that every row and batch entry starts 16-byte aligned)::

    R̂   (ax, r, f, by, l)          the split pass
    C1  (ax, i, f, by, l)  = Ẑx[ax]ᵀ R̂          batch ax
    W   (by, ax, i, f, j)  = C1 Ẑy[by]           batch by, rows (ax, i, f)
    W'  (ax, i, f, by, j)  = D ∘ W               one elementwise product
    C3  (ax, r, f, by, j)  = Ẑx[ax] W'           batch ax
    U   (by, ax, r, f, l)  = C3 Ẑy[by]ᵀ          batch by, rows (ax, r, f)

(``f`` the field, ``r``/``l`` half-window rows and columns, ``i``/``j``
modes).  The products are cuBLAS SGEMMs in f32 (TF32 stays off).  The
hand-written passes read the field once and write it once: the split
applies the window and the corrections on the way in, the merge writes the
window and the field's ring on the way out.

:func:`bases` keeps the f32 bases in that form, once per owner and device;
:meth:`Bases.matrix` and :meth:`Bases.vector` lay the diagonal's host data
out in ``D``'s layout.  Where a basis has no even-odd form :func:`bases`
returns None and ``FDM2D`` keeps its plain ``torch.matmul`` code, as it
does for float64 fields and on the CPU (:func:`takes`).

Each pass launch adds one to ``kernels.LAUNCHES["evenodd_pass"]`` (a CUDA
graph's replay adds what its capture recorded), each transform one to
``profiling.COUNTERS["fdm.gemm_launches"]``.
"""
from __future__ import annotations

import ctypes
import typing

import numpy as np
import torch

from sem_tpu_torch.ops.kernels import _launch
from sem_tpu_torch.utils.profiling import COUNTERS
from sem_tpu_torch.utils.tensors import device_const

__all__ = ["PARITY_TOL", "parity", "Bases", "bases", "takes",
           "Corrections", "transform"]

#: :func:`parity`'s test of a column: its mirror asymmetry at most this
#: share of its largest entry, under half an f32 ulp of that entry, so that
#: the f32 halves round from the same values as the whole column
PARITY_TOL = 3e-8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad4(n: int) -> int:
    return _cdiv(n, 4) * 4


def parity(Z: np.ndarray, tol: float = PARITY_TOL):
    """The even-odd form of a basis ``Z`` (``n × s``: rows the grid's nodes
    in order, columns the modes) of an operator symmetric about the grid's
    middle row: ``(Ẑ, modes)``, ``Ẑ`` of ``2 × P × S`` (``P = n - n // 2``):
    ``Ẑ[0]`` the even columns' first ``P`` rows, ``Ẑ[1]`` the odd columns'
    first ``n // 2`` rows, zero beyond; ``modes`` the two arrays of the
    columns' indices in ``Z``.  A column is even or odd to ``tol`` of its
    largest entry; None where a column is neither (a grid that is not
    symmetric), or ``n < 2``."""
    n, s = Z.shape
    h = n // 2
    if h == 0:
        return None
    scale = tol * np.abs(Z).max(axis=0)
    even = np.abs(Z - Z[::-1]).max(axis=0) <= scale
    odd = np.abs(Z + Z[::-1]).max(axis=0) <= scale
    if not np.all(even ^ odd):
        return None
    modes = (np.flatnonzero(even), np.flatnonzero(odd))
    P, S = n - h, max(map(len, modes))
    out = np.zeros((2, P, S))
    out[0, :, :len(modes[0])] = Z[:P][:, modes[0]]
    out[1, :h, :len(modes[1])] = Z[:h][:, modes[1]]
    return out, modes


class Bases(typing.NamedTuple):
    """The f32 bases as :func:`transform` reads them (from :func:`bases`):
    ``zx`` ``2 × Pp × Sp`` (per x parity the half-window's rows and modes,
    zero-padded to multiples of 4), ``zy`` ``2 × Qp × Tp``; ``modes_x``,
    ``modes_y`` each parity's columns in the whole basis."""
    zx: torch.Tensor
    zy: torch.Tensor
    modes_x: tuple
    modes_y: tuple

    def matrix(self, owner, key, host: typing.Callable[[], np.ndarray],
               pad) -> torch.Tensor:
        """The host matrix ``host()`` over the modes (``s × t``) in the
        layout of ``D``, ``(by, ax, i, 1, j)`` (``pad`` beyond the modes),
        of the bases' dtype and device, cached on ``owner``."""
        def build():
            a = np.asarray(host())
            Sp, Tp = self.zx.shape[2], self.zy.shape[2]
            out = np.full((2, 2, Sp, 1, Tp), pad, dtype=a.dtype)
            for ax, mx in enumerate(self.modes_x):
                for by, my in enumerate(self.modes_y):
                    out[by, ax, :len(mx), 0, :len(my)] = a[np.ix_(mx, my)]
            return out

        return device_const(owner, ("gemm", key), build, self.zx.dtype,
                            self.zx.device)

    def vector(self, owner, key, axis, host, pad) -> torch.Tensor:
        """The host vector ``host()`` over the modes of ``axis`` (0: x, 1:
        y) in ``D``'s layout, ``(1, 2, Sp, 1, 1)`` or ``(2, 1, 1, 1, Tp)``
        (``pad`` beyond the modes), of the bases' dtype and device, cached
        on ``owner``."""
        def build():
            a = np.asarray(host())
            modes = self.modes_x if axis == 0 else self.modes_y
            out = np.full((2, (self.zx if axis == 0 else self.zy).shape[2]),
                          pad)
            for par, m in enumerate(modes):
                out[par, :len(m)] = a[m]
            return (out[None, :, :, None, None] if axis == 0 else
                    out[:, None, None, None, :])

        return device_const(owner, ("gemm", key), build, self.zx.dtype,
                            self.zx.device)


def bases(owner, Zx: typing.Callable[[], np.ndarray],
          Zy: typing.Callable[[], np.ndarray], device,
          dtype=torch.float32) -> typing.Optional[Bases]:
    """The :class:`Bases` of the host bases ``Zx()`` (``p × s``) and
    ``Zy()`` (``q × t``) where both have an even-odd form (grids symmetric
    about their midlines), else None; copies of ``dtype`` made once per
    device and kept on ``owner``
    (:func:`~sem_tpu_torch.utils.tensors.device_const`), the y copy the x
    one where the host arrays are equal (square grids)."""
    cache = owner.__dict__.setdefault("_gemm_bases", {})
    key = (torch.device(device), dtype)
    if key in cache:
        return cache[key]
    px, py = parity(Zx()), parity(Zy())
    out = None
    if px is not None and py is not None:
        def padded(key, p):
            def build():
                z = p[0]
                full = np.zeros((2, _pad4(z.shape[1]), _pad4(z.shape[2])))
                full[:, :z.shape[1], :z.shape[2]] = z
                return full
            return device_const(owner, ("gemm", key), build, dtype,
                                device)

        zx = padded("Zx_parity", px)
        zy = zx if np.array_equal(Zx(), Zy()) else padded("Zy_parity", py)
        out = Bases(zx, zy, px[1], py[1])
    return cache.setdefault(key, out)


def takes(device, dtype) -> bool:
    """Whether ``FDM2D``'s transforms of fields of ``dtype`` on ``device``
    take the even-odd chain (float32 on the card, where :func:`bases` finds
    the form); the others keep their ``torch.matmul`` code."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


class Corrections(typing.NamedTuple):
    """``FDM2D``'s Dirichlet corrections of a window (f32 vectors on the
    device, over the window's rows (``cw``, ``ce``, ``m1x``) or columns
    (``cs``, ``cn``, ``m1y``); None for a side without one): the terms
    ``(cw_i F(0, y)) m1y_j``, ``(ce_i F(Ngx-1, y)) m1y_j``, ``(F(x, 0) cs_j)
    m1x_i`` and ``(F(x, Ngy-1) cn_j) m1x_i`` taken off the window's
    values."""
    cw: torch.Tensor = None
    ce: torch.Tensor = None
    cs: torch.Tensor = None
    cn: torch.Tensor = None
    m1x: torch.Tensor = None
    m1y: torch.Tensor = None


class _PassParams(ctypes.Structure):
    """``PassParams`` of ``csrc/evenodd_passes.cu``."""
    _P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    _fields_ = [("f", _P), ("u", _P), ("out", _P), ("cw", _P), ("ce", _P),
                ("cs", _P), ("cn", _P), ("m1x", _P), ("m1y", _P),
                ("f_bs", _L), ("f_ld", _L), ("o_bs", _L), ("o_ld", _L),
                ("batch", _I), ("Ngx", _I), ("Ngy", _I), ("x0", _I),
                ("y0", _I), ("p", _I), ("q", _I), ("Pp", _I), ("Qp", _I)]


def _rhs_plain(F, window, corr: Corrections) -> torch.Tensor:
    """The split pass's right-hand side ``R`` (``batch × p × q``) by tensor
    ops, in ``FDM2D``'s order."""
    x0, y0, p, q = window
    Ngx, Ngy = F.shape[1:]
    R = F[:, x0:x0 + p, y0:y0 + q].clone()
    rows = slice(x0, x0 + p)
    cols = slice(y0, y0 + q)
    if corr.cw is not None:
        R -= (corr.cw[:, None] * F[:, 0:1, cols]) * corr.m1y
    if corr.ce is not None:
        R -= (corr.ce[:, None] * F[:, Ngx - 1:Ngx, cols]) * corr.m1y
    if corr.cs is not None:
        R -= (F[:, rows, 0:1] * corr.cs[None, :]) * corr.m1x[:, None]
    if corr.cn is not None:
        R -= (F[:, rows, Ngy - 1:Ngy] * corr.cn[None, :]) * corr.m1x[:, None]
    return R


def _split_plain(F, window, corr, Pp, Qp) -> torch.Tensor:
    """Plain PyTorch version of the split pass (the same f32 sums): ``R̂``
    as ``(ax, r, f, by, l)``, ``2 × Pp × batch × 2 × Qp``, zero past the
    halves and in the odd half's middle row and column."""
    R = _rhs_plain(F, window, corr)
    B, p, q = R.shape
    hp, hq = p // 2, q // 2
    P, Q = p - hp, q - hq
    a, b = R[:, :P], R.flip(1)[:, :P]
    rows = torch.stack([a + b, a - b], 1)              # f, ax, r, q
    if p % 2:
        rows[:, 0, hp] = a[:, hp]
        rows[:, 1, hp] = 0.0
    c, d = rows[..., :Q], rows.flip(3)[..., :Q]
    half = torch.stack([c + d, c - d], 2)              # f, ax, by, r, l
    if q % 2:
        half[:, :, 0, :, hq] = c[:, :, :, hq]
        half[:, :, 1, :, hq] = 0.0
    out = R.new_zeros((2, Pp, B, 2, Qp))
    out[:, :P, :, :, :Q] = half.permute(1, 3, 0, 2, 4)
    return out


def _merge_plain(out, U, F, window) -> None:
    """Plain PyTorch version of the merge pass: ``U`` as ``(by, ax, r, f,
    l)`` into the window of ``out``, ``F``'s values around it."""
    x0, y0, p, q = window
    out.copy_(F)
    P, Q = p - p // 2, q - q // 2
    u = U.permute(3, 1, 0, 2, 4)[:, :, :, :P, :Q]      # f, ax, by, r, l
    i = torch.arange(p, device=U.device)
    j = torch.arange(q, device=U.device)
    mx, my = i >= P, j >= Q
    k = torch.where(mx, p - 1 - i, i)
    l = torch.where(my, q - 1 - j, j)
    g = u[:, :, :, k][:, :, :, :, l]
    my_, mx_ = my[None, :], mx[:, None]
    te = torch.where(my_, g[:, 0, 0] - g[:, 0, 1], g[:, 0, 0] + g[:, 0, 1])
    to = torch.where(my_, g[:, 1, 0] - g[:, 1, 1], g[:, 1, 0] + g[:, 1, 1])
    out[:, x0:x0 + p, y0:y0 + q] = torch.where(mx_, te - to, te + to)


def _pass(merge: bool, F, U, out, window, corr: Corrections,
          Pp, Qp) -> None:
    """Launch the split (``out`` ``R̂``) or merge (``out`` the output field)
    pass on ``F``, the field; ``F`` and ``out`` with unit stride along
    their rows.  A block takes one output row at a time."""
    dev = out.device
    x0, y0, p, q = window
    for t in (F, out):
        if t.stride(-1) != 1 or t.dtype != torch.float32 or t.device != dev:
            raise ValueError("evenodd: f32 fields on one device with unit "
                             "stride along their rows")
    B, Ngx, Ngy = F.shape
    rows = B * Ngx if merge else 4 * B * Pp
    if 4 * B * max(Pp, Ngx) >= 2 ** 31:
        raise ValueError("evenodd: the passes count rows in 32 bits")
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    s = _PassParams(f=F.data_ptr(), u=ptr(U), out=out.data_ptr(),
                    cw=ptr(corr.cw), ce=ptr(corr.ce), cs=ptr(corr.cs),
                    cn=ptr(corr.cn), m1x=ptr(corr.m1x), m1y=ptr(corr.m1y),
                    f_bs=F.stride(0), f_ld=F.stride(1), o_bs=out.stride(0),
                    o_ld=out.stride(1), batch=B, Ngx=Ngx, Ngy=Ngy, x0=x0,
                    y0=y0, p=p, q=q, Pp=Pp, Qp=Qp)
    _launch("evenodd_pass", "sem_evenodd_pass", "f32", dev,
            ctypes.addressof(s), int(merge), max(1, rows))


def transform(F: torch.Tensor, b: Bases, out: torch.Tensor,
              diag: torch.Tensor, window=None,
              corr: Corrections = Corrections()) -> torch.Tensor:
    """``U = Zx (D ∘ (Zxᵀ R Zy)) Zyᵀ`` for each field of ``F`` (``batch ×
    Ngx × Ngy``, unit stride along its rows), ``R`` its ``window`` ``(x0,
    y0, p, q)`` (the whole field by default) less the Dirichlet corrections
    ``corr``; ``b`` the bases of :func:`bases`, ``diag`` ``D`` in its
    layout ``(by, ax, i, 1, j)`` (:meth:`Bases.matrix`,
    :meth:`Bases.vector`).  Writes ``out`` (the shape of ``F``, unit stride
    along its rows): ``U`` in the window, ``F``'s values outside it;
    returns ``out``.  On the CPU the passes are their plain twins."""
    B, Ngx, Ngy = F.shape
    window = (0, 0, Ngx, Ngy) if window is None else window
    _, Pp, Sp = b.zx.shape
    _, Qp, Tp = b.zy.shape
    card = out.device.type == "cuda"
    if card:
        R = F.new_empty((2, Pp, B, 2, Qp))
        _pass(False, F, None, R, window, corr, Pp, Qp)
    else:
        R = _split_plain(F, window, corr, Pp, Qp)
    C1 = torch.bmm(b.zx.transpose(1, 2), R.view(2, Pp, 2 * B * Qp))
    W = torch.bmm(C1.as_strided((2, 2 * Sp * B, Qp), (Qp, 2 * Qp, 1)), b.zy)
    W2 = R.new_empty((2, Sp, B, 2, Tp))
    torch.mul(W.view(2, 2, Sp, B, Tp), diag, out=W2.permute(3, 0, 1, 2, 4))
    C3 = torch.bmm(b.zx, W2.view(2, Sp, 2 * B * Tp))
    U = torch.bmm(C3.as_strided((2, 2 * Pp * B, Tp), (Tp, 2 * Tp, 1)),
                  b.zy.transpose(1, 2))
    U = U.view(2, 2, Pp, B, Qp)
    if card:
        _pass(True, F, U, out, window, corr, Pp, Qp)
        COUNTERS["fdm.gemm_launches"] += 1
    else:
        _merge_plain(out, U, F, window)
    return out
