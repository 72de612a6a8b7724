"""Matrix-free Krylov solvers on torch tensors: restarted GMRES, flexible
GMRES, the host-orchestrated mixed-precision refinement around them, and the
stochastic row-norm estimate that conditions the row-scaled flexible chunks.

Counterparts of ``sem_tpu.krylov.gmres``, ``fgmres``, ``cg``,
``refined_gmres_host``, ``rownorm_estimate`` and ``rowscale_prep``.  The
reference runs GMRES as one ``lax.while_loop`` on the device; here the loop is
Python driving device tensors.  Every n-sized object (basis, iterate,
residual) stays on the device in a basis buffer allocated once per solve; the
small Hessenberg/Givens recurrence runs on the host in float64.  Each
iteration reads back one small vector (the new Hessenberg column and two
norms), which is also what the convergence test needs; an iteration whose
DGKS test asks for a second orthogonalization sweep reads back once more.

``gmres(..., group=g)`` and ``fgmres(..., group=g)`` run on row strips over
the ranks of ``g``: each norm and each chunk of projection coefficients is
reduced locally, then all-reduced.  :func:`strip_chunk` builds the solvers'
decomposed f32 chunks on it.

:class:`CapturedProgram` is the solve path's one rule for CUDA graphs.  On
it, :class:`CapturedOperator` replays the fixed operator of the solvers'
plain f32 chunks from one CUDA graph per linearization, and the operators
of the MDA's device windows' nested float64 solves: the host launches one
graph per application instead of the operator's dozens of kernels.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch

from sem_tpu_torch.ops.kernels import LAUNCHES
from sem_tpu_torch.ops.sharded import COLLECTIVES, all_reduce
from sem_tpu_torch.utils.profiling import COUNTERS, read, span

__all__ = ["gmres", "fgmres", "cg", "strip_chunk", "refined_gmres_host",
           "print_hist", "hist_printing_chunk", "CapturedProgram",
           "CapturedOperator",
           "KrylovInfo", "rownorm_estimate", "rowscale_prep",
           "DGKS_ETA", "DGKS_ETA_F64"]


def rownorm_estimate(matvec: Callable, n: int, dtype,
                     generator: Optional[torch.Generator] = None,
                     probes=8, *, device="cpu", strips=None,
                     nf: int = 1) -> torch.Tensor:
    """Stochastic row-norm estimate of a linear operator:
    ``d_i = sqrt(mean_k (A z_k)_i²)`` over Rademacher probes ``z_k``, an
    unbiased estimator of the squared row 2-norms.  ``diag(d)`` is the norm
    conditioner of SEM systems, whose raw rows mix stiffness- and
    unit-Dirichlet scales spanning ~1e7 (used by the row-scaled flexible f32
    chunks).  Floored at ``1e-12·max(d)`` so reciprocals are safe.

    :param generator: a CPU ``torch.Generator`` the ±1 probes are drawn from
        (on the CPU, then moved to ``device``); not read when ``probes`` is a
        tensor
    :param probes: the number of probes, or a ``(k, n)`` tensor of ±1 probe
        vectors to use as they are (e.g. the ones another package drew)
    :param strips: a :class:`sem_tpu_torch.ops.RowStrips`: ``matvec`` takes
        and returns this rank's strips of ``nf`` stacked fields, each probe
        (of the full length ``n``) is cut to them first, and the per-row
        estimate is all-gathered before the floor (one collective), so every
        rank returns the full single-process estimate
    """
    if isinstance(probes, int):
        z = torch.randint(0, 2, (probes, n), generator=generator,
                          dtype=torch.int8, device="cpu")
        probes = (2 * z - 1).to(device=device, dtype=dtype)
    acc = 0.0
    for z in probes.to(dtype):
        w = matvec(z if strips is None else strips.local(z, nf))
        acc = acc + w * w
    d = torch.sqrt(acc / probes.shape[0])
    if strips is not None:
        d = strips.gather(d, nf)
    return torch.maximum(d, 1e-12 * d.max())


def rowscale_prep(r: torch.Tensor, scale, dinv: torch.Tensor):
    """Per-pass prep of the row-scaled refinement chunks: downcast, scale by
    the row-norm inverse, and the chunk tolerance ``scale·‖rp‖``.  Returns
    ``(rp, atol_lp, ‖rp‖)``, the two scalars as 0-d tensors."""
    rp = r.to(dinv.dtype) * dinv
    rpn = torch.linalg.vector_norm(rp)
    return rp, scale * rpn, rpn


class KrylovInfo(NamedTuple):
    """Solver diagnostics (host values)."""

    converged: bool
    iterations: int        # operator applications
    resnorm: float         # final true residual 2-norm
    stalled: bool          # stagnated at a roundoff plateau before atol
    resweeps: int = 0      # iterations that ran the DGKS second sweep
    bnorm: float = 0.0     # ‖b‖ (set by refined_gmres_host)


_CHUNK = 16  # Krylov-basis rows per orthogonalization chunk

# DGKS reorthogonalization threshold η: resweep when the first sweep
# cancelled more than (1-η) of ‖w‖.  The reference measured η=0.25 to give
# identical iteration counts and solutions to the classical 1/√2 for the
# f32/bf16 chunks while skipping most second sweeps; f64 solves keep the
# classical constant (see sem_tpu.krylov).
DGKS_ETA = 0.25            # f32 / bfloat16 working dtypes
DGKS_ETA_F64 = 2 ** -0.5   # float64

_LP_DTYPES = (torch.float32, torch.bfloat16)


def _mgs_sweep_live(V, w, k, cchunk, group=None):
    """One block-MGS sweep of ``w`` against the live rows ``0..k`` of ``V``,
    chunk by chunk.  Returns ``(w, h)`` with ``h`` of length ``k+1``.  With
    a ``group``, ``V`` and ``w`` are this rank's strips, and each chunk's
    projection coefficients are all-reduced before the update."""
    hs = []
    for j in range(k // cchunk + 1):
        Vj = V[j * cchunk:min((j + 1) * cchunk, k + 1)].to(w.dtype)
        hj = Vj @ w
        if group is not None:
            hj = all_reduce(group, hj)
        w = w - Vj.T @ hj
        hs.append(hj)
    return w, torch.cat(hs)


def _arnoldi_column(V, w, k, cchunk, eta, eps_tiny, norm, group=None):
    """Orthogonalize ``w`` against the live rows ``0..k`` of ``V`` (one
    block-MGS sweep, a second one when the DGKS test asks for it), store the
    normalized result as row ``k+1``, and return ``(hk, resweep)``: ``hk``
    the new Hessenberg column as ``k+2`` host floats, ``resweep`` 1 if the
    second sweep ran.  One host read, one more with the second sweep."""
    n0 = norm(w)
    w, h = _mgs_sweep_live(V, w, k, cchunk, group)
    n1 = norm(w)
    host = read(torch.cat([torch.stack([n0, n1]), h]), "arnoldi")
    hcol = host[2:]
    hk1 = host[1]
    resweep = 0
    if host[1] < eta * host[0]:     # DGKS: second sweep
        w, h2 = _mgs_sweep_live(V, w, k, cchunk, group)
        host2 = read(torch.cat([norm(w)[None], h2]), "arnoldi2")
        hk1 = host2[0]
        hcol = [a + c for a, c in zip(hcol, host2[1:])]
        resweep = 1
    V[k + 1] = w / max(hk1, eps_tiny)
    return hcol + [hk1], resweep


def _givens(h, cs, sn, g, k):
    """Apply the stored rotations to column ``h`` (host floats, length k+2),
    form the rotation zeroing ``h[k+1]``, update ``g``; return the residual
    estimate ``|g[k+1]|``."""
    for j in range(k):
        t = cs[j] * h[j] + sn[j] * h[j + 1]
        h[j + 1] = -sn[j] * h[j] + cs[j] * h[j + 1]
        h[j] = t
    denom = math.hypot(h[k], h[k + 1])
    if denom > 1e-300:
        c, s = h[k] / denom, h[k + 1] / denom
    else:
        c, s = 1.0, 0.0
    cs[k], sn[k] = c, s
    h[k], h[k + 1] = denom, 0.0
    g[k + 1] = -s * g[k]
    g[k] = c * g[k]
    return abs(g[k + 1])


def _givens_update_device(h, cs, sn, g, k, m, eps_tiny=1e-300):
    """:func:`_givens` on device tensors, with nothing read back: apply the
    stored rotations to the new column ``h`` (length ``m+1``), form the
    rotation zeroing ``h[k+1]``, update ``g``.  ``k`` is a 0-d int64 tensor.

    Counterpart of ``sem_tpu.krylov._givens_update``: unused rotation slots
    hold the identity (``cs=1``, ``sn=0``), so all ``m`` slots are applied in
    order and no masking on ``k`` is needed; the first-order recurrence
    ``α_{j+1} = -s_j α_j + c_j h_{j+1}`` runs as a loop over the slots where
    the reference uses an associative scan.

    :return: ``(h, cs, sn, g, res)``, ``res = |g[k+1]|`` a 0-d tensor
    """
    alpha = h[0]
    rot = []
    for j in range(m):
        rot.append(cs[j] * alpha + sn[j] * h[j + 1])
        alpha = -sn[j] * alpha + cs[j] * h[j + 1]
    h = torch.stack(rot + [alpha])
    slot = torch.arange(m + 1, device=h.device)
    at_k, at_k1 = slot == k, slot == k + 1
    hk, hk1 = (h.index_select(0, i.reshape(1))[0] for i in (k, k + 1))
    denom = torch.sqrt(hk * hk + hk1 * hk1)
    big = denom > eps_tiny
    safe = torch.clamp_min(denom, eps_tiny)
    c = torch.where(big, hk / safe, 1.0)
    s = torch.where(big, hk1 / safe, 0.0)
    cs = torch.where(at_k[:m], c, cs)
    sn = torch.where(at_k[:m], s, sn)
    h = torch.where(at_k, denom, torch.where(at_k1, 0.0, h))
    gk = g.index_select(0, k.reshape(1))[0]
    g = torch.where(at_k, c * gk, torch.where(at_k1, -s * gk, g))
    return h, cs, sn, g, (s * gk).abs()


def _read_first(rnorm, atol):
    """The first host read of a solve: ``(β, atol)`` as floats.  A 0-d
    tensor ``atol`` (a tolerance decided on the device) rides β's read, so
    it costs no read of its own."""
    if isinstance(atol, torch.Tensor):
        beta, atol = read(torch.stack([rnorm, atol.to(rnorm.dtype)]),
                          "first")
        return beta, atol
    return read(rnorm, "first"), float(atol)


def _basis(rows, first, n, dtype, device):
    """A Krylov basis buffer of ``rows`` rows, or of its ``first`` rows
    (at least 2) where given; :func:`_grown` makes the rest."""
    if first is not None:
        rows = min(rows, max(2, int(first)))
    return torch.empty((rows, n), dtype=dtype, device=device)


def _grown(V, rows):
    """``V`` in a buffer of ``rows`` rows, its rows copied exactly."""
    W = V.new_empty((rows, V.shape[1]))
    W[:V.shape[0]] = V
    return W


def _norm(group):
    """The 2-norm of a vector, or of a vector decomposed into this rank's
    strips over ``group`` (the local square sum, all-reduced)."""
    if group is None:
        return torch.linalg.vector_norm

    def norm(x):
        return torch.sqrt(all_reduce(group, (x @ x).reshape(1)))[0]

    return norm


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, *, atol: float,
          restart: int = 30, maxiter: int = 1000,
          precon: Optional[Callable] = None, return_hist: bool = False,
          basis_dtype=None, dgks_eta: float = None, group=None,
          basis_rows: int = None):
    """Restarted GMRES(m) with right preconditioning.

    Same algorithm as ``sem_tpu.krylov.gmres``: live-chunk block-MGS with a
    DGKS-selective second sweep, Givens rotations, a true-residual restart
    test that flags stagnation, and (for f32/bf16 working dtypes) the
    in-cycle plateau exit (< 2% progress over 40 iterations).

    :param matvec: linear operator ``A(x)``
    :param b: right-hand side (flat tensor; its dtype is the working dtype)
    :param x0: initial guess (zeros if None)
    :param atol: absolute tolerance on ‖b − A x‖₂: a float, or a 0-d
        tensor on ``b``'s device, read with the first residual norm (a
        tolerance decided on the device costs no read of its own)
    :param restart: Krylov window m
    :param maxiter: max total inner iterations (matvec applications)
    :param precon: *linear* right preconditioner ``M⁻¹(r)``
    :param return_hist: also return the per-iteration recurrence residual
        (a float64 host tensor of shape ``(maxiter,)``, entries past the last
        iteration holding the initial residual): the data behind the
        ``'LGMRES_iter'`` prints.  The values are the ones the convergence
        test reads anyway, so the history costs no extra host read
    :param basis_dtype: storage dtype of the basis (default: ``b.dtype``);
        arithmetic stays in the working dtype
    :param dgks_eta: DGKS reorthogonalization threshold (None = the
        dtype-dependent default: :data:`DGKS_ETA` for f32/bf16,
        :data:`DGKS_ETA_F64` for f64); each triggered resweep doubles that
        iteration's basis traffic
    :param group: decompose over the ranks of this group
        (:mod:`sem_tpu_torch.parallel`): ``b``, ``x0``, the result and what
        ``matvec``/``precon`` take and return are this rank's strips; every
        norm and projection is reduced locally, then all-reduced, so each
        scalar that reaches the host is the same on every rank
    :param basis_rows: rows of the basis allocated at the start (None: all
        ``m+1``); a cycle that needs more allocates the whole basis then and
        copies the rows it has, so the iterates are the same.  For short
        solves repeated many times, whose ``m+1`` rows would sit unused
    :return: ``(x, KrylovInfo)`` or ``(x, KrylovInfo, hist)``
    """
    if precon is None:
        precon = lambda r: r  # noqa: E731
    norm = _norm(group)
    m = int(restart)
    n = b.shape[0]
    dtype = b.dtype
    lowp = dtype in _LP_DTYPES
    eta = ((DGKS_ETA if lowp else DGKS_ETA_F64) if dgks_eta is None
           else float(dgks_eta))
    bdt = dtype if basis_dtype is None else basis_dtype
    eps_tiny = 1e-300 if dtype == torch.float64 else 1e-30
    cchunk = min(_CHUNK, m + 1)
    V = _basis(m + 1, basis_rows, n, bdt, b.device)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)

    def new_cycle(x, tol=0.0):
        r = b - matvec(x)
        beta, tol = _read_first(norm(r), tol)
        V[0] = r / max(beta, eps_tiny)
        return beta, tol

    beta, atol = new_cycle(x, atol)
    hist = [beta] * maxiter   # recurrence residual per iteration
    it = nresweep = 0
    res = cycle_res = beta
    stalled = False
    done = beta <= atol
    while not done:
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs, sn = [1.0] * m, [0.0] * m
        k = 0
        while True:
            if k + 2 > V.shape[0]:
                V = _grown(V, m + 1)
            hk, resw = _arnoldi_column(
                V, matvec(precon(V[k].to(dtype))), k, cchunk, eta, eps_tiny,
                norm, group)
            nresweep += resw
            res = _givens(hk, cs, sn, g, k)
            H[:k + 2, k] = hk
            hist[it] = res
            it += 1
            stall_in = (lowp and it - 1 >= 40
                        and res > 0.98 * hist[it - 1 - 40])
            if res <= atol or k + 1 >= m or it >= maxiter or stall_in:
                break
            k += 1
        kk = k + 1
        y = scipy.linalg.solve_triangular(H[:kk, :kk], g[:kk], lower=False)
        yt = torch.as_tensor(y, dtype=dtype, device=b.device)
        x = x + precon(V[:kk].to(dtype).T @ yt)
        beta, _ = new_cycle(x)
        # stagnation: a full cycle (or an in-cycle plateau) improved the TRUE
        # residual by < 10% — a roundoff plateau further cycles cannot beat
        stalled = (beta > atol and beta > 0.9 * cycle_res
                   and (kk >= m or stall_in))
        done = beta <= atol or it >= maxiter or stalled
        res = cycle_res = beta
    info = KrylovInfo(converged=res <= atol, iterations=it, resnorm=res,
                      stalled=stalled, resweeps=nresweep)
    if return_hist:
        return x, info, torch.tensor(hist, dtype=torch.float64)
    return x, info


def fgmres(matvec: Callable, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None, *, atol: float,
           restart: int = 20, maxiter: int = 1000, precon: Callable,
           return_hist: bool = False, basis_dtype=None,
           dgks_eta: float = None, group=None, basis_rows: int = None):
    """Flexible GMRES(m): the right preconditioner may vary per application
    (it may contain inner Krylov solves), so the preconditioned vectors ``Z``
    are stored and the solution update uses them (Saad's FGMRES).

    Same algorithm as ``sem_tpu.krylov.fgmres``, sharing :func:`gmres`'s
    orthogonalization (live-chunk block-MGS, DGKS-selective second sweep),
    Givens recurrence, in-cycle plateau exit for f32/bf16 and true-residual
    stall rule.  ``basis_dtype`` is the storage dtype of the Arnoldi basis
    ``V`` only: ``Z`` holds the solution update and stays in the working
    dtype.  ``atol`` may be a 0-d tensor, ``dgks_eta`` sets the DGKS
    threshold, ``group`` decomposes the solve over row strips and
    ``basis_rows`` allocates the first rows of ``V`` and ``Z`` alone, as in
    :func:`gmres`.

    :return: ``(x, KrylovInfo)``, or ``(x, KrylovInfo, hist)`` with
        ``return_hist`` (see :func:`gmres`)
    """
    norm = _norm(group)
    m = int(restart)
    n = b.shape[0]
    dtype = b.dtype
    lowp = dtype in _LP_DTYPES
    eta = ((DGKS_ETA if lowp else DGKS_ETA_F64) if dgks_eta is None
           else float(dgks_eta))
    bdt = dtype if basis_dtype is None else basis_dtype
    eps_tiny = 1e-300 if dtype == torch.float64 else 1e-30
    cchunk = min(_CHUNK, m + 1)
    V = _basis(m + 1, basis_rows, n, bdt, b.device)
    Z = torch.empty((V.shape[0] - 1, n), dtype=dtype, device=b.device)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)

    def new_cycle(x, tol=0.0):
        r = b - matvec(x)
        beta, tol = _read_first(norm(r), tol)
        V[0] = r / max(beta, eps_tiny)
        return beta, tol

    beta, atol = new_cycle(x, atol)
    hist = [beta] * maxiter   # recurrence residual per iteration
    it = nresweep = 0
    res = cycle_res = beta
    stalled = False
    done = beta <= atol
    while not done:
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs, sn = [1.0] * m, [0.0] * m
        k = 0
        while True:
            if k + 2 > V.shape[0]:
                V, Z = _grown(V, m + 1), _grown(Z, m)
            Z[k] = precon(V[k].to(dtype))
            hk, resw = _arnoldi_column(V, matvec(Z[k]), k, cchunk, eta,
                                       eps_tiny, norm, group)
            nresweep += resw
            res = _givens(hk, cs, sn, g, k)
            H[:k + 2, k] = hk
            hist[it] = res
            it += 1
            stall_in = (lowp and it - 1 >= 40
                        and res > 0.98 * hist[it - 1 - 40])
            if res <= atol or k + 1 >= m or it >= maxiter or stall_in:
                break
            k += 1
        kk = k + 1
        y = scipy.linalg.solve_triangular(H[:kk, :kk], g[:kk], lower=False)
        x = x + Z[:kk].T @ torch.as_tensor(y, dtype=dtype, device=b.device)
        beta, _ = new_cycle(x)
        stalled = (beta > atol and beta > 0.9 * cycle_res
                   and (kk >= m or stall_in))
        done = beta <= atol or it >= maxiter or stalled
        res = cycle_res = beta
    info = KrylovInfo(converged=res <= atol, iterations=it, resnorm=res,
                      stalled=stalled, resweeps=nresweep)
    if return_hist:
        return x, info, torch.tensor(hist, dtype=torch.float64)
    return x, info


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, atol: float, maxiter: int = 1000,
       precon: Optional[Callable] = None):
    """Preconditioned conjugate gradients for SPD operators.

    Offered alongside GMRES for symmetric systems (e.g. pure-diffusion
    subproblems).  Same algorithm as ``sem_tpu.krylov.cg``: the loop runs
    while the recurrence residual ``‖r‖₂`` exceeds ``atol`` (one host read
    per iteration, the convergence test's own).

    :return: ``(x, KrylovInfo)``
    """
    if precon is None:
        precon = lambda r: r  # noqa: E731
    dtype = b.dtype
    atol = float(atol)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    r = b - matvec(x)
    z = precon(r)
    p = z
    rz = r @ z
    it = 0
    res = read(torch.linalg.vector_norm(r), "cg")
    while res > atol and it < maxiter:
        Ap = matvec(p)
        alpha = rz / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precon(r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
        res = read(torch.linalg.vector_norm(r), "cg")
    return x, KrylovInfo(converged=res <= atol, iterations=it, resnorm=res,
                         stalled=False)


def strip_chunk(strips, nf: int, mv: Callable, pc: Callable, **gmres_kw):
    """A ``gmres_chunk`` for :func:`refined_gmres_host` decomposed over the
    ranks of ``strips.group`` (a :class:`sem_tpu_torch.ops.RowStrips`) for
    vectors of ``nf`` stacked fields: the RHS and warm start are cut to this
    rank's strips, the operator ``pc ∘ mv`` applies ``mv`` on the strips
    (one halo exchange) and the preconditioner ``pc`` on the all-gathered
    full fields (replicated), GMRES all-reduces its reductions, and the
    correction is all-gathered back to the full, replicated vector."""
    def op(q):
        return strips.local(pc(strips.gather(mv(q), nf)), nf)

    def chunk(rp, x0, atol_lp):
        x, *rest = gmres(op, strips.local(rp, nf), x0=strips.local(x0, nf),
                         atol=atol_lp, group=strips.group, **gmres_kw)
        return (strips.gather(x, nf), *rest)

    return chunk


class CapturedProgram:
    """A program ``fn`` of device tensors replayed from one CUDA graph: the
    one capture rule of the solve path, for the f32 chunks' operators and
    the device windows' nested float64 operators
    (:class:`CapturedOperator`, prefix ``krylov``) and the MDA's fused
    host-FGMRES programs (prefix ``mda``).

    :meth:`capture` runs ``fn(*static)`` eagerly on the current stream,
    which warms cuBLAS and makes the constants ``fn`` makes on first use,
    and returns that result.  On a CUDA device, outside a running capture,
    it then captures ``fn(*static)`` (span ``<prefix>.capture``, counter
    ``<prefix>.captures``) on the stream :class:`torch.cuda.graph` captures
    on, in ``thread_local`` error mode (``solve_continued`` builds the next
    level's solvers in a worker thread meanwhile) and without that
    context's device sync, ``gc.collect`` and ``empty_cache``.  No warm-up
    makes a stream: each new stream keeps a cuBLAS workspace of its own
    (32 MiB on an H100) for as long as the process lives.  The graph draws
    its memory from ``pool``, a pool of its own unless the owner hands it
    another program's before the capture; a pool is freed when the last
    program holding it goes.  A capture that ran a collective of
    :mod:`sem_tpu_torch.ops.sharded` raises: the captured programs act on
    replicated data alone, under a process group too, and a replayed
    collective would tie the ranks' replays together.

    A call ``self(*args)`` runs ``fn(*args)`` eagerly until a graph is
    captured, and inside a running capture.  Otherwise it copies each
    argument into its static input (a number fills a 0-d one; an argument
    that is its static input is not copied), replays the graph and returns
    ``out``, the capture's outputs, which the next replay overwrites.  A
    replay runs the kernels ``fn`` runs, with the same shapes, so it gives
    the eager bits; it adds the kernel launches its capture recorded to
    ``ops.kernels.LAUNCHES`` (counter ``<prefix>.replays``).
    """

    __slots__ = ("fn", "prefix", "graph", "pool", "static", "out",
                 "launches")

    def __init__(self, fn: Callable, prefix: str):
        self.fn, self.prefix = fn, prefix
        self.graph = self.pool = None

    def capture(self, *static):
        out = self.fn(*static)
        dev = static[0].device
        if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return out
        with torch.cuda.device(dev), span(f"{self.prefix}.capture"):
            if self.pool is None:
                self.pool = torch.cuda.MemPool()
            graph = torch.cuda.CUDAGraph()
            launches, collectives = dict(LAUNCHES), dict(COLLECTIVES)
            with torch.cuda.stream(torch.cuda.graph(graph).capture_stream):
                graph.capture_begin(self.pool.id,
                                    capture_error_mode="thread_local")
                try:
                    captured = self.fn(*static)
                finally:
                    graph.capture_end()
            # the capture ran nothing: its launches count at each replay
            self.launches = tuple((k, v - launches[k])
                                  for k, v in LAUNCHES.items()
                                  if v != launches[k])
            LAUNCHES.update(launches)
        if COLLECTIVES != collectives:
            raise RuntimeError(f"{self.prefix}: a captured program ran "
                               f"collectives ({collectives} -> "
                               f"{COLLECTIVES}); it must act on replicated "
                               f"data alone")
        self.graph, self.static, self.out = graph, static, captured
        COUNTERS[f"{self.prefix}.captures"] += 1
        return out

    def __call__(self, *args):
        if self.graph is None or torch.cuda.is_current_stream_capturing():
            return self.fn(*args)
        for s, a in zip(self.static, args):
            if a is not s:
                if isinstance(a, torch.Tensor):
                    s.copy_(a)
                else:
                    s.fill_(a)
        self.graph.replay()
        for name, n in self.launches:
            LAUNCHES[name] += n
        COUNTERS[f"{self.prefix}.replays"] += 1
        return self.out

    def __del__(self):
        # the graph and the tensors before the pool: a pool going frees only
        # the memory that no graph and no tensor holds any more
        self.graph = self.out = self.static = None


class CapturedOperator(CapturedProgram):
    """The fixed linear operator ``fn`` of one linearization's f32 chunks,
    or of the device windows' nested float64 solves, as a
    :class:`CapturedProgram` (prefix ``krylov``): its first call on a
    CUDA tensor is the warm-up, whose result it returns, and captures
    ``fn`` on a static copy of its argument.  A caller consumes a result
    before it calls again, as :func:`gmres` does."""

    __slots__ = ()

    def __init__(self, fn: Callable):
        super().__init__(fn, "krylov")

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if self.graph is None and q.is_cuda:
            return self.capture(q.clone())
        return super().__call__(q)


def print_hist(label: str, hist, n: int, offset: int = 0):
    """The ``'LGMRES_iter'`` lines of a solve: one per iteration, its number
    (continuing from ``offset``) and its recurrence residual."""
    for j, h in enumerate(hist[:n].tolist()):
        print(f"{label} LGMRES: {offset + j + 1}\t{h}")


def hist_printing_chunk(chunk: Callable, label: str):
    """Wrap a ``gmres_chunk`` built with ``return_hist=True``: print each
    chunk's f32 inner-loop residuals as ``'LGMRES_iter'`` lines, numbered
    through the chunks of one solve, and return ``(x, info)``."""
    count = 0

    def printing(rp, x0, atol_lp):
        nonlocal count
        x, info, hist = chunk(rp, x0, atol_lp)
        print_hist(label, hist, info.iterations, count)
        count += info.iterations
        return x, info

    return printing


def refined_gmres_host(cres: Callable, pc_lp: Callable,
                       gmres_chunk: Callable, b: torch.Tensor,
                       x0: torch.Tensor, *, atol: float = None,
                       maxiter: int, max_refine: int = 12,
                       inner_rtol: float = 1e-5, lp_dtype=torch.float32,
                       atol_fn: Callable = None):
    """Mixed-precision GMRES: bounded low-precision left-preconditioned
    chunks inside a float64 iterative-refinement loop with best-iterate
    tracking (the policy of ``sem_tpu.krylov.refined_gmres_host``: one chunk
    per refinement pass, learned attainable floor, adaptive deepening of the
    inner tolerance, plateau and divergence classification).

    :param cres: ``cres(x) -> b - A x`` in the outer (f64) dtype
    :param pc_lp: low-precision preconditioner ``M⁻¹(r_lp)``
    :param gmres_chunk: ``gmres_chunk(rhs_lp, x0_lp, atol_lp) ->
        (x_lp, KrylovInfo)`` — a bounded run of left-preconditioned GMRES
        on ``M⁻¹A x = rhs_lp``
    :param atol_fn: optional ``atol_fn(‖b‖) -> atol`` (then ``atol`` may be
        None); the resulting ‖b‖ is reported in ``KrylovInfo.bnorm``
    :return: ``(x, KrylovInfo)``
    """
    normb = 0.0
    if atol_fn is not None:
        normb = read(torch.linalg.vector_norm(b), "normb")
        atol = atol_fn(normb)
    x = x_best = x0
    rn_best = float("inf")
    rn0 = None
    prev = float("inf")
    total_it = total_resweeps = 0
    plateau = False          # exited because refinement stopped progressing
    floor_rel = 0.0          # learned attainable relative chunk residual
    last_inner_floored = False  # the last chunk hit its floor (or idled)
    inner_eff = inner_rtol   # adaptively deepened
    passes = 0
    passes_cap = max_refine + 1
    chunk_iters_max = 0
    xin = torch.zeros(b.shape, dtype=lp_dtype, device=b.device)
    zlp = torch.zeros_like(xin)   # chunk warm start (reused)
    while True:
        x = x + xin.to(x.dtype)
        r = cres(x)
        rp = pc_lp(r.to(lp_dtype))
        rn, rpn = read(torch.stack([torch.linalg.vector_norm(r),
                                    torch.linalg.vector_norm(rp).to(r.dtype)]),
                       "pass")
        if rn0 is None:
            rn0 = rn
        if rn < rn_best:
            x_best, rn_best = x, rn
        if rn <= atol or not np.isfinite(rn):
            plateau = False
            break
        if total_it >= maxiter or passes >= passes_cap:
            plateau = False   # iteration or pass budget exhausted
            break
        if rn > 0.9 * prev:
            # the last pass barely moved the TRUE residual.  If its chunk
            # converged in the preconditioned norm, deepen the inner
            # tolerance and retry (bounded by the f32 floor ~1e-7)
            if (not last_inner_floored and inner_eff > 2e-7
                    and total_it < maxiter):
                inner_eff = max(inner_eff * 1e-2, 1e-7)
            else:
                plateau = rn > atol
                break
        prev = rn
        # ONE bounded chunk per refinement pass, then back to the f64 pass
        atol_lp = max(inner_eff, 2.0 * floor_rel) * rpn
        xin, info = gmres_chunk(rp, zlp, atol_lp)
        passes += 1
        total_it += info.iterations
        total_resweeps += info.resweeps
        chunk_iters_max = max(chunk_iters_max, info.iterations, 1)
        passes_cap = max(max_refine + 1, -(-maxiter // chunk_iters_max))
        last_inner_floored = info.stalled or info.iterations == 0
        # learned attainable floor: a chunk that ended non-converged shows
        # the f32 floor of this preconditioned system relative to its input
        if not info.converged and rpn > 0.0:
            floor_rel = max(floor_rel, info.resnorm / rpn)

    # converged / genuine plateau (real progress, then no more) / neither
    # (divergence or budget exhaustion while progressing — callers raise)
    converged = rn_best <= atol
    made_progress = rn0 is not None and (rn_best < 0.99 * rn0
                                         or rn0 <= atol * 10)
    genuine_plateau = plateau and (made_progress or last_inner_floored)
    return x_best, KrylovInfo(converged=converged, iterations=total_it,
                              resnorm=rn_best,
                              stalled=not converged and genuine_plateau,
                              resweeps=total_resweeps, bnorm=normb)
