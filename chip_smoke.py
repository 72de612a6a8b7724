#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``sem_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, one output line each (any failure raises and exits non-zero before
the last line):

1. device and build: the card's name and power limit (``nvidia-smi``), and
   the ``nvcc`` build of the CUDA kernels from ``sem_tpu_torch/csrc``;
2. kernel B1 (CD system apply) vs its plain PyTorch version and vs the f64
   dense path, at P=4 8×8, P=16 32×32 and P=16 64×64, tolerance
   2e-5·max|ref|;
3. kernel B2 (NS coupled saddle matvec), the same checks;
4. each whole-grid kernel at its main-path shape (B1 at P=16 32×32 and
   also 64×64, B2 at P=16 64×64): ``device_us`` (20 wrapper calls captured
   in one CUDA graph, the replay timed with CUDA events, median of 20
   replays, divided by 20: the host is excluded), ``call_us`` (an event pair
   around one wrapper call, median of 50: what the solver pays when the card
   waits for the host), ``host_us`` (host clock per call over 200
   back-to-back calls: the wrapper's enqueue cost), ``plain_us`` and
   ``plain_device_us`` (the plain version, as ``call_us`` and as
   ``device_us``), ``bound_us`` (bytes each read once over 3.35 TB/s or
   the structurally nonzero flops over 67 TFLOP/s f32, whichever is
   larger) and ``share`` (bound over device time), ``library_us`` (one
   cuSPARSE ``A @ x`` of the assembled operator as a
   ``torch.sparse_csr_tensor``, built on the card, timed like
   ``device_us``), ``strip_r1_us`` (the device time of B3/B4 on one strip,
   R=1: the same kernel through its row-window entry point, on the same
   inputs) and ``strip_over_whole`` (that over ``device_us``, about 1);
5. the reference configuration: ``run`` JNK, P=4 8×8, Ra=1e3 — de Vahl Davis
   anchors u_max·RePr = 3.649 and v_max·RePr = 3.697 within 1%, ≤ 6 Newton
   iterations;
6. the main path at full size: ``build_coupled`` + ``solve`` JNK with NS at
   P=16 64×64 and CD at P=16 32×32, Ra=1e3, from zero, to the coupled RMS
   tolerance 1e-8 of the reference's p16 study runs; the kernel launch
   counts are reset just before and read just after, and B1's and B2's
   must be > 0;
7. kernels B3/B4 (B1/B2 on row strips) at P=4 8×8, P=16 32×32 and P=16
   64×64 with R = 1, 2 and 4 strips in this process, each strip's halo cut
   from the full field: the concatenated strips against the plain strip
   versions and the f64 dense path (tolerance 2e-5·max|ref|), and against
   B1's/B2's output, which must be the same bits (B3/B4 are B1/B2's kernels
   on a row window: this holds the window, halo and tile-lattice logic
   against the whole-grid launch);
8. B3/B4 on rank 0's strip of R=2 at P=16 64×64, and B3 also at its
   main-path shape P=16 32×32: the measurements of phase 4 but
   ``strip_r1_us`` (the library operator is the strip's rows against the
   haloed strip's columns);
9. the multi-process path at full size: ``run_parallel`` with the
   configuration of phase 6, two ranks started as two processes of this
   script (NCCL with one card per rank where there are two cards, gloo with
   both ranks on cuda:0 otherwise).  Counts are reset just before and read
   just after; in each rank B3's and B4's must be > 0 and B1's and B2's 0
   (every f32 matvec went to the strips), the residual must meet atol and
   the u-anchor 3.6531 ± 1e-3.  Rank 0 then times one halo exchange, one
   full-field all-gather and one all-reduce at the NS chunk's shapes.

10. ``solve_continued`` at full width (the grids and tolerance of phase 6),
    once with the default halving ladder P4→P8→P16 and once with
    ``ladder=[(4,4),(16,16)]``: per level the build wait (what the worker
    thread did not hide), the solve wall and the stats; the total wall beside
    phase 6's direct wall; B1's and B2's launches must be > 0, the residual
    meet atol and the u-anchor 3.6531 ± 1e-3;
11. pseudo-transient continuation at full width: ``build_coupled(mode="PTC")``
    on the same grids at Ra=1e5, from zero, coupled RMS 1e-8: steps, stats,
    coupled GMRES iterations, final Δt, wall, the host time inside the two
    disciplines' ``solve_linear``, B1/B2 launches (> 0); the residual must
    meet atol and the centerline anchors u_max·RePr (on x=1/2) and
    v_max·RePr (on y=1/2) the de Vahl Davis values 34.73 and 68.59 within
    1 %;
12. the flexible chunks at full width: phase 11 with ``velo_inner=5`` (every
    NS preconditioner application runs 5 GMRES steps on the true velocity
    Jacobian, kernel B2 again): the same requirements, the flexible-retry and
    f64-fallback counters, and B2 launches per coupled GMRES iteration, which
    must exceed phase 11's;
13. checkpoint round trip: phase 11's march under a ``time_budget_s`` that
    trips it part-way; exactly that ``RuntimeError`` is caught, the ``.npz``
    is loaded, and a new march resumed from it with the stored ``ptc_dt``
    must converge to the same anchors.

14. the Schur blocks at full width, standalone NS: the lid-driven cavity
    (``u_N=1``, ``Gr=0``) at Re=100 on NS P=16 64×64 through
    ``NavierStokesSolver.run`` with ``linear_solver="coupled"``, once with
    each of ``schur_precon`` ``'spectral'``, ``'pcd'`` and ``'mass'``: Newton
    iterations, coupled GMRES inner iterations per Newton step, f32 chunks
    (refinement passes), B2 launches (> 0), the flexible-retry and f64
    counters, wall.  The Newton residual must meet ``mtol_newton``, u on the
    vertical centerline the Ghia, Ghia & Shin (1982) Re=100 table within
    2e-2, and the runs' u at those points agree within 1e-6.  Should
    ``'mass'`` exhaust its iteration cap at this width, its line says so and
    it runs at P=16 16×16 instead;
15. the Uzawa linear solver at full width: the same problem with
    ``linear_solver="uzawa"``, ``schur_precon="spectral"``,
    ``maxiter_velo=150`` (float64, nested Krylov): Newton iterations, Schur GMRES iterations per Newton step, the
    velocity-solve iterations (pre-solve, nested total, back-substitution),
    wall, ms per velocity iteration; B1-B4 launches must all be 0, the
    Newton count phase 14's ``'spectral'`` count ± 1 and u at the Ghia
    points equal to that run's within 1e-6;
16. ``sem_tpu_torch.assemble`` against kernel B1 at P=16 32×32: the
    assembled ``K + Pe·(diag(u) Gx + diag(v) Gy)`` as a
    ``torch.sparse_csr_tensor`` on the card applied to phase 2's inputs,
    within phase 2's tolerance of the kernel's output; its nonzero count
    beside that of phase 4's hand-built library operator.

``python3 chip_smoke.py --ns-options`` runs phases 14-16 alone.

Then the wall of every phase and the total; a JSON line with one entry per
kernel at its main-path shape: ``ms`` and ``plain_ms`` are event pairs
(``call_us``, ``plain_us``), ``device_ms``, ``plain_device_ms`` and
``library_ms`` CUDA-graph device times, ``launches`` the count of phase 6
(B1/B2) or phase 9 (B3/B4, rank 0) and ``launches_by_path`` the counts of
phases 10–12 and 14–15; as the last line ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""
import argparse
import contextlib
import io
import json
import os
import socket
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

# the main path's configuration (phases 6 and 9)
NORTH_STAR = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=16, N_ex_cd=32, N_ey_cd=32,
                  P_ns=16, N_ex_ns=64, N_ey_ns=64, mode="JNK",
                  mtol_nonlin=1e-8, iprint=False)
RANKS = 2            # phase 9
RANK_TIMEOUT_S = 600
# phases 11-13: the grids and tolerance of the main path at Ra=1e5
PTC_RA1E5 = dict(NORTH_STAR, Ra=1e5, mode="PTC")
# de Vahl Davis (1983): u_max·RePr on x=1/2, v_max·RePr on y=1/2, by Ra
DE_VAHL_DAVIS = {1e5: (34.73, 68.59), 1e6: (64.63, 219.36)}
# phases 14-15: the lid-driven cavity on the main path's NS grid, and Ghia,
# Ghia & Shin (1982) Table I, u on the vertical centerline x=1/2 at Re=100
# (Newton RMS 5e-12 with linear solves to 1e-12, so that two converged runs
# can be held to each other at 1e-6: the near-spurious pressure modes of the
# equal-order discretization map a residual to ~100 times itself in u, and
# runs that stop at the solver's default RMS 1e-5, or at 1e-9, were measured
# 4e-5 and 9e-5 apart)
LID_CAVITY = dict(Re=100.0, Gr=0.0, P=16, N_ex=64, N_ey=64, u_N=1.0,
                  mtol=1e-12, mtol_newton=5e-12, iprint=[])
GHIA_Y = (0.0547, 0.1016, 0.2813, 0.4531, 0.5000, 0.7344)
GHIA_U_RE100 = (-0.03717, -0.06434, -0.15662, -0.21090, -0.20581, 0.00332)


def _line(tag, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


class Walls:
    """Wall seconds per phase: ``mark(name)`` closes the phase that ran
    since the previous mark."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.phases = {}

    def mark(self, name):
        now = time.perf_counter()
        self.phases[name] = round(now - self.last, 2)
        self.last = now

    def show(self):
        _line("walls", **self.phases,
              total=f"{time.perf_counter() - self.t0:.2f}")


# the card's peaks for the bounds (NVIDIA's H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def device_us(fn, k=20, reps=20):
    """Device µs per call of ``fn``: k calls captured in one CUDA graph (the
    wrapper's ctypes launch goes to the capturing stream), the replay timed
    with CUDA events, median of ``reps`` replays, divided by k."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(1e3 * e0.elapsed_time(e1) / k)
    del graph
    return statistics.median(times)


def call_us(fn, reps=50, warm=5):
    """µs of an event pair around one call of ``fn``, median of ``reps``
    after ``warm`` calls: the host's work inside the window included."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(1e3 * e0.elapsed_time(e1))
    return statistics.median(times)


def host_us(fn, n=200):
    """Host-clock µs per call over n back-to-back calls of ``fn`` with no
    synchronisation between them: the wrapper's enqueue cost, where it
    exceeds the kernel's device time."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def bound_us(kernels, coupled, grid, rows, strip, mb=None):
    """(µs, "bytes" or "operations") of the least time the card could take
    for one apply of B1/B3 (``coupled`` False) or B2/B4 on grid rows
    ``rows``: each input byte read once and each output byte written once
    (the Krylov fields with their P halo rows for a strip; the band
    coefficients of the rows and columns; the mask as bytes) over the HBM
    rate, against the flops of the structurally nonzero taps that the
    outputs need (``band_tap_ranges``; on a Dirichlet row of B2 only K dp)
    plus the epilogue's, over the f32 peak."""
    P, Ngx, Ngy = grid.P, grid.Ngx, grid.Ngy
    r0, r1 = rows
    nr, nb = r1 - r0, 2 * P + 1
    nodes = nr * Ngy
    t0, t1 = kernels.band_tap_ranges(Ngx, P)
    nx = (t1 - t0)[r0:r1].astype(float)
    t0, t1 = kernels.band_tap_ranges(Ngy, P)
    ny = (t1 - t0).astype(float)
    ext = (nr + 2 * P if strip else nr) * Ngy   # Krylov field values read
    consts = 8 * nb * (nr + Ngy) + 4 * (nr + Ngy)
    taps = Ngy * nx.sum() + nr * ny.sum()       # one x sum + one y sum
    if not coupled:
        nbytes = 4 * (ext + 3 * nodes) + consts
        flops = 2 * 2 * taps + 10 * nodes
    else:
        m = mb.reshape(nr, Ngy).cpu().numpy()
        n_mb = float(m.sum())
        taps_mb = (m.sum(1) * nx).sum() + (m.sum(0) * ny).sum()
        nbytes = 4 * (3 * ext + 9 * nodes) + nodes + consts
        flops = (2 * (5 * (taps - taps_mb) + taps_mb)
                 + 33 * (nodes - n_mb) + 3 * n_mb)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e6 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def csr_operator(kernels, grid, rows, strip, pointwise):
    """The operator of B1/B3 (``pointwise = (u, v, coef)`` of the rows) or
    B2/B4 (``(ul, vl, jac, mb, coef)``) on grid rows ``rows``, assembled on
    the card from the band storage with index arithmetic, zeros dropped,
    as a ``torch.sparse_csr_tensor`` (f32 values, int32 indices).  Its
    columns are the input field(s) whole, or for a strip the strip with P
    halo rows per side; B2's Dirichlet rows are du, dv and K dp.  A
    yardstick for ``library_us`` only: the port never calls it."""
    import torch

    P, Ngx, Ngy = grid.P, grid.Ngx, grid.Ngy
    r0, r1 = rows
    nr = r1 - r0
    M = nr * Ngy
    dev = pointwise[0].device
    c = kernels.band_operators(grid, torch.float32, dev)
    g0 = r0 - P if strip else 0                 # grid row of input row 0
    F = (nr + 2 * P if strip else Ngx) * Ngy    # one input field
    i = torch.arange(r0, r1, device=dev).view(-1, 1, 1)
    j = torch.arange(Ngy, device=dev).view(1, -1, 1)
    t = torch.arange(2 * P + 1, device=dev).view(1, 1, -1)
    node = (i - r0) * Ngy + j
    centre = (i - g0) * Ngy + j
    kx, ky = i - P + t, j - P + t
    ok_x, ok_y = (kx >= 0) & (kx < Ngx), (ky >= 0) & (ky < Ngy)
    col_x, col_y = (kx - g0) * Ngy + j, (i - g0) * Ngy + ky
    MX = c["m1x"][r0:r1].view(-1, 1).expand(nr, Ngy)
    MY = c["m1y"].view(1, -1).expand(nr, Ngy)
    parts = []

    def add(val, ok, cols, ro, co):
        keep = ok & (val != 0)
        parts.append((ro + node.expand_as(val)[keep],
                      co + cols.expand_as(val)[keep], val[keep]))

    def x(band, scale, ro=0, co=0):     # x taps of rows r0..r1-1
        add(band[r0:r1].unsqueeze(1) * scale.unsqueeze(2), ok_x, col_x, ro,
            co)

    def y(bandT, scale, ro=0, co=0):    # y taps
        add(bandT.T.unsqueeze(0) * scale.unsqueeze(2), ok_y, col_y, ro, co)

    def d(scale, ro=0, co=0):           # the node's own column
        add(scale.unsqueeze(2), torch.ones((), dtype=torch.bool, device=dev),
            centre, ro, co)

    if len(pointwise) == 3:
        u, v, coef = pointwise
        U, V = u.view(nr, Ngy), v.view(nr, Ngy)
        x(c["kxb"], MY)
        x(c["gxb"], coef * U * MY)
        y(c["kybT"], MX)
        y(c["gybT"], coef * V * MX)
        shape = (M, F)
    else:
        ul, vl, jac, mb, coef = pointwise
        UL, VL = ul.view(nr, Ngy), vl.view(nr, Ngy)
        JXX, JXY, JYX, JYY = (a.view(nr, Ngy) for a in jac)
        m = mb.view(nr, Ngy).float()
        nm = 1 - m
        for ro, co in ((0, 0), (M, F)):      # dru (du block), drv (dv block)
            x(c["kxb"], nm * MY, ro, co)
            x(c["gxb"], nm * coef * UL * MY, ro, co)
            y(c["kybT"], nm * MX, ro, co)
            y(c["gybT"], nm * coef * VL * MX, ro, co)
            d(m, ro, co)
        d(nm * JXX, 0, 0)
        d(nm * JXY, 0, F)
        x(c["gxb"], nm * MY, 0, 2 * F)
        d(nm * JYX, M, 0)
        d(nm * JYY, M, F)
        y(c["gybT"], nm * MX, M, 2 * F)
        x(c["gxb"], nm * MY, 2 * M, 0)       # drc
        y(c["gybT"], nm * MX, 2 * M, F)
        x(c["kxb"], m * MY, 2 * M, 2 * F)
        y(c["kybT"], m * MX, 2 * M, 2 * F)
        shape = (3 * M, 3 * F)
    rr, cc, vv = (torch.cat(p) for p in zip(*parts))
    del parts
    with warnings.catch_warnings():   # "sparse support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_coo_tensor(torch.stack([rr, cc]), vv, shape
                                    ).coalesce().to_sparse_csr()
        return torch.sparse_csr_tensor(A.crow_indices().int(),
                                       A.col_indices().int(), A.values(),
                                       shape)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch import operators as ops
    from sem_tpu_torch.coupling import build_coupled, run
    from sem_tpu_torch.mesh import Grid2D
    from sem_tpu_torch.ops import _build, kernels, sharded
    from sem_tpu_torch.parallel import row_strips

    dev = torch.device("cuda")
    walls = Walls()

    # ---- 1. device and build ----
    smi = _smi_line()
    t0 = time.perf_counter()
    _build.library()
    _line("build", seconds=f"{time.perf_counter() - t0:.2f}",
          nvcc_seconds=f"{_build.last_build_seconds:.2f}",
          lib_dir=_build.build_dir())

    def inputs(grid, dtype):
        """Seeded device inputs of both kernels: (u, v, w) and
        (q, ul, vl, jac, mb)."""
        r = np.random.default_rng(grid.N)
        N = grid.N

        def t(a):
            return torch.as_tensor(a, device=dev).to(dtype)

        u, v, w = (t(r.standard_normal(N)) for _ in range(3))
        q = t(r.standard_normal(3 * N))
        jac = tuple(t(r.standard_normal(N)) for _ in range(4))
        mb = np.zeros(N, bool)
        mb[r.choice(N, size=N // 7, replace=False)] = True
        mb = torch.as_tensor(mb, device=dev)
        return {"apply_system": (u, v, w, 7.5),
                "apply_coupled_system": (q, u, v, jac, mb, 37.0)}

    kernel_fns = {
        "apply_system": (kernels.apply_system_kernel,
                         kernels.apply_system_plain, ops.apply_system),
        "apply_coupled_system": (kernels.apply_coupled_system_kernel,
                                 kernels.apply_coupled_system_plain,
                                 ops.apply_coupled_system)}

    def max_err(got, ref):
        err = float((got.double() - ref.double()).abs().max())
        scale = float(ref.double().abs().max())
        return err, scale

    walls.mark("1_build")

    # ---- 2./3. kernels vs plain and vs the f64 dense path ----
    # the main path applies B1 on the CD grid (P16 32×32) and B2 on the NS
    # grid (P16 64×64); the JSON rows report each kernel at its own shape
    g4, g32, g64 = (Grid2D(4, 8, 8, 1.0, 1.3), Grid2D(16, 32, 32, 1.0, 1.0),
                    Grid2D(16, 64, 64, 1.0, 1.0))
    main_grid = {"apply_system": g32, "apply_coupled_system": g64}
    report = {name: {} for name in kernel_fns}
    for name, (kfn, pfn, dense) in kernel_fns.items():
        for grid in (g4, g32, g64):
            a32 = inputs(grid, torch.float32)[name]
            a64 = inputs(grid, torch.float64)[name]
            got = kfn(grid, *a32)
            ref = pfn(grid, *a32)
            ref64 = dense(grid, *a64)
            torch.cuda.synchronize()
            err, scale = max_err(got, ref)
            err64, scale64 = max_err(got, ref64)
            ok = err <= 2e-5 * scale and err64 <= 2e-5 * scale64
            _line(name, grid=grid.tag, N=grid.N, max_abs_err=f"{err:.3e}",
                  max_abs_err_f64=f"{err64:.3e}", scale=f"{scale:.3e}",
                  tol="2e-5*scale", ok=ok)
            if not ok:
                raise AssertionError(f"{name} at {grid.tag}: kernel error "
                                     f"{err:.3e} (plain) / {err64:.3e} (f64 "
                                     f"dense) exceeds 2e-5*{scale:.3e}")
            if grid is main_grid[name]:
                report[name]["max_abs_err"] = err

    walls.mark("2_3_kernel_checks")

    # ---- 4. timings at P=16 (inputs already on the card) ----
    strip_fns = {
        "apply_system_sharded": (sharded.apply_system_sharded,
                                 sharded.apply_system_sharded_plain),
        "apply_coupled_system_sharded": (
            sharded.apply_coupled_system_sharded,
            sharded.apply_coupled_system_sharded_plain)}
    whole = {"apply_system_sharded": "apply_system",
             "apply_coupled_system_sharded": "apply_coupled_system"}
    strip_of = {v: k for k, v in whole.items()}

    def strip_args(name, grid, rows, a):
        """One strip's arguments from the whole-grid inputs ``a``."""
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        if name == "apply_system_sharded":
            u, v, w, coef = a
            return (grid, rows, u[sl], v[sl],
                    sharded.strip_with_halo(grid, rows, w), coef)
        q, u, v, jac, mb, coef = a
        return (grid, rows, sharded.strip_with_halo(grid, rows, q, 3), u[sl],
                v[sl], tuple(j[sl] for j in jac), mb[sl], coef)

    def measure(name, grid, rows, kfn, pfn, args):
        """Phase 4/8 measurements of kernel ``name`` (whole grid or strip)
        called as ``kfn(*args)``; its plain version ``pfn``."""
        strip = name.endswith("_sharded")
        coupled = "coupled" in name
        pw = args[2:] if strip else args[1:]    # after grid (and rows)
        x_in = pw[0] if coupled else pw[2]      # q (q_ext) or w (w_ext)
        pointwise = (pw[1], pw[2], pw[3], pw[4], pw[5]) if coupled \
            else (pw[0], pw[1], pw[3])
        m = {"device_us": device_us(lambda: kfn(*args)),
             "call_us": call_us(lambda: kfn(*args)),
             "plain_us": call_us(lambda: pfn(*args)),
             "plain_device_us": device_us(lambda: pfn(*args)),
             "host_us": host_us(lambda: kfn(*args))}
        m["bound_us"], m["bound_by"] = bound_us(
            kernels, coupled, grid, rows, strip,
            pointwise[3] if coupled else None)
        m["share"] = m["bound_us"] / m["device_us"]
        A = csr_operator(kernels, grid, rows, strip, pointwise)
        got, lib = kfn(*args), A @ x_in
        torch.cuda.synchronize()
        err, scale = max_err(lib, got)
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{name} at {grid.tag}: the assembled CSR "
                                 f"operator differs from the kernel by "
                                 f"{err:.3e} (scale {scale:.3e})")
        m["library_us"] = device_us(lambda: A @ x_in)
        m["library_nnz"] = A.values().numel()
        del A
        torch.cuda.empty_cache()
        return m

    def show(name, grid, m, **extra):
        _line("timing", kernel=name, grid=grid.tag, **extra,
              host_us=f"{m['host_us']:.2f}",
              device_us=f"{m['device_us']:.2f}",
              call_us=f"{m['call_us']:.2f}",
              plain_us=f"{m['plain_us']:.1f}",
              plain_device_us=f"{m['plain_device_us']:.1f}",
              bound_us=f"{m['bound_us']:.2f}", bound_by=m["bound_by"],
              share=f"{m['share']:.3f}",
              library_us=f"{m['library_us']:.2f}",
              library_nnz=m["library_nnz"],
              device_method="cuda_graph_20_calls", smi=f"'{smi}'")

    for name, (kfn, pfn, _) in kernel_fns.items():
        for grid in (g32, g64) if name == "apply_system" else (g64,):
            a = inputs(grid, torch.float32)[name]
            m = measure(name, grid, (0, grid.Ngx), kfn, pfn, (grid, *a))
            sname = strip_of[name]
            sa = strip_args(sname, grid, (0, grid.Ngx), a)
            sfn = strip_fns[sname][0]
            m["strip_r1_us"] = device_us(lambda: sfn(*sa))
            show(name, grid, m, strip_r1_us=f"{m['strip_r1_us']:.2f}",
                 strip_over_whole=f"{m['strip_r1_us'] / m['device_us']:.3f}")
            if grid is main_grid[name]:
                report[name].update(m)

    walls.mark("4_timings")

    # ---- 5. reference configuration (de Vahl Davis, P=4 8×8) ----
    xp, yp = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101),
                         indexing="ij")
    t0 = time.perf_counter()
    T, u, v, state, stats = run((xp, yp), 1.0, 1.0, Re=1e3, Ra=1e3,
                                Pr=0.71, P_cd=4, N_ex_cd=8, N_ey_cd=8,
                                P_ns=4, N_ex_ns=8, N_ey_ns=8, mode="JNK",
                                iprint=False, return_state=True,
                                device="cuda")
    umax, vmax = float(np.max(u)) * 1e3 * 0.71, float(np.max(v)) * 1e3 * 0.71
    _line("reference", config="P4_8x8_JNK", seconds=
          f"{time.perf_counter() - t0:.2f}", stats=stats.as_list(),
          gmres_iters=stats.gmres_iters, u_anchor=f"{umax:.4f}",
          v_anchor=f"{vmax:.4f}")
    if not (abs(umax - 3.649) / 3.649 < 0.01
            and abs(vmax - 3.697) / 3.697 < 0.01
            and stats.nonlinear_iters <= 6):
        raise AssertionError(f"de Vahl Davis anchors missed: u {umax}, "
                             f"v {vmax}, stats {stats.as_list()}")

    walls.mark("5_reference")

    # ---- 6. the main path at full size ----
    t0 = time.perf_counter()
    cd, ns, mda = build_coupled(1.0, 1.0, device="cuda", **NORTH_STAR)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    s = mda.solve()
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    resid = float(torch.linalg.vector_norm(mda._residuals(s)))
    u_anchor = float(s.u.abs().max()) * 1e3 * 0.71
    finite = all(bool(torch.isfinite(f).all()) for f in (s.T, s.u, s.v, s.p))
    _line("north_star", ns="P16_64x64", cd="P16_32x32", dof=mda.DOF,
          build_s=f"{t_build:.2f}", solve_s=f"{t_solve:.2f}",
          stats=mda.stats.as_list(), gmres_iters=mda.stats.gmres_iters,
          residual=f"{resid:.3e}", atol=f"{mda.atol_nonlin:.3e}",
          u_anchor=f"{u_anchor:.4f}",
          f64_fallback_count=ns.f64_fallback_count,
          launches=launches,
          max_memory_allocated_GB=
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if not (finite and resid <= mda.atol_nonlin
            and abs(u_anchor - 3.6531) <= 1e-3
            and all(launches[k] > 0 for k in kernel_fns)):
        raise AssertionError(
            f"north-star solve failed: finite={finite} residual {resid:.3e} "
            f"(atol {mda.atol_nonlin:.3e}) u_anchor {u_anchor:.4f} "
            f"launches {launches}")

    walls.mark("6_north_star")

    # ---- 7. kernels B3/B4 on row strips, halos cut from the full field ----
    main_strip_grid = {"apply_system_sharded": g32,
                       "apply_coupled_system_sharded": g64}

    def on_strips(name, fn, grid, R, a):
        """The strips' outputs in the whole grid's layout."""
        outs = [fn(*strip_args(name, grid, rows, a)).reshape(-1, (
            rows[1] - rows[0]) * grid.Ngy)
            for rows in row_strips(grid.Ngx, R, grid.P)]
        return torch.cat(outs, dim=1).reshape(-1)

    for name, (kfn, pfn) in strip_fns.items():
        for grid in (g4, g32, g64):
            a32 = inputs(grid, torch.float32)[whole[name]]
            a64 = inputs(grid, torch.float64)[whole[name]]
            ref64 = kernel_fns[whole[name]][2](grid, *a64)
            b12 = kernel_fns[whole[name]][0](grid, *a32)
            for R in (1, 2, 4):
                got = on_strips(name, kfn, grid, R, a32)
                ref = on_strips(name, pfn, grid, R, a32)
                torch.cuda.synchronize()
                err, scale = max_err(got, ref)
                err64, scale64 = max_err(got, ref64)
                diff_whole = float((got - b12).abs().max())
                ok = (err <= 2e-5 * scale and err64 <= 2e-5 * scale64
                      and diff_whole == 0.0)
                _line(name, grid=grid.tag, R=R, max_abs_err=f"{err:.3e}",
                      max_abs_err_f64=f"{err64:.3e}", scale=f"{scale:.3e}",
                      tol="2e-5*scale", max_diff_to_whole_grid_kernel=
                      f"{diff_whole:.3e}", tol_whole="0 (same bits)", ok=ok)
                if not ok:
                    raise AssertionError(
                        f"{name} at {grid.tag} R={R}: kernel error "
                        f"{err:.3e} (plain) / {err64:.3e} (f64 dense) "
                        f"exceeds 2e-5*{scale:.3e}, or the strips differ "
                        f"from the whole-grid kernel by {diff_whole:.3e}")
                if grid is main_strip_grid[name] and R == RANKS:
                    report[name] = {"max_abs_err": err}

    walls.mark("7_strip_checks")

    # ---- 8. strip timings (rank 0's strip of R=2) ----
    for name, (kfn, pfn) in strip_fns.items():
        for grid in (g32, g64) if name == "apply_system_sharded" else (g64,):
            rows = row_strips(grid.Ngx, RANKS, grid.P)[0]
            a = strip_args(name, grid, rows,
                           inputs(grid, torch.float32)[whole[name]])
            m = measure(name, grid, rows, kfn, pfn, a)
            show(name, grid, m, R=RANKS, strip_rows=f"{rows[0]}:{rows[1]}")
            if grid is main_strip_grid[name]:
                report[name].update(m)

    walls.mark("8_strip_timings")

    # ---- 9. run_parallel, one process per rank ----
    ranks = run_ranks()
    r0 = ranks[0]
    walls.mark("9_run_parallel")

    # ---- 10.-13. continuation, PTC, flexible chunks, checkpoints ----
    by_path = continuation_phases(smi, direct_s=t_build + t_solve,
                                  walls=walls)

    # ---- 14.-16. Schur blocks, Uzawa, assemble.py ----
    by_path.update(ns_option_phases(smi, walls))
    walls.show()

    rows = []
    for name, src, replaces, n in (
            ("apply_system", "sem_tpu_torch/csrc/apply_system.cu",
             "sem_tpu/ops/pallas_kernels.py:104", launches["apply_system"]),
            ("apply_coupled_system", "sem_tpu_torch/csrc/coupled_system.cu",
             "sem_tpu/ops/pallas_kernels.py:276",
             launches["apply_coupled_system"]),
            ("apply_system_sharded", "sem_tpu_torch/csrc/apply_system.cu",
             "sem_tpu/ops/pallas_kernels.py:541",
             r0["launches"]["apply_system_sharded"]),
            ("apply_coupled_system_sharded",
             "sem_tpu_torch/csrc/coupled_system.cu",
             "sem_tpu/ops/pallas_kernels.py:630",
             r0["launches"]["apply_coupled_system_sharded"])):
        r = report[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n,
                     "launches_by_path": {path: counts.get(name, 0)
                                          for path, counts in by_path.items()},
                     "max_abs_err": r["max_abs_err"],
                     "ms": 1e-3 * r["call_us"],
                     "plain_ms": 1e-3 * r["plain_us"],
                     "bound_ms": 1e-3 * r["bound_us"],
                     "bound_by": r["bound_by"],
                     "library_ms": 1e-3 * r["library_us"],
                     "device_ms": 1e-3 * r["device_us"],
                     "plain_device_ms": 1e-3 * r["plain_device_us"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def centerline_anchors(ns, s, n=2001):
    """(u_max·RePr on x=L/2, v_max·RePr on y=L/2) of a coupled state at
    Re=1e3, Pr=0.71: the values the de Vahl Davis benchmark reports (at high
    Ra the domain maxima lie off the centerlines)."""
    import numpy as np

    line, half = np.linspace(0.0, 1.0, n), np.array([0.5])
    u_line = ns._get_interpol(s.u, np.meshgrid(half, line, indexing="ij"))
    v_line = ns._get_interpol(s.v, np.meshgrid(line, half, indexing="ij"))
    return (float(np.max(np.abs(u_line))) * 1e3 * 0.71,
            float(np.max(np.abs(v_line))) * 1e3 * 0.71)


def _require(ok, what):
    if not ok:
        raise AssertionError(what)


def _counted(fn):
    """``fn()`` with the kernel launch counts set to 0 just before and read
    just after: (result, counts, wall seconds)."""
    import torch
    from sem_tpu_torch.ops import kernels

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), time.perf_counter() - t0


def _residual(mda, s):
    import torch

    finite = all(bool(torch.isfinite(f).all()) for f in (s.T, s.u, s.v, s.p))
    return finite, float(torch.linalg.vector_norm(mda._residuals(s)))


def ptc_march(tag, smi, s0=None, **kw):
    """One PTC march of the main path's grids (``PTC_RA1E5`` updated by
    ``kw``) on the card: one line with steps, stats, wall, the host time
    inside the two disciplines' ``solve_linear`` (each ends in a host read,
    so the host clock holds the device's work), the NS inner iterations and
    B1/B2 launches; the residual must meet atol, the centerline values the
    de Vahl Davis anchors of its Ra within 1 %, and B1 and B2 must have been
    launched.  Returns
    (mda, launches, wall seconds, B2 launches per coupled GMRES iteration).
    """
    from sem_tpu_torch.coupling import build_coupled

    cfg = dict(PTC_RA1E5, **kw)
    anchors = DE_VAHL_DAVIS[cfg["Ra"]]
    cd, ns, mda = build_coupled(1.0, 1.0, device="cuda", **cfg)
    spent = {"cd": 0.0, "ns": 0.0, "ns_inner_its": 0}
    for key, comp in (("cd", mda.cd_comp), ("ns", mda.ns_comp)):
        def timed(*a, _f=comp.solve_linear, _k=key, **k):
            t0 = time.perf_counter()
            out = _f(*a, **k)
            spent[_k] += time.perf_counter() - t0
            if _k == "ns":
                spent["ns_inner_its"] += ns.last_schur_info.iterations
            return out
        comp.solve_linear = timed
    s, n, wall = _counted(lambda: mda.solve(s0))
    finite, resid = _residual(mda, s)
    u_c, v_c = centerline_anchors(ns, s)
    b2 = n["apply_coupled_system"]
    b2_per_it = b2 / max(mda.stats.gmres_iters, 1)
    _line(tag, Ra=f"{cfg['Ra']:.0e}", velo_inner=cfg.get("velo_inner", 0),
          steps=mda.stats.nonlinear_iters, stats=mda.stats.as_list(),
          gmres_iters=mda.stats.gmres_iters,
          final_dt=f"{mda._ptc_dt_current:.3g}", wall_s=f"{wall:.2f}",
          cd_solve_linear_s=f"{spent['cd']:.2f}",
          ns_solve_linear_s=f"{spent['ns']:.2f}",
          ns_inner_its=spent["ns_inner_its"],
          residual=f"{resid:.3e}", atol=f"{mda.atol_nonlin:.3e}",
          u_centerline=f"{u_c:.4f}", v_centerline=f"{v_c:.4f}",
          flex_retry_count=ns.flex_retry_count,
          f64_fallback_count=ns.f64_fallback_count,
          besteffort_floor_count=ns.besteffort_floor_count, launches=n,
          b2_per_gmres_it=f"{b2_per_it:.2f}",
          b2_per_ns_inner_it=f"{b2 / max(spent['ns_inner_its'], 1):.2f}",
          smi=f"'{smi}'")
    _require(finite and resid <= mda.atol_nonlin
             and all(abs(got - want) <= 0.01 * want
                     for got, want in zip((u_c, v_c), anchors))
             and n["apply_system"] > 0 and b2 > 0,
             f"{tag} failed: finite={finite} residual {resid:.3e} (atol "
             f"{mda.atol_nonlin:.3e}) centerline anchors {u_c:.4f} / "
             f"{v_c:.4f} (want {anchors}) launches {n}")
    return mda, n, wall, b2_per_it


def continuation_phases(smi, direct_s=None, walls=None):
    """Phases 10-13 (module docstring).  Returns the kernel launch counts of
    phases 10-12 by path; any failed requirement raises."""
    import torch

    sys.path.insert(0, ROOT)
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.coupling import build_coupled, solve_continued
    from sem_tpu_torch.utils.checkpoint import load_checkpoint

    walls = walls or Walls()
    by_path = {}

    # ---- 10. solve_continued at full width ----
    cont_kw = {k: v for k, v in NORTH_STAR.items()
               if k not in ("P_cd", "P_ns")}
    for tag, ladder_kw in (("halving", dict(levels=2)),
                           ("two_level", dict(ladder=[(4, 4), (16, 16)]))):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            (cd, ns, mda, s), n, wall = _counted(lambda: solve_continued(
                1.0, 1.0, P_cd=16, P_ns=16, timing=True, device="cuda",
                **ladder_kw, **cont_kw))
        levels = [ln.split("level ", 1)[1].replace(" ", "_").replace(
            ":_", ":") for ln in log.getvalue().splitlines()
            if "[ttfs]" in ln]
        finite, resid = _residual(mda, s)
        u_anchor = float(s.u.abs().max()) * 1e3 * 0.71
        by_path[f"continued_{tag}"] = n
        _line("continued", ladder=tag, levels=levels,
              total_s=f"{wall:.2f}", direct_s=(
                  "not_measured" if direct_s is None else f"{direct_s:.2f}"),
              fine_stats=mda.stats.as_list(),
              fine_gmres_iters=mda.stats.gmres_iters,
              residual=f"{resid:.3e}", atol=f"{mda.atol_nonlin:.3e}",
              u_anchor=f"{u_anchor:.4f}", launches=n, smi=f"'{smi}'")
        _require(finite and resid <= mda.atol_nonlin
                and abs(u_anchor - 3.6531) <= 1e-3
                and n["apply_system"] > 0 and n["apply_coupled_system"] > 0,
                f"solve_continued ({tag}) failed: finite={finite} residual "
                f"{resid:.3e} (atol {mda.atol_nonlin:.3e}) u_anchor "
                f"{u_anchor:.4f} launches {n}")

    # the same ladder with the host constants' disk cache off: the three
    # levels built one after the other, then solve_continued, whose worker
    # thread builds level i+1 while level i solves
    cached = os.environ.get("SEM_TPU_CACHE")
    os.environ["SEM_TPU_CACHE"] = "0"
    try:
        serial = []
        for P in (4, 8, 16):
            t0 = time.perf_counter()
            build_coupled(1.0, 1.0, P_cd=P, P_ns=P, device="cuda", **cont_kw)
            torch.cuda.synchronize()
            serial.append(round(time.perf_counter() - t0, 2))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            _, _, wall = _counted(lambda: solve_continued(
                1.0, 1.0, P_cd=16, P_ns=16, timing=True, device="cuda",
                levels=2, **cont_kw))
    finally:
        if cached is None:
            del os.environ["SEM_TPU_CACHE"]
        else:
            os.environ["SEM_TPU_CACHE"] = cached
    waits = [float(ln.split("build-wait ")[1].split("s")[0])
             for ln in log.getvalue().splitlines() if "[ttfs]" in ln]
    _line("continued_cold_cache", serial_build_s=serial,
          serial_build_total_s=f"{sum(serial):.2f}",
          threaded_build_wait_s=waits,
          threaded_build_wait_total_s=f"{sum(waits):.2f}",
          threaded_total_s=f"{wall:.2f}")
    walls.mark("10_continued")

    # ---- 11./12. PTC at Ra=1e5, plain and flexible chunks ----
    mda11, by_path["ptc"], wall11, b2_plain = ptc_march(
        "ptc", smi)
    walls.mark("11_ptc")
    _, by_path["ptc_velo_inner"], _, b2_flex = ptc_march(
        "ptc_velo_inner", smi, velo_inner=5)
    _require(b2_flex > b2_plain,
            f"velo_inner=5 launched B2 {b2_flex:.2f} times per coupled GMRES "
            f"iteration, no more than velo_inner=0 ({b2_plain:.2f})")
    walls.mark("12_ptc_velo_inner")

    # ---- 13. checkpoint round trip ----
    path = os.path.join(ROOT, "build", "sem_tpu_torch", "chip_smoke_ptc.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    budget = 0.3 * wall11
    _, _, mda = build_coupled(1.0, 1.0, device="cuda", checkpoint_path=path,
                              time_budget_s=budget, **PTC_RA1E5)
    try:
        mda.solve()
    except RuntimeError as err:
        if "wall-clock budget exhausted" not in str(err):
            raise
        stopped = str(err)
    else:
        raise AssertionError(f"the {budget:.2f} s budget did not trip")
    s_ck, cfg, iters, extras = load_checkpoint(
        path, expect_config=mda.checkpoint_config, with_extras=True,
        device="cuda")
    _require(1 <= iters[2] < mda11.stats.nonlinear_iters
            and extras["ptc_dt"] > 0,
            f"checkpoint after {iters} with {extras}: {stopped}")
    _line("checkpoint", budget_s=f"{budget:.2f}", stopped_after=iters[2],
          iters=iters, ptc_dt=f"{extras['ptc_dt']:.4g}",
          bytes=os.path.getsize(path))
    resumed, _, _, _ = ptc_march("ptc_resumed", smi, s0=s_ck,
                                 ptc_dt0=extras["ptc_dt"])
    _require(resumed.stats.nonlinear_iters < mda11.stats.nonlinear_iters,
            f"the resumed march took {resumed.stats.nonlinear_iters} steps, "
            f"the whole one {mda11.stats.nonlinear_iters}")
    walls.mark("13_checkpoint")
    return by_path


def lid_cavity_run(tag, smi, **kw):
    """One standalone NS solve of ``LID_CAVITY`` (updated by ``kw``) through
    ``NavierStokesSolver.run`` on the card, one line; the Newton residual
    must meet ``mtol_newton`` and u at the Ghia points the table within
    2e-2.  Returns a dict with the node count, u at the Ghia points, the
    Newton count, the launches, the wall and the velocity iterations."""
    import numpy as np
    import torch
    from sem_tpu_torch import NavierStokesSolver
    from sem_tpu_torch.models import navier_stokes as nsmod

    cfg = dict(LID_CAVITY, **kw)
    t0 = time.perf_counter()
    ns = NavierStokesSolver(1.0, 1.0, device="cuda", **cfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    steps, kept, chunks, velo = [], {}, [0], []
    update, solution, gmres = ns._get_update, ns._get_solution, nsmod.gmres
    solve_velo = ns._solve_velo

    def counted_velo(*a):
        out = solve_velo(*a)
        velo.append(out[1].iterations)
        return out

    def counted_update(*a, **k):
        # an Uzawa update's velocity solves: the pre-solve, one per Schur
        # matvec, the back-substitution
        del velo[:]
        out = update(*a, **k)
        steps.append((ns.last_schur_info.iterations,
                      (velo[0], sum(velo[1:-1]), velo[-1]) if velo
                      else (0, 0, 0)))
        return out

    def kept_solution(T, *a, **k):
        kept["T"], kept["uvp"] = T, solution(T, *a, **k)
        return kept["uvp"]

    def counted_gmres(mv, b, *a, **k):
        chunks[0] += b.dtype == torch.float32 and "x0" in k
        return gmres(mv, b, *a, **k)

    ns._get_update, ns._get_solution = counted_update, kept_solution
    ns._solve_velo = counted_velo
    nsmod.gmres = counted_gmres
    pts = np.meshgrid(np.array([0.5]), np.array(GHIA_Y), indexing="ij")
    try:
        (u_pts, _, _), n, wall = _counted(
            lambda: ns.run(lambda x, y: 0 * x, pts))
    finally:
        nsmod.gmres = gmres
    u_ghia = np.asarray(u_pts).reshape(-1)
    ghia_dev = float(np.max(np.abs(u_ghia - np.array(GHIA_U_RE100))))
    u, v, p = kept["uvp"]
    resid = ns._residual_norm(*ns._get_residuals(u, v, p, kept["T"]))
    atol = ns._mtol_newton * (3 * ns.N) ** 0.5
    finite = all(bool(torch.isfinite(f).all()) for f in (u, v, p))
    pre, nested, back = (sum(s[1][i] for s in steps) for i in range(3))
    _line(tag, grid=ns.grid.tag, N=ns.N,
          linear_solver=cfg.get("linear_solver", "coupled"),
          schur_precon=cfg.get("schur_precon", "spectral"),
          newton_iters=ns._k, gmres_iters_per_step=[s[0] for s in steps],
          gmres_iters=sum(s[0] for s in steps), f32_chunks=chunks[0],
          velo_iters_pre=pre, velo_iters_nested=nested, velo_iters_back=back,
          flex_retry_count=ns.flex_retry_count,
          f64_fallback_count=ns.f64_fallback_count,
          build_s=f"{t_build:.2f}", wall_s=f"{wall:.2f}",
          residual=f"{resid:.3e}", atol=f"{atol:.3e}",
          u_ghia=[round(float(x), 6) for x in u_ghia],
          ghia_dev=f"{ghia_dev:.2e}", launches=n, smi=f"'{smi}'")
    _require(finite and resid <= atol and ghia_dev <= 2e-2,
             f"{tag} failed: finite={finite} residual {resid:.3e} (atol "
             f"{atol:.3e}) deviation from Ghia {ghia_dev:.3e}")
    return dict(N=ns.N, u_ghia=u_ghia, newton=ns._k, launches=n, wall=wall,
                velo_iters=pre + nested + back)


def ns_option_phases(smi, walls=None):
    """Phases 14-16 (module docstring).  Returns the kernel launch counts of
    phases 14-15 by path; any failed requirement raises."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch import assemble
    from sem_tpu_torch.mesh import Grid2D
    from sem_tpu_torch.ops import kernels

    walls = walls or Walls()
    by_path = {}
    failed = []     # raised together at the end: every phase prints its line

    def same_answer(a, b, what):
        diff = float(np.max(np.abs(a["u_ghia"] - b["u_ghia"])))
        if diff > 1e-6:
            failed.append(f"{what}: u at the Ghia points differs by "
                          f"{diff:.3e} (> 1e-6)")
        return diff

    # ---- 14. the three Schur blocks, coupled path ----
    runs = {}
    for sp in ("spectral", "pcd", "mass"):
        try:
            runs[sp] = lid_cavity_run(f"ns_{sp}", smi, schur_precon=sp)
        except RuntimeError as err:
            if sp != "mass":
                raise
            # the mass block's counts grow with 1/h: record it and run the
            # block at a width it solves
            _line("ns_mass", grid="P16_64x64", exhausted=f"'{err}'")
            runs[sp] = lid_cavity_run("ns_mass", smi, schur_precon=sp,
                                      N_ex=16, N_ey=16)
        by_path[f"ns_{sp}"] = n = runs[sp]["launches"]
        _require(n["apply_coupled_system"] > 0
                 and n["apply_system"] == 0,
                 f"ns_{sp}: launches {n} (B2 must run, B1 must not: 'pcd' "
                 f"applies the dense operator)")
    diffs = {sp: same_answer(runs[sp], runs["spectral"], f"ns_{sp}")
             for sp in ("pcd", "mass")
             if runs[sp]["N"] == runs["spectral"]["N"]}
    _line("ns_schur_blocks", max_u_diff_to_spectral={
        k: f"{d:.2e}" for k, d in diffs.items()}, tol="1e-6")
    walls.mark("14_ns_schur_blocks")

    # ---- 15. Uzawa ----
    # maxiter_velo=150: at these tolerances the floor 10·eps·‖b‖ of a nested
    # velocity solve's tolerance sits at what float64 can attain here; a
    # solve that reaches it in ~60 iterations without meeting it creeps on
    # through short restart cycles up to the default cap of 4000 (measured:
    # 871 iterations per solve on average, 590-660 s for this phase, the
    # same answer)
    uz = lid_cavity_run("ns_uzawa", smi, linear_solver="uzawa",
                        maxiter_velo=150)
    by_path["ns_uzawa"] = uz["launches"]
    diff = same_answer(uz, runs["spectral"], "ns_uzawa")
    _line("ns_uzawa_vs_coupled", max_u_diff=f"{diff:.2e}", tol="1e-6",
          newton=(uz["newton"], runs["spectral"]["newton"]),
          wall_ratio=f"{uz['wall'] / runs['spectral']['wall']:.1f}",
          ms_per_velo_iter=f"{1e3 * uz['wall'] / max(uz['velo_iters'], 1):.3f}")
    if not (all(c == 0 for c in uz["launches"].values())
            and abs(uz["newton"] - runs["spectral"]["newton"]) <= 1):
        failed.append(f"ns_uzawa: launches {uz['launches']} (must be 0), "
                      f"Newton {uz['newton']} against "
                      f"{runs['spectral']['newton']}")
    walls.mark("15_ns_uzawa")

    # ---- 16. assemble.py against kernel B1 ----
    grid = Grid2D(16, 32, 32, 1.0, 1.0)
    r = np.random.default_rng(grid.N)       # phase 2's inputs
    u, v, w = (r.standard_normal(grid.N) for _ in range(3))
    Pe = 7.5
    t0 = time.perf_counter()
    Cx, Cy = assemble.global_convection_matrices(grid)
    A = (assemble.global_stiffness_matrix(grid)
         + Pe * (Cx.left(u) + Cy.left(v))).tocsr()
    t_asm = time.perf_counter() - t0
    dev = torch.device("cuda")
    with warnings.catch_warnings():   # "sparse support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        A32 = torch.sparse_csr_tensor(
            torch.as_tensor(A.indptr.astype(np.int32), device=dev),
            torch.as_tensor(A.indices.astype(np.int32), device=dev),
            torch.as_tensor(A.data, device=dev).float(), A.shape)
    f32 = [torch.as_tensor(a, device=dev).float() for a in (u, v, w)]
    got = kernels.apply_system_kernel(grid, *f32, Pe)
    lib = A32 @ f32[2]
    hand = csr_operator(kernels, grid, (0, grid.Ngx), False,
                        (f32[0], f32[1], Pe))
    torch.cuda.synchronize()
    err = float((lib.double() - got.double()).abs().max())
    scale = float(got.double().abs().max())
    ok = err <= 2e-5 * scale
    _line("assemble", grid=grid.tag, nnz=A.nnz,
          hand_built_nnz=hand.values().numel(), assemble_s=f"{t_asm:.2f}",
          max_abs_err_to_B1=f"{err:.3e}", scale=f"{scale:.3e}",
          tol="2e-5*scale", ok=ok)
    if not ok:
        failed.append(f"the assembled operator differs from kernel B1 by "
                      f"{err:.3e} (scale {scale:.3e})")
    walls.mark("16_assemble")
    _require(not failed, "; ".join(failed))
    return by_path


def _smi_line():
    """The card's name and power limit, printed and returned."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return smi


def ns_options_main():
    """``--ns-options``: the card's line, the build, then phases 14-16."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from sem_tpu_torch.ops import _build

    smi = _smi_line()
    _build.library()
    walls = Walls()
    ns_option_phases(smi.splitlines()[0], walls)
    walls.show()


def ptc_ra_main(Ra):
    """``--ptc-ra``: the card's line, then one ``velo_inner=5`` PTC march."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    smi = _smi_line()
    ptc_march("ptc_velo_inner", smi.splitlines()[0], Ra=Ra, velo_inner=5)


def _free_port():
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def run_ranks():
    """Phase 9: start one process of this script per rank, wait for all
    (killing every one on a failure or the time limit), print their output
    and check each rank's result; returns the ranks' results."""
    port = _free_port()
    # each rank writes to a file: a full pipe would block a rank's prints
    # while the other waits for it in a collective
    log_dir = os.path.join(ROOT, "build", "sem_tpu_torch")
    os.makedirs(log_dir, exist_ok=True)
    logs = [open(os.path.join(log_dir, f"chip_smoke_rank{r}.log"), "w+")
            for r in range(RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(RANKS), "--port", str(port)], cwd=ROOT,
        stdout=log, stderr=subprocess.STDOUT, text=True)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        res = None
        for ln in log.read().splitlines():
            if ln.startswith("RANK_RESULT "):
                res = json.loads(ln[len("RANK_RESULT "):])
            else:
                print(f"  rank{r}| {ln}", flush=True)
        log.close()
        results.append(res)
    if timed_out:
        raise AssertionError(f"run_parallel ranks exceeded {RANK_TIMEOUT_S} "
                             f"s and were killed")
    for r, (p, res) in enumerate(zip(procs, results)):
        if p.returncode != 0 or res is None:
            raise AssertionError(f"rank {r} failed (exit {p.returncode})")
        n = res["launches"]
        if not (res["finite"] and res["residual"] <= res["atol"]
                and abs(res["u_anchor"] - 3.6531) <= 1e-3
                and n["apply_system_sharded"] > 0
                and n["apply_coupled_system_sharded"] > 0
                and n["apply_system"] == 0 and n["apply_coupled_system"] == 0):
            raise AssertionError(f"run_parallel failed in rank {r}: {res}")
    if any(res["stats"] != results[0]["stats"] for res in results):
        raise AssertionError(f"ranks disagree: {results}")
    return results


def rank_main(rank: int, world: int, port: int):
    """One rank of phase 9 (started by :func:`run_ranks`)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.coupling import build_coupled, run_parallel
    from sem_tpu_torch.ops import COLLECTIVES, LAUNCHES, RowStrips
    from sem_tpu_torch.ops.sharded import all_reduce
    from sem_tpu_torch.parallel import init_distributed, make_group, use_group

    rank, world, dev = init_distributed(f"127.0.0.1:{port}", world, rank)
    group = make_group()
    tag = f"rank{rank}"
    _line(tag, backend=group.backend, world=world, device=dev,
          device_count=torch.cuda.device_count(),
          card=torch.cuda.get_device_name(dev))
    pts = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                      indexing="ij")
    # warm-up (CUDA, cuBLAS, gloo/NCCL set-up) on the reference configuration
    t0 = time.perf_counter()
    _, u, v, _, stats = run_parallel(
        pts, 1.0, 1.0, Re=1e3, Ra=1e3, Pr=0.71, P_cd=4, N_ex_cd=8, N_ey_cd=8,
        P_ns=4, N_ex_ns=8, N_ey_ns=8, mode="JNK", iprint=False,
        return_state=True, device=dev)
    _line(tag, warmup="P4_8x8_JNK", seconds=f"{time.perf_counter() - t0:.2f}",
          stats=stats.as_list(), gmres_iters=stats.gmres_iters)

    for counts in (LAUNCHES, COLLECTIVES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, _, _, s, stats = run_parallel(pts, 1.0, 1.0, return_state=True,
                                     device=dev, **NORTH_STAR)
    torch.cuda.synchronize(dev)
    t_run = time.perf_counter() - t0
    launches, collectives = dict(LAUNCHES), dict(COLLECTIVES)
    peak = torch.cuda.max_memory_allocated(dev)

    # the solvers again, to evaluate the final residual of the state
    t0 = time.perf_counter()
    with use_group(group):
        _, ns, mda = build_coupled(1.0, 1.0, device=dev, **NORTH_STAR)
    torch.cuda.synchronize(dev)
    t_build = time.perf_counter() - t0
    resid = float(torch.linalg.vector_norm(mda._residuals(s)))
    u_anchor = float(s.u.abs().max()) * 1e3 * 0.71
    finite = all(bool(torch.isfinite(f).all()) for f in (s.T, s.u, s.v, s.p))
    _line(tag, north_star="run_parallel", run_parallel_s=f"{t_run:.2f}",
          build_s=f"{t_build:.2f}", stats=stats.as_list(),
          gmres_iters=stats.gmres_iters, residual=f"{resid:.3e}",
          atol=f"{mda.atol_nonlin:.3e}", u_anchor=f"{u_anchor:.4f}",
          launches=launches, collectives=collectives,
          max_memory_allocated_GB=f"{peak / 1e9:.2f}")

    # one of each collective at the NS chunk's shapes (host clock around
    # synchronized calls, median of 20 after warm-up; every rank takes part)
    st = RowStrips(ns.grid, group)
    x = torch.randn(3 * st.nrows * ns.grid.Ngy, device=dev)

    def median_us(fn, reps=20, warm=3):
        ts = []
        for i in range(warm + reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            if i >= warm:
                ts.append(time.perf_counter() - t0)
        return 1e6 * statistics.median(ts)

    coll_us = {"halo_exchange_3_fields": median_us(lambda: st.exchange(x, 3)),
               "strip_gather_3_fields": median_us(lambda: st.gather(x, 3)),
               "all_reduce_17": median_us(lambda: all_reduce(
                   group, torch.ones(17, device=dev)))}
    _line(tag, collective_us={k: f"{v:.1f}" for k, v in coll_us.items()},
          strip_rows=f"{st.rows[0]}:{st.rows[1]}", Ngy=ns.grid.Ngy)
    print("RANK_RESULT " + json.dumps({
        "rank": rank, "backend": group.backend, "stats": stats.as_list(),
        "gmres_iters": stats.gmres_iters, "residual": resid,
        "atol": mda.atol_nonlin, "u_anchor": u_anchor, "finite": finite,
        "launches": launches, "collectives": collectives,
        "collective_us": coll_us, "run_parallel_s": t_run,
        "build_s": t_build, "peak_bytes": peak}), flush=True)
    # leaving with the group alive can abort at interpreter exit (gloo)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ptc-ra", type=float, choices=sorted(DE_VAHL_DAVIS),
                    help="instead of the smoke run: one PTC march of the "
                         "main path's grids at this Ra with velo_inner=5 "
                         "(Ra=1e6 takes minutes)")
    ap.add_argument("--ns-options", action="store_true",
                    help="instead of the smoke run: phases 14-16 alone (the "
                         "Schur blocks, Uzawa, assemble.py)")
    a = ap.parse_args()
    if a.ptc_ra is not None:
        ptc_ra_main(a.ptc_ra)
    elif a.ns_options:
        ns_options_main()
    elif a.rank is None:
        main()
    else:
        rank_main(a.rank, a.world, a.port)
