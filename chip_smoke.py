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
   2e-5·max|ref|; then on bfloat16 fields (the reference's Pallas kernels'
   other dtype) vs its plain version at bf16, within one bf16 ulp
   (``BF16_TOL``: rtol 2^-7, atol 1e-5·max|ref|);
3. kernel B2 (NS coupled saddle matvec), the same checks; then, for both,
   the dense route above the kernels' order limit ``P_MAX``: at P=65 2×1
   the dispatchers ``apply_*_best`` and the R = 1, 3 strips of the B3/B4
   wrappers (halos cut from the full field) at f32 and bf16 against the
   plain versions (2e-5·max|ref| at f32, 2^-6·max|ref| at bf16, where the
   dense path rounds its products and glue to bf16), the launch counts
   reset just before and read just after: every one 0;
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
   then the same rows on bf16 fields (``bound_us`` at 2 bytes per field
   value, compact band coefficient and mass, the band flops at the bf16
   tensor-core peak; ``library_us`` a bf16
   ``torch.sparse_csr_tensor`` product where torch takes one on the card,
   else the error it raised);
5. the reference configuration: ``run`` JNK, P=4 8×8, Ra=1e3, on the
   entry point's default program (4,356 coupled DOF: the device windows) —
   de Vahl Davis anchors u_max·RePr = 3.649 and v_max·RePr = 3.697 within
   1%, ≤ 6 Newton iterations;
6. the main path at full size: ``build_coupled`` + ``solve`` JNK with NS at
   P=16 64×64 and CD at P=16 32×32, Ra=1e3, from zero, to the coupled RMS
   tolerance 1e-8 of the reference's p16 study runs, pinned to the un-fused
   host FGMRES (``UNFUSED``: ``fused=False, device_krylov=False``), the
   witness of that program; the kernel launch counts are reset just before
   and read just after, and B1's and B2's must be > 0;
7. kernels B3/B4 (B1/B2 on row strips) at P=4 8×8, P=16 32×32 and P=16
   64×64 with R = 1, 2 and 4 strips in this process, and strips thinner
   than P (``STRIP_COUNTS``: R = 9, 16 at P=4 8×8, 64 at P=16 32×32, strips
   of 2-4 and 8-9 rows), each strip's halo cut
   from the full field: the concatenated strips against the plain strip
   versions and the f64 dense path (tolerance 2e-5·max|ref|), and against
   B1's/B2's output, which must be the same bits (B3/B4 are B1/B2's kernels
   on a row window: this holds the window, halo and tile-lattice logic
   against the whole-grid launch); then on bf16 fields against the bf16
   plain strips (``BF16_TOL``) and the bf16 whole-grid launch (same bits);
8. B3/B4 on rank 0's strip of R=2 at P=16 64×64, and B3 also at its
   main-path shape P=16 32×32: the measurements of phase 4 but
   ``strip_r1_us`` (the library operator is the strip's rows against the
   haloed strip's columns), at f32 and at bf16;
8b. the bf16 path: the dispatchers ``apply_system_best`` (CD grid, P=16
   32×32) and ``apply_coupled_system_best`` (NS grid, P=16 64×64) and the
   strip kernels B3/B4 on the two strips of R=2 (halos cut from the full
   field), each driving ``BF16_POWER_STEPS`` steps of a power iteration on
   bf16 fields, the counts reset just before and read just after: every
   bf16 kernel launched that many times (per strip for B3/B4) and no f32
   kernel; the estimates finite and within 2 % of the same iteration at
   f32 (run after the counts are read).  Then B1-B4 at bf16 (the
   tensor-core kernels) against their plain versions per output element,
   B1/B3 at P=16 32×32 and 64×64, B2/B4 at P=16 64×64, whole grid and R =
   1, 2, 4 strips (and 64 at 32×32): at most one bf16 ulp wherever the
   error exceeds 1e-5·max|ref| (the elements beyond one ulp under that
   floor counted, any above it printed with its place), the strips the
   whole-grid bits; their
   device, call and host µs, bound and share at each of those shapes (R=2
   strip 0 for B3/B4) beside the f32 kernel's of this call (phases 4 and 8)
   and the bf16 cuSPARSE µs;
9. the multi-process path at full size: ``run_parallel`` with the configuration
   of phase 6 (pinned as phase 6 is), two ranks started as two processes of
   this script (NCCL with one card per rank where there are two cards, gloo
   with both ranks on cuda:0 otherwise).  Counts are reset just before and read
   just after; in each rank B3's and B4's must be > 0 and B1's and B2's 0
   (every f32 matvec went to the strips), the residual must meet atol and the
   u-anchor 3.6531 ± 1e-3.  Rank 0 then times one halo exchange, one full-field
   all-gather and one all-reduce at the NS chunk's shapes.  Each rank then runs
   three more programs under the group, the counts reset before each: (9b)
   ``run_parallel(..., velo_inner=5)`` on phase 6's grids (pinned), whose B4
   launches per coupled GMRES iteration must exceed phase 9's; (9c)
   ``fused=True`` on the same grids (``build_coupled`` under the group, to keep
   the MDA): the first wall (the graph capture included), a warm wall, and the
   collectives of one replayed fused step, which must be 0; (9d)
   ``run_parallel(..., device_krylov=True)`` on phase 23c's grids (NS P=16
   32×32 / CD P=16 16×16, RMS 1e-10).  Each must meet its residual and the
   u-anchor 3.6531 ± 1e-3 with B3 and B4 > 0 and B1 and B2 0 in every rank, and
   the ranks' stats must be equal.  One line prints rank 0's runs beside phase
   6's solve, one after phase 23 beside 23a and 23c.

10. ``solve_continued`` at full width (the grids, tolerance and pinned program
    of phase 6), once with the default halving ladder P4→P8→P16 and once with
    ``ladder=[(4,4),(16,16)]``: per level the build wait (what the worker
    thread did not hide), the solve wall and the stats; the total wall beside
    phase 6's direct wall; B1's and B2's launches must be > 0, the residual
    meet atol and the u-anchor 3.6531 ± 1e-3;
11. pseudo-transient continuation at full width: ``build_coupled(mode="PTC")``
    on the same grids at Ra=1e5, from zero, coupled RMS 1e-8, pinned to the
    un-fused host program as phases 12 and 13 are: steps, stats,
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
    it runs at P=16 16×16 instead.  In the whole script ``'pcd'`` runs at
    P=16 16×16 beside a ``'spectral'`` run there, so that phases 17-19 fit
    the script's time; ``--ns-options`` runs it at 64×64;
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

17. profile of the main path: one warm north-star solve (phase 6's
    configuration and pinned program, a fresh ``build_coupled``) inside
    ``sem_tpu_torch.utils.profiling.trace`` (``torch.profiler``, CPU and CUDA
    activities): the five device operations with the most device time and
    their shares of it, B1's and B2's shares, the device-busy share of the
    wall; the trace goes to ``build/sem_tpu_torch/trace`` (not brought back:
    tens of MB);
18. the implicit adjoint at full width: phase 6's state tightened to
    ``mtol_nonlin=1e-10`` (warm start, pinned as phase 6), then
    ``sem_tpu_torch.coupling.implicit.gradients`` of the reference's loss
    ``sum(u² + v²)`` with respect to Re, Ra, Pr at the defaults
    (``inner_rtol=1e-4``, ``max_basis_gb=0.5``): the outer and inner
    windows, outer iterations, wall, s/it, host ms per transposed matvec
    (``J_xᵀ w`` by autograd, synchronized, median of 20), a ``PhaseTimer``
    split (vjp set-up / row norms / FGMRES / θ-vjp), peak device memory,
    the raw residual ``‖J_xᵀλ − g‖/‖g‖`` from an independent vector-Jacobian
    product beside its bound 1e-6 (printed, not required: see the note in
    :func:`adjoint_phase`), the three gradients, and d/dRa against central
    differences of two warm-started JNK re-solves at ``Ra(1 ± 1e-4)``
    (:func:`fd_derivative`; within 1e-3; on a
    miss the steps 1e-3 and 1e-5 are tried and printed, and the phase passes
    only if one of them agrees); B1-B4 launches 0;
19. the study path through its CLIs, as subprocesses: ``boussinesq_run -P 8
    -Ne 32 -Ra 1e5 -mode PTC -ckpt True`` (through ``runpy``, so that its
    kernel launches are read after the march), ``adjoint_hi -ckpt <that>
    -fd 1`` and ``summarize``: exit codes 0, the ``.npz``, ``.stats.json``
    and ``.ckpt.npz`` written, the march's centerline anchors the de Vahl
    Davis values within 1 %, the adjoint's FD line printed.

20. the examples as subprocesses (``python -m sem_tpu_torch.examples.<name>
    --check``, through ``runpy`` so that their launches are read), started
    together: the convection-diffusion example (B1 launched), the lid cavity
    ``--quick`` and full (B2), the sequential Boussinesq JNK full and
    ``--quick`` GS and NJ (B1 and B2); then ``boussinesq_parallel --ranks
    2`` (JNK P4 8×8, its own two rank processes) alone, and then
    ``--quick --ranks 8`` (the reference's own command: GS P3 3×3, 10 rows
    over eight ranks on the one card, strips of one and two rows), whose
    per-rank counts must show B3 and B4 launched on each rank.  Each must
    exit 0 and print ``CHECK OK``;
21. ``python -m sem_tpu_torch.bench``: its JSON line on one line; the
    headline rate must be > 0, the coupled solve's u-anchor 3.653 ± 1e-3, B1
    launched;
22. the remaining study CLIs: ``north_star --short`` (u-anchor 3.6531 ±
    1e-3, residual ≤ atol, B1/B2 launched), ``centerline`` on phase 19's
    ``.npz`` (equal to its ``.stats.json`` anchors to 1e-9), ``ns_scale 8 16
    8 32 --mode bouss`` (``'mass'``; B2), ``krylov_econ --direct`` (its
    resweep share and ms per NS f32 iteration) and ``ptc_band_probe`` on
    phase 19's ``.ckpt.npz`` (``-P 8 -Ne 32 -Ra 1e5 -its 40``; B2).

23. the fused and on-device coupled Krylov programs: (a) phase 6's solve
    with ``fused=True`` (the fused host-FGMRES step as CUDA graphs and the
    two-round preconditioner): walls of the first solve (the capture
    included) and of a warm one, stats, coupled GMRES iterations and B1/B2
    launches (> 0) beside phase 6's; the residual must meet atol and the
    u-anchor 3.6531 ± 1e-3; the host synchronizations of one replayed step
    and its scalar read (``torch.cuda.set_sync_debug_mode("warn")``, the
    warnings recorded) must be 1; (b) three replayed steps against their
    eager twins on the same inputs: the largest differences in V, Z, H, g
    and the residual, ≤ 1e-12 relative; (c) ``device_krylov=True`` on NS
    P=16 32×32 / CD P=16 16×16 (855,556 DOF) beside the host JNK solve of
    the same grids (pinned: ``UNFUSED``), both to the coupled RMS 1e-10:
    walls, windows, stats, GMRES iterations, launches of the whole solve and
    inside the windows (B1-B4 all 0 there), the residual within atol and the
    u-anchor within 1e-3 of the host solve's;
    (d) phase 11's march with ``fused=True`` beside phase 11's: steps,
    stats, launches (B1/B2 > 0), wall and phase 11's anchors.
24. ``defaults``: the entry points with no program argument, as a user
    calls them: ``run`` and ``build_coupled`` at the reference P4 8×8 and
    ``build_coupled`` at phase 23c's grids and at the north star.  Each line
    prints the coupled DOF, the program the MDA took (``device_krylov``,
    ``fused``) and the reference's rule (the device windows up to
    ``DEVICE_KRYLOV_MAX_DOF`` = 10⁶ DOF, the fused host FGMRES above), the
    build and solve walls, stats, coupled GMRES iterations and launches.
    The choice must be the rule's and fused, every residual within atol; at
    P4 8×8 ``run``'s stats those of ``build_coupled`` and phase 5's anchors;
    at 23c's grids and the north star the stats, GMRES iterations and
    launches those of the pinned run of the same program in this call (23c
    device, 23a fused) and the u-anchor 3.6531 ± 1e-3.

``python3 chip_smoke.py --kernels`` runs phases 1-4, 7, 8 and 8b alone (the
kernel checks and timings at both dtypes), ``python3 chip_smoke.py --gemm``
phase 25 alone (:func:`gemm_phase`: the even-odd FDM transforms beside
their plain forms),
``python3 chip_smoke.py --ns-options`` runs phases 14-16 alone,
``python3 chip_smoke.py --parallel`` phase 9 (with 9b-9d) alone,
``python3 chip_smoke.py --adjoint`` phases 17-19 (after one north-star
solve for the warm-up and the state), ``python3 chip_smoke.py --drivers``
phase 19 and then phases 20-22 (the examples and CLIs on their default
programs), ``python3 chip_smoke.py --krylov`` phases 6, 11, 23 and 24.

Then the wall of every phase and the total; a JSON line with one entry per
kernel at its main-path shape: ``ms`` and ``plain_ms`` are event pairs
(``call_us``, ``plain_us``), ``device_ms``, ``plain_device_ms`` and
``library_ms`` CUDA-graph device times, ``launches`` the count of phase 6
(B1/B2) or phase 9 (B3/B4, rank 0) and ``launches_by_path`` the counts of
phases 10–12, 14–15, 18, 19's march, 20–22 (rank 0's for the parallel
example), 23, 24 and 9b–9d (rank 0's); then one entry per kernel at bf16
(``"dtype": "bfloat16"``, the same ``replaces``), its ``launches`` those of
phase 8b and its ``launches_by_path`` the bf16 counts of phase 6 and of the
paths above (0: every solver runs f32); as the last line
``{"ok": true, "device": {...}}``.
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
# the un-fused host FGMRES with the adaptive block-Jacobi sweep: the program
# that phases 6, 9 (and 9b), 10-13, 17, 18 and 23c's host side are pinned
# to, so that each stays the witness of one program now that the entry
# points take the reference's choice by problem size (phase 24)
UNFUSED = dict(fused=False, device_krylov=False)
# the reference's rule that phase 24 holds the port's default choice to:
# the device windows up to this many coupled DOF (sem_tpu's default
# SEM_TPU_DEVICE_KRYLOV_MAX_DOF), the fused host FGMRES above
DEVICE_KRYLOV_MAX_DOF = 1_000_000
# phases 9d and 23c: the device windows' grids and tolerance
DEVICE_GRIDS = dict(NORTH_STAR, N_ex_ns=32, N_ey_ns=32, N_ex_cd=16,
                    N_ey_cd=16, mtol_nonlin=1e-10)
RANK_TIMEOUT_S = 600
# phases 2, 3, 7: a bf16 kernel against its bf16 plain version: one bf16
# ulp (8 significant bits) relative, and 1e-5·max|ref| absolute
BF16_TOL = dict(rtol=2.0 ** -7, atol_rel=1e-5)
BF16_POWER_STEPS = 10  # phase 8b
# phases 7 and 8b: the strip counts per grid; R = 9, 16 at P4 8×8 (33 rows)
# and R = 64 at P16 32×32 (513 rows) give strips thinner than P
STRIP_COUNTS = {"P4_8x8": (1, 2, 4, 9, 16), "P16_32x32": (1, 2, 4, 64),
                "P16_64x64": (1, 2, 4)}
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
BF16_TC_FLOPS = 989e12    # dense bf16 on the tensor cores


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


def bound_us(kernels, coupled, grid, rows, strip, mb=None, fbytes=4):
    """(µs, "bytes" or "operations") of the least time the card could take
    for one apply of B1/B3 (``coupled`` False) or B2/B4 on grid rows
    ``rows``: each input byte read once and each output byte written once
    (the Krylov fields with their P halo rows for a strip, ``fbytes`` per
    value of a field, of the compact band coefficients of the rows and
    columns (2P+1 per row and operator) and of the masses: 4 at f32, 2 at
    bf16; the mask as bytes) over the HBM rate, against the flops of the
    structurally nonzero taps that the outputs need (``band_tap_ranges``;
    on a Dirichlet row of B2 only K dp) over the peak for the operands'
    type (bf16: the tensor cores' dense bf16 peak), plus the epilogue's
    over the f32 peak (it is f32 arithmetic at both dtypes)."""
    P, Ngx, Ngy = grid.P, grid.Ngx, grid.Ngy
    r0, r1 = rows
    nr, nb = r1 - r0, 2 * P + 1
    nodes = nr * Ngy
    t0, t1 = kernels.band_tap_ranges(Ngx, P)
    nx = (t1 - t0)[r0:r1].astype(float)
    t0, t1 = kernels.band_tap_ranges(Ngy, P)
    ny = (t1 - t0).astype(float)
    ext = (nr + 2 * P if strip else nr) * Ngy   # Krylov field values read
    consts = fbytes * (2 * nb + 1) * (nr + Ngy)  # K, G bands and the mass
    taps = Ngy * nx.sum() + nr * ny.sum()       # one x sum + one y sum
    if not coupled:
        nbytes = fbytes * (ext + 3 * nodes) + consts
        band, pointwise = 2 * 2 * taps, 10 * nodes
    else:
        m = mb.reshape(nr, Ngy).cpu().numpy()
        n_mb = float(m.sum())
        taps_mb = (m.sum(1) * nx).sum() + (m.sum(0) * ny).sum()
        nbytes = fbytes * (3 * ext + 9 * nodes) + nodes + consts
        band = 2 * (5 * (taps - taps_mb) + taps_mb)
        pointwise = 33 * (nodes - n_mb) + 3 * n_mb
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (band / (BF16_TC_FLOPS if fbytes == 2 else F32_FLOPS)
             + pointwise / F32_FLOPS)
    return 1e6 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def csr_operator(kernels, grid, rows, strip, pointwise):
    """The operator of B1/B3 (``pointwise = (u, v, coef)`` of the rows) or
    B2/B4 (``(ul, vl, jac, mb, coef)``) on grid rows ``rows``, assembled on
    the card from the band storage with index arithmetic, zeros dropped,
    as a ``torch.sparse_csr_tensor`` (values in the pointwise fields'
    dtype, f32 or bf16, rounded from the f32 operator; int32 indices).  Its
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
        U, V = u.view(nr, Ngy).float(), v.view(nr, Ngy).float()
        x(c["kxb"], MY)
        x(c["gxb"], coef * U * MY)
        y(c["kybT"], MX)
        y(c["gybT"], coef * V * MX)
        shape = (M, F)
    else:
        ul, vl, jac, mb, coef = pointwise
        UL, VL = ul.view(nr, Ngy).float(), vl.view(nr, Ngy).float()
        JXX, JXY, JYX, JYY = (a.view(nr, Ngy).float() for a in jac)
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
                                       A.col_indices().int(),
                                       A.values().to(pointwise[0].dtype),
                                       shape)


def main(kernels_only=False):
    """The smoke run (module docstring); ``kernels_only``: phases 1-4, 7, 8
    and 8b alone."""
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

    def bf16_ok(got, ref):
        """(within BF16_TOL elementwise, largest |got-ref|, max|ref|)."""
        g, r = got.double(), ref.double()
        err, scale = max_err(got, ref)
        ok = bool(((g - r).abs() <= BF16_TOL["rtol"] * r.abs()
                   + BF16_TOL["atol_rel"] * scale).all())
        return ok and got.dtype == torch.bfloat16, err, scale

    bf16 = torch.bfloat16
    bf16_tol = (f"rtol={BF16_TOL['rtol']:.6g}+"
                f"{BF16_TOL['atol_rel']:g}*scale")

    walls.mark("1_build")

    # the strip kernels B3/B4, their plain versions, and their whole-grid
    # kernels B1/B2
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

    def on_strips(name, fn, grid, R, a):
        """The strips' outputs in the whole grid's layout."""
        outs = [fn(*strip_args(name, grid, rows, a)).reshape(-1, (
            rows[1] - rows[0]) * grid.Ngy)
            for rows in row_strips(grid.Ngx, R, grid.P)]
        return torch.cat(outs, dim=1).reshape(-1)

    # ---- 2./3. kernels vs plain and vs the f64 dense path ----
    # the main path applies B1 on the CD grid (P16 32×32) and B2 on the NS
    # grid (P16 64×64); the JSON rows report each kernel at its own shape
    g4, g32, g64 = (Grid2D(4, 8, 8, 1.0, 1.3), Grid2D(16, 32, 32, 1.0, 1.0),
                    Grid2D(16, 64, 64, 1.0, 1.0))
    main_grid = {"apply_system": g32, "apply_coupled_system": g64}
    report = {name: {} for name in kernel_fns}
    # phases 4 and 8's measurements by (kernel and dtype suffix, grid tag)
    measured = {}
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
    # the same kernels on bf16 fields, against their bf16 plain versions
    for name, (kfn, pfn, _) in kernel_fns.items():
        report[name + "_bf16"] = {}
        for grid in (g4, g32, g64):
            a = inputs(grid, bf16)[name]
            got = kfn(grid, *a)
            ref = pfn(grid, *a)
            torch.cuda.synchronize()
            ok, err, scale = bf16_ok(got, ref)
            _line(name, dtype="bfloat16", grid=grid.tag, N=grid.N,
                  max_abs_err=f"{err:.3e}", scale=f"{scale:.3e}",
                  tol=bf16_tol, ok=ok)
            if not ok:
                raise AssertionError(f"{name} at {grid.tag}, bf16: kernel "
                                     f"error {err:.3e} exceeds {bf16_tol} "
                                     f"(scale {scale:.3e})")
            if grid is main_grid[name]:
                report[name + "_bf16"]["max_abs_err"] = err

    # above P_MAX the kernels take no order: the dispatchers and the strip
    # wrappers take the dense path (cuBLAS), with no launch
    g65 = Grid2D(kernels.P_MAX + 1, 2, 1, 1.0, 1.0)
    best = {"apply_system": kernels.apply_system_best,
            "apply_coupled_system": kernels.apply_coupled_system_best}
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    res65, ok65 = {}, True
    for dt, tag, tol in ((torch.float32, "f32", 2e-5),
                         (bf16, "bf16", 2.0 ** -6)):
        for name, (_, pfn, _) in kernel_fns.items():
            a = inputs(g65, dt)[name]
            sname = strip_of[name]
            cases = [("whole", best[name](g65, *a), pfn(g65, *a))] + [
                (f"R={R}", on_strips(sname, strip_fns[sname][0], g65, R, a),
                 on_strips(sname, strip_fns[sname][1], g65, R, a))
                for R in (1, 3)]
            torch.cuda.synchronize()
            for where, got, ref in cases:
                err, scale = max_err(got, ref)
                res65[f"{name}:{where}:{tag}"] = f"{err:.3e}/{scale:.3e}"
                ok65 &= got.dtype == dt and err <= tol * scale
    launches65 = dict(kernels.LAUNCHES)
    ok65 &= not any(launches65.values())
    _line("dense_route", grid=g65.tag, N=g65.N,
          max_abs_err_over_scale=res65,
          tol="2e-5*scale (f32), 2^-6*scale (bf16)", launches=launches65,
          ok=ok65)
    if not ok65:
        raise AssertionError(f"the dense route above P_MAX: errors {res65} "
                             f"or launches {launches65}")

    walls.mark("2_3_kernel_checks")

    # ---- 4. timings at P=16 (inputs already on the card) ----
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
        low = x_in.dtype == bf16
        m["bound_us"], m["bound_by"] = bound_us(
            kernels, coupled, grid, rows, strip,
            pointwise[3] if coupled else None, fbytes=2 if low else 4)
        m["share"] = m["bound_us"] / m["device_us"]
        A = csr_operator(kernels, grid, rows, strip, pointwise)
        m["library_nnz"] = A.values().numel()
        got = kfn(*args)
        try:
            lib = A @ x_in
            torch.cuda.synchronize()
        except RuntimeError as e:   # no bf16 sparse product in this torch
            if not low:
                raise
            m["library_us"] = None
            m["library_error"] = repr(str(e).splitlines()[0][:120])
        else:
            err, scale = max_err(lib, got)
            # the bf16 product rounds the operator's values to bf16, its
            # output too: a few bf16 ulps of the largest output
            if not err <= (2.0 ** -5 if low else 1e-4) * scale:
                raise AssertionError(f"{name} at {grid.tag}: the assembled "
                                     f"CSR operator differs from the kernel "
                                     f"by {err:.3e} (scale {scale:.3e})")
            m["library_us"] = device_us(lambda: A @ x_in)
            m["library_err"] = err
        del A
        torch.cuda.empty_cache()
        return m

    def show(name, grid, m, **extra):
        lib = ({"library_us": f"{m['library_us']:.2f}"}
               if m["library_us"] is not None
               else {"library_us": "none",
                     "library_raised": m["library_error"]})
        _line("timing", kernel=name, grid=grid.tag, **extra,
              host_us=f"{m['host_us']:.2f}",
              device_us=f"{m['device_us']:.2f}",
              call_us=f"{m['call_us']:.2f}",
              plain_us=f"{m['plain_us']:.1f}",
              plain_device_us=f"{m['plain_device_us']:.1f}",
              bound_us=f"{m['bound_us']:.2f}", bound_by=m["bound_by"],
              share=f"{m['share']:.3f}", **lib,
              library_nnz=m["library_nnz"],
              device_method="cuda_graph_20_calls", smi=f"'{smi}'")

    for dt, sfx in ((torch.float32, ""), (bf16, "_bf16")):
        for name, (kfn, pfn, _) in kernel_fns.items():
            for grid in (g32, g64) if name == "apply_system" else (g64,):
                a = inputs(grid, dt)[name]
                m = measure(name, grid, (0, grid.Ngx), kfn, pfn, (grid, *a))
                sname = strip_of[name]
                sa = strip_args(sname, grid, (0, grid.Ngx), a)
                sfn = strip_fns[sname][0]
                m["strip_r1_us"] = device_us(lambda: sfn(*sa))
                show(name, grid, m, **({"dtype": "bfloat16"} if sfx else {}),
                     strip_r1_us=f"{m['strip_r1_us']:.2f}", strip_over_whole=
                     f"{m['strip_r1_us'] / m['device_us']:.3f}")
                measured[name + sfx, grid.tag] = m
                if grid is main_grid[name]:
                    report[name + sfx].update(m)

    walls.mark("4_timings")

    # ---- 7., 8., 8b. the strip kernels and the bf16 path ----
    def strip_phases():
        """Phases 7, 8 and 8b; returns phase 8b's launch counts."""
        main_strip_grid = {"apply_system_sharded": g32,
                           "apply_coupled_system_sharded": g64}

        # ---- 7. kernels B3/B4 on row strips, halos cut from the field ----
        for name, (kfn, pfn) in strip_fns.items():
            for grid in (g4, g32, g64):
                a32 = inputs(grid, torch.float32)[whole[name]]
                a64 = inputs(grid, torch.float64)[whole[name]]
                ref64 = kernel_fns[whole[name]][2](grid, *a64)
                b12 = kernel_fns[whole[name]][0](grid, *a32)
                for R in STRIP_COUNTS[grid.tag]:
                    got = on_strips(name, kfn, grid, R, a32)
                    ref = on_strips(name, pfn, grid, R, a32)
                    torch.cuda.synchronize()
                    err, scale = max_err(got, ref)
                    err64, scale64 = max_err(got, ref64)
                    diff_whole = float((got - b12).abs().max())
                    ok = (err <= 2e-5 * scale and err64 <= 2e-5 * scale64
                          and diff_whole == 0.0)
                    _line(name, grid=grid.tag, R=R, max_abs_err=f"{err:.3e}",
                          max_abs_err_f64=f"{err64:.3e}",
                          scale=f"{scale:.3e}", tol="2e-5*scale",
                          max_diff_to_whole_grid_kernel=f"{diff_whole:.3e}",
                          tol_whole="0 (same bits)", ok=ok)
                    if not ok:
                        raise AssertionError(
                            f"{name} at {grid.tag} R={R}: kernel error "
                            f"{err:.3e} (plain) / {err64:.3e} (f64 dense) "
                            f"exceeds 2e-5*{scale:.3e}, or the strips "
                            f"differ from the whole-grid kernel by "
                            f"{diff_whole:.3e}")
                    if grid is main_strip_grid[name] and R == RANKS:
                        report[name] = {"max_abs_err": err}
            # the same on bf16 fields
            for grid in (g4, g32, g64):
                a = inputs(grid, bf16)[whole[name]]
                b12 = kernel_fns[whole[name]][0](grid, *a)
                for R in STRIP_COUNTS[grid.tag]:
                    got = on_strips(name, kfn, grid, R, a)
                    ref = on_strips(name, pfn, grid, R, a)
                    torch.cuda.synchronize()
                    ok, err, scale = bf16_ok(got, ref)
                    same = torch.equal(got, b12)
                    _line(name, dtype="bfloat16", grid=grid.tag, R=R,
                          max_abs_err=f"{err:.3e}", scale=f"{scale:.3e}",
                          tol=bf16_tol, same_bits_as_whole_grid_kernel=same,
                          ok=ok and same)
                    if not (ok and same):
                        raise AssertionError(
                            f"{name} at {grid.tag} R={R}, bf16: kernel error "
                            f"{err:.3e} exceeds {bf16_tol} (scale "
                            f"{scale:.3e}), or the strips are not the "
                            f"whole-grid kernel's bits ({same})")
                    if grid is main_strip_grid[name] and R == RANKS:
                        report[name + "_bf16"] = {"max_abs_err": err}

        walls.mark("7_strip_checks")

        # ---- 8. strip timings (rank 0's strip of R=2) ----
        for dt, sfx in ((torch.float32, ""), (bf16, "_bf16")):
            for name, (kfn, pfn) in strip_fns.items():
                for grid in ((g32, g64) if name == "apply_system_sharded"
                             else (g64,)):
                    rows = row_strips(grid.Ngx, RANKS, grid.P)[0]
                    a = strip_args(name, grid, rows,
                                   inputs(grid, dt)[whole[name]])
                    m = measure(name, grid, rows, kfn, pfn, a)
                    show(name, grid, m,
                         **({"dtype": "bfloat16"} if sfx else {}), R=RANKS,
                         strip_rows=f"{rows[0]}:{rows[1]}")
                    measured[name + sfx, grid.tag] = m
                    if grid is main_strip_grid[name]:
                        report[name + sfx].update(m)

        walls.mark("8_strip_timings")
        return bf16_path()

    # ---- 8b. the bf16 path ----
    def bf16_path():
        """Phase 8b (module docstring); returns its launch counts."""
        def power(apply, x):
            lam = None
            for _ in range(BF16_POWER_STEPS):
                y = apply(x).float()
                lam = float(y.abs().max())
                x = (y / lam).to(x.dtype)
            return lam

        def paths(dt):
            """(name, apply, start) of each kernel's power iteration."""
            a1 = inputs(g32, dt)["apply_system"]
            a2 = inputs(g64, dt)["apply_coupled_system"]
            return (
                ("apply_system", lambda x: kernels.apply_system_best(
                    g32, a1[0], a1[1], x, a1[3]), a1[2]),
                ("apply_coupled_system",
                 lambda x: kernels.apply_coupled_system_best(g64, x, *a2[1:]),
                 a2[0]),
                ("apply_system_sharded", on_strips_of(
                    "apply_system_sharded", g32, a1, 2), a1[2]),
                ("apply_coupled_system_sharded", on_strips_of(
                    "apply_coupled_system_sharded", g64, a2, 0), a2[0]))

        def on_strips_of(name, grid, a, i):
            """The decomposed apply: x in slot i of a, on each strip."""
            fn = strip_fns[name][0]
            return lambda x: torch.cat([
                fn(*strip_args(name, grid, rows, a[:i] + (x,) + a[i + 1:]
                               )).reshape(-1, (rows[1] - rows[0]) * grid.Ngy)
                for rows in row_strips(grid.Ngx, RANKS, grid.P)],
                dim=1).reshape(-1)

        runs = paths(bf16)
        torch.cuda.synchronize()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        lams = {name: power(apply, x) for name, apply, x in runs}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        lam32 = {name: power(apply, x) for name, apply, x in paths(
            torch.float32)}
        want = {name + "_bf16": BF16_POWER_STEPS * (
            RANKS if name.endswith("_sharded") else 1) for name in lams}
        ok = all(counts[k] == want.get(k, 0) for k in counts) and all(
            np.isfinite(lams[k]) and abs(lams[k] - lam32[k])
            <= 0.02 * abs(lam32[k]) for k in lams)
        _line("bf16_path", steps=BF16_POWER_STEPS, wall_s=f"{wall:.3f}",
              estimates={k: f"{v:.5g}" for k, v in lams.items()},
              estimates_f32={k: f"{v:.5g}" for k, v in lam32.items()},
              launches=counts, ok=ok)
        if not ok:
            raise AssertionError(f"bf16 path failed: launches {counts} "
                                 f"(want {want}), estimates {lams} against "
                                 f"f32 {lam32}")
        tensor_core_checks()
        walls.mark("8b_bf16_path")
        return counts

    def ulps(got, ref):
        """bf16 ulps between two bf16 tensors: the distance of their values
        on the ordered line of bf16 bit patterns."""
        def line(t):
            b = t.contiguous().view(torch.int16).int() & 0xFFFF
            return torch.where(b >= 0x8000, 0x8000 - b, b)
        return (line(got) - line(ref)).abs()

    def tensor_core_checks():
        """Phase 8b: B1-B4 at bf16 (the tensor-core kernels) against their
        plain versions per output element, B1/B3 at P16 32×32 and 64×64 and
        B2/B4 at P16 64×64, whole grid (through the dispatchers) and the R
        = 1, 2, 4 strips (each strip's halo cut from the full field): at
        most one bf16 ulp wherever the error exceeds the absolute floor
        ``BF16_TOL['atol_rel']``·max|ref|; the elements beyond one ulp under
        that floor are counted, and any above it printed with their place;
        the strips the whole-grid launch's bits.  Then their device, call
        and host µs, bound and share at each shape beside the f32 kernel's
        of this call (phases 4 and 8) and the bf16 cuSPARSE µs."""
        best = {"apply_system": kernels.apply_system_best,
                "apply_coupled_system": kernels.apply_coupled_system_best}
        cases, same = [], {}
        for name, grid in (("apply_system", g32), ("apply_system", g64),
                           ("apply_coupled_system", g64)):
            a = inputs(grid, bf16)[name]
            whole_out = best[name](grid, *a)
            cases.append((name, grid, "whole", whole_out,
                          kernel_fns[name][1](grid, *a)))
            sname = strip_of[name]
            sfn, spfn = strip_fns[sname]
            nf = 3 if name == "apply_coupled_system" else 1
            for R in STRIP_COUNTS[grid.tag]:
                outs, refs = [], []
                for rows in row_strips(grid.Ngx, R, grid.P):
                    sa = strip_args(sname, grid, rows, a)
                    outs.append(sfn(*sa).reshape(nf, -1))
                    refs.append(spfn(*sa).reshape(nf, -1))
                got = torch.cat(outs, 1).reshape(-1)
                cases.append((sname, grid, f"R={R}", got,
                              torch.cat(refs, 1).reshape(-1)))
                same[f"{sname}:{grid.tag}:R={R}"] = torch.equal(got,
                                                                whole_out)
        torch.cuda.synchronize()
        ok, res = all(same.values()), {}
        for name, grid, where, got, ref in cases:
            u = ulps(got, ref)
            err = (got.double() - ref.double()).abs()
            scale = float(ref.double().abs().max())
            far = (u > 1) & (err > BF16_TOL["atol_rel"] * scale)
            above = u[err > BF16_TOL["atol_rel"] * scale]
            r = res[f"{name}:{grid.tag}:{where}"] = {
                "max_ulps_above_floor": int(above.max()) if above.numel()
                else 0,
                "over_1ulp_under_floor": int(((u > 1) & ~far).sum()),
                "over_1ulp_above_floor": int(far.sum())}
            if r["over_1ulp_above_floor"]:
                ok = False
                r["first"] = [
                    (divmod(int(k) % grid.N, grid.Ngy), int(k) // grid.N,
                     float(got[k]), float(ref[k]), int(u[k]))
                    for k in far.nonzero().flatten()[:3]]
        _line("bf16_tensor_cores", checks=res,
              floor=f"{BF16_TOL['atol_rel']:g}*scale",
              strips_same_bits_as_whole_grid=same, ok=ok)
        if not ok:
            raise AssertionError(f"B1-B4 at bf16: beyond one bf16 ulp of "
                                 f"the plain versions {res}, or strips "
                                 f"not the whole-grid bits {same}")
        for name, grid in (("apply_system", g32), ("apply_system", g64),
                           ("apply_system_sharded", g32),
                           ("apply_system_sharded", g64),
                           ("apply_coupled_system", g64),
                           ("apply_coupled_system_sharded", g64)):
            lo = measured[name + "_bf16", grid.tag]
            hi = measured[name, grid.tag]
            lib = lo["library_us"]
            _line("bf16_tensor_core_timing", kernel=name, grid=grid.tag, **(
                {"R": RANKS, "strip": 0} if name.endswith("_sharded")
                else {}),
                device_us=f"{lo['device_us']:.2f}",
                device_us_f32=f"{hi['device_us']:.2f}",
                bound_us=f"{lo['bound_us']:.2f}",
                bound_us_f32=f"{hi['bound_us']:.2f}",
                share=f"{lo['share']:.3f}", share_f32=f"{hi['share']:.3f}",
                call_us=f"{lo['call_us']:.2f}",
                call_us_f32=f"{hi['call_us']:.2f}",
                host_us=f"{lo['host_us']:.2f}",
                host_us_f32=f"{hi['host_us']:.2f}",
                library_us="none" if lib is None else f"{lib:.2f}",
                smi=f"'{smi}'")

    if kernels_only:
        strip_phases()
        walls.show()
        return

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
    cd, ns, mda = build_coupled(1.0, 1.0, device="cuda", **NORTH_STAR,
                                **UNFUSED)
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

    s6 = s
    beside = {"north_star": dict(solve_s=t_solve, stats=mda.stats.as_list(),
                                 gmres_iters=mda.stats.gmres_iters,
                                 launches=launches)}
    walls.mark("6_north_star")

    # ---- 7., 8., 8b. ----
    bf16_counts = strip_phases()

    # ---- 9. run_parallel, one process per rank ----
    ranks = run_ranks(beside)
    r0 = ranks[0]
    walls.mark("9_run_parallel")

    # ---- 10.-13. continuation, PTC, flexible chunks, checkpoints ----
    by_path = continuation_phases(smi, direct_s=t_build + t_solve,
                                  walls=walls, beside=beside)

    # ---- 14.-16. Schur blocks, Uzawa, assemble.py ----
    by_path.update(ns_option_phases(smi, walls, cut=True))

    # ---- 17.-19. profile, implicit adjoint, study CLIs ----
    paths, study = adjoint_phases(smi, walls, s6)
    by_path.update(paths)

    # ---- 20.-22. examples, bench, the remaining study CLIs ----
    by_path.update(driver_phases(smi, walls, study))

    # ---- 23. the fused and on-device coupled Krylov programs ----
    by_path.update(krylov_phase(smi, walls, beside))

    # ---- 24. the entry points' defaults beside phase 23's pinned runs ----
    by_path.update(defaults_phase(smi, walls, beside))
    for path, run in zip(("parallel_velo_inner", "parallel_fused",
                          "parallel_device_krylov"), r0["runs"].values()):
        by_path[path] = run["launches"]
    _line("parallel_vs_phase23", **{
        k: {key: (round(v, 2) if isinstance(v, float) else v)
            for key, v in r.items() if key in (
                "wall_s", "first_solve_s", "warm_solve_s", "stats",
                "gmres_iters", "launches")}
        for k, r in (("9c_fused_rank0", r0["runs"]["fused"]),
                     ("23a_fused", beside["fused"]),
                     ("9d_device_rank0", r0["runs"]["device_krylov"]),
                     ("23c_device", beside["device"]))})
    walls.show()

    rows = []
    kernel_rows = (
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
             r0["launches"]["apply_coupled_system_sharded"]))
    # the bf16 rows: phase 8b's launches; by path, every solver path's bf16
    # count (phases 6 and 9 included)
    solver_paths = dict(by_path, north_star=launches,
                        run_parallel_rank0=r0["launches"])
    for name, src, replaces, n in kernel_rows + tuple(
            (name + "_bf16", src, replaces, bf16_counts[name + "_bf16"])
            for name, src, replaces, _ in kernel_rows):
        r = report[name]
        low = name.endswith("_bf16")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "dtype": "bfloat16" if low else "float32",
                     "launches": n,
                     "launches_by_path": {
                         path: counts.get(name, 0) for path, counts in (
                             solver_paths if low else by_path).items()},
                     "max_abs_err": r["max_abs_err"],
                     "ms": 1e-3 * r["call_us"],
                     "plain_ms": 1e-3 * r["plain_us"],
                     "bound_ms": 1e-3 * r["bound_us"],
                     "bound_by": r["bound_by"],
                     "library_ms": (None if r["library_us"] is None
                                    else 1e-3 * r["library_us"]),
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

    cfg = {**PTC_RA1E5, **UNFUSED, **kw}
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
          # the fused preconditioner runs its chunks without solve_linear
          b2_per_ns_inner_it=(f"{b2 / spent['ns_inner_its']:.2f}"
                              if spent["ns_inner_its"] else "not_counted"),
          smi=f"'{smi}'")
    _require(finite and resid <= mda.atol_nonlin
             and all(abs(got - want) <= 0.01 * want
                     for got, want in zip((u_c, v_c), anchors))
             and n["apply_system"] > 0 and b2 > 0,
             f"{tag} failed: finite={finite} residual {resid:.3e} (atol "
             f"{mda.atol_nonlin:.3e}) centerline anchors {u_c:.4f} / "
             f"{v_c:.4f} (want {anchors}) launches {n}")
    return mda, n, wall, b2_per_it


def continuation_phases(smi, direct_s=None, walls=None, beside=None):
    """Phases 10-13 (module docstring).  Returns the kernel launch counts of
    phases 10-12 by path; any failed requirement raises.  Phase 11's march
    goes into ``beside["ptc"]`` (phase 23 prints it beside its own)."""
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
    cont_kw.update(UNFUSED)
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
    if beside is not None:
        beside["ptc"] = ptc_summary(mda11, by_path["ptc"], wall11)
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
                              time_budget_s=budget, **PTC_RA1E5, **UNFUSED)
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


def ptc_summary(mda, launches, wall):
    """What phase 23 prints of a PTC march beside its own."""
    return dict(steps=mda.stats.nonlinear_iters, stats=mda.stats.as_list(),
                gmres_iters=mda.stats.gmres_iters, wall_s=round(wall, 2),
                launches=launches)


def krylov_phase(smi, walls, beside):
    """Phase 23 (module docstring): (a)-(d) beside phase 6's solve and
    phase 11's march (``beside``).  Returns the kernel launch counts by path;
    any failed requirement raises."""
    import torch
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.ops import kernels

    by_path = {}

    # ---- (a) the fused host FGMRES at the north star ----
    _, ns, mda = build_coupled(1.0, 1.0, device="cuda", fused=True,
                               **NORTH_STAR)
    s, n, wall_first = _counted(mda.solve)
    finite, resid = _residual(mda, s)
    u_anchor = float(s.u.abs().max()) * 1e3 * 0.71
    stats, its = mda.stats.as_list(), mda.stats.gmres_iters
    _, _, wall_warm = _counted(mda.solve)
    by_path["krylov_fused_jnk"] = n
    beside["fused"] = dict(first_solve_s=wall_first, warm_solve_s=wall_warm,
                           stats=stats, gmres_iters=its, launches=n)
    # one replayed step and its scalar read under the sync debug mode
    mda._linearize(s)
    F = mda._residuals(s)
    start, step, precon_split = mda._fg_fused(mtol=mda.mtol_precon)
    out = start(1e-3 * F, -F)
    z = precon_split(*out[6:-1])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            marks = [len(seen)]
            res_t = step(*out[:6], 0, *z)[-1]
            marks.append(len(seen))
            float(res_t)
            marks.append(len(seen))
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def syncs_in(a, b):
        return [f"{w.filename}:{w.lineno}" for w in seen[a:b]
                if "synchroniz" in str(w.message)]

    in_step, in_read = syncs_in(*marks[:2]), syncs_in(*marks[1:])
    syncs = len(in_step) + len(in_read)
    sites = dict(step=in_step, read=in_read,
                 outside=syncs_in(0, marks[0]) + syncs_in(marks[2], None))
    _line("krylov_fused_jnk", ns="P16_64x64", cd="P16_32x32", dof=mda.DOF,
          first_solve_s=f"{wall_first:.2f}", warm_solve_s=f"{wall_warm:.2f}",
          stats=stats, gmres_iters=its, launches=n,
          phase6_solve_s=f"{beside['north_star']['solve_s']:.2f}",
          phase6_stats=beside["north_star"]["stats"],
          phase6_gmres_iters=beside["north_star"]["gmres_iters"],
          phase6_launches=beside["north_star"]["launches"],
          residual=f"{resid:.3e}", atol=f"{mda.atol_nonlin:.3e}",
          u_anchor=f"{u_anchor:.4f}", syncs_per_replayed_step=syncs,
          sync_sites=sites, smi=f"'{smi}'")
    _require(finite and resid <= mda.atol_nonlin
             and abs(u_anchor - 3.6531) <= 1e-3
             and n["apply_system"] > 0 and n["apply_coupled_system"] > 0
             and syncs == 1,
             f"fused JNK failed: finite={finite} residual {resid:.3e} (atol "
             f"{mda.atol_nonlin:.3e}) u_anchor {u_anchor:.4f} launches {n} "
             f"syncs per replayed step {syncs}")

    # ---- (b) the captured start/step against their eager twins ----
    lin = mda._fg[2]
    startf, stepf = mda._build_fg_fused()
    x, b = 1e-3 * F, -F
    got = [t.clone() for t in start(x, b)]
    ref_out = [t.clone() for t in startf(x, b, *lin)]
    diffs = {}

    def compare(tag, a, r):
        scale = max(float(r.double().abs().max()), 1e-300)
        d = float((a.double() - r.double()).abs().max()) / scale
        diffs[tag] = max(diffs.get(tag, 0.0), d)

    for tag, i in (("V", 0), ("Z", 1), ("H", 2), ("g", 5), ("res", -1)):
        compare(tag, got[i], ref_out[i])
    state_g, state_e = start(x, b)[:6], [t.clone() for t in ref_out[:6]]
    vp = got[6:-1]
    for k in range(3):
        z = [t.clone() for t in precon_split(*vp)]
        out_g = step(*state_g, k, *z)
        out_e = stepf(*state_e, torch.tensor(k, device=x.device), *z, *lin)
        for tag, i in (("V", 0), ("Z", 1), ("H", 2), ("g", 5), ("res", -1)):
            compare(tag, out_g[i], out_e[i])
        vp = [t.clone() for t in out_g[6:-1]]
    torch.cuda.synchronize()
    worst = max(diffs.values())
    _line("krylov_graph_vs_eager", steps=3,
          max_rel_diff={k: f"{v:.3e}" for k, v in diffs.items()},
          bitwise=worst == 0.0, tol="1e-12")
    _require(worst <= 1e-12, f"graph against eager: {diffs}")
    del mda, lin, start, step
    torch.cuda.empty_cache()
    walls.mark("23a_23b_fused_jnk")

    # ---- (c) the on-device windows beside the host JNK solve ----
    # at RMS 1e-10: the main path's 1e-8 admits ~3e-3 in the u-anchor on
    # these grids (the smallest stiffness eigenvalues are ~1e-4); on an
    # H100 the two solves gave 3.6504 (device) and 3.6532 (host) there,
    # both residuals within atol
    grids = DEVICE_GRIDS
    runs = {}
    for tag, kw in (("host", UNFUSED), ("device", dict(device_krylov=True))):
        _, _, mda = build_coupled(1.0, 1.0, device="cuda", **grids, **kw)
        inside = dict.fromkeys(kernels.LAUNCHES, 0)
        windows = [0]
        window = mda._jnk_window

        def counted_window(*a, _w=window, **k):
            before = dict(kernels.LAUNCHES)
            out = _w(*a, **k)
            windows[0] += 1
            for key in inside:
                inside[key] += kernels.LAUNCHES[key] - before[key]
            return out

        mda._jnk_window = counted_window
        s, n, wall = _counted(mda.solve)
        finite, resid = _residual(mda, s)
        runs[tag] = dict(wall_s=f"{wall:.2f}", windows=windows[0],
                         stats=mda.stats.as_list(),
                         gmres_iters=mda.stats.gmres_iters, launches=n,
                         window_launches=inside, residual=f"{resid:.3e}",
                         atol=f"{mda.atol_nonlin:.3e}", finite=finite,
                         resid_ok=resid <= mda.atol_nonlin,
                         u_anchor=float(s.u.abs().max()) * 1e3 * 0.71)
    by_path["krylov_device_jnk"] = runs["device"]["launches"]
    beside["device"] = dict(runs["device"], wall_s=float(
        runs["device"]["wall_s"]))
    du = abs(runs["device"]["u_anchor"] - runs["host"]["u_anchor"])
    _line("krylov_device_jnk", ns="P16_32x32", cd="P16_16x16", dof=mda.DOF,
          **{f"{tag}_{k}": (f"{v:.4f}" if k == "u_anchor" else v)
             for tag, r in runs.items() for k, v in r.items()
             if k not in ("finite", "resid_ok")},
          u_anchor_diff=f"{du:.2e}", smi=f"'{smi}'")
    dev = runs["device"]
    _require(all(r["finite"] and r["resid_ok"] for r in runs.values())
             and runs["host"]["windows"] == 0 and dev["windows"] > 0
             and all(v == 0 for v in dev["window_launches"].values())
             and du <= 1e-3,
             f"device JNK failed: {runs}")
    walls.mark("23c_device_jnk")

    # ---- (d) phase 11's march with the fused programs ----
    mda, by_path["krylov_fused_ptc"], wall, _ = ptc_march(
        "ptc_fused", smi, fused=True)
    _line("ptc_fused_vs_phase11",
          fused=ptc_summary(mda, by_path["krylov_fused_ptc"], wall),
          phase11=beside.get("ptc", "not_run"))
    walls.mark("23d_fused_ptc")
    return by_path


def defaults_phase(smi, walls, beside):
    """Phase 24 (module docstring): ``run`` and ``build_coupled`` with no
    program argument at the reference P4 8×8, at ``DEVICE_GRIDS`` and at
    the north star, beside phase 23's pinned runs of the same programs
    (``beside``).  Returns the kernel launch counts by path; any failed
    requirement raises."""
    import numpy as np
    from sem_tpu_torch.coupling import build_coupled, run

    by_path = {}
    xp, yp = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101),
                         indexing="ij")
    p4 = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=4, N_ex_cd=8, N_ey_cd=8,
              P_ns=4, N_ex_ns=8, N_ey_ns=8, mode="JNK", iprint=False)
    (_, u, v, _, run_stats), n_run, wall_run = _counted(lambda: run(
        (xp, yp), 1.0, 1.0, return_state=True, device="cuda", **p4))
    umax, vmax = float(np.max(u)) * 710.0, float(np.max(v)) * 710.0
    for tag, cfg, pinned in (("p4_8x8", p4, None),
                             ("device_grids", DEVICE_GRIDS, "device"),
                             ("north_star", NORTH_STAR, "fused")):
        t0 = time.perf_counter()
        _, _, mda = build_coupled(1.0, 1.0, device="cuda", **cfg)
        build = time.perf_counter() - t0
        s, n, wall = _counted(mda.solve)
        finite, resid = _residual(mda, s)
        u_anchor = float(s.u.abs().max()) * 710.0
        rule = mda.DOF <= DEVICE_KRYLOV_MAX_DOF
        by_path[f"defaults_{tag}"] = n
        r = dict(stats=mda.stats.as_list(), gmres_iters=mda.stats.gmres_iters,
                 launches=n)
        ok = (mda.device_krylov == rule and mda.fused and finite
              and resid <= mda.atol_nonlin)
        extra = {}
        if tag == "p4_8x8":
            extra = dict(run_stats=run_stats.as_list(),
                         run_gmres_iters=run_stats.gmres_iters,
                         run_launches=n_run, run_s=f"{wall_run:.2f}",
                         u_anchor=f"{umax:.4f}", v_anchor=f"{vmax:.4f}")
            ok = (ok and run_stats.as_list() == r["stats"]
                  and abs(umax - 3.649) / 3.649 < 0.01
                  and abs(vmax - 3.697) / 3.697 < 0.01
                  and run_stats.nonlinear_iters <= 6)
        else:
            ref = beside[pinned]
            extra = {f"pinned_{k}": ref[k] for k in r}
            extra["u_anchor"] = f"{u_anchor:.4f}"
            ok = (ok and all(r[k] == ref[k] for k in r)
                  and abs(u_anchor - 3.6531) <= 1e-3)
        _line("defaults", config=tag, dof=mda.DOF,
              device_krylov=mda.device_krylov, fused=mda.fused,
              reference_rule=("device_windows" if rule else "fused_host"),
              build_s=f"{build:.2f}", solve_s=f"{wall:.2f}", **r, **extra,
              residual=f"{resid:.3e}", atol=f"{mda.atol_nonlin:.3e}",
              smi=f"'{smi}'")
        _require(ok, f"defaults at {tag} failed: device_krylov "
                     f"{mda.device_krylov} (rule {rule}), fused {mda.fused}, "
                     f"residual {resid:.3e}, {r}, {extra}")
        del mda
    walls.mark("24_defaults")
    return by_path


def krylov_main():
    """``--krylov``: the card's line, the build, phase 6's solve and phase
    11's march (what phase 23 prints beside its own), then phases 23 and
    24."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.ops import _build

    smi = _smi_line().splitlines()[0]
    _build.library()
    walls = Walls()
    _, _, mda = build_coupled(1.0, 1.0, device="cuda", **NORTH_STAR,
                              **UNFUSED)
    mda.solve()     # warm-up
    mda.cd_comp.iter_count_solve = mda.ns_comp.iter_count_solve = 0
    s, n, wall = _counted(mda.solve)
    beside = {"north_star": dict(solve_s=wall, stats=mda.stats.as_list(),
                                 gmres_iters=mda.stats.gmres_iters,
                                 launches=n)}
    walls.mark("6_north_star")
    mda11, n11, wall11, _ = ptc_march("ptc", smi)
    beside["ptc"] = ptc_summary(mda11, n11, wall11)
    walls.mark("11_ptc")
    krylov_phase(smi, walls, beside)
    defaults_phase(smi, walls, beside)
    walls.show()


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


def ns_option_phases(smi, walls=None, cut=False):
    """Phases 14-16 (module docstring).  Returns the kernel launch counts of
    phases 14-15 by path; any failed requirement raises.  With ``cut`` (the
    whole script, so that phases 17-19 fit its time) ``'pcd'`` runs at NS
    P16 16×16 beside a ``'spectral'`` run there (91.6 s at 64×64);
    ``--ns-options`` runs it at 64×64."""
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
    small = dict(N_ex=16, N_ey=16) if cut else {}
    if cut:
        runs["spectral_16x16"] = lid_cavity_run("ns_spectral", smi, **small)
    for sp in ("spectral", "pcd", "mass"):
        try:
            runs[sp] = lid_cavity_run(f"ns_{sp}", smi, schur_precon=sp,
                                      **(small if sp == "pcd" else {}))
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
    same_grid = {r["N"]: r for r in (runs.get("spectral_16x16"),
                                     runs["spectral"]) if r}
    diffs = {sp: same_answer(runs[sp], same_grid[runs[sp]["N"]], f"ns_{sp}")
             for sp in ("pcd", "mass") if runs[sp]["N"] in same_grid}
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
    ref = same_grid[uz["N"]]
    diff = same_answer(uz, ref, "ns_uzawa")
    _line("ns_uzawa_vs_coupled", max_u_diff=f"{diff:.2e}", tol="1e-6",
          newton=(uz["newton"], ref["newton"]),
          wall_ratio=f"{uz['wall'] / ref['wall']:.1f}",
          ms_per_velo_iter=f"{1e3 * uz['wall'] / max(uz['velo_iters'], 1):.3f}")
    if not (all(c == 0 for c in uz["launches"].values())
            and abs(uz["newton"] - ref["newton"]) <= 1):
        failed.append(f"ns_uzawa: launches {uz['launches']} (must be 0), "
                      f"Newton {uz['newton']} against {ref['newton']}")
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


# phase 19: the study CLIs as subprocesses; the march runs through runpy,
# exactly as ``python -m`` runs it, so that its launch counts can be read
STUDY_MARCH = ["-P", "8", "-Ne", "32", "-Ra", "1e5", "-mode", "PTC",
               "-ckpt", "True"]
STUDY_TIMEOUT_S = 900
_RUN_COUNTED = (
    "import json, runpy, sys\n"
    "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
    "from sem_tpu_torch.ops import kernels\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
    "print('LAUNCHES ' + json.dumps(kernels.LAUNCHES), flush=True)\n")


def profile_phase(smi, logdir, top=5):
    """Phase 17 (module docstring)."""
    import torch
    from torch.autograd import DeviceType
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.utils.profiling import trace

    _, _, mda = build_coupled(1.0, 1.0, device="cuda", **NORTH_STAR,
                              **UNFUSED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mda.solve()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    _, _, mda = build_coupled(1.0, 1.0, device="cuda", **NORTH_STAR,
                              **UNFUSED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(logdir) as prof:
        mda.solve()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in dev)      # µs
    dev.sort(key=lambda e: -e.device_time_total)

    def share(pred):
        return sum(e.device_time_total for e in dev if pred(e.key)) / max(
            busy, 1e-9)

    tops = [(e.key[:60], round(e.device_time_total / max(busy, 1e-9), 4),
             e.count) for e in dev[:top]]
    b1 = share(lambda k: "apply_system_kernel" in k)
    b2 = share(lambda k: "coupled_system_kernel" in k)
    _line("profile", solve_s=f"{wall:.2f}", unprofiled_solve_s=f"{plain:.2f}",
          stats=mda.stats.as_list(), device_busy_ms=f"{busy / 1e3:.1f}",
          device_busy_share_of_unprofiled_wall=f"{busy / 1e6 / plain:.3f}",
          device_kernels=len(dev), b1_share=f"{b1:.4f}",
          b2_share=f"{b2:.4f}", smi=f"'{smi}'")
    for rank, (key, sh, n) in enumerate(tops, 1):
        _line("profile_top", rank=rank, share=sh, calls=n, op=f"'{key}'")
    _require(busy > 0 and b1 > 0 and b2 > 0,
             f"the profile holds no device time of B1/B2 (busy {busy} µs, "
             f"{len(dev)} device operations)")


def fd_derivative(F, x, params, loss_fn, build, name="Ra", rel=1e-4):
    """Central finite difference of ``loss_fn`` in ``params[name]`` by two
    JNK re-solves warm-started at the flat state ``x``.

    The step ``h = rel·θ`` puts on ``x`` a residual ``F(x, θ+h) − F(x, θ)``
    of RMS ``r`` (2.6e-11 at p16 64×64, Ra=1e3, rel 1e-4: below any fixed
    study tolerance, where a re-solve would take no Newton step and the
    difference would read 0).  Each re-solve therefore runs to RMS ``r/30``
    with its coupled GMRES to 1e-6 relative (``mtol_gmres=1e-6·r``,
    ``forcing=1e-6``) and at most 5 Newton steps; one that floors above
    that raises ``RuntimeError``.  (At the p16 Ra=1e5 PTC state such a
    re-solve stopped with "Boussinesq JNK GMRES: no convergence in 1
    iterations", at 1e-4 relative too: not analysed; this phase is at
    Ra=1e3.)

    :param build: ``build(**overrides) -> BoussinesqMDA`` at the state's
        configuration
    :return: ``(fd, r, [Newton steps per re-solve])``
    """
    import torch
    from sem_tpu_torch.coupling import CoupledState

    h = params[name] * rel
    pt = {k: torch.tensor(v, dtype=torch.float64, device=x.device)
          for k, v in params.items()}
    dF = F(x, dict(pt, **{name: pt[name] + h})) - F(x, pt)
    r = float(torch.linalg.vector_norm(dF)) / x.shape[0] ** 0.5
    vals, newton = [], []
    for sgn in (+1, -1):
        mda = build(**{name: params[name] + sgn * h}, mode="JNK",
                    mtol_nonlin=r / 30, mtol_gmres=1e-6 * r, forcing=1e-6,
                    maxiter=5)
        N_cd, N_ns = mda.N_cd, mda.N_ns
        sp = mda.solve(CoupledState(x[:N_cd], x[N_cd:N_cd + N_ns],
                                    x[N_cd + N_ns:N_cd + 2 * N_ns],
                                    x[N_cd + 2 * N_ns:]))
        vals.append(float(loss_fn(torch.cat([sp.T, sp.u, sp.v, sp.p]))))
        newton.append(mda.stats.nonlinear_iters)
    return (vals[0] - vals[1]) / (2 * h), r, newton


def adjoint_phase(smi, s6):
    """Phase 18 (module docstring); returns its launch counts."""
    import numpy as np
    import torch
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.coupling import implicit
    from sem_tpu_torch.utils.profiling import PhaseTimer

    cfg = dict(NORTH_STAR, mtol_nonlin=1e-10, **UNFUSED)
    params = {k: cfg[k] for k in ("Re", "Ra", "Pr")}
    t0 = time.perf_counter()
    cd, ns, mda = build_coupled(1.0, 1.0, device="cuda", **cfg)
    s = mda.solve(s6)
    torch.cuda.synchronize()
    t_state = time.perf_counter() - t0
    finite, resid = _residual(mda, s)
    _require(finite and resid <= mda.atol_nonlin,
             f"adjoint state: residual {resid:.3e} (atol "
             f"{mda.atol_nonlin:.3e})")
    x = torch.cat([s.T, s.u, s.v, s.p])
    N_cd, N_ns = cd.N, ns.N

    def loss_fn(xf):
        u = xf[N_cd:N_cd + N_ns]
        v = xf[N_cd + N_ns:N_cd + 2 * N_ns]
        return torch.sum(u ** 2 + v ** 2)

    restart, inner_restart, inner_dtype = implicit.adjoint_windows(
        cd, ns, x.shape[0])
    F = implicit.coupled_residual_fn(cd, ns)
    pt = {k: torch.tensor(v, dtype=torch.float64, device=x.device)
          for k, v in params.items()}
    mv = implicit._vjp(lambda q: F(q, pt), x)
    w = torch.ones_like(x)
    ms = []
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mv(w)
        torch.cuda.synchronize()
        if i >= 3:
            ms.append(1e3 * (time.perf_counter() - t0))
    del mv

    # the PhaseTimer split: each piece of the module wrapped in a span
    timer = PhaseTimer()
    seen = {}
    saved = {k: getattr(implicit, k) for k in (
        "_vjp", "rownorm_estimate", "_fgmres", "parameter_gradients",
        "solve_adjoint")}

    def span(name, fn):
        def wrapped(*a, **k):
            with timer(name):
                return fn(*a, **k)
        return wrapped

    def kept(*a, **k):
        seen["lam"], seen["its"] = out = saved["solve_adjoint"](*a, **k)
        seen["gbar"] = a[3]
        return out

    implicit._vjp = span("vjp_setup", saved["_vjp"])
    implicit.rownorm_estimate = span("row_norms", saved["rownorm_estimate"])
    implicit._fgmres = span("fgmres", saved["_fgmres"])
    implicit.parameter_gradients = span("theta_vjp",
                                        saved["parameter_gradients"])
    implicit.solve_adjoint = kept
    torch.cuda.reset_peak_memory_stats()
    try:
        (loss, grads), n, wall = _counted(lambda: implicit.gradients(
            cd, ns, x, loss_fn, params))
    finally:
        for k, fn in saved.items():
            setattr(implicit, k, fn)
    peak = torch.cuda.max_memory_allocated()
    its, lam, g = seen["its"], seen["lam"], seen["gbar"]
    r = implicit._vjp(lambda q: F(q, pt), x)(lam) - g
    raw = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(g))
    split = {k: f"{v:.2f}" for k, v in timer.totals.items()}

    _line("adjoint", ns="P16_64x64", cd="P16_32x32", n=x.shape[0],
          state_s=f"{t_state:.2f}", state_residual=f"{resid:.3e}",
          restart=restart, inner_restart=inner_restart,
          inner_basis=str(inner_dtype).replace("torch.", ""),
          outer_its=its, wall_s=f"{wall:.2f}",
          s_per_it=f"{wall / max(its, 1):.3f}",
          host_ms_per_transposed_matvec=f"{np.median(ms):.3f}",
          split_s=split, peak_memory_GB=f"{peak / 1e9:.2f}",
          raw_residual=f"{raw:.3e}", lam_max=f"{float(lam.abs().max()):.3e}",
          loss=f"{loss:.8e}",
          dRa=f"{grads['Ra']:.8e}", dRe=f"{grads['Re']:.8e}",
          dPr=f"{grads['Pr']:.8e}", launches=n, smi=f"'{smi}'")

    def fd_at(rel):
        """:func:`fd_derivative` at relative step ``rel``: (fd,
        relative difference to the adjoint, how); a re-solve that floors is
        reported as floored."""
        def build(**kw):
            return build_coupled(1.0, 1.0, device="cuda",
                                 **dict(cfg, **kw))[2]

        try:
            fd, r, newton = fd_derivative(F, x, params, loss_fn, build,
                                          rel=rel)
        except RuntimeError as err:
            return float("nan"), float("inf"), f"floored:'{err}'"
        return (fd, abs(fd - grads["Ra"]) / max(abs(fd), 1e-300),
                f"dF_rms={r:.2e},newton={newton}")

    t0 = time.perf_counter()
    fds = {1e-4: fd_at(1e-4)}
    if fds[1e-4][1] > 1e-3:
        for rel in (1e-3, 1e-5):
            fds[rel] = fd_at(rel)
    _line("adjoint_fd", fd_s=f"{time.perf_counter() - t0:.2f}", **{
        f"step_{rel:.0e}": f"fd={fd:.8e},rel_diff={d:.2e},{how}"
        for rel, (fd, d, how) in fds.items()}, tol="1e-3")
    # the raw residual is printed beside its bound, not required: at these
    # states the coupled Jacobian has a one-dimensional null space, λ carries
    # a large multiple of its left null vector, and J_xᵀλ evaluates at a
    # rounding floor above 1e-6·‖g‖ (PERF.md, the adjoint); the gradient is held
    # to FD instead
    fd_ok = [rel for rel, (_, d, _) in fds.items() if d <= 1e-3]
    _line("adjoint_requirements", raw_residual_le_1e_6=raw <= 1e-6,
          fd_within_1e_3_at_steps=fd_ok)
    _require(fd_ok and all(c == 0 for c in n.values()),
             f"adjoint failed: FD {fds} (tol 1e-3 at one step at least), "
             f"launches {n} (must be 0)")
    return n


def _start_cli(args, counted=False, **env):
    """Start one study CLI as a subprocess of this script from the
    checkout's root (``env`` added to its environment), its output going to
    temporary files (a full pipe would stall it while another CLI is waited
    for)."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1", **env)
    cmd = ([sys.executable, "-c", _RUN_COUNTED] if counted
           else [sys.executable, "-m"]) + args
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err,
                            text=True)
    return proc, out, err, time.perf_counter()


def _finish_cli(tag, started):
    """Wait for a CLI of :func:`_start_cli` (killed ``STUDY_TIMEOUT_S``
    after its start); its output is printed with a prefix and its standard
    output returned; a non-zero exit raises."""
    proc, out, err, t0 = started
    try:
        proc.wait(timeout=max(1.0, t0 + STUDY_TIMEOUT_S - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    wall = time.perf_counter() - t0
    texts = []
    for f in (out, err):
        f.seek(0)
        texts.append(f.read())
        f.close()
    for ln in "".join(texts).splitlines()[-40:]:
        print(f"  {tag}| {ln}", flush=True)
    _line(tag, exit=proc.returncode, wall_s=f"{wall:.2f}")
    _require(proc.returncode == 0, f"{tag} exited {proc.returncode}")
    return texts[0]


def _study_cli(tag, args, counted=False):
    """One study CLI as a subprocess (:func:`_start_cli`), waited for."""
    return _finish_cli(tag, _start_cli(args, counted))


def study_phase(smi):
    """Phase 19 (module docstring); returns the march's launch counts, its
    files (by suffix) and its ``.stats.json``."""
    import shutil

    outdir = os.path.join(ROOT, "build", "sem_tpu_torch", "study_smoke")
    shutil.rmtree(outdir, ignore_errors=True)
    out = _study_cli("study_march",
                     ["sem_tpu_torch.study.boussinesq_run", *STUDY_MARCH,
                      "-outdir", outdir], counted=True)
    n = _launches(out)
    titles = [f[:-11] for f in os.listdir(outdir) if f.endswith(".stats.json")]
    _require(len(titles) == 1, f"study march: stats files {titles}")
    files = {s: os.path.join(outdir, titles[0] + s)
             for s in (".npz", ".stats.json", ".ckpt.npz")}
    missing = [f for f in files.values() if not os.path.exists(f)]
    _require(not missing, f"study march wrote no {missing}")
    adj = _study_cli("study_adjoint", ["sem_tpu_torch.study.adjoint_hi",
                                       "-ckpt", files[".ckpt.npz"], "-fd",
                                       "1"])
    fd = [ln for ln in adj.splitlines() if ln.startswith("FD d(loss)/d(Ra)")]
    _require(fd, "adjoint_hi printed no FD line")
    rel = float(fd[0].rsplit("rel diff ", 1)[1].rstrip(")"))
    _study_cli("study_summarize", ["sem_tpu_torch.study.summarize", outdir])
    with open(files[".stats.json"]) as fh:
        stats = json.load(fh)
    anchors = DE_VAHL_DAVIS[stats["Ra"]]
    _line("study", title=titles[0], iters=stats["iters"],
          anchor_kind=stats["anchor_kind"],
          u_centerline=stats["u_anchor"], v_centerline=stats["v_anchor"],
          adjoint_fd_rel_diff=f"{rel:.2e}", launches=n, smi=f"'{smi}'")
    _require(stats["anchor_kind"] == "centerline"
             and all(abs(got - want) <= 0.01 * want for got, want in
                     zip((stats["u_anchor"], stats["v_anchor"]), anchors))
             and n["apply_system"] > 0 and n["apply_coupled_system"] > 0,
             f"study march: anchors {stats} (want {anchors}), launches {n}")
    return n, files, stats


def adjoint_phases(smi, walls, s6):
    """Phases 17-19 (module docstring); returns the launch counts of phase
    18 and of phase 19's march by path, and phase 19's files and stats."""
    profile_phase(smi, os.path.join(ROOT, "build", "sem_tpu_torch", "trace"))
    walls.mark("17_profile")
    by_path = {"adjoint": adjoint_phase(smi, s6)}
    walls.mark("18_adjoint")
    by_path["study_ptc_p8"], *study = study_phase(smi)
    walls.mark("19_study_cli")
    return by_path, study


def _launches(out):
    """The launch counts a counted CLI run printed last."""
    return json.loads(out.split("LAUNCHES ", 1)[1].splitlines()[0])


# phase 20: (tag, module and arguments, kernels that must have launched)
B1, B2 = "apply_system", "apply_coupled_system"
EXAMPLES = (
    ("example_cd", ["convection_diffusion"], (B1,)),
    ("example_ns_quick", ["navier_stokes", "--quick"], (B2,)),
    ("example_ns", ["navier_stokes"], (B2,)),
    ("example_seq_jnk", ["boussinesq_sequential"], (B1, B2)),
    ("example_seq_gs_quick", ["boussinesq_sequential", "--quick", "--mode",
                              "GS"], (B1, B2)),
    ("example_seq_nj_quick", ["boussinesq_sequential", "--quick", "--mode",
                              "NJ"], (B1, B2)))


def example_phase(smi):
    """Phase 20 (module docstring); returns the launch counts by path (rank
    0's for the parallel example)."""
    import ast

    by_path = {}
    # all at once (one host thread each): their walls are mostly process
    # start, and none is timed
    started = [_start_cli([f"sem_tpu_torch.examples.{name}", "--check",
                           *args], counted=True, OMP_NUM_THREADS="1")
               for _, (name, *args), _ in EXAMPLES]
    try:
        for (tag, _, need), job in zip(EXAMPLES, started):
            out = _finish_cli(tag, job)
            n = by_path[tag] = _launches(out)
            _line(tag, check_ok="CHECK OK" in out, launches=n,
                  smi=f"'{smi}'")
            _require("CHECK OK" in out and all(n[k] > 0 for k in need),
                     f"{tag}: no CHECK OK, or none of {need} launched: {n}")
    finally:
        for proc, *_ in started:        # a failure leaves none running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # the parallel example: JNK P4 8×8 on two ranks, and the reference's
    # own command, --quick (GS P3 3×3: 10 rows) on eight ranks, whose strips
    # of one and two rows take their halos from up to three ranks (the
    # library was built before: the ranks load it)
    for tag, args, world in (("example_parallel", [], 2),
                             ("example_parallel_quick_8", ["--quick"], 8)):
        out = _study_cli(tag, ["sem_tpu_torch.examples.boussinesq_parallel",
                               "--check", *args, "--ranks", str(world)])
        line = [ln for ln in out.splitlines()
                if ln.startswith("kernel launches by rank: ")]
        _require(line, f"{tag}: boussinesq_parallel printed no launch "
                       f"counts")
        ranks = ast.literal_eval(line[0].split(": ", 1)[1])
        _line(tag, check_ok="CHECK OK" in out, ranks=len(ranks),
              launches_by_rank=ranks, smi=f"'{smi}'")
        _require("CHECK OK" in out and len(ranks) == world
                 and all(n["apply_system_sharded"] > 0
                         and n["apply_coupled_system_sharded"] > 0
                         for n in ranks),
                 f"{tag}: no CHECK OK, or a rank launched no B3/B4: "
                 f"{ranks}")
        by_path[tag + "_rank0"] = ranks[0]
    return by_path


def bench_phase(smi):
    """Phase 21 (module docstring); returns its launch counts by path."""
    out = _study_cli("bench", ["sem_tpu_torch.bench"], counted=True)
    n = _launches(out)
    b = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    _line("bench", gdof_s_p16_64x64=f"{b['value']:.4f}",
          gdof_s_p8_32x32=f"{b['device_apply_p8_32x32_gdof_s']:.4f}",
          csr_gdof_s=f"{b['csr_pinned_gdof_s']:.5f}",
          csr_source=f"'{b['csr_source']}'",
          vs_baseline=f"{b['vs_baseline']:.2f}",
          solve_p8_16x16_s=f"{b['coupled_solve_p8_16x16_s']:.3f}",
          u_anchor=f"{b['coupled_solve_u_anchor']:.4f}", launches=n,
          card=f"'{b['card']}'", power_limit=f"'{b['power_limit']}'")
    _require(b["value"] > 0
             and abs(b["coupled_solve_u_anchor"] - 3.653) <= 1e-3
             and n[B1] > 0,
             f"bench: value {b['value']}, u-anchor "
             f"{b['coupled_solve_u_anchor']} (want 3.653 +- 1e-3), launches "
             f"{n}")
    return {"bench": n}


def study_cli_phase(smi, study):
    """Phase 22 (module docstring), on phase 19's files and stats; returns
    the launch counts by path."""
    import re

    files, stats = study
    by_path = {}
    num = r"([-+0-9.eE]+|inf|nan)"

    out = _study_cli("north_star_short", ["sem_tpu_torch.study.north_star",
                                          "--short"], counted=True)
    n = by_path["north_star_short"] = _launches(out)
    m = re.search(r"NORTH STAR: .* ladder solve ([0-9.]+)s; u_max\*RePr = "
                  + num + r" .*\|r\| = " + num + r" <= atol " + num, out)
    _require(m, "north_star printed no NORTH STAR line")
    wall, u, r, atol = map(float, m.groups())
    _line("north_star_short", ladder_s=wall, u_anchor=u, residual=r,
          atol=atol, launches=n, smi=f"'{smi}'")
    _require(abs(u - 3.6531) <= 1e-3 and r <= atol
             and n[B1] > 0 and n[B2] > 0,
             f"north_star --short: u-anchor {u}, residual {r} (atol "
             f"{atol}), launches {n}")

    out = _study_cli("centerline", ["sem_tpu_torch.study.centerline",
                                    files[".npz"], "8", "32"])
    got = [float(re.search(r"= " + num, ln).group(1))
           for ln in out.splitlines() if "centerline) = " in ln]
    want = [stats["u_anchor"], stats["v_anchor"]]
    _line("centerline", got=got, stats_json=want)
    _require(len(got) == 2 and all(abs(g - w) <= 1e-9
                                   for g, w in zip(got, want)),
             f"centerline: {got} against phase 19's stats {want}")

    # the north-star NS physics: the lid cavity at Re=400 with 'mass' floors
    # at P8 16×16 in both packages (Newton stagnates, f64 rescues stall)
    out = _study_cli("ns_scale", ["sem_tpu_torch.study.ns_scale", "8", "16",
                                  "8", "32", "--mode", "bouss"], counted=True)
    n = by_path["ns_scale"] = _launches(out)
    rows = [ln for ln in out.splitlines() if ln.startswith("[ns_scale]")]
    for ln in rows:
        print(f"  {ln}", flush=True)
    _require(len(rows) == 2 and n[B2] > 0,
             f"ns_scale: rows {rows}, launches {n}")

    out = _study_cli("krylov_econ_direct", ["sem_tpu_torch.study.krylov_econ",
                                            "--direct"], counted=True)
    n = by_path["krylov_econ_direct"] = _launches(out)
    m = re.search(r"RESULT-direct .*: ([0-9.]+)s iters=(\d+) resweeps=(\d+) "
                  r"resweep_share=" + num, out)
    _require(m, "krylov_econ printed no RESULT-direct line")
    # the study counts the NS chunks of the block-Jacobi sweep; the fused
    # preconditioner's chunks, which its default program runs, it does not
    # count (nor does the JAX script)
    its = int(m.group(2))
    _line("krylov_econ_direct", solve_s=m.group(1), ns_f32_iters=its,
          resweeps=m.group(3), resweep_share=m.group(4),
          ms_per_it=(f"{1e3 * float(m.group(1)) / its:.3f}" if its
                     else "not_counted"),
          launches=n, smi=f"'{smi}'")
    _require(n[B1] > 0 and n[B2] > 0, f"krylov_econ: launches {n}")

    out = _study_cli("ptc_band_probe", [
        "sem_tpu_torch.study.ptc_band_probe", "-ckpt", files[".ckpt.npz"],
        "-P", "8", "-Ne", "32", "-Ra", "1e5", "-its", "40"], counted=True)
    n = by_path["ptc_band_probe"] = _launches(out)
    cells = [ln.strip() for ln in out.splitlines()
             if ln.strip().startswith("dt=")]
    _line("ptc_band_probe", cells=len(cells), launches=n, smi=f"'{smi}'")
    _require(len(cells) == 1 and n[B2] > 0,
             f"ptc_band_probe: cells {cells}, launches {n}")
    return by_path


def driver_phases(smi, walls, study):
    """Phases 20-22 (module docstring); returns the launch counts by
    path."""
    by_path = example_phase(smi)
    walls.mark("20_examples")
    by_path.update(bench_phase(smi))
    walls.mark("21_bench")
    by_path.update(study_cli_phase(smi, study))
    walls.mark("22_study_clis")
    return by_path


def adjoint_main():
    """``--adjoint``: the card's line, the build, one north-star solve (the
    warm-up and phase 18's starting state), then phases 17-19."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.ops import _build

    smi = _smi_line()
    _build.library()
    walls = Walls()
    _, _, mda = build_coupled(1.0, 1.0, device="cuda", **NORTH_STAR,
                              **UNFUSED)
    s6 = mda.solve()
    walls.mark("6_north_star")
    adjoint_phases(smi.splitlines()[0], walls, s6)
    walls.show()


def drivers_main():
    """``--drivers``: the card's line, the build, phase 19's march and
    study CLIs (the files phase 22 reads), then phases 20-22."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from sem_tpu_torch.ops import _build

    smi = _smi_line().splitlines()[0]
    _build.library()
    walls = Walls()
    _, *study = study_phase(smi)
    walls.mark("19_study_cli")
    driver_phases(smi, walls, study)
    walls.show()


def _smi_line():
    """The card's name and power limit, printed and returned."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return smi


def gemm_phase(smi):
    """Phase 25: the f32 FDM transforms in even-odd form (``ops/gemm.py``,
    ``csrc/evenodd_passes.cu``) at the main path's shapes: the NS velocity
    FDM (P16 64×64, batch 2, 1023²) and the CD FDM (P16 32×32, Dirichlet in
    x, 511×513); the 'spectral' Schur block (P16 64×64, 1025²) keeps its
    ``torch.matmul`` code and is not timed here.  Per transform a line: its
    device µs (``device_us``), those of its split and merge passes alone
    (``split_us``, ``merge_us``), the FFMA
    bound of the four even-odd products at 67 TFLOP/s and the share of it
    the transform reaches; the same chain with the passes' plain PyTorch
    twins as ``library_ms`` (every kernel a library's); the plain transform
    of the unsplit bases on ``torch.matmul`` (cuBLAS SGEMMs on the odd
    sides) as ``plain_ms``; the errors of the chain and of the plain path
    against the f64 transform, relative to its maximum (the chain's must
    be at most 1.5 times the plain path's).  Then one line per product:
    its shape and device µs alone.  Returns the JSON entries."""
    import torch

    from sem_tpu_torch import FDM2D
    from sem_tpu_torch.mesh import Grid2D
    from sem_tpu_torch.ops import LAUNCHES, gemm

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(25)

    def rel(got, ref):
        return float((got.double() - ref).abs().max() / ref.abs().max())

    def plain_pass(merge, F, U, out, window, corr, Pp, Qp):
        if merge:
            gemm._merge_plain(out, U, F, window)
        else:
            out.copy_(gemm._split_plain(F, window, corr, Pp, Qp))

    def patched(fn, **attrs):
        """``fn()`` with attributes of ``ops/gemm.py`` replaced."""
        old = {k: getattr(gemm, k) for k in attrs}
        for k, v in attrs.items():
            setattr(gemm, k, v)
        try:
            return fn()
        finally:
            for k, v in old.items():
                setattr(gemm, k, v)

    g64 = Grid2D(16, 64, 64, 1.0, 1.0)
    g32 = Grid2D(16, 32, 32, 1.0, 1.0)
    fv, fc = FDM2D(g64), FDM2D(g32, (True, True), (False, False))
    cases = {   # name: (the FDM, fields)
        "fdm_velocity_1023x2": (fv, 2),
        "fdm_cd_511x513": (fc, 1),
    }
    ones = torch.ones(1, dtype=torch.float32, device=dev)
    out = []
    for name, (apply, B) in cases.items():
        g = apply.grid
        x64 = torch.randn((B, g.N), generator=gen,
                          dtype=torch.float64).to(dev)
        x = x64.float()
        ref = apply(x64)
        err = rel(apply(x), ref)
        plain_err = patched(lambda: rel(apply(x), ref),
                            takes=lambda device, dtype: False)
        n0 = LAUNCHES["evenodd_pass"]
        apply(x)
        passes = LAUNCHES["evenodd_pass"] - n0
        us = device_us(lambda: apply(x))
        lib_us = patched(lambda: device_us(lambda: apply(x)),
                         _pass=plain_pass)
        plain_us = patched(lambda: device_us(lambda: apply(x)),
                           takes=lambda device, dtype: False)
        b, = (v for (_, dtype), v in apply._gemm_bases.items()
              if dtype == torch.float32)
        (_, Pp, Sp), (_, Qp, Tp) = b.zx.shape, b.zy.shape
        # the two passes alone, on the transform's own window and scratch
        F = x.reshape(-1, g.Ngx, g.Ngy)
        window = (apply._x0, apply._y0, apply._x1 - apply._x0,
                  apply._y1 - apply._y0)
        corr = apply._gemm_corrections(ones)
        R = F.new_empty((2, Pp, B, 2, Qp))
        split_us = device_us(lambda: gemm._pass(False, F, None, R, window,
                                                corr, Pp, Qp))
        U = torch.randn(2, 2, Pp, B, Qp, generator=gen).to(dev)
        merged = torch.empty_like(F)
        merge_us = device_us(lambda: gemm._pass(True, F, U, merged, window,
                                                corr, Pp, Qp))
        # (batch, M, N, K) of the four products, as transform runs them
        prods = {"C1": (2, Sp, 2 * B * Qp, Pp), "W": (2, 2 * Sp * B, Tp, Qp),
                 "C3": (2, Pp, 2 * B * Tp, Sp), "U": (2, 2 * Pp * B, Qp, Tp)}
        flops = sum(2 * n * M * N * K for n, M, N, K in prods.values())
        bound = 1e6 * flops / F32_FLOPS
        _require(passes == 2 and err <= 1.5 * plain_err,
                 f"{name}: {passes} pass launches, error {err:.3e} against "
                 f"the plain path's {plain_err:.3e}")
        _line("gemm_chain", case=name, device_us=f"{us:.2f}",
              bound_us=f"{bound:.2f}", share=f"{bound / us:.3f}",
              tflops=f"{flops / us / 1e6:.2f}",
              library_ms=f"{lib_us / 1e3:.4f}",
              plain_ms=f"{plain_us / 1e3:.4f}", split_us=f"{split_us:.2f}",
              merge_us=f"{merge_us:.2f}", err=f"{err:.3e}",
              plain_err=f"{plain_err:.3e}")
        out.append({"kernel": "evenodd_chain", "case": name,
                    "device_ms": us / 1e3, "bound_ms": bound / 1e3,
                    "library_ms": lib_us / 1e3, "plain_ms": plain_us / 1e3,
                    "split_ms": split_us / 1e3, "merge_ms": merge_us / 1e3,
                    "err": err, "plain_err": plain_err})

        def rand(*shape):
            return torch.randn(shape, generator=gen).to(dev)

        # each product's operands with the strides transform gives them
        zx, zy = rand(2, Pp, Sp), rand(2, Qp, Tp)
        operands = {
            "C1": (zx.transpose(1, 2), rand(2, Pp, 2 * B * Qp)),
            "W": (rand(2, Sp, 2 * B * Qp).as_strided(
                (2, 2 * Sp * B, Qp), (Qp, 2 * Qp, 1)), zy),
            "C3": (zx, rand(2, Sp, 2 * B * Tp)),
            "U": (rand(2, Pp, 2 * B * Tp).as_strided(
                (2, 2 * Pp * B, Tp), (Tp, 2 * Tp, 1)), zy.transpose(1, 2))}
        for pname, (n, M, N, K) in prods.items():
            a, c = operands[pname]
            p_us = device_us(lambda: torch.bmm(a, c))
            f = 2 * n * M * N * K
            _line("gemm_product", case=name, product=pname, batch=n, M=M,
                  N=N, K=K, device_us=f"{p_us:.2f}",
                  tflops=f"{f / p_us / 1e6:.2f}")
    return out


def gemm_main():
    """``--gemm``: the card's line, the build, then phase 25 alone."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.ops import _build

    smi = _smi_line()
    t0 = time.perf_counter()
    _build.library()
    _line("build", seconds=f"{time.perf_counter() - t0:.2f}",
          nvcc_seconds=f"{_build.last_build_seconds:.2f}")
    walls = Walls()
    entries = gemm_phase(smi)
    walls.mark("25_gemm_chain")
    walls.show()
    print(json.dumps({"kernels": entries, "device": smi}), flush=True)


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


def parallel_main():
    """``--parallel``: the card's line, the build, then phase 9 alone."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from sem_tpu_torch.ops import _build

    _smi_line()
    _build.library()
    walls = Walls()
    run_ranks()
    walls.mark("9_run_parallel")
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


def run_ranks(beside=None):
    """Phase 9: start one process of this script per rank, wait for all
    (killing every one on a failure or the time limit), print their output
    and check each rank's result (9b-9d included); print rank 0's runs
    beside phase 6's single-process solve (``beside``, where it ran);
    returns the ranks' results."""
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
    for r, res in enumerate(results):
        per_it9 = (res["launches"]["apply_coupled_system_sharded"]
                   / max(res["gmres_iters"], 1))
        for name, x in res["runs"].items():
            n = x["launches"]
            ok = (x["finite"] and x["residual"] <= x["atol"]
                  and abs(x["u_anchor"] - 3.6531) <= 1e-3
                  and n["apply_system_sharded"] > 0
                  and n["apply_coupled_system_sharded"] > 0
                  and n["apply_system"] == 0
                  and n["apply_coupled_system"] == 0)
            if name == "velo_inner":
                x["b4_per_gmres_it"] = (n["apply_coupled_system_sharded"]
                                        / max(x["gmres_iters"], 1))
                ok = ok and x["b4_per_gmres_it"] > per_it9
            if name == "fused":
                ok = ok and x["captured"] and all(
                    v == 0 for v in x["replayed_step_collectives"].values())
            if not ok:
                raise AssertionError(f"phase 9 run {name} failed in rank "
                                     f"{r}: {x}")
    if any(res["stats"] != results[0]["stats"]
           or any(x["stats"] != results[0]["runs"][k]["stats"]
                  for k, x in res["runs"].items()) for res in results):
        raise AssertionError(f"ranks disagree: {results}")
    r0 = results[0]
    six = (beside or {}).get("north_star")
    _line("parallel_vs_single",
          phase9=dict(wall_s=round(r0["run_parallel_s"], 2),
                      stats=r0["stats"], gmres_iters=r0["gmres_iters"],
                      b4_per_gmres_it=round(
                          r0["launches"]["apply_coupled_system_sharded"]
                          / max(r0["gmres_iters"], 1), 2)),
          **{f"9{c}_{k}": {key: (round(v, 2) if isinstance(v, float) else v)
                           for key, v in x.items()
                           if key in ("wall_s", "first_solve_s",
                                      "warm_solve_s", "stats",
                                      "gmres_iters", "launches",
                                      "collectives", "b4_per_gmres_it")}
             for c, (k, x) in zip("bcd", r0["runs"].items())},
          phase6=("not_run" if six is None else dict(
              solve_s=round(six["solve_s"], 2), stats=six["stats"],
              gmres_iters=six["gmres_iters"], launches=six["launches"])))
    return results


def parallel_programs(tag, dev, group, pts, mda9):
    """Phases 9b-9d in one rank (module docstring): each run with the kernel
    launch and collective counts set to 0 just before and read just after.
    ``mda9`` is phase 9's MDA, whose residual serves 9b's grids.  Returns
    ``{run: result}``."""
    import torch
    from sem_tpu_torch.coupling import build_coupled, run_parallel
    from sem_tpu_torch.ops import COLLECTIVES, LAUNCHES
    from sem_tpu_torch.parallel import use_group

    def reset():
        for counts in (LAUNCHES, COLLECTIVES):
            for k in counts:
                counts[k] = 0
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    def result(name, s, stats, mda, wall):
        torch.cuda.synchronize(dev)
        r = dict(wall_s=wall, stats=stats.as_list(),
                 gmres_iters=stats.gmres_iters, launches=dict(LAUNCHES),
                 collectives=dict(COLLECTIVES),
                 residual=float(torch.linalg.vector_norm(mda._residuals(s))),
                 atol=mda.atol_nonlin,
                 u_anchor=float(s.u.abs().max()) * 1e3 * 0.71,
                 finite=all(bool(torch.isfinite(f).all())
                            for f in (s.T, s.u, s.v, s.p)))
        _line(tag, run=name, **{k: (f"{v:.3e}" if k == "residual" else
                                        f"{v:.4f}" if k == "u_anchor" else
                                        f"{v:.2f}" if k.endswith("_s") else v)
                                     for k, v in r.items()})
        return r

    runs = {}
    # ---- 9b. the flexible chunks on the strips ----
    t0 = reset()
    *_, s, stats = run_parallel(pts, 1.0, 1.0, return_state=True, device=dev,
                                velo_inner=5, **NORTH_STAR, **UNFUSED)
    runs["velo_inner"] = result("9b_velo_inner", s, stats, mda9,
                                time.perf_counter() - t0)

    # ---- 9c. the fused programs (run_parallel's body, to keep the MDA) ----
    t0 = reset()
    with use_group(group):
        _, _, mda = build_coupled(1.0, 1.0, device=dev, fused=True,
                                  **NORTH_STAR)
        s = mda.solve()
        first = time.perf_counter() - t0
        r = result("9c_fused", s, mda.stats, mda, first)
        t0 = time.perf_counter()
        mda.solve()
        torch.cuda.synchronize(dev)
        warm = time.perf_counter() - t0
        # the collectives of one replayed fused step
        mda._linearize(s)
        F = mda._residuals(s)
        start, step, precon_split = mda._fg_fused(mtol=mda.mtol_precon)
        out = start(1e-3 * F, -F)
        z = precon_split(*out[6:-1])
        torch.cuda.synchronize(dev)
        before = dict(COLLECTIVES)
        step(*out[:6], 0, *z)
        torch.cuda.synchronize(dev)
        replay = {k: COLLECTIVES[k] - before[k] for k in before}
    r.update(first_solve_s=first, warm_solve_s=warm,
             replayed_step_collectives=replay,
             captured=mda._fg[1].graph is not None)
    _line(tag, run="9c_fused", first_solve_s=f"{first:.2f}",
          warm_solve_s=f"{warm:.2f}", replayed_step_collectives=replay,
          captured=r["captured"])
    runs["fused"] = r
    del mda, start, step
    torch.cuda.empty_cache()

    # ---- 9d. the device windows on phase 23c's grids ----
    with use_group(group):
        _, _, mda = build_coupled(1.0, 1.0, device=dev, **DEVICE_GRIDS)
    t0 = reset()
    *_, s, stats = run_parallel(pts, 1.0, 1.0, return_state=True, device=dev,
                                device_krylov=True, **DEVICE_GRIDS)
    runs["device_krylov"] = result("9d_device_krylov", s, stats, mda,
                                   time.perf_counter() - t0)
    return runs


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

    rank, world, dev = init_distributed(f"127.0.0.1:{port}", world, rank,
                                        device="cuda")
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
        return_state=True, device=dev, **UNFUSED)
    _line(tag, warmup="P4_8x8_JNK", seconds=f"{time.perf_counter() - t0:.2f}",
          stats=stats.as_list(), gmres_iters=stats.gmres_iters)

    for counts in (LAUNCHES, COLLECTIVES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, _, _, s, stats = run_parallel(pts, 1.0, 1.0, return_state=True,
                                     device=dev, **NORTH_STAR, **UNFUSED)
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
    runs = parallel_programs(tag, dev, group, pts, mda)
    print("RANK_RESULT " + json.dumps({
        "rank": rank, "backend": group.backend, "stats": stats.as_list(),
        "gmres_iters": stats.gmres_iters, "residual": resid,
        "atol": mda.atol_nonlin, "u_anchor": u_anchor, "finite": finite,
        "launches": launches, "collectives": collectives,
        "collective_us": coll_us, "run_parallel_s": t_run,
        "build_s": t_build, "peak_bytes": peak, "runs": runs}), flush=True)
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
    ap.add_argument("--kernels", action="store_true",
                    help="instead of the smoke run: phases 1-4, 7, 8 and 8b "
                         "alone (the kernel checks and timings at f32 and "
                         "bf16, the bf16 path)")
    ap.add_argument("--ns-options", action="store_true",
                    help="instead of the smoke run: phases 14-16 alone (the "
                         "Schur blocks, Uzawa, assemble.py)")
    ap.add_argument("--adjoint", action="store_true",
                    help="instead of the smoke run: phases 17-19 alone (the "
                         "profile, the implicit adjoint, the study CLIs)")
    ap.add_argument("--krylov", action="store_true",
                    help="instead of the smoke run: phases 6 and 11, then "
                         "phase 23 (the fused and on-device coupled Krylov "
                         "programs) and phase 24 (the entry points' "
                         "defaults)")
    ap.add_argument("--gemm", action="store_true",
                    help="instead of the smoke run: phase 25 alone (the "
                         "even-odd FDM transforms)")
    ap.add_argument("--parallel", action="store_true",
                    help="instead of the smoke run: phase 9 alone (two rank "
                         "processes: run_parallel and its programs 9b-9d)")
    ap.add_argument("--drivers", action="store_true",
                    help="instead of the smoke run: phase 19, then phases "
                         "20-22 alone (the examples, the bench, the study "
                         "CLIs)")
    a = ap.parse_args()
    if a.ptc_ra is not None:
        ptc_ra_main(a.ptc_ra)
    elif a.drivers:
        drivers_main()
    elif a.parallel:
        parallel_main()
    elif a.gemm:
        gemm_main()
    elif a.krylov:
        krylov_main()
    elif a.kernels:
        main(kernels_only=True)
    elif a.ns_options:
        ns_options_main()
    elif a.adjoint:
        adjoint_main()
    elif a.rank is None:
        main()
    else:
        rank_main(a.rank, a.world, a.port)
