#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``sem_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, one output line each (any failure raises and exits non-zero before
the last line):

1. device and build: the card's name and power limit (``nvidia-smi``), and
   the ``nvcc`` build of the two CUDA kernels from ``sem_tpu_torch/csrc``;
2. kernel B1 (CD system apply) vs its plain PyTorch version and vs the f64
   dense path, at P=4 8×8, P=16 32×32 and P=16 64×64, tolerance
   2e-5·max|ref|;
3. kernel B2 (NS coupled saddle matvec), the same checks;
4. median µs per apply of each kernel and its plain version at P=16 64×64,
   and of B1 also at its main-path shape P=16 32×32 (CUDA events, after
   warm-up);
5. the reference configuration: ``run`` JNK, P=4 8×8, Ra=1e3 — de Vahl Davis
   anchors u_max·RePr = 3.649 and v_max·RePr = 3.697 within 1%, ≤ 6 Newton
   iterations;
6. the main path at full size: ``build_coupled`` + ``solve`` JNK with NS at
   P=16 64×64 and CD at P=16 32×32, Ra=1e3, from zero, to the coupled RMS
   tolerance 1e-8 of the reference's p16 study runs; the kernel launch
   counts are reset just before and read just after, and each must be > 0.

Then a JSON line with one entry per kernel, and as the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time


def _line(tag, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch import operators as ops
    from sem_tpu_torch.coupling import build_coupled, run
    from sem_tpu_torch.mesh import Grid2D
    from sem_tpu_torch.ops import _build, kernels

    dev = torch.device("cuda")

    # ---- 1. device and build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
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

    # ---- 4. timings at P=16 (inputs already on the card) ----
    def median_ms(fn, reps=50, warm=5):
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
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    for name, (kfn, pfn, _) in kernel_fns.items():
        for grid in (g64, g32) if name == "apply_system" else (g64,):
            a = inputs(grid, torch.float32)[name]
            plain_ms = median_ms(lambda: pfn(grid, *a))
            ms = median_ms(lambda: kfn(grid, *a))
            _line("timing", kernel=name, grid=grid.tag,
                  kernel_us=f"{1e3 * ms:.1f}", plain_us=f"{1e3 * plain_ms:.1f}",
                  smi=f"'{smi}'")
            if grid is main_grid[name]:
                report[name].update(ms=ms, plain_ms=plain_ms)

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

    # ---- 6. the main path at full size ----
    t0 = time.perf_counter()
    cd, ns, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=1e3, Pr=0.71,
                                P_cd=16, N_ex_cd=32, N_ey_cd=32,
                                P_ns=16, N_ex_ns=64, N_ey_ns=64,
                                mode="JNK", mtol_nonlin=1e-8, iprint=False,
                                device="cuda")
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
            and all(n > 0 for n in launches.values())):
        raise AssertionError(
            f"north-star solve failed: finite={finite} residual {resid:.3e} "
            f"(atol {mda.atol_nonlin:.3e}) u_anchor {u_anchor:.4f} "
            f"launches {launches}")

    rows = []
    for name, src, replaces in (
            ("apply_system", "sem_tpu_torch/csrc/apply_system.cu",
             "sem_tpu/ops/pallas_kernels.py:104"),
            ("apply_coupled_system", "sem_tpu_torch/csrc/coupled_system.cu",
             "sem_tpu/ops/pallas_kernels.py:276")):
        r = report[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
