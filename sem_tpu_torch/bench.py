"""Benchmark of the port: SEM operator-apply throughput (GDOF/s per card).

Counterpart of the JAX package's ``bench.py``, run as
``python -m sem_tpu_torch.bench`` from the root of a checkout.  The headline
is the sustained application rate of the hot SEM operator, the
convection-diffusion system matvec ``(K + Pe·conv)u`` inside every Krylov
iteration, through ``ops.kernels.apply_system_best`` at float32 (kernel B1 on
the card), at p=16, 64×64 elements (N = 1,050,625 DOF).

``vs_baseline``: the same operator assembled to SciPy CSR and applied on
this machine's host CPU (the reference architecture, reference
ConvectionDiffusion_Solver.py:87) at the CSR-feasible p=8, 32×32, against
the card's rate there.  The CSR rate is the pinned one
``python -m sem_tpu_torch.bench --pin-csr`` wrote to
``<build dir>/csr_pinned.json`` (``build/sem_tpu_torch``, git-ignored;
``SEM_TPU_TORCH_BUILD_DIR`` overrides it) where that file exists, and is
measured inline otherwise; ``csr_source`` in the output says which.  The
JAX package's pinned constant in ``BASELINE.json`` was measured on another
machine's host and is never read or written here.

Second metric: the wall of the coupled Boussinesq JNK re-solve at P=8, NS
16×16 / CD 8×8 (de Vahl Davis configuration), with its u_max·Re·Pr anchor.

Prints ONE JSON line with the JAX line's keys plus ``csr_source``, ``card``
and ``power_limit`` (``nvidia-smi``).  Runs on the card (``--device cuda``,
the default) and exits non-zero where torch sees none; ``--device cpu`` runs
the same on the CPU (the kernels' plain versions), only when asked.
"""
import argparse
import datetime
import json
import subprocess
import time

import numpy as np
import torch

METRIC = "sem_operator_apply_p16_64x64_f32"
HEADLINE = dict(P=16, N_ex=64, N_ey=64)   # the headline configuration
HEADLINE_ITERS = 100
_CMP_CONFIG = dict(P=8, N_ex=32, N_ey=32)  # ratio config (CSR-feasible)
CMP_ITERS = 200
CSR_ITERS = 30
SOLVE = dict(P=8, N_e=16)                  # coupled_solve_wall


def _pin_path():
    from sem_tpu_torch.ops import _build

    return _build.build_dir() / "csr_pinned.json"


def chain_inputs(grid, dtype, device, pe: float = 40.0):
    """The chain's seeded inputs ``(u, v, x, c)``: the wind, the start
    vector after three power steps, and the constant scale ``c ≈ 1/ρ(A)``
    (computed outside any timed region)."""
    from sem_tpu_torch.ops.kernels import apply_system_best

    def seeded(seed):
        return torch.as_tensor(
            np.random.default_rng(seed).standard_normal(grid.N)).to(
                device=device, dtype=dtype)

    u, v = seeded(0), seeded(1)
    x = u / torch.linalg.vector_norm(u)
    for _ in range(3):
        y = apply_system_best(grid, u, v, x, pe)
        lam = float(torch.linalg.vector_norm(y))
        x = y / lam
    return u, v, x, 1.0 / lam


def chain(grid, u, v, x, c, iters: int, pe: float = 40.0):
    """``iters`` applies of ``x ← c·(A x)``."""
    from sem_tpu_torch.ops.kernels import apply_system_best

    for _ in range(iters):
        x = c * apply_system_best(grid, u, v, x, pe)
    return x


def device_apply_rate(grid, dtype, iters: int, pe: float = 40.0,
                      device="cuda"):
    """Sustained BARE (K + Pe·conv) apply rate in GDOF/s: ``(rate, dt)``.

    The timed region holds only the chained applies ``x ← c·(A x)`` with a
    constant ``c`` (:func:`chain_inputs`), so no norm or reduction is timed.
    On the card the ``iters`` applies are captured in one CUDA graph and one
    replay, after a warm one, is timed with CUDA events: no host work is
    timed, as in the JAX package's jitted ``fori_loop``.  Unlike there, the
    scale is a second elementwise launch per apply (XLA fused it into the
    apply's own pass), so each apply moves the field twice more through
    memory than the kernel alone.  On the CPU the loop runs eagerly under
    the host clock.
    """
    device = torch.device(device)
    u, v, x, c = chain_inputs(grid, dtype, device, pe)
    if device.type != "cuda":
        chain(grid, u, v, x, c, 1, pe)   # warm
        t0 = time.perf_counter()
        chain(grid, u, v, x, c, iters, pe)
        dt = time.perf_counter() - t0
        return grid.N * iters / dt / 1e9, dt
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        chain(grid, u, v, x, c, 2, pe)   # warm-up outside the capture
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain(grid, u, v, x, c, iters, pe)
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    dt = 1e-3 * e0.elapsed_time(e1)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("device_apply_rate: the chain left non-finite "
                           "values")
    del graph, out
    return grid.N * iters / dt / 1e9, dt


def csr_apply_rate(grid, iters: int, pe: float = 40.0, repeats: int = 3):
    """The reference-architecture baseline: assembled CSR matvec on the host
    CPU, best of ``repeats``: ``(GDOF/s, the CSR matrix)``."""
    import scipy.sparse as sp

    from sem_tpu_torch import operators as ops

    P = grid.P
    rng = np.random.default_rng(0)
    # assemble (K + Pe*conv(u,v)) elementwise into CSR via the local->global
    # map
    K_s, M_w, D = grid.basis.K, grid.basis.weights, grid.basis.D
    wq = grid.wq2d
    u_e = ops.gather(grid, torch.as_tensor(rng.standard_normal(grid.N))
                     ).numpy()
    v_e = ops.gather(grid, torch.as_tensor(
        np.random.default_rng(1).standard_normal(grid.N))).numpy()
    P1 = P + 1
    # element matrix A_e[i,j,k,l] = stiffness + convection
    I = np.eye(P1)
    Kx = (2 / grid.dx) * K_s
    Ky = (2 / grid.dy) * K_s
    mx = grid.dx / 2 * M_w
    my = grid.dy / 2 * M_w
    stiff = (np.einsum("ik,jl,j->ijkl", Kx, I, my)
             + np.einsum("ik,jl,i->ijkl", I, Ky, mx))
    rows, cols, vals = [], [], []
    gidx = grid.gidx.reshape(grid.N_e, P1, P1)
    for e in range(grid.N_e):
        conv = (pe * wq * (grid.dy / 2 * u_e[e]))[:, :, None, None] \
            * D[:, None, :, None] * I[None, :, None, :] \
            + (pe * wq * (grid.dx / 2 * v_e[e]))[:, :, None, None] \
            * I[:, None, :, None] * D[None, :, None, :]
        A_e = stiff + conv
        g = gidx[e]
        rows.append(np.broadcast_to(g[:, :, None, None], A_e.shape).ravel())
        cols.append(np.broadcast_to(g[None, None, :, :], A_e.shape).ravel())
        vals.append(A_e.ravel())
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(grid.N, grid.N)).tocsr()
    x = np.random.default_rng(2).standard_normal(grid.N)
    A @ x  # warm
    best = float("inf")
    for _ in range(repeats):  # best-of-N: the host CPU is shared and noisy
        t0 = time.perf_counter()
        xx = x
        for _ in range(iters):
            y = A @ xx
            xx = y / np.linalg.norm(y)
        best = min(best, time.perf_counter() - t0)
    return grid.N * iters / best / 1e9, A


def coupled_solve_wall(P=8, N_e=16, device="cuda"):
    """End-to-end coupled Boussinesq JNK solve wall-clock: de Vahl Davis
    config at a fixed mid-size grid, solved from zero to coupled rms 1e-9
    (the reference example's tolerance, reference
    Boussinesq_SequentialCoupler.py:15-17).  The first solve warms the
    process; the second, from zero again, is timed (ending in a device
    synchronize).  Returns (wall seconds of the solve, u_max·Re·Pr)."""
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.utils import sync

    device = torch.device(device)
    cd, ns, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=1e3, Pr=0.71,
                                P_cd=P, N_ex_cd=N_e // 2, N_ey_cd=N_e // 2,
                                P_ns=P, N_ex_ns=N_e, N_ey_ns=N_e,
                                mode="JNK", iprint=False, device=device)
    mda.solve()  # warm-up; the re-solve below is the measured one
    mda.cd_comp.iter_count_solve = mda.ns_comp.iter_count_solve = 0
    sync(device)
    t0 = time.perf_counter()
    s = mda.solve()
    sync(device)
    wall = time.perf_counter() - t0
    u_anchor = float(s.u.abs().max()) * 1e3 * 0.71
    return wall, u_anchor


def pin_csr_baseline(repeats: int = 10):
    """Measure the CSR baseline best-of-N on this host and persist it in
    ``<build dir>/csr_pinned.json`` (never in ``BASELINE.json``)."""
    from sem_tpu_torch.mesh import Grid2D

    cmp_grid = Grid2D(L_x=1.0, L_y=1.0, **_CMP_CONFIG)
    rate, _ = csr_apply_rate(cmp_grid, iters=CSR_ITERS, repeats=repeats)
    path = _pin_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "config": "p{P}_{N_ex}x{N_ey}_f64_csr_host".format(**_CMP_CONFIG),
            "gdof_s": rate,
            "best_of": repeats,
            "date": datetime.date.today().isoformat(),
            "note": ("reference-architecture baseline: assembled CSR matvec "
                     "of (K + Pe*conv) on this machine's host CPU (reference "
                     "ConvectionDiffusion_Solver.py:87); pinned so bench "
                     "runs do not fold host contention into vs_baseline"),
        }, f, indent=2)
        f.write("\n")
    print(f"pinned CSR baseline: {rate:.4f} GDOF/s (best of {repeats}) "
          f"-> {path}")
    return rate


def card():
    """(name, power limit) of the card as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    name, limit = smi.splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def main(device="cuda"):
    """Measure and print the JSON line; returns it as a dict."""
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.mesh import Grid2D
    from sem_tpu_torch.utils import cli_device

    device = cli_device(device)
    dtype = torch.float32
    name, limit = card() if device.type == "cuda" else ("cpu", None)

    # reference-architecture baseline: this host's pinned rate (measure with
    # --pin-csr); measured inline where none was pinned
    pin = _pin_path()
    cmp_grid = Grid2D(L_x=1.0, L_y=1.0, **_CMP_CONFIG)
    if pin.exists():
        with open(pin) as f:
            pinned = json.load(f)
        csr_rate = float(pinned["gdof_s"])
        csr_source = f"pinned {pin} ({pinned['date']})"
    else:
        csr_rate, _ = csr_apply_rate(cmp_grid, iters=CSR_ITERS)
        csr_source = "inline"
    print(f"csr baseline: {csr_source}", flush=True)

    # device side of the ratio at the same (CSR-feasible) configuration
    dev_rate_cmp = max(device_apply_rate(cmp_grid, dtype, iters=CMP_ITERS,
                                         device=device)[0]
                       for _ in range(3))
    vs_baseline = dev_rate_cmp / csr_rate

    # headline: bare apply rate at the north-star configuration (best of 3)
    big = Grid2D(L_x=1.0, L_y=1.0, **HEADLINE)
    value = max(device_apply_rate(big, dtype, iters=HEADLINE_ITERS,
                                  device=device)[0]
                for _ in range(3))

    # second metric: end-to-end coupled-solve wall-clock
    solve_wall, u_anchor = coupled_solve_wall(device=device, **SOLVE)

    line = {
        "metric": METRIC,
        "value": value,
        "unit": "GDOF/s",
        # ratio vs the reference architecture, at the CSR-feasible config:
        # device apply rate there / this host's CSR rate
        "vs_baseline": vs_baseline,
        "vs_baseline_config": "p{P}_{N_ex}x{N_ey} (device f32 vs host "
                              "CSR)".format(**_CMP_CONFIG),
        "device_apply_p8_32x32_gdof_s": dev_rate_cmp,
        "csr_pinned_gdof_s": csr_rate,
        "csr_source": csr_source,
        "coupled_solve_p8_16x16_s": solve_wall,
        "coupled_solve_u_anchor": u_anchor,
        "card": name,
        "power_limit": limit,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pin-csr", action="store_true",
                    help="measure the host CSR baseline (best of 10) and "
                         "write it to <build dir>/csr_pinned.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    a = ap.parse_args()
    if a.pin_csr:
        pin_csr_baseline()
    else:
        main(device=a.device)
