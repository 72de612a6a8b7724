"""NS solve wall-clock and inner iteration counts across resolutions, on the
port.

Counterpart of the JAX package's ``study/ns_scale.py``: quantifies how the
Schur-block preconditioner of the coupled saddle solve scales with the grid
(the diagonal-mass block degrades about linearly with 1/h; the reference
repository sidesteps it with an exact SuperLU inner solve, reference
NavierStokes_Solver.py:176-187).  On the card every f32 GMRES iteration
applies kernel B2.

Usage: ``python -m sem_tpu_torch.study.ns_scale [P Ne [P Ne ...]]
[--precon mass|pcd|spectral] [--mode lid|bouss] [--device cpu]``
(default configurations P8 16×16, P8 32×32, P16 64×64)
"""
import argparse
import time

import torch


def run_config(P, Ne, precon="mass", Re=400.0, mode="lid", device="cuda"):
    """One standalone NS solve from zero; prints one line and returns its
    numbers (``N``, ``build_s``, ``solve_s``, ``newton``, ``last_inner``,
    ``rms``).

    ``mode='lid'``: lid-driven cavity at ``Re`` (strong convection).
    ``mode='bouss'``: the north-star NS physics, buoyancy-driven at Re=1e3,
    Ra=1e3, Pr=0.71 (Gr=Ra/Pr), no-slip walls, differentially heated
    temperature profile (velocities ~5e-3, so mild convection)."""
    from sem_tpu_torch.models.navier_stokes import NavierStokesSolver
    from sem_tpu_torch.utils import sync

    device = torch.device(device)
    t0 = time.perf_counter()
    if mode == "bouss":
        Re, Gr, u_N = 1e3, 1e3 / 0.71, 0.0
    else:
        Gr, u_N = 0.0, 1.0
    ns = NavierStokesSolver(1.0, 1.0, Re=Re, Gr=Gr, P=P, N_ex=Ne, N_ey=Ne,
                            u_N=u_N, mtol=1e-10, mtol_newton=1e-8,
                            schur_precon=precon,
                            iprint=["NEWTON_iter", "LGMRES_suc"],
                            device=device)
    sync(device)
    t_build = time.perf_counter() - t0
    if mode == "bouss":
        T = torch.as_tensor(0.5 - ns.points[0], dtype=torch.float64,
                            device=device)
    else:
        T = torch.zeros(ns.N, dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    u, v, p = ns._get_solution(T)
    sync(device)
    t_solve = time.perf_counter() - t0
    ru, rv, rc = ns._get_residuals(u, v, p, T)
    rms = float(torch.sqrt(sum(torch.linalg.vector_norm(r) ** 2
                               for r in (ru, rv, rc)) / (3 * ns.N)))
    inner = int(ns.last_schur_info.iterations)
    print(f"[ns_scale] P={P} Ne={Ne} N={ns.N} precon={precon} mode={mode}: "
          f"build {t_build:.1f}s solve {t_solve:.1f}s "
          f"newton={ns._k} last_inner={inner} rms={rms:.2e}", flush=True)
    return dict(N=ns.N, build_s=t_build, solve_s=t_solve, newton=ns._k,
                last_inner=inner, rms=rms)


def main(argv=None):
    """Run every configuration; returns their :func:`run_config` dicts."""
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.utils import cli_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    help="pairs P Ne (default 8 16 8 32 16 64)")
    ap.add_argument("--precon", default="mass",
                    choices=("mass", "pcd", "spectral"))
    ap.add_argument("--mode", default="lid", choices=("lid", "bouss"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    a = ap.parse_args(argv)
    if len(a.sizes) % 2:
        ap.error("sizes come in pairs P Ne")
    device = cli_device(a.device)
    configs = (list(zip(a.sizes[::2], a.sizes[1::2])) if a.sizes
               else [(8, 16), (8, 32), (16, 64)])
    return [run_config(P, Ne, precon=a.precon, mode=a.mode, device=device)
            for P, Ne in configs]


if __name__ == "__main__":
    main()
