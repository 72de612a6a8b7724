"""North-star measurement on the port: coupled Boussinesq p16 64×64 to rms
1e-8.

Counterpart of the JAX package's ``study/north_star.py``: builds the
p-continuation ladder (P4 → P8 → P16 at fixed 64×64 NS / 32×32 CD
elements), runs it once to warm the process, then reports the warm ladder's
solve wall-clock and the de Vahl Davis velocity anchor.  On the card the CD
solves apply kernel B1 and the NS solves kernel B2 at every order of the
ladder.

Usage::

    python -m sem_tpu_torch.study.north_star [--direct] [--ttfs] [--short]
        [--device cpu]

``--short`` uses the two-level P4 → P16 ladder (skips P8; the P16 level may
pay 1-2 Newton iterations instead of 0); ``--direct`` additionally times the
single-level p16 solve from zero, twice, for the continuation-speedup
comparison; ``--ttfs`` times the user-facing end-to-end path instead: ONE
``solve_continued`` call including all solver construction (the next
level's construction overlaps the coarse solves in a worker thread;
eigendecompositions and spectral constants disk-cached), with per-level
build-wait / solve lines.
"""
import argparse
import time

import torch

KW = dict(Re=1e3, Ra=1e3, Pr=0.71,
          N_ex_cd=32, N_ey_cd=32, N_ex_ns=64, N_ey_ns=64,
          mode="JNK", mtol_nonlin=1e-8, iprint=False)

LADDER = (4, 8, 16)


def build_levels(ladder_ps=None, device="cuda"):
    """``{P: (cd, ns, mda)}`` of every ladder level."""
    from sem_tpu_torch.coupling.boussinesq import build_coupled
    from sem_tpu_torch.utils import sync

    levels = {}
    for P in ladder_ps or LADDER:
        t0 = time.perf_counter()
        levels[P] = build_coupled(1.0, 1.0, P_cd=P, P_ns=P, device=device,
                                  **KW)
        sync(device)
        print(f"build P={P}: {time.perf_counter() - t0:.1f}s", flush=True)
    return levels


def ladder(levels):
    """One solve of the ladder, each level warm-started by the previous
    level's solution (cross-mesh transfer); returns the finest level's
    ``(state, mda)``."""
    from sem_tpu_torch.coupling.mda import CoupledState
    from sem_tpu_torch.interp import apply_transfer
    from sem_tpu_torch.utils import sync

    s = None
    prev = None
    for P, (cd, ns, mda) in levels.items():
        mda.cd_comp.iter_count_solve = mda.ns_comp.iter_count_solve = 0
        if s is not None:
            cd0, ns0 = prev
            s = CoupledState(T=apply_transfer(cd0.grid, cd.grid, s.T),
                             u=apply_transfer(ns0.grid, ns.grid, s.u),
                             v=apply_transfer(ns0.grid, ns.grid, s.v),
                             p=apply_transfer(ns0.grid, ns.grid, s.p))
        t0 = time.perf_counter()
        s = mda.solve(s)
        sync(mda.device)
        print(f"  level P={P}: {time.perf_counter() - t0:.1f}s "
              f"stats={mda.stats.as_list()}", flush=True)
        prev = (cd, ns)
    return s, mda


def main(argv=None):
    """Run the measurement; returns a dict of what it printed (``wall_s``,
    ``u_anchor``, ``residual``, ``atol``)."""
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.utils import cli_device, sync

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--direct", action="store_true",
                    help="also time the single-level p16 solve from zero "
                         "(with --ttfs: a one-level ladder)")
    ap.add_argument("--ttfs", action="store_true",
                    help="time one solve_continued call, construction "
                         "included")
    ap.add_argument("--short", action="store_true",
                    help="two-level ladder: the coarsest and finest orders")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    a = ap.parse_args(argv)
    device = cli_device(a.device)
    lad = (LADDER[0], LADDER[-1]) if a.short else LADDER
    Pf = lad[-1]
    tag = f"p{Pf} {KW['N_ex_ns']}x{KW['N_ey_ns']}"

    if a.ttfs:
        from sem_tpu_torch.coupling.boussinesq import solve_continued
        # --ttfs --direct: a single-level "ladder" (one set of solvers, the
        # Newton iterations from zero)
        steps = [(Pf, Pf)] if a.direct else [(P, P) for P in lad]
        t0 = time.perf_counter()
        cd, ns, mda, s = solve_continued(1.0, 1.0, ladder=steps, P_cd=Pf,
                                         P_ns=Pf, timing=True,
                                         device=device, **KW)
        sync(device)
        wall = time.perf_counter() - t0
        u_anchor = float(s.u.abs().max()) * 1e3 * 0.71
        r = float(torch.linalg.vector_norm(mda._residuals(s)))
        print(f"TTFS: end-to-end {tag} build+solve {wall:.1f}s; "
              f"u_max*RePr = {u_anchor:.4f}; |r| = {r:.2e} "
              f"<= atol {mda.atol_nonlin:.2e}", flush=True)
        return dict(wall_s=wall, u_anchor=u_anchor, residual=r,
                    atol=mda.atol_nonlin)

    levels = build_levels(lad, device)
    t0 = time.perf_counter()
    ladder(levels)
    print(f"solve 1 (warm-up): {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    s, mda = ladder(levels)
    wall = time.perf_counter() - t0
    u_anchor = float(s.u.abs().max()) * 1e3 * 0.71
    r = float(torch.linalg.vector_norm(mda._residuals(s)))
    print(f"NORTH STAR: warm coupled {tag} ladder solve {wall:.1f}s; "
          f"u_max*RePr = {u_anchor:.4f} (de Vahl Davis: 3.649); "
          f"|r| = {r:.2e} <= atol {mda.atol_nonlin:.2e}", flush=True)
    out = dict(wall_s=wall, u_anchor=u_anchor, residual=r,
               atol=mda.atol_nonlin)

    if a.direct:
        cd, ns, mda = levels[Pf]
        for label in ("no continuation", "warm"):
            # per-solve stats (the JAX script's accumulate across solves)
            mda.cd_comp.iter_count_solve = mda.ns_comp.iter_count_solve = 0
            t0 = time.perf_counter()
            mda.solve()
            sync(device)
            print(f"direct p{Pf} ({label}): {time.perf_counter() - t0:.1f}s "
                  f"stats={mda.stats.as_list()}", flush=True)
    return out


if __name__ == "__main__":
    main()
