"""Krylov per-iteration economics on the north-star ladder, on the port.

Counterpart of the JAX package's ``study/krylov_econ.py``.  Measures, on
the real ladder solve (P4 → P8 → P16, NS 64×64 / CD 32×32, not a synthetic
worst case):

* per-level NS inner-f32 iteration and DGKS resweep counts
  (``KrylovInfo.resweeps``: iterations whose orthogonalization ran the
  second sweep, which doubles that iteration's basis traffic) of the NS
  solver's ``_get_update`` (the Gauss-Seidel and block-Jacobi sweeps; the
  fused two-round preconditioner's chunks are not counted, as in the JAX
  script),
* warm ladder wall-clock and convergence stats,

under a configurable DGKS threshold η (``--eta``, default
``sem_tpu_torch.krylov.DGKS_ETA``) and NS GMRES window (``--restart``,
default auto): the data behind the η/restart defaults.  ``--direct`` solves
the p16 level alone from zero (hundreds of f32 iterations: the clean ms/it
signal).

Phase attribution (:func:`instrument_phases`): CUDA-synchronized spans
(:class:`sem_tpu_torch.utils.profiling.PhaseTimer`; each span edge
synchronizes the card, so totals are upper bounds, and spans nest) around
these functions of the port:

* ``cd.solve_linear`` / ``ns.solve_linear``: the disciplines' block solves
  (``ConvectionDiffusionComponent.solve_linear``,
  ``NavierStokesComponent.solve_linear``);
* ``cd.f32_chunks``: ``ConvectionDiffusionSolver._update_mixed`` (f64
  refinement around the f32 GMRES chunks, kernel B1);
* ``ns.f32_chunks``: ``NavierStokesSolver._update_coupled_mixed`` (the same
  for the coupled saddle solve, kernel B2), and ``ns.f64``:
  ``NavierStokesSolver._update_coupled_f64`` (its f64 rescue);
* ``mda.bgs_rhs``, ``mda.block_jacobi``, ``mda.apply_linear``:
  ``BoussinesqMDA._bgs_rhs``, ``_block_jacobi`` (the coupled
  preconditioner) and ``_apply_linear`` (the coupled matvec);
* ``mda.fg_start`` and ``mda.fg_step``, the fused host-FGMRES programs
  that ``_fg_fused`` binds (a CUDA graph replay on the card), and
  ``mda.pc_fused``, one application of the fused two-round preconditioner
  that ``_pc_fused`` binds;
* ``mda.jnk_cycle``: ``BoussinesqMDA._jnk_window``, one on-device JNK
  window.

The coupled Krylov program is the MDA's default, as in the JAX script: the
device windows on the levels of at most ``DEVICE_KRYLOV_MAX_DOF`` coupled
DOF (P4 and P8), the fused host FGMRES above (P16).  ``--fused`` takes the
fused host FGMRES on every level, ``--unfused`` the un-fused host FGMRES
with the adaptive block-Jacobi sweep on every level (the two host programs
the study compares).

Usage::

    python -m sem_tpu_torch.study.krylov_econ [--eta X] [--restart N]
        [--ra 1e3] [--direct] [--fused | --unfused] [--device cpu]
"""
import argparse
import contextlib
import time

import torch

KW = dict(Re=1e3, Pr=0.71, N_ex_cd=32, N_ey_cd=32, N_ex_ns=64, N_ey_ns=64,
          mode="JNK", mtol_nonlin=1e-8, iprint=False)
LADDER = (4, 8, 16)


def instrument_phases(ns, cd, mda=None):
    """Wrap the functions named in the module docstring in spans of one
    :class:`PhaseTimer`, which is returned."""
    from sem_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()

    def timed(fn, key):
        def spanned(*a, **k):
            with timer(key):
                return fn(*a, **k)

        return spanned

    def wrap(obj, name, key):
        setattr(obj, name, timed(getattr(obj, name), key))

    wrap(cd, "_update_mixed", "cd.f32_chunks")
    wrap(ns, "_update_coupled_mixed", "ns.f32_chunks")
    wrap(ns, "_update_coupled_f64", "ns.f64")
    if mda is not None:
        wrap(mda.cd_comp, "solve_linear", "cd.solve_linear")
        wrap(mda.ns_comp, "solve_linear", "ns.solve_linear")
        for name in ("_bgs_rhs", "_block_jacobi", "_apply_linear"):
            wrap(mda, name, f"mda.{name[1:]}")
        wrap(mda, "_jnk_window", "mda.jnk_cycle")
        # the bound fused programs, each call a span (never inside a CUDA
        # graph's capture: the spans wrap what _fg_fused returns)
        fg_fused, pc_fused = mda._fg_fused, mda._pc_fused

        def fg_fused_timed(*a, **k):
            start, step, precon_split = fg_fused(*a, **k)
            return (timed(start, "mda.fg_start"),
                    timed(step, "mda.fg_step"), precon_split)

        def pc_fused_timed(*a, **k):
            precon_split = pc_fused(*a, **k)
            return (None if precon_split is None
                    else timed(precon_split, "mda.pc_fused"))

        mda._fg_fused, mda._pc_fused = fg_fused_timed, pc_fused_timed
    return timer


def print_phases(timer, label):
    """One line of the spans' totals and counts; then reset them."""
    parts = "  ".join(f"{k}={t:.2f}s/{timer.counts[k]}x"
                      for k, t in sorted(timer.totals.items()))
    print(f"phases [{label}] (nested spans): {parts}", flush=True)
    timer.totals.clear()
    timer.counts.clear()


def instrument_ns(ns):
    """Accumulate the NS inner iteration/resweep totals across
    ``_get_update``."""
    orig = ns._get_update
    tot = {"calls": 0, "iters": 0, "resweeps": 0}

    def wrapped(*a, **k):
        out = orig(*a, **k)
        info = ns.last_schur_info
        tot["calls"] += 1
        tot["iters"] += int(info.iterations)
        tot["resweeps"] += int(info.resweeps)
        return out

    ns._get_update = wrapped
    return tot


@contextlib.contextmanager
def _overrides(eta, restart):
    """``krylov.DGKS_ETA`` and the NS GMRES window set for the duration
    (``build_coupled`` does not forward an NS restart: it is injected at
    the constructor, as the JAX script does)."""
    from sem_tpu_torch import krylov
    import sem_tpu_torch.models.navier_stokes as nsmod

    saved_eta, orig_init = krylov.DGKS_ETA, nsmod.NavierStokesSolver.__init__
    if eta is not None:
        krylov.DGKS_ETA = eta
    if restart is not None:
        def patched(self, *a, **k):
            k.setdefault("restart", restart)
            return orig_init(self, *a, **k)

        nsmod.NavierStokesSolver.__init__ = patched
    try:
        yield
    finally:
        krylov.DGKS_ETA = saved_eta
        nsmod.NavierStokesSolver.__init__ = orig_init


def main(argv=None):
    """Run the study; returns a dict (``wall_s``, ``iters``, ``resweeps``,
    ``stats``, ``u_anchor``; ``levels`` with the per-level counts of the
    warm ladder)."""
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.utils import cli_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eta", type=float, default=None,
                    help="DGKS resweep threshold (default krylov.DGKS_ETA)")
    ap.add_argument("--restart", type=int, default=None,
                    help="NS GMRES window (default: auto-sized)")
    ap.add_argument("--ra", type=float, default=1e3)
    ap.add_argument("--direct", action="store_true",
                    help="single-level p16 solve from zero (no ladder): "
                         "hundreds of f32 iterations, the clean ms/it "
                         "signal")
    program = ap.add_mutually_exclusive_group()
    program.add_argument("--fused", action="store_true",
                         help="the fused host FGMRES and the two-round "
                              "preconditioner on every level "
                              "(fused=True, device_krylov=False); default: "
                              "the MDA's own choice, the JAX package's "
                              "(device windows up to 1e6 coupled DOF, the "
                              "fused host FGMRES above)")
    program.add_argument("--unfused", action="store_true",
                         help="the un-fused host FGMRES with the adaptive "
                              "block-Jacobi sweep on every level "
                              "(fused=False, device_krylov=False)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    with _overrides(args.eta, args.restart):
        return _run(args, device)


def _run(args, device):
    from sem_tpu_torch import krylov
    from sem_tpu_torch.coupling.boussinesq import build_coupled
    from sem_tpu_torch.coupling.mda import CoupledState
    from sem_tpu_torch.interp import apply_transfer
    from sem_tpu_torch.utils import sync

    program = (dict(fused=True, device_krylov=False) if args.fused else
               dict(fused=False, device_krylov=False) if args.unfused else
               dict(fused=None, device_krylov=None))
    print(f"config: eta={krylov.DGKS_ETA} restart={args.restart or 'auto'} "
          f"Ra={args.ra:g} fused={program['fused']} "
          f"device_krylov={program['device_krylov']}", flush=True)
    kw = dict(KW, Ra=args.ra, device=device, **program)

    def share(rs, its):
        return f"({100 * rs / max(its, 1):.0f}%)"

    if args.direct:
        Pf = LADDER[-1]
        t0 = time.perf_counter()
        cd, ns, mda = build_coupled(1.0, 1.0, P_cd=Pf, P_ns=Pf, **kw)
        tot = instrument_ns(ns)
        timer = instrument_phases(ns, cd, mda)
        sync(device)
        print(f"build p{Pf}: {time.perf_counter() - t0:.1f}s", flush=True)
        for tag in ("first", "warm"):
            tot.update(calls=0, iters=0, resweeps=0)
            mda.cd_comp.iter_count_solve = mda.ns_comp.iter_count_solve = 0
            t0 = time.perf_counter()
            s = mda.solve()
            sync(device)
            wall = time.perf_counter() - t0
            its, rs = tot["iters"], tot["resweeps"]
            print(f"[{tag}] direct p{Pf}: {wall:.2f}s "
                  f"stats={mda.stats.as_list()} NS f32 iters={its} "
                  f"resweeps={rs} {share(rs, its)} "
                  f"~{1e3 * wall / max(its, 1):.1f} ms/it-incl-overhead",
                  flush=True)
            print_phases(timer, tag)
        r = float(torch.linalg.vector_norm(mda._residuals(s)))
        print(f"RESULT-direct eta={krylov.DGKS_ETA}: {wall:.2f}s "
              f"iters={its} resweeps={rs} resweep_share={rs / max(its, 1):.3f} "
              f"|r|={r:.2e}", flush=True)
        return dict(wall_s=wall, iters=its, resweeps=rs,
                    stats=mda.stats.as_list(),
                    u_anchor=float(s.u.abs().max()) * 1e3 * 0.71)

    levels = {}
    for P in LADDER:
        t0 = time.perf_counter()
        cd, ns, mda = build_coupled(1.0, 1.0, P_cd=P, P_ns=P, **kw)
        levels[P] = (cd, ns, mda, instrument_ns(ns))
        sync(device)
        print(f"build P={P}: {time.perf_counter() - t0:.1f}s", flush=True)

    def ladder(tag):
        s = None
        prev = None
        rows = []
        for P in LADDER:
            cd, ns, mda, tot = levels[P]
            mda.cd_comp.iter_count_solve = mda.ns_comp.iter_count_solve = 0
            it0, rs0 = tot["iters"], tot["resweeps"]
            if s is not None:
                cd0, ns0 = prev
                s = CoupledState(T=apply_transfer(cd0.grid, cd.grid, s.T),
                                 u=apply_transfer(ns0.grid, ns.grid, s.u),
                                 v=apply_transfer(ns0.grid, ns.grid, s.v),
                                 p=apply_transfer(ns0.grid, ns.grid, s.p))
            t0 = time.perf_counter()
            s = mda.solve(s)
            sync(device)
            wall = time.perf_counter() - t0
            its = tot["iters"] - it0
            rs = tot["resweeps"] - rs0
            rows.append(dict(P=P, stats=mda.stats.as_list(), iters=its,
                             resweeps=rs))
            print(f"  [{tag}] P={P}: {wall:.2f}s stats={mda.stats.as_list()} "
                  f"NS f32 iters={its} resweeps={rs} {share(rs, its)}",
                  flush=True)
            prev = (cd, ns)
        return s, mda, rows

    t0 = time.perf_counter()
    ladder("first")
    print(f"solve 1 (warm-up): {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    s, mda, rows = ladder("warm")
    wall = time.perf_counter() - t0
    u_anchor = float(s.u.abs().max()) * 1e3 * 0.71
    r = float(torch.linalg.vector_norm(mda._residuals(s)))
    its = sum(row["iters"] for row in rows)
    rs = sum(row["resweeps"] for row in rows)
    print(f"RESULT eta={krylov.DGKS_ETA} restart={args.restart or 'auto'}: "
          f"ladder {wall:.2f}s; u_max*RePr={u_anchor:.4f}; "
          f"|r|={r:.2e} (atol {mda.atol_nonlin:.2e})", flush=True)
    return dict(wall_s=wall, iters=its, resweeps=rs,
                stats=mda.stats.as_list(), u_anchor=u_anchor, levels=rows)


if __name__ == "__main__":
    main()
