"""Parameter-sweep study harness for the coupled Boussinesq problem, on the
port.

Counterpart of the JAX package's ``study/boussinesq_run.py``: a CLI that
sweeps polynomial order / element count / Re / Ra / coupling mode, tees
stdout to a per-run log file, and saves element-scattered solution fields
plus iteration counts ``[cd_solves, ns_solves, nonlinear_iters]`` to ``.npz``
with the same config-encoding run title, ``.log``, ``.stats.json`` and
``.ckpt.npz`` names, so the two packages' rows sit side by side.

Flags (comma-separated sweep lists):

    -P 4,8          polynomial orders
    -Ne 8,16        element counts (CD runs at Ne/2)
    -Re 1e3         Reynolds numbers
    -Ra 1e3,1e4     Rayleigh numbers
    -mode JNK       GS | NJ | JNK | PTC (pseudo-transient continuation, the
                    high-Ra path)
    -log True       tee stdout to <outdir>/<title>.log
    -save True      save .npz results and the .stats.json sidecar
    -backend single single | mesh (mesh: every rank of the process group
                    that the SEM_TPU_COORDINATOR, SEM_TPU_NUM_PROCESSES and
                    SEM_TPU_PROCESS_ID variables describe runs this same
                    command, the solve is decomposed over them, and rank 0
                    alone writes the files; without the variables one
                    process runs the single path)
    -racont True    Ra continuation up to each Ra (solve_ra_continued)
    -ckpt True      checkpoint the coupled iterate every few nonlinear
                    iterations, and the converged state at the end, to
                    <outdir>/<title>.ckpt.npz (sem_tpu's script writes the
                    periodic checkpoints only)
    -resume True    warm-start from that checkpoint if present (implies
                    checkpointing the continued run)
    -ptc_dt0 0.1, -ptc_growth 3, -ptc_forcing 1e-2, -ptc_dtmax 1e12
                    PTC controller overrides
    -schur spectral NS Schur-block override (mass | pcd | spectral)
    -budget 9000    wall-clock budget in seconds: the MDA checkpoints and
                    exits between nonlinear iterations when it is spent
    -init path.npz  warm-start from a checkpoint of a different physics
                    config on the same grid (ignored when -resume finds a
                    same-config checkpoint)
    -precon bgs2    coupled-preconditioner override (bj | bgs | bgs2)
    -velo_inner 5   k inner GMRES steps on the true velocity Jacobian in
                    every NS preconditioner application
    -device cuda    torch device (the card by default; ``cpu`` when asked)
    -outdir Boussinesq_study_torch
                    output directory (never the JAX package's
                    ``Boussinesq_study/``)

Run: ``python -m sem_tpu_torch.study.boussinesq_run -P 4 -Ne 8 -mode JNK``
"""
import contextlib
import json
import os
import sys
import time

import numpy as np

OUTDIR = "Boussinesq_study_torch"


class Logger:
    """stdout tee into a log file."""

    def __init__(self, file):
        self.terminal = sys.__stdout__
        self.log = open(file, "w")

    def write(self, message):
        self.log.write(message)
        self.terminal.write(message)

    def flush(self):
        self.log.flush()
        self.terminal.flush()


def run(log=False, save=True,
        L_x=1., L_y=1.,
        Re=1.e3, Ra=1.e3, Pr=0.71,
        P=4, N_e=8,
        mode="JNK", backend="single",
        mtol_nonlin=1e-10, AGi=8, AGr=0.8, AGc=0.2,
        mtol_gmres=1e-13, restart=20,
        mtol_internal=1e-13, forcing=None, racont=False, ckpt=False,
        resume=False, velo_inner=0, init=None, budget=None,
        ptc_dt0=None, ptc_growth=None, ptc_forcing=None, precon=None,
        ptc_dtmax=None, schur=None, device="cuda", outdir=OUTDIR):
    """One run of the sweep; returns ``(state, MDAStats)``.  ``forcing=None``
    keeps the coupled GMRES at a fixed tolerance, so the saved iteration
    counts compare with ``sem_tpu``'s study."""
    if backend not in ("single", "mesh"):
        raise ValueError(f"-backend {backend}: single or mesh")
    from sem_tpu_torch import operators as ops
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.parallel import use_group
    from sem_tpu_torch.utils.checkpoint import load_checkpoint

    group = mesh_group(device) if backend == "mesh" else None
    writer = group is None or group.rank == 0

    # the run title of sem_tpu's study: mode, physics, discretization and
    # the mode's tolerances
    title = f"Boussinesq{mode}_{Re:.1e}~{Ra:.1e}~{Pr}_{P}~{N_e}_"
    if mode == "GS":
        title += f"{mtol_nonlin:.0e}_{mtol_internal:.0e}"
    elif mode == "NJ":
        title += f"{mtol_nonlin:.0e}~{AGi}~{AGr}~{AGc}_{mtol_internal:.0e}"
    elif mode in ("JNK", "PTC"):
        title += (f"{mtol_nonlin:.0e}_{mtol_gmres:.0e}~{restart}_"
                  f"{mtol_internal:.0e}")
    else:
        raise RuntimeError("Unknown method")
    print(title)
    if writer:
        os.makedirs(outdir, exist_ok=True)
    if log and writer:
        sys.stdout = Logger(os.path.join(outdir, f"{title}.log"))

    try:
        # CD at half the NS element count
        kw = dict(Re=Re, Pr=Pr,
                  P_cd=P, N_ex_cd=max(1, int(N_e / 2)),
                  N_ey_cd=max(1, int(N_e / 2)),
                  P_ns=P, N_ex_ns=N_e, N_ey_ns=N_e,
                  mode=mode, mtol_nonlin=mtol_nonlin,
                  AGi=AGi, AGr=AGr, AGc=AGc,
                  mtol_gmres=mtol_gmres, restart=restart,
                  mtol_internal=mtol_internal, forcing=forcing,
                  velo_inner=velo_inner, device=device)
        if budget is not None:
            # an absolute deadline: the Ra ladder builds an MDA per level
            kw["time_deadline"] = time.monotonic() + float(budget)
        for kname, v in (("ptc_dt0", ptc_dt0), ("ptc_growth", ptc_growth),
                         ("ptc_forcing", ptc_forcing),
                         ("ptc_dt_max", ptc_dtmax)):
            if v is not None:
                kw[kname] = float(v)
        if schur is not None:
            kw["schur_precon"] = schur
        if precon is not None:
            kw["precon"] = precon
        if init and racont:
            raise ValueError(
                "-init is not supported with -racont True (the Ra ladder "
                "owns its warm starts); drop -racont to seed a single-level "
                "run from the checkpoint")
        if ckpt or resume:
            kw["checkpoint_path"] = os.path.join(outdir, f"{title}.ckpt.npz")
        def grouped():
            return (use_group(group) if group is not None
                    else contextlib.nullcontext())

        if racont:
            from sem_tpu_torch.coupling import solve_ra_continued
            with grouped():
                cd, ns, mda, state = solve_ra_continued(L_x, L_y, Ra, **kw)
        else:
            with grouped():
                cd, ns, mda = build_coupled(L_x, L_y, Ra=Ra, **kw)
            state0 = None
            if resume and os.path.exists(kw["checkpoint_path"]):
                state0, _, it0, extras = load_checkpoint(
                    kw["checkpoint_path"],
                    expect_config=mda.checkpoint_config, with_extras=True,
                    device=device)
                # continue the SER Δt ramp where the checkpoint left it
                if extras.get("ptc_dt") and ptc_dt0 is None:
                    mda.ptc_dt0 = float(extras["ptc_dt"])
                print(f"resuming from {kw['checkpoint_path']} "
                      f"(saved iters "
                      f"{list(it0) if it0 is not None else '?'}"
                      + (f", dt={extras['ptc_dt']:.3g}"
                         if extras.get("ptc_dt") else "") + ")")
            elif init:
                # only the discretization must match the checkpoint's
                state0, cfg0, _ = load_checkpoint(init, device=device)
                grid_keys = ("P_cd", "N_ex_cd", "N_ey_cd",
                             "P_ns", "N_ex_ns", "N_ey_ns")
                mism = {k: (cfg0.get(k), kw[k]) for k in grid_keys
                        if cfg0.get(k) != kw[k]}
                if mism:
                    raise ValueError(
                        f"-init checkpoint discretization mismatch: {mism}")
                print(f"init from {init} "
                      f"(Ra={cfg0.get('Ra')}, Re={cfg0.get('Re')})")
            with grouped():
                state = mda.solve(state0)
        if (ckpt or resume) and writer:
            # the converged state too (the MDA writes every few iterations
            # only), so that adjoint_hi reads a converged state
            mda._maybe_checkpoint(state, mda.stats.nonlinear_iters,
                                  force=True)
    finally:
        if log and writer:
            sys.stdout.log.close()
            sys.stdout = sys.__stdout__

    def escatter(grid, f):
        return ops.gather(grid, f).cpu().numpy().reshape(
            grid.N_ex, grid.N_ey, grid.P + 1, grid.P + 1)

    T_e = escatter(cd.grid, state.T)
    u_e = escatter(ns.grid, state.u)
    v_e = escatter(ns.grid, state.v)
    iters = mda.stats.as_list()
    print(iters)

    if save and writer:
        np.savez(os.path.join(outdir, title), T_e, u_e, v_e, np.array(iters))
        stats = dict(mode=mode, Re=Re, Ra=Ra, Pr=Pr, P=P, Ne=N_e,
                     iters=[int(x) for x in iters],
                     u_anchor=round(float(np.abs(u_e).max()) * Re * Pr, 4),
                     v_anchor=round(float(np.abs(v_e).max()) * Re * Pr, 4),
                     anchor_kind="domain_max")
        with open(os.path.join(outdir, f"{title}.stats.json"), "w") as fh:
            json.dump(stats, fh, indent=1)
    return state, mda.stats


def mesh_group(device):
    """The group of ``-backend mesh``: every rank of the process group that
    the ``SEM_TPU_*`` variables describe (initialized here on first use,
    over gloo for ``-device cpu``), or ``None`` without the variables, where
    one process runs the single path (a group of one rank)."""
    import torch.distributed as dist

    from sem_tpu_torch.parallel import init_distributed, make_group

    if not dist.is_initialized():
        if "SEM_TPU_COORDINATOR" not in os.environ:
            return None
        init_distributed(device=device)
    return make_group()


def main(argv=None):
    import torch.distributed as dist

    args = sys.argv if argv is None else [sys.argv[0]] + list(argv)
    opts = dict(save=True, log=False, mode="JNK", racont=False, ckpt=False,
                resume=False, velo_inner=0, init=None, budget=None,
                ptc_dt0=None, ptc_growth=None, ptc_forcing=None,
                ptc_dtmax=None, schur=None, precon=None, backend="single",
                device="cuda", outdir=OUTDIR)
    sweep = dict(P=[4], Ne=[8], Re=[1.e3], Ra=[1.e3])
    started = dist.is_initialized()   # by the caller, who ends it

    def flag(s):
        return s.lower() in ("true", "1", "yes")

    casts = {"-log": ("log", flag), "-save": ("save", flag),
             "-mode": ("mode", str), "-backend": ("backend", str),
             "-racont": ("racont", flag), "-ckpt": ("ckpt", flag),
             "-resume": ("resume", flag), "-velo_inner": ("velo_inner", int),
             "-init": ("init", str), "-budget": ("budget", float),
             "-ptc_dt0": ("ptc_dt0", float),
             "-ptc_growth": ("ptc_growth", float),
             "-ptc_forcing": ("ptc_forcing", float),
             "-ptc_dtmax": ("ptc_dtmax", float), "-schur": ("schur", str),
             "-precon": ("precon", str), "-device": ("device", str),
             "-outdir": ("outdir", str)}
    lists = {"-P": ("P", int), "-Ne": ("Ne", int), "-Re": ("Re", float),
             "-Ra": ("Ra", float)}
    for i, arg in enumerate(args[:-1]):
        if arg in casts:
            key, cast = casts[arg]
            opts[key] = cast(args[i + 1])
        elif arg in lists:
            key, cast = lists[arg]
            sweep[key] = [cast(s) for s in args[i + 1].split(",")]

    for Re in sweep["Re"]:
        for Ra in sweep["Ra"]:
            for P in sweep["P"]:
                for Ne in sweep["Ne"]:
                    run(Re=Re, Ra=Ra, P=P, N_e=Ne, **opts)
    if opts["backend"] == "mesh" and dist.is_initialized() and not started:
        # leaving with a gloo group alive can abort at interpreter exit
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
