"""Adjoint cost at a checkpointed coupled state, on the port.

Counterpart of the JAX package's ``study/adjoint_hi.py``: loads a converged
study checkpoint (the ``-ckpt True`` artifact of
:mod:`sem_tpu_torch.study.boussinesq_run`, or of ``sem_tpu``'s study: the
format is shared), rebuilds the solvers at its recorded configuration,
verifies the state's residual, and measures ``solve_adjoint`` and the
parameter gradient with respect to Ra/Re/Pr: wall-clock, outer FGMRES
iterations, and the gradient values.  The loss is the reference's
``sum(u² + v²)`` over the NS nodes.

Usage::

  python -m sem_tpu_torch.study.adjoint_hi -ckpt <dir>/<title>.ckpt.npz \\
      [-inner_rtol 1e-4] [-atol 1e-10] [-restart 60] [-maxiter 2000] \\
      [-inner_maxiter 600] [-max_basis_gb 0.5] [-iprint 1] [-fd 0] \\
      [-device cuda]

``-fd 1`` also checks d(loss)/d(Ra) against central finite differences of
two JNK re-solves warm-started from the checkpointed state at the study's
default tolerances (relative step 1e-4, the measured sweet spot between FD
truncation and the re-solves' state-resolution floor), as ``sem_tpu``'s
study script does.
"""
import sys
import time

import numpy as np
import torch


def _flag(args, name, default, cast=float):
    if name in args:
        return cast(args[args.index(name) + 1])
    return default


def main(argv=None):
    """Run the study; returns a dict of what it printed (``residual_rms``,
    ``iterations``, ``wall_s``, ``loss``, ``grads`` and, with ``-fd 1``,
    ``fd``)."""
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.coupling.implicit import (adjoint_windows,
                                                 coupled_residual_fn,
                                                 parameter_gradients,
                                                 solve_adjoint)
    from sem_tpu_torch.utils.checkpoint import load_checkpoint

    args = sys.argv[1:] if argv is None else list(argv)
    path = _flag(args, "-ckpt", None, str)
    if not path:
        sys.exit("usage: python -m sem_tpu_torch.study.adjoint_hi "
                 "-ckpt <study ckpt.npz> [...]")
    inner_rtol = _flag(args, "-inner_rtol", 1e-4)
    atol = _flag(args, "-atol", 1e-10)
    restart = _flag(args, "-restart", 60, int)
    maxiter = _flag(args, "-maxiter", 2000, int)
    inner_maxiter = _flag(args, "-inner_maxiter", 600, int)
    max_basis_gb = _flag(args, "-max_basis_gb", 0.5)
    do_fd = _flag(args, "-fd", 0, int)
    device = _flag(args, "-device", "cuda", str)

    state, cfg, iters = load_checkpoint(path, device=device)
    print(f"checkpoint: {path}\n  config {cfg}  iters {iters}", flush=True)
    params = {k: float(cfg[k]) for k in ("Re", "Ra", "Pr")}
    grid_kw = {k: cfg[k] for k in ("P_cd", "N_ex_cd", "N_ey_cd", "P_ns",
                                   "N_ex_ns", "N_ey_ns")}

    t0 = time.perf_counter()
    cd, ns, _ = build_coupled(1.0, 1.0, **params, **grid_kw, mode="JNK",
                              iprint=False, device=device)
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    x = torch.cat([state.T, state.u, state.v, state.p])
    F = coupled_residual_fn(cd, ns)
    r = F(x, {k: torch.tensor(v, dtype=torch.float64, device=device)
              for k, v in params.items()})
    rms = float(torch.linalg.vector_norm(r)) / np.sqrt(x.shape[0])
    print(f"state residual rms: {rms:.3e} (converged study states are "
          f"<= ~1e-10)", flush=True)

    N_cd, N_ns = cd.N, ns.N

    def loss_fn(xf):
        u = xf[N_cd:N_cd + N_ns]
        v = xf[N_cd + N_ns:N_cd + 2 * N_ns]
        return torch.sum(u ** 2 + v ** 2)

    outer, inner, inner_dtype = adjoint_windows(
        cd, ns, x.shape[0], restart=restart, max_basis_gb=max_basis_gb)
    print(f"adjoint windows: outer {outer} (float64), inner {inner} "
          f"({str(inner_dtype or torch.float64).replace('torch.', '')}) "
          f"at max_basis_gb={max_basis_gb}", flush=True)

    # adjoint solve, timed apart from the theta-gradient epilogue
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(xg)
    gbar = torch.autograd.grad(loss, xg)[0]
    loss = float(loss.detach())
    t0 = time.perf_counter()
    lam, its = solve_adjoint(cd, ns, x, gbar, params, atol=atol,
                             restart=restart, maxiter=maxiter,
                             inner_rtol=inner_rtol,
                             inner_maxiter=inner_maxiter,
                             max_basis_gb=max_basis_gb, raise_on_fail=False,
                             iprint=bool(_flag(args, "-iprint", 0, int)))
    wall = time.perf_counter() - t0
    print(f"adjoint solve: {wall:.1f}s, {its} outer FGMRES iterations "
          f"({wall / max(its, 1):.2f} s/it)", flush=True)

    grads = parameter_gradients(cd, ns, x, params, lam)
    print(f"loss = {loss:.8e}", flush=True)
    for k, g in sorted(grads.items()):
        print(f"  d(loss)/d({k}) = {g:.8e}", flush=True)
    out = dict(residual_rms=rms, iterations=its, wall_s=wall, loss=loss,
               grads=grads)

    if do_fd:
        from sem_tpu_torch.coupling import CoupledState

        h = params["Ra"] * 1e-4
        vals = {}
        for sgn in (+1, -1):
            t0 = time.perf_counter()
            _, _, mda_p = build_coupled(
                1.0, 1.0, **dict(params, Ra=params["Ra"] + sgn * h),
                **grid_kw, mode="JNK", iprint=False, device=device)
            sp = mda_p.solve(CoupledState(state.T, state.u, state.v,
                                          state.p))
            vals[sgn] = float(loss_fn(torch.cat([sp.T, sp.u, sp.v, sp.p])))
            print(f"FD re-solve Ra{'+' if sgn > 0 else '-'}h: "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        fd = (vals[+1] - vals[-1]) / (2 * h)
        print(f"FD d(loss)/d(Ra) = {fd:.8e}  "
              f"(adjoint {grads['Ra']:.8e}, rel diff "
              f"{abs(fd - grads['Ra']) / max(abs(fd), 1e-300):.2e})",
              flush=True)
        out["fd"] = fd
    return out


if __name__ == "__main__":
    main()
