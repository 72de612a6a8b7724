"""Probe the coupled linear solve inside a PTC Δt band, offline, on the port.

Counterpart of the JAX package's ``study/ptc_band_probe.py``.  At high Ra
the SER controller of pseudo-transient continuation (PTC) can keep probing
Δt values whose implicit-Euler tangent system the coupled FGMRES contracts
only very slowly: real progress, so plateau tests never fire.  This script
reproduces that system from a run checkpoint (same state, same
σ = (Pe/Δt, Re/Δt) shifts, the host FGMRES that PTC itself uses) and
measures the per-iteration contraction rate for candidate preconditioner
strengths (``velo_inner``) and Δt values, without spending march
wall-clock on blind production runs.  The checkpoint format is shared, so a
checkpoint of either package's study works.  The probe runs the host
FGMRES with the MDA's own host program, as the JAX script does: by default
the fused step and the two-round preconditioner (``BoussinesqMDA._fg_fused``).

The RHS is the true PTC right-hand side ``-F(x)``: consistent by
construction (random RHSs lie about preconditioner quality; this one is the
actual Newton residual the march solves against).

Usage::

  python -m sem_tpu_torch.study.ptc_band_probe \\
      -ckpt <dir>/<title>.ckpt.npz -Ra 1e8 [-P 16] [-Ne 64] [-dt 0.9,2.7] \\
      [-velo_inner 5,10] [-pc bgs] [-its 80] [-restart 20] [-forcing F] \\
      [-schur spectral] [-device cpu]

Each (velo_inner, pc, dt) cell prints: iterations run, relative residual,
the trailing-20 contraction rate ρ, and the projected iterations to the PTC
forcing tolerance, the number the SER controller effectively prices a Δt
probe at.
"""
import sys

import numpy as np
import torch


def probe(ckpt, Ra, P=16, N_e=64, Re=1.e3, Pr=0.71, dts=(0.9,),
          velo_inners=(5,), pcs=("bgs",), its=80, restart=20,
          mtol_nonlin=1e-10, mtol_gmres=1e-13, mtol_internal=1e-13,
          ptc_forcing=None, schur=None, device="cuda"):
    """Print one line per cell and the summary; returns the rows
    ``(velo_inner, pc, dt, its, rel, rho, projected)``."""
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.coupling.mda import _fgmres
    from sem_tpu_torch.utils.checkpoint import load_checkpoint

    state0, cfg0, _ = load_checkpoint(ckpt, device=device)
    print(f"checkpoint: {ckpt}\n  config {cfg0}")

    rows = []
    for k, pc in [(k, pc) for k in velo_inners for pc in pcs]:
        cd, ns, mda = build_coupled(
            1.0, 1.0, Re=Re, Ra=Ra, Pr=Pr,
            P_cd=P, N_ex_cd=max(1, N_e // 2), N_ey_cd=max(1, N_e // 2),
            P_ns=P, N_ex_ns=N_e, N_ey_ns=N_e, mode="PTC",
            mtol_nonlin=mtol_nonlin, mtol_gmres=mtol_gmres,
            restart=restart, mtol_internal=mtol_internal,
            velo_inner=k, precon=pc, device=device,
            **({"schur_precon": schur} if schur else {}),
            **({"ptc_forcing": ptc_forcing} if ptc_forcing else {}))
        s = state0
        F = mda._residuals(s)
        norm = float(torch.linalg.vector_norm(F))
        atol_k = max(mda.atol_gmres, mda.ptc_forcing * norm)
        Pe = mda.cd_comp.cd._Pe
        Re_ = mda.ns_comp.ns._Re
        print(f"velo_inner={k} pc={pc}: |F| = {norm:.4e}, atol_k = "
              f"{atol_k:.4e}")
        for dt in dts:
            mda._linearize(s, sigma_cd=Pe / dt, sigma_ns=Re_ / dt)
            hist = []
            dx, iters, ok = _fgmres(
                mda._apply_linear,
                lambda r: mda._block_jacobi(r, mtol=mda.mtol_precon,
                                            best_effort=True),
                -F, atol=atol_k, restart=mda.restart, maxiter=its,
                callback=lambda i, res: hist.append(res),
                fused=(mda._fg_fused(mtol=mda.mtol_precon) if mda.fused
                       else None))
            res = hist[-1]
            w = min(20, len(hist) - 1)
            rho = (hist[-1] / hist[-1 - w]) ** (1.0 / w) if w > 0 else 1.0
            need = (0.0 if res <= atol_k else
                    np.log(res / atol_k) / -np.log(rho)
                    if 0 < rho < 1 else np.inf)
            rows.append((k, pc, dt, iters, res / norm, rho, need))
            print(f"  dt={dt:<8g} its={iters:<4d} rel={res / norm:.3e} "
                  f"rho(20)={rho:.5f} projected_to_atol="
                  f"{need if np.isfinite(need) else float('inf'):.0f}",
                  flush=True)
    print("\nsummary (velo_inner, pc, dt, its, rel, rho, projected):")
    for r in rows:
        print("  " + "\t".join(f"{x:.4g}" if isinstance(x, float) else str(x)
                               for x in r))
    return rows


def main(argv=None):
    import sem_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from sem_tpu_torch.utils import cli_device

    a = sys.argv[1:] if argv is None else list(argv)

    def get(flag, default):
        return next((a[i + 1] for i, s in enumerate(a[:-1]) if s == flag),
                    default)

    ckpt = get("-ckpt", None)
    if not ckpt:
        sys.exit("usage: python -m sem_tpu_torch.study.ptc_band_probe "
                 "-ckpt <study ckpt.npz> [-Ra 1e8] [...]")
    return probe(ckpt=ckpt,
                 Ra=float(get("-Ra", "1e8")),
                 P=int(get("-P", "16")), N_e=int(get("-Ne", "64")),
                 Re=float(get("-Re", "1e3")), Pr=float(get("-Pr", "0.71")),
                 dts=[float(s) for s in get("-dt", "0.9").split(",")],
                 velo_inners=[int(s) for s in
                              get("-velo_inner", "5").split(",")],
                 pcs=get("-pc", "bgs").split(","),
                 its=int(get("-its", "80")),
                 restart=int(get("-restart", "20")),
                 ptc_forcing=(float(get("-forcing", "0")) or None),
                 schur=get("-schur", None),
                 device=cli_device(get("-device", "cuda")))


if __name__ == "__main__":
    main()
