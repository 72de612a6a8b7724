"""Coupled JNK stats of one package at one configuration, by hand on the CPU.

Prints ``[cd_solves, ns_solves, nonlinear]``, the coupled GMRES iterations
and u_max·RePr of one from-zero JNK solve (Re=1e3, Ra=1e3, Pr=0.71,
``mtol_nonlin=1e-8``, host FGMRES) of ``sem_tpu`` (``--package jax``) or of
``sem_tpu_torch`` (``--package torch``, on the CPU).  In both the fused
programs follow ``SEM_TPU_FG_FUSED`` (the port: ``fused=False`` where it is
``0``).  Not a test; run from the root of a checkout::

    SEM_TPU_FG_FUSED=0 SEM_TPU_FUSED_PC=0 JAX_PLATFORMS=cpu \\
        python tests/torch_stats_compare.py --package jax -P 8 --ne-ns 16 --ne-cd 8
    SEM_TPU_FG_FUSED=0 \\
        python tests/torch_stats_compare.py --package torch -P 8 --ne-ns 16 --ne-cd 8
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("-P", type=int, default=8)
    ap.add_argument("--ne-ns", type=int, default=16)
    ap.add_argument("--ne-cd", type=int, default=8)
    a = ap.parse_args()
    kw = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=a.P, N_ex_cd=a.ne_cd,
              N_ey_cd=a.ne_cd, P_ns=a.P, N_ex_ns=a.ne_ns, N_ey_ns=a.ne_ns,
              mode="JNK", mtol_nonlin=1e-8, iprint=False,
              device_krylov=False)
    t0 = time.perf_counter()
    if a.package == "jax":
        import tests.conftest  # noqa: F401  (forces the CPU platform)
        from sem_tpu.coupling import build_coupled
        _, _, mda = build_coupled(1.0, 1.0, **kw)
    else:
        from sem_tpu_torch.coupling import build_coupled
        fused = os.environ.get("SEM_TPU_FG_FUSED", "1") != "0"
        _, _, mda = build_coupled(1.0, 1.0, device="cpu", fused=fused, **kw)
    s = mda.solve()
    u_anchor = float(abs(s.u).max()) * 1e3 * 0.71
    print(f"package={a.package} P={a.P} ns={a.ne_ns}x{a.ne_ns} "
          f"cd={a.ne_cd}x{a.ne_cd} "
          f"FG_FUSED={os.environ.get('SEM_TPU_FG_FUSED', 'unset')} "
          f"FUSED_PC={os.environ.get('SEM_TPU_FUSED_PC', 'unset')} "
          f"stats={mda.stats.as_list()} gmres_iters={mda.stats.gmres_iters} "
          f"u_anchor={u_anchor:.4f} seconds={time.perf_counter() - t0:.1f}",
          flush=True)


if __name__ == "__main__":
    main()
