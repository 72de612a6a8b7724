"""Coupled Boussinesq demo: differentially heated cavity (natural
convection), on the port.

Counterpart of the JAX package's ``examples/boussinesq_sequential.py``:
Re=1e3, Ra=1e3, Pr=0.71, P=4, 8×8 elements, JNK coupling; prints
``u_max·Re·Pr`` and ``v_max·Re·Pr`` for comparison with de Vahl Davis (1983),
doi.org/10.1002/fld.1650030305 (literature: ≈3.649 and ≈3.697 at Ra=10³).
On the card the CD solves apply kernel B1 and the NS solves kernel B2.

Usage::

    python -m sem_tpu_torch.examples.boussinesq_sequential [--check] \\
        [--quick] [--mode GS|NJ|JNK] [--device cpu]
"""
import argparse

import numpy as np

# de Vahl Davis (1983) benchmark values at Ra=1e3, Pr=0.71
DVD_UMAX = 3.649
DVD_VMAX = 3.697


def main(check=False, quick=False, mode="JNK", device="cuda"):
    """Solve, print, and with ``check`` assert; returns ``umax``, ``vmax``
    (scaled by Re·Pr) and the MDA ``stats`` ``[cd, ns, nonlinear]``."""
    from sem_tpu_torch.coupling import run
    from sem_tpu_torch.utils import cli_device

    device = cli_device(device)
    L_x = L_y = 1.0
    Re, Ra, Pr = 1e3, 1e3, 0.71
    P = 4
    N_e = 4 if quick else 8

    x_plot, y_plot = np.meshgrid(np.linspace(0, L_x, 101),
                                 np.linspace(0, L_y, 101), indexing="ij")
    T_plot, u_plot, v_plot, _, stats = run((x_plot, y_plot), L_x, L_y,
                                           Re, Ra, Pr,
                                           P, N_e, N_e,
                                           P, N_e, N_e,
                                           mode=mode, return_state=True,
                                           device=device)

    umax = np.max(u_plot) * Re * Pr
    vmax = np.max(v_plot) * Re * Pr
    print(f"u_max*RePr = {umax:.3f}  (de Vahl Davis: {DVD_UMAX})")
    print(f"v_max*RePr = {vmax:.3f}  (de Vahl Davis: {DVD_VMAX})")
    out = dict(umax=float(umax), vmax=float(vmax), stats=stats.as_list())

    if check:
        tol = 0.05 if quick else 0.02
        assert abs(umax - DVD_UMAX) < tol * DVD_UMAX, f"u_max {umax}"
        assert abs(vmax - DVD_VMAX) < tol * DVD_VMAX, f"v_max {vmax}"
        print("CHECK OK")
        return out

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return out
    fig, ax = plt.subplots(figsize=(L_x * 6, L_y * 6))
    ax.streamplot(x_plot.T, y_plot.T, u_plot.T, v_plot.T, density=3)
    CS = ax.contour(x_plot, y_plot, T_plot, levels=11, colors="k",
                    linestyles="solid")
    ax.clabel(CS, inline=True)
    ax.set_title(f"Ra={Ra:.1e}, P={P}, N_e={N_e}, mode={mode}",
                 fontsize="small")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.savefig("boussinesq.png", dpi=fig.dpi)
    print("saved boussinesq.png")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="assert the de Vahl Davis anchors; no plot")
    ap.add_argument("--quick", action="store_true",
                    help="4x4 elements (default 8x8)")
    ap.add_argument("--mode", default="JNK", choices=("GS", "NJ", "JNK"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    a = ap.parse_args()
    main(check=a.check, quick=a.quick, mode=a.mode, device=a.device)
