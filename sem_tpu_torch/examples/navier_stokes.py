"""Steady Navier-Stokes demo: lid-driven cavity, on the port.

Counterpart of the JAX package's ``examples/navier_stokes.py``: Re=400,
P=4, 16×16 elements, u=1 on the moving lid, validated against the Ghia,
Ghia & Shin (1982) centerline velocity tables
(doi.org/10.1016/0021-9991(82)90058-4).  On the card every f32 GMRES
iteration of the coupled saddle solve applies kernel B2.

Usage::

    python -m sem_tpu_torch.examples.navier_stokes                # Re=400
    python -m sem_tpu_torch.examples.navier_stokes --quick        # Re=100 8x8
    python -m sem_tpu_torch.examples.navier_stokes --check [--quick] \\
        [--device cpu]
"""
import argparse

import numpy as np

# Ghia et al. (1982) Table I: u through the vertical centerline (x=0.5).
GHIA_Y = np.array([0.0547, 0.1016, 0.2813, 0.4531, 0.5000, 0.7344])
GHIA_U_RE100 = np.array([-0.03717, -0.06434, -0.15662, -0.21090, -0.20581,
                         0.00332])
GHIA_U_RE400 = np.array([-0.08186, -0.14612, -0.32726, -0.17119, -0.11477,
                         0.16256])


def main(check: bool = False, quick: bool = False, device: str = "cuda"):
    """Solve, print, and with ``check`` assert; returns ``newton``,
    ``u_at_ghia`` and ``err`` (the largest deviation from the table)."""
    from sem_tpu_torch import NavierStokesSolver
    from sem_tpu_torch.utils import cli_device

    device = cli_device(device)
    L_x = L_y = 1.0
    Re = 100 if quick else 400
    P = 4
    N_e = 8 if quick else 16
    ghia_u = GHIA_U_RE100 if quick else GHIA_U_RE400

    ns = NavierStokesSolver(L_x, L_y, Re, 0, P, N_e, N_e, u_N=1,
                            iprint=["NEWTON_suc", "NEWTON_iter"],
                            device=device)

    x_plot, y_plot = np.meshgrid(np.linspace(0, L_x, 101),
                                 np.linspace(0, L_y, 101), indexing="ij")
    u_plot, v_plot, p_plot = ns.run(T_func=lambda x, y: 0 * x * y,
                                    points_plot=(x_plot, y_plot))

    u_center = u_plot[50, :]
    y_line = y_plot[50, :]
    u_at_ghia = np.interp(GHIA_Y, y_line, u_center)
    err = float(np.max(np.abs(u_at_ghia - ghia_u)))
    print(f"Re={Re}: Newton iterations {ns._k}")
    print("centerline u vs Ghia:", np.array2string(u_at_ghia, precision=4),
          "vs", np.array2string(ghia_u, precision=4))
    print(f"max abs deviation from Ghia table: {err:.4f}")
    out = dict(newton=ns._k, u_at_ghia=u_at_ghia, err=err)

    if check:
        tol = 0.02 if quick else 0.015  # coarse-grid tolerance
        assert err < tol, f"Ghia deviation {err:.4f} exceeds {tol}"
        print("CHECK OK")
        return out

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return out
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.streamplot(x_plot.T, y_plot.T, u_plot.T, v_plot.T, density=2)
    ax.set_title(f"Re={Re:.0e}, P={P}, N_e={N_e}", fontsize="small")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.savefig("navier_stokes.png", dpi=fig.dpi)
    print("saved navier_stokes.png")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="assert the deviation from the Ghia table; no plot")
    ap.add_argument("--quick", action="store_true",
                    help="Re=100 on 8x8 elements (default Re=400, 16x16)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    a = ap.parse_args()
    main(check=a.check, quick=a.quick, device=a.device)
