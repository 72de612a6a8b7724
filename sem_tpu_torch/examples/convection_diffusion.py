"""Steady convection-diffusion demo: circular flow in a box, on the port.

Counterpart of the JAX package's ``examples/convection_diffusion.py``:
Pe=40, P=4, 16×16 elements, Dirichlet T=+0.5 (west) / -0.5 (east),
homogeneous Neumann north/south, circular velocity field
[u, v] = [y - L_y/2, L_x/2 - x].  On the card every f32 GMRES iteration
applies kernel B1.

Usage::

    python -m sem_tpu_torch.examples.convection_diffusion           # + plot
    python -m sem_tpu_torch.examples.convection_diffusion --check   # asserts
    python -m sem_tpu_torch.examples.convection_diffusion --check --device cpu
"""
import argparse

import numpy as np


def main(check: bool = False, device: str = "cuda"):
    """Solve, print, and with ``check`` assert; returns ``T_min``, ``T_max``,
    ``iterations`` (GMRES) and ``asym`` (the antisymmetry defect)."""
    from sem_tpu_torch import ConvectionDiffusionSolver
    from sem_tpu_torch.utils import cli_device

    device = cli_device(device)
    L_x = L_y = 1.0
    P, N_ex, N_ey, Pe = 4, 16, 16, 40.0
    u = lambda x, y: y - L_y / 2
    v = lambda x, y: L_x / 2 - x

    cd = ConvectionDiffusionSolver(L_x, L_y, Pe, P, N_ex, N_ey,
                                   T_E=-0.5, T_W=0.5,
                                   iprint=["LGMRES_suc"], device=device)

    x_plot, y_plot = np.meshgrid(np.linspace(0, L_x, 51),
                                 np.linspace(0, L_y, 51), indexing="ij")
    T_plot = cd.run(u, v, (x_plot, y_plot))

    iterations = int(cd.last_info.iterations)
    print(f"T range: [{T_plot.min():.6f}, {T_plot.max():.6f}]")
    print(f"GMRES iterations: {iterations}")
    # the configuration is antisymmetric under (x,y) -> (L-x, L-y); the
    # defect bound matches the solver contract (GMRES converges to
    # atol = mtol*sqrt(N) ~ 1.3e-9 absolute; solution junk along
    # weakly-observable directions is of the same order)
    asym = float(np.max(np.abs(T_plot + T_plot[::-1, ::-1])))
    out = dict(T_min=float(T_plot.min()), T_max=float(T_plot.max()),
               iterations=iterations, asym=asym)

    if check:
        assert abs(T_plot.max() - 0.5) < 1e-10, "west Dirichlet violated"
        assert abs(T_plot.min() + 0.5) < 1e-10, "east Dirichlet violated"
        assert asym < 1e-8, f"antisymmetry defect {asym:.2e}"
        print("CHECK OK")
        return out

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return out
    fig, ax = plt.subplots(figsize=(L_x * 4, L_y * 4))
    CS = ax.contour(x_plot, y_plot, T_plot, levels=11, colors="k",
                    linestyles="solid")
    ax.streamplot(x_plot.T, y_plot.T, u(x_plot, y_plot).T,
                  v(x_plot, y_plot).T, density=1)
    ax.clabel(CS, inline=True)
    ax.set_title(f"P={P}, N_ex={N_ex}, N_ey={N_ey}, Pe={Pe}",
                 fontsize="small")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.savefig("convection_diffusion.png", dpi=fig.dpi)
    print("saved convection_diffusion.png")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="assert the Dirichlet values and the antisymmetry; "
                         "no plot")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    a = ap.parse_args()
    main(check=a.check, device=a.device)
