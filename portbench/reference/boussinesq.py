"""Plain reference of the coupled Boussinesq problem (de Vahl Davis'
differentially heated cavity).

Temperature ``T`` lives on the convection-diffusion grid (``P_cd``,
``N_ex_cd × N_ey_cd``), velocity and pressure on the Navier-Stokes grid
(``P_ns``, ``N_ex_ns × N_ey_ns``); each discipline reads the other's fields
interpolated at its own nodes.  With ``Pe = Re·Pr`` and ``Gr = Ra/Pr``::

    rT = Pe (u Gx T + v Gy T) + K T,   T − 0.5 on side W, T + 0.5 on side E

(adiabatic S and N), and the momentum and continuity rows of
:func:`portbench.reference.navier_stokes.ns_residual` with buoyancy
``(Gr/Re) M T`` and no-slip walls.  The coupled residual is
``[rT, ru, rv, rc]`` over ``N_cd + 3 N_ns`` rows.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.navier_stokes import ns_residual
from portbench.reference.sem import F64, Grid, make_grid

__all__ = ["grids", "coupled_residual", "residual_rms", "readings",
           "plain_state", "anchors"]


def grids(cfg: dict, device="cpu"):
    """(CD grid, NS grid) of the configuration."""
    return tuple(make_grid(cfg["P_" + d], cfg["N_ex_" + d], cfg["N_ey_" + d],
                           cfg["L_x"], cfg["L_y"], str(device))
                 for d in ("cd", "ns"))


def _numbers(cfg, params):
    Re = float(params.get("Re", cfg["Re"]))
    Pr = float(params.get("Pr", cfg["Pr"]))
    Ra = float(params["Ra"])
    return Re, Pr, Ra


def coupled_residual(gc: Grid, gn: Grid, Re, Pr, Ra, T, u, v, p):
    """(rT, ru, rv, rc) as grid fields."""
    Pe, Gr = Re * Pr, Ra / Pr
    uc, vc = gn.transfer_to(gc, u), gn.transfer_to(gc, v)
    rT = Pe * gc.convection(uc, vc, T) + gc.stiffness(T)
    W, E = gc.side("W"), gc.side("E")
    rT = torch.where(W, T - 0.5, torch.where(E, T + 0.5, rT))
    ru, rv, rc = ns_residual(gn, Re, Gr, u, v, p, T=gc.transfer_to(gn, T))
    return rT, ru, rv, rc


def _fields(gc, gn, state, device):
    t = lambda k, g: torch.as_tensor(np.asarray(state[k]), dtype=F64,
                                     device=device).reshape(g.Ngx, g.Ngy)
    return t("T", gc), t("u", gn), t("v", gn), t("p", gn)


def readings(cfg: dict, params: dict, state: dict, device="cpu") -> dict:
    """The numbers a run compares, for ``state`` = flat ``T, u, v, p`` at
    the request's ``Ra`` (``Re``, ``Pr`` from the request where it gives
    them, else from the configuration): ``residual_rms``, the RMS over the
    ``N_cd + 3 N_ns`` rows of the coupled residual, and ``continuity_rms``,
    the RMS over the ``N_ns`` continuity rows ``rc`` alone."""
    gc, gn = grids(cfg, device)
    r = coupled_residual(gc, gn, *_numbers(cfg, params),
                         *_fields(gc, gn, state, device))
    ss = [float((x * x).sum()) for x in r]
    return {"residual_rms": float(np.sqrt(sum(ss) / (gc.N + 3 * gn.N))),
            "continuity_rms": float(np.sqrt(ss[3] / gn.N))}


def residual_rms(cfg: dict, params: dict, state: dict, device="cpu") -> float:
    """The ``residual_rms`` of :func:`readings`."""
    return readings(cfg, params, state, device)["residual_rms"]


def anchors(cfg: dict, params: dict, state: dict, n_plot: int = 101):
    """de Vahl Davis' anchors ``(u_max·Re·Pr, v_max·Re·Pr)``: the largest
    ``u`` and ``v`` on an ``n_plot × n_plot`` grid of points, scaled by
    ``Re·Pr``."""
    gc, gn = grids(cfg)
    Re, Pr, _ = _numbers(cfg, params)
    xs = np.linspace(0.0, cfg["L_x"], n_plot)
    ys = np.linspace(0.0, cfg["L_y"], n_plot)
    _, u, v, _ = _fields(gc, gn, state, "cpu")
    return (float(gn.evaluate(u, xs, ys).max()) * Re * Pr,
            float(gn.evaluate(v, xs, ys).max()) * Re * Pr)


def plain_state(cfg: dict, params: dict, device="cpu", tol=None):
    """The reference's own coupled solve at a small size: Newton on the
    whole coupled residual with its dense Jacobian, from zero.  Returns flat
    numpy ``T, u, v, p``; for the CPU tests."""
    from portbench.reference.newton import newton

    gc, gn = grids(cfg, device)
    nums = _numbers(cfg, params)
    nc, nn = gc.N, gn.N

    def split(x):
        T = x[:nc].reshape(gc.Ngx, gc.Ngy)
        u, v, p = (x[nc + k * nn:nc + (k + 1) * nn].reshape(gn.Ngx, gn.Ngy)
                   for k in range(3))
        return T, u, v, p

    def F(x):
        return torch.cat([r.reshape(-1) for r in coupled_residual(
            gc, gn, *nums, *split(x))])

    tol = tol if tol is not None else float(cfg["mtol_nonlin"])
    x = newton(F, torch.zeros(nc + 3 * nn, dtype=F64, device=device),
               tol * np.sqrt(nc + 3 * nn)).cpu().numpy()
    return {"T": x[:nc], "u": x[nc:nc + nn], "v": x[nc + nn:nc + 2 * nn],
            "p": x[nc + 2 * nn:]}
