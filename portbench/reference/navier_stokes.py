"""Plain reference of the steady Navier-Stokes (Boussinesq momentum)
residual, and of the lid-driven cavity configuration.

The discrete equations, on the nodes of a :class:`~portbench.reference.sem.Grid`::

    ru = K u + Re (u Gx u + v Gy u) + Gx p
    rv = K v + Re (u Gx v + v Gy v) + Gy p − (Gr/Re) M T
    rc = Gx u + Gy v

with, on every wall node, the Dirichlet rows ``u − u_wall``, ``v − v_wall``
(no normal flow; the tangential values of sides W, E, S, N set in that
order, so the lid's value holds at its corners) and the pressure rows
``K p`` (homogeneous Neumann), and at the centre node (flat index
``⌊N/2⌋``) the pressure pin ``p``.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.sem import F64, Grid, make_grid

__all__ = ["ns_residual", "residual_rms", "readings", "grid", "plain_state"]


def ns_residual(g: Grid, Re: float, Gr: float, u, v, p, T=None,
                walls=None):
    """(ru, rv, rc) as ``(Ngx, Ngy)`` fields; ``walls`` maps ``u_S``,
    ``u_N``, ``v_W``, ``v_E`` to the tangential wall values (0 if left
    out)."""
    walls = walls or {}
    conv = lambda w: Re * g.convection(u, v, w)
    ru = g.stiffness(u) + conv(u) + g.grad_x(p)
    rv = g.stiffness(v) + conv(v) + g.grad_y(p)
    if T is not None and Gr != 0.0:
        rv = rv - (Gr / Re) * g.mass(T)
    rc = g.grad_x(u) + g.grad_y(v)
    ud = torch.zeros_like(u)
    vd = torch.zeros_like(v)
    wall = torch.zeros_like(u, dtype=torch.bool)
    for side, uval, vval in (("W", 0.0, walls.get("v_W", 0.0)),
                             ("E", 0.0, walls.get("v_E", 0.0)),
                             ("S", walls.get("u_S", 0.0), 0.0),
                             ("N", walls.get("u_N", 0.0), 0.0)):
        m = g.side(side)
        ud = torch.where(m, torch.full_like(ud, uval), ud)
        vd = torch.where(m, torch.full_like(vd, vval), vd)
        wall = wall | m
    ru = torch.where(wall, u - ud, ru)
    rv = torch.where(wall, v - vd, rv)
    rc = torch.where(wall, g.stiffness(p), rc)
    pin = torch.zeros(g.N, dtype=torch.bool, device=u.device)
    pin[g.N // 2] = True
    pin = pin.reshape(g.Ngx, g.Ngy)
    rc = torch.where(pin, p, rc)
    return ru, rv, rc


def grid(cfg: dict, device="cpu") -> Grid:
    return make_grid(cfg["P"], cfg["N_ex"], cfg["N_ey"], cfg["L_x"],
                     cfg["L_y"], str(device))


def _walls(cfg):
    return {k: float(cfg.get(k, 0.0)) for k in ("u_S", "u_N", "v_W", "v_E")}


def readings(cfg: dict, params: dict, state: dict, device="cpu") -> dict:
    """The numbers a run compares, for ``state`` = flat ``u``, ``v``, ``p``
    of the standalone NS problem of ``cfg`` (``Gr`` = 0 unless the
    configuration gives one) at the request's ``Re``: ``residual_rms``, the
    RMS over the ``3N`` rows of the residual, and ``continuity_rms``, the
    RMS over the ``N`` continuity rows ``rc`` alone."""
    g = grid(cfg, device)
    f = {k: torch.as_tensor(np.asarray(state[k]), dtype=F64,
                            device=device).reshape(g.Ngx, g.Ngy)
         for k in ("u", "v", "p")}
    Re = float(params["Re"])
    r = ns_residual(g, Re, float(cfg.get("Gr", 0.0)), f["u"], f["v"], f["p"],
                    walls=_walls(cfg))
    ss = [float((x * x).sum()) for x in r]
    return {"residual_rms": float(np.sqrt(sum(ss) / (3 * g.N))),
            "continuity_rms": float(np.sqrt(ss[2] / g.N))}


def residual_rms(cfg: dict, params: dict, state: dict, device="cpu") -> float:
    """The ``residual_rms`` of :func:`readings`."""
    return readings(cfg, params, state, device)["residual_rms"]


def plain_state(cfg: dict, params: dict, device="cpu", tol=None):
    """The reference's own solve of the configuration at a small size:
    Newton with the dense Jacobian of the residual (forward-mode autograd)
    and a dense linear solve, from zero.  Returns flat numpy ``u, v, p``;
    for the CPU tests (it does not scale past a few thousand unknowns)."""
    from portbench.reference.newton import newton

    g = grid(cfg, device)
    Re = float(params["Re"])
    walls = _walls(cfg)
    n = g.N

    def F(x):
        u, v, p = (x[k * n:(k + 1) * n].reshape(g.Ngx, g.Ngy)
                   for k in range(3))
        return torch.cat([r.reshape(-1) for r in ns_residual(
            g, Re, float(cfg.get("Gr", 0.0)), u, v, p, walls=walls)])

    tol = tol if tol is not None else float(cfg["mtol_newton"])
    x = newton(F, torch.zeros(3 * n, dtype=F64, device=device),
               tol * np.sqrt(3 * n))
    x = x.cpu().numpy()
    return {"u": x[:n], "v": x[n:2 * n], "p": x[2 * n:]}
