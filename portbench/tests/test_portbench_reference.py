"""The plain references on the CPU at small sizes: they accept a converged
solve of the program, reject the same state perturbed or held in float32
(the control: the nearest precision below the configurations' float64),
and their own solves reproduce the published anchors within the examples'
tolerances (de Vahl Davis 3.649 / 3.697 within 2 % at P4 8×8; Ghia Re=100
within 2e-2 at P4 8×8)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import boussinesq as rb
from portbench.reference import navier_stokes as rn

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
DVD = dict(json.loads((CONFIGS / "dvd_p16.json").read_text()),
           P_cd=4, N_ex_cd=8, N_ey_cd=8, P_ns=4, N_ex_ns=8, N_ey_ns=8)
GHIA = dict(json.loads((CONFIGS / "ghia_p16.json").read_text()),
            P=4, N_ex=8, N_ey=8)
GHIA_Y = np.array([0.0547, 0.1016, 0.2813, 0.4531, 0.5000, 0.7344])
GHIA_U_RE100 = np.array([-0.03717, -0.06434, -0.15662, -0.21090, -0.20581,
                         0.00332])


@pytest.fixture(scope="module")
def dvd_port():
    from sem_tpu_torch.coupling import build_coupled

    keys = ("Re", "Pr", "P_cd", "N_ex_cd", "N_ey_cd", "P_ns", "N_ex_ns",
            "N_ey_ns", "mode", "mtol_nonlin")
    _, _, mda = build_coupled(1.0, 1.0, Ra=1e3, iprint=False, device="cpu",
                              **{k: DVD[k] for k in keys})
    s = mda.solve()
    return {k: getattr(s, k).numpy() for k in "Tuvp"}


@pytest.fixture(scope="module")
def ghia_port():
    from sem_tpu_torch import NavierStokesSolver

    ns = NavierStokesSolver(1.0, 1.0, Re=100.0, Gr=0.0, P=4, N_ex=8, N_ey=8,
                            u_N=1.0, mtol=GHIA["mtol"],
                            mtol_newton=GHIA["mtol_newton"], iprint=[],
                            device="cpu")
    u, v, p = ns._get_solution(torch.zeros(ns.N, dtype=torch.float64))
    return {"u": u.numpy(), "v": v.numpy(), "p": p.numpy()}


def f32(state):
    return {k: v.astype(np.float32).astype(np.float64)
            for k, v in state.items()}


def test_dvd_accepts_the_programs_solve(dvd_port):
    assert rb.residual_rms(DVD, {"Ra": 1e3}, dvd_port) \
        <= DVD["limits"]["residual_rms"]


def test_dvd_rejects_perturbed_wrong_ra_and_f32(dvd_port):
    lim = DVD["limits"]["residual_rms"]
    bad = dict(dvd_port, u=dvd_port["u"] * (1 + 1e-3))
    assert rb.residual_rms(DVD, {"Ra": 1e3}, bad) > 10 * lim
    assert rb.residual_rms(DVD, {"Ra": 1.05e3}, dvd_port) > 10 * lim
    # the control: the converged answer held in float32 (at P16 64×64 it
    # reads 2.1-2.3 times the limit, as it does here), and above the
    # continuity rows' limit, which the converged answer keeps
    assert rb.residual_rms(DVD, {"Ra": 1e3}, f32(dvd_port)) > lim
    lim_c = DVD["limits"]["continuity_rms"]
    assert rb.readings(DVD, {"Ra": 1e3}, f32(dvd_port))["continuity_rms"] \
        > lim_c
    assert rb.readings(DVD, {"Ra": 1e3}, dvd_port)["continuity_rms"] <= lim_c


def test_dvd_own_solve_gives_de_vahl_davis(dvd_port):
    ref = rb.plain_state(DVD, {"Ra": 1e3})
    u, v = rb.anchors(DVD, {"Ra": 1e3}, ref)
    assert abs(u - 3.649) < 0.02 * 3.649 and abs(v - 3.697) < 0.02 * 3.697
    assert rb.anchors(DVD, {"Ra": 1e3}, dvd_port) == pytest.approx(
        (u, v), rel=1e-5)


def test_ghia_accepts_the_programs_solve(ghia_port):
    assert rn.residual_rms(GHIA, {"Re": 100.0}, ghia_port) \
        <= GHIA["limits"]["residual_rms"]


def test_ghia_rejects_perturbed_and_f32(ghia_port):
    lim = GHIA["limits"]["residual_rms"]
    bad = dict(ghia_port, v=ghia_port["v"] + 1e-9)
    assert rn.residual_rms(GHIA, {"Re": 100.0}, bad) > 10 * lim
    assert rn.residual_rms(GHIA, {"Re": 101.0}, ghia_port) > 10 * lim
    assert rn.residual_rms(GHIA, {"Re": 100.0}, f32(ghia_port)) > 3 * lim


def test_ghia_own_solve_gives_ghia():
    ref = rn.plain_state(GHIA, {"Re": 100.0})
    g = rn.grid(GHIA)
    U = torch.as_tensor(ref["u"]).reshape(g.Ngx, g.Ngy)
    u_line = g.evaluate(U, np.array([0.5]), GHIA_Y)[0]
    assert np.max(np.abs(u_line - GHIA_U_RE100)) < 2e-2
