"""Entry of the standalone Navier-Stokes configurations: a request builds
``NavierStokesSolver`` at its own Re (a constructor argument) and runs the
Newton solve that ``NavierStokesSolver.run`` makes, ``_get_solution`` at
T = 0, from zero or from the start state the traffic gives it."""
from __future__ import annotations

import torch

BUILD_KEYS = ("Gr", "P", "N_ex", "N_ey", "u_N", "mtol", "mtol_newton",
              "schur_precon")
FIELDS = ("u", "v", "p")


class Entry:
    solve_span = "ns.solve"

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)

    def kernel_grids(self) -> dict:
        c = self.cfg
        return {"b2": (c["P"], c["N_ex"], c["N_ey"])}

    def solve(self, params: dict, start, span):
        from sem_tpu_torch import NavierStokesSolver

        kw = {k: self.cfg[k] for k in BUILD_KEYS}
        with span("build"):
            ns = NavierStokesSolver(self.cfg["L_x"], self.cfg["L_y"],
                                    Re=params["Re"], iprint=[],
                                    device=self.device, **kw)
        with span(self.solve_span):
            T = torch.zeros(ns.N, dtype=torch.float64, device=self.device)
            u, v, p = ns._get_solution(T, *(start or (None,) * 3))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return (u, v, p), {"ns_solves": ns._k, "newton_steps": ns._k}

    @staticmethod
    def to_host(state) -> dict:
        return {k: f.cpu().numpy() for k, f in zip(FIELDS, state)}

    def to_device(self, host: dict):
        return tuple(torch.as_tensor(host[k], device=self.device)
                     for k in FIELDS)
