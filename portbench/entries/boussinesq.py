"""Entry of the coupled Boussinesq configurations: a request builds the
solvers at its own Ra (``build_coupled``, which takes Re, Ra and Pr as
constructor arguments) and runs ``BoussinesqMDA.solve`` from zero or from
the start state the traffic gives it."""
from __future__ import annotations

import dataclasses

import torch

# configuration keys that pass to build_coupled as they stand
BUILD_KEYS = ("Re", "Pr", "P_cd", "N_ex_cd", "N_ey_cd", "P_ns", "N_ex_ns",
              "N_ey_ns", "mode", "mtol_nonlin")
FIELDS = ("T", "u", "v", "p")


class Entry:
    solve_span = "mda.solve"

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)

    def kernel_grids(self) -> dict:
        """(P, N_ex, N_ey) of the grid each kernel runs on."""
        c = self.cfg
        return {"b2": (c["P_ns"], c["N_ex_ns"], c["N_ey_ns"])}

    def solve(self, params: dict, start, span):
        from sem_tpu_torch.coupling import build_coupled

        kw = {k: self.cfg[k] for k in BUILD_KEYS}
        kw.update({k: params[k] for k in ("Re", "Pr", "Ra") if k in params})
        with span("build"):
            _, _, mda = build_coupled(self.cfg["L_x"], self.cfg["L_y"],
                                      iprint=False, device=self.device, **kw)
        with span(self.solve_span):
            s = mda.solve(start)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return s, dataclasses.asdict(mda.stats)

    @staticmethod
    def to_host(state) -> dict:
        return {k: getattr(state, k).cpu().numpy() for k in FIELDS}

    def to_device(self, host: dict):
        from sem_tpu_torch.coupling.mda import CoupledState

        return CoupledState(*(torch.as_tensor(host[k], device=self.device)
                              for k in FIELDS))
