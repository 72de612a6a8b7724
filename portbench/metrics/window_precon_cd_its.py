"""Discipline solvers: GMRES iterations of the float64 CD solves nested in
the device windows' preconditioner, per request (counter
``mda.window_precon.cd_its``)."""
from portbench.readers import mean_stat


def read(run):
    return mean_stat(run, "mda.window_precon.cd_its")
