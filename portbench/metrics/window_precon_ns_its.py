"""Discipline solvers: GMRES iterations of the float64 NS solves nested in
the device windows' preconditioner, per request (counter
``mda.window_precon.ns_its``)."""
from portbench.readers import mean_stat


def read(run):
    return mean_stat(run, "mda.window_precon.ns_its")
