"""Discipline solvers: NS linear solves per request (``MDAStats.ns_solves``
of a coupled solve; the Newton steps ``_k`` of a standalone NS solve)."""
from portbench.readers import mean_stat


def read(run):
    return mean_stat(run, "ns_solves")
