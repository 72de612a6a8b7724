"""PTC controller: rejected pseudo-time step attempts per request, for a
blow-up of the residual or a failed linear solve that raised it
(``MDAStats.ptc_rejected``)."""
from portbench.readers import mean_stat


def read(run):
    return mean_stat(run, "ptc_rejected")
