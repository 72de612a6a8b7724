"""PTC controller: accepted pseudo-time steps per request
(``MDAStats.ptc_accepted``)."""
from portbench.readers import mean_stat


def read(run):
    return mean_stat(run, "ptc_accepted")
