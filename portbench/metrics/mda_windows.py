"""MDA engine: the device windows of coupled GMRES a request ran
(counter ``mda.windows``)."""
from portbench.readers import mean_stat


def read(run):
    return mean_stat(run, "mda.windows")
