"""MDA engine: ``MDAStats.gmres_iters`` (coupled GMRES iterations) per
request."""
from portbench.readers import mean_stat


def read(run):
    return mean_stat(run, "gmres_iters")
