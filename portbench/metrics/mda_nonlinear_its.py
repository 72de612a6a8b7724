"""MDA engine: ``MDAStats.nonlinear_iters`` per request."""
from portbench.readers import mean_stat


def read(run):
    return mean_stat(run, "nonlinear_iters")
