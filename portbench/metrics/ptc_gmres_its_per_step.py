"""MDA engine: coupled FGMRES iterations per PTC step attempt,
``gmres_iters / (ptc_accepted + ptc_rejected)`` of each request's
``MDAStats``, then the mean over the requests."""
from portbench.readers import mean


def per_step(stats: dict):
    attempts = stats.get("ptc_accepted", 0) + stats.get("ptc_rejected", 0)
    return stats["gmres_iters"] / attempts if attempts else None


def read(run):
    return mean(per_step(r["stats"]) for r in run.records if r["stats"])
