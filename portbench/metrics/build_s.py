"""Construction: the harness's span around the constructor call of each
request (``build_coupled``, ``NavierStokesSolver``), mean per request, in
seconds of the host clock."""
from portbench.readers import mean


def read(run):
    return mean(r["spans"].get("build") for r in run.records)
