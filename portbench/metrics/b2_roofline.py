"""Kernel B2: share of its roofline, in %: the least time of one launch on
the configuration's NS grid (``yardstick.b2_bound_s``: bytes over the HBM
rate) over the mean device time of B2's f32 launches in the trace."""
from portbench.yardstick import b2_bound_s


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.select(lambda name: "coupled_system_kernel" in name)
    if n == 0 or seconds <= 0:
        return None
    bound, _ = b2_bound_s(*run.kernel_grids["b2"])
    return 100.0 * bound / (seconds / n)
