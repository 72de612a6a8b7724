"""Device: idle share in %, 1 − (device busy time of the traced requests) /
(the untraced wall of the same requests, same parameters and start states,
in the measured window of the same process)."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    wall = sum(run.records[i]["wall_s"] for i in run.traced)
    return 100.0 * (1.0 - run.trace.busy_s / wall) if wall > 0 else None
