"""Dense operators and preconditioners: device milliseconds per request of
the traced kernels whose names hold ``gemm`` (cuBLAS: the FDM and Schur
eigenbasis products, the dense operators)."""


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.select(lambda name: "gemm" in name.lower())
    return 1e3 * seconds / len(run.traced) if n else None
