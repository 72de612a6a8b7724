"""Kernel B2: wrapper calls per request (``kernels.LAUNCHES``, f32 and
bf16), one per f32 inner iteration of the NS solves; launches replayed
inside a CUDA graph are not counted."""
from portbench.readers import mean


def read(run):
    return mean(r["launches"]["apply_coupled_system"]
                + r["launches"]["apply_coupled_system_bf16"]
                for r in run.records if r["launches"] is not None)
