"""Tracing / profiling utilities: counterparts of ``sem_tpu.utils.profiling``.

* :class:`PhaseTimer`: named wall-clock spans with a report, in the
  reference's format; on a machine with a CUDA card each span edge
  synchronizes the device, so a span holds the device work it enqueued;
* :func:`trace`: a ``torch.profiler`` trace (CPU and, where there is a card,
  CUDA activities) of the enclosed region, written into a directory as a
  Chrome trace that TensorBoard or Perfetto open.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["PhaseTimer", "trace"]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class PhaseTimer:
    """Named wall-clock phase accumulator.

    >>> timer = PhaseTimer()
    >>> with timer("assembly"): ...
    >>> with timer("solve"): ...
    >>> timer.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, out=print):
        width = max((len(k) for k in self.totals), default=0)
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            out(f"{name:<{width}}  {total:10.3f}s  x{self.counts[name]}")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``logdir`` (``<host>_<pid>.<time>.pt.trace.json``); yields the profiler,
    whose ``key_averages()`` hold the per-operator sums."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
