"""Spans of the harness and the reading of a device trace.

:class:`Spans` records host-clock spans around the calls into the program
(``build``, the solve).  While a trace is taken it also enqueues one marker
kernel (``torch.cuda._sleep``, ``spin_kernel`` in the trace) at every span
edge, so that the device timeline can be cut by what the host was doing.

:func:`profile_device` runs a function under ``torch.profiler`` with CUDA
activities only (the CPU activities slow the host-driven solve about
elevenfold) and returns the device events, read in memory: nothing is
written to disk.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

__all__ = ["Spans", "profile_device", "DeviceTrace", "MARKER"]

#: name of the marker kernel in the trace
MARKER = "spin_kernel"


class Spans:
    """Named host-clock spans of one request at a time."""

    def __init__(self):
        self.current = defaultdict(float)
        self.edges = []        # (span name or None, t) at each marked edge
        self.marking = False   # enqueue a marker kernel at each edge
        self.stack = []

    def reset(self):
        self.current = defaultdict(float)

    def _mark(self, name):
        if self.marking:
            import torch

            torch.cuda._sleep(1)
            self.edges.append(name)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.stack.append(name)
        self._mark(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.current[name] += time.perf_counter() - t0
            self.stack.pop()
            self._mark(self.stack[-1] if self.stack else "harness")


def _event_times(e):
    """(start, end) in seconds of a kineto event, across torch versions."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        d = e.end_ns() - s if hasattr(e, "end_ns") else e.duration_ns()
        return s * 1e-9, (s + d) * 1e-9
    s = e.start_us()
    return s * 1e-6, (s + e.duration_us()) * 1e-6


def profile_device(fn):
    """``fn()`` under the profiler (CUDA activities); returns ``(result,
    events)`` with ``events`` a list of ``(name, start_s, end_s)`` of the
    operations that ran on the device, sorted by start."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        s, t = _event_times(e)
        events.append((e.name(), s, t))
    events.sort(key=lambda x: x[1])
    return out, events


class DeviceTrace:
    """What a traced window's device events say.

    :param events: ``(name, start_s, end_s)`` sorted by start, markers
        included
    :param edges: the span opened (or returned to) at each marker, in order
    :param wall_s: host wall of the traced window
    """

    def __init__(self, events, edges, wall_s: float):
        self.wall_s = float(wall_s)
        markers = [e for e in events if MARKER in e[0]]
        self.ops = [e for e in events if MARKER not in e[0]]
        self.labelled = len(markers) == len(edges) and len(edges) > 0
        # the span each op was enqueued in: the last marker before it
        labels, mi = [], 0
        for name, s, _ in self.ops:
            while mi < len(markers) and markers[mi][1] <= s:
                mi += 1
            labels.append(edges[mi - 1] if self.labelled and mi > 0
                          else "unlabelled")
        self.labels = labels
        # busy time: the union of the ops' intervals (markers left out)
        busy, end = 0.0, None
        for _, s, t in sorted(self.ops, key=lambda x: x[1]):
            if end is None or s > end:
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        self.busy_s = busy

    def kernel_seconds(self) -> dict:
        out = defaultdict(float)
        for name, s, t in self.ops:
            out[name] += t - s
        return dict(out)

    def select(self, pred):
        """(count, seconds) of the ops whose name satisfies ``pred``."""
        sel = [t - s for name, s, t in self.ops if pred(name)]
        return len(sel), float(sum(sel))

    def idle_gaps(self):
        """``(label, seconds)`` of every gap between consecutive ops, the
        label being the span that enqueued the op after the gap."""
        gaps, end = [], None
        for (name, s, t), lab in zip(self.ops, self.labels):
            if end is not None and s > end:
                gaps.append((lab, s - end))
            end = t if end is None else max(end, t)
        return gaps
