"""Tracing / profiling utilities: counterparts of ``sem_tpu.utils.profiling``,
and the port's own spans and counters on its solve path.

* :func:`span`: a named host-clock interval around a piece of the program
  (``mda.newton``, ``ns.chunk``, ``krylov.capture``, ``build.host``, ...).
  Its edges never synchronize the device.  While tracing is off
  (:func:`enable`, :func:`disable`) it returns one shared no-op object;
  while it is on, each span closed is logged as a :class:`SpanRecord`
  whose times are ``time.time_ns()``, the clock of ``torch.profiler``'s
  events, so the program's spans lie on a device trace's timeline as they
  are.
  :func:`take_spans` returns the log and clears it.  The nesting depth is
  counted per thread (``solve_continued`` builds the next level in a worker
  thread while the main thread solves);
* :func:`read`: the one way the solve path brings a device value to the
  host (``t.tolist()``), counted under ``reads.<site>`` and, while tracing
  is on, wrapped in the span ``read.<site>``;
* :data:`COUNTERS`: the program's own counters (``reads.<site>``,
  ``ns.inner_its``, ``krylov.captures``, ``krylov.replays``,
  ``mda.captures``, ``mda.replays``, ``ptc.*``, ``mda.windows``,
  ``mda.window_precon.*``,
  ``build.cache_hits``, ``build.cache_misses``), always on:
  one integer increment each.
  :func:`counters` is a flat snapshot of them and of
  ``ops.kernels.LAUNCHES`` and ``ops.sharded.COLLECTIVES``;
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
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

__all__ = ["PhaseTimer", "trace", "span", "read", "enable", "disable",
           "take_spans", "counters", "COUNTERS", "SpanRecord"]

#: the program's own counters since the process started (``reads.<site>``:
#: host reads by site; ``ns.inner_its``: iterations of the NS f32 chunks;
#: ``krylov.captures``, ``krylov.replays``: CUDA graphs of the plain f32
#: chunks' operators captured and replayed, ``krylov.CapturedOperator``;
#: ``mda.captures``, ``mda.replays``: the same of the MDA's fused
#: host-FGMRES programs, ``start`` and ``step`` (``krylov.CapturedProgram``);
#: ``ptc.<outcome>``: the coupled PTC march's step attempts, ``accepted``,
#: ``partial``, ``rejects.blowup``, ``rejects.linfail``;
#: ``mda.windows``: the MDA's device windows; ``mda.window_precon.cd_its``,
#: ``mda.window_precon.ns_its``: GMRES iterations of the float64 discipline
#: solves nested in the windows' preconditioner;
#: ``build.cache_hits``, ``build.cache_misses``: grids, FDM solvers and
#: spectral Schur data a constructor asked ``sem_tpu_torch.build_cache``
#: for, found there or built)
COUNTERS = defaultdict(int)

_on = False
_log = []     # closed spans while tracing is on (list.append holds the GIL)


class SpanRecord(NamedTuple):
    """One closed span: ``start``/``end`` on the span's clock (ns of
    ``time.time_ns()`` for :func:`span`), ``depth`` the spans open on the
    same thread when it opened."""

    name: str
    thread: int
    start: int
    end: int
    depth: int


class _Depth(threading.local):
    n = 0


_depth = _Depth()


class _Span:
    """An open interval: stamps ``clock()`` on entry and exit (after
    ``edge()``, where given) and hands its :class:`SpanRecord` to ``sink``."""

    __slots__ = ("name", "sink", "clock", "edge", "t0", "depth")

    def __init__(self, name, sink, clock, edge=None):
        self.name, self.sink, self.clock, self.edge = name, sink, clock, edge

    def __enter__(self):
        self.depth = _depth.n
        _depth.n += 1
        if self.edge is not None:
            self.edge()
        self.t0 = self.clock()
        return self

    def __exit__(self, *exc):
        if self.edge is not None:
            self.edge()
        t1 = self.clock()
        _depth.n -= 1
        self.sink(SpanRecord(self.name, threading.get_ident(), self.t0, t1,
                             self.depth))
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager timing the enclosed piece of the program as span
    ``name`` while tracing is on; the shared no-op otherwise."""
    if not _on:
        return _NO_SPAN
    return _Span(name, _log.append, time.time_ns)


def read(t: torch.Tensor, site: str):
    """``t.tolist()``: a host read of the solve path, counted under
    ``reads.<site>`` and timed as span ``read.<site>`` while tracing is on
    (the span holds the wait for the device)."""
    COUNTERS["reads." + site] += 1
    if not _on:
        return t.tolist()
    with _Span("read." + site, _log.append, time.time_ns):
        return t.tolist()


def enable():
    """Log every span closed from now on."""
    global _on
    _on = True


def disable():
    """Stop logging spans (the log is kept until :func:`take_spans`)."""
    global _on
    _on = False


def take_spans() -> list:
    """The :class:`SpanRecord` s closed since the last call, in the order
    they closed; the log is cleared."""
    out = _log[:]
    del _log[:len(out)]
    return out


def counters() -> dict:
    """A flat snapshot of every counter the program keeps:
    ``launches.<wrapper>`` (``ops.kernels.LAUNCHES``),
    ``collectives.<kind>`` (``ops.sharded.COLLECTIVES``) and
    :data:`COUNTERS` under their own names."""
    from sem_tpu_torch.ops.kernels import LAUNCHES
    from sem_tpu_torch.ops.sharded import COLLECTIVES

    out = {f"launches.{k}": v for k, v in LAUNCHES.items()}
    out.update((f"collectives.{k}", v) for k, v in COLLECTIVES.items())
    out.update(COUNTERS)
    return out


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class PhaseTimer:
    """Named wall-clock phase accumulator (spans of :func:`span`'s kind on
    ``time.perf_counter``, each edge synchronizing the device).

    >>> timer = PhaseTimer()
    >>> with timer("assembly"): ...
    >>> with timer("solve"): ...
    >>> timer.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def _add(self, rec: SpanRecord):
        self.totals[rec.name] += rec.end - rec.start
        self.counts[rec.name] += 1

    def __call__(self, name: str):
        return _Span(name, self._add, time.perf_counter, _sync)

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
