"""Helpers that the per-layer metric readers (``metrics/<name>.py``) share.

A reader is a module with ``read(run) -> float | None``; ``run`` is the
harness's :class:`portbench.run.RunRecord`.  A reader that finds nothing to
read returns ``None`` and the harness leaves its metric out of the line.
"""
from __future__ import annotations

__all__ = ["mean", "mean_stat"]


def mean(values):
    values = [float(v) for v in values if v is not None]
    return sum(values) / len(values) if values else None


def mean_stat(run, key):
    """Mean over the window's requests of the program counter ``key``."""
    return mean(r["stats"].get(key) for r in run.records if r["stats"])
