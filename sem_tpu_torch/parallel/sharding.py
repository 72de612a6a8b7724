"""Rank groups and the row-strip layout of the decomposed solves.

Counterpart of ``sem_tpu.parallel.sharding``.  There, GSPMD shards every
field over a device mesh and XLA inserts the collectives.  Torch has no GSPMD,
so the port decomposes explicitly, and only where the sharded kernels act: the
float32 Krylov chunks of the CD and NS solvers.  Rank ``r`` of ``R`` owns a
contiguous block of rows of the ``(Ngx, Ngy)`` grid (:func:`row_strips`);
everything outside the chunks stays replicated on every rank.

Wrap a region in ``use_group(make_group())`` and the solvers built or run in
it take the decomposed chunks (``sem_tpu_torch.ops.sharded``); with no active
group, or a group of one rank, they run the single-device code unchanged.
Not ported: ``place`` and ``constrain`` (they only steer GSPMD) and the
two-level ``('dcn', 'x')`` mesh (a torch group is flat).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["Group", "make_group", "use_group", "active_group", "row_strips"]

_state = threading.local()


class Group:
    """The flat group of every rank of ``torch.distributed``'s default
    process group: its rank, size and backend, and the two collectives the
    decomposed solves use (tests substitute a fake)."""

    def __init__(self):
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = str(dist.get_backend())

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (equal shapes), in rank order."""
        import torch.distributed as dist

        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, in place; returns ``t``."""
        import torch.distributed as dist

        dist.all_reduce(t)
        return t


def make_group() -> Group:
    """The group of every rank of the default process group (see
    :func:`sem_tpu_torch.parallel.init_distributed`)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_group: torch.distributed is not initialized "
                           "(call sem_tpu_torch.parallel.init_distributed)")
    return Group()


def active_group():
    return getattr(_state, "group", None)


@contextlib.contextmanager
def use_group(group):
    """Activate ``group``: the solvers decompose their f32 chunks over it."""
    prev = active_group()
    _state.group = group
    try:
        yield group
    finally:
        _state.group = prev


def row_strips(Ngx: int, R: int, P: int) -> list:
    """Near-equal contiguous row strips ``[(r0, r1), ...]`` of an ``Ngx``-row
    grid over ``R`` ranks (the first ``Ngx % R`` strips take one row more).

    The C0 operators couple rows up to ``P`` apart, so a strip's halo is
    ``P`` rows per side and has to come from its two neighbours alone: a
    strip thinner than ``P`` rows raises ``ValueError``.
    """
    base, extra = divmod(int(Ngx), int(R))
    if base < P:
        raise ValueError(f"row strips of a {Ngx}-row grid over {R} ranks are "
                         f"{base} rows thin, under the halo width P={P}")
    bounds, r0 = [], 0
    for r in range(R):
        r1 = r0 + base + (r < extra)
        bounds.append((r0, r1))
        r0 = r1
    return bounds
