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

``make_group(ranks=, dcn=)`` is the counterpart of ``make_mesh(devices=,
dcn=)``: a group over some of the default group's ranks, and the two-level
layout over hosts.  ``sem_tpu`` states that its ``('dcn', 'x')`` mesh is
numerically identical to the flat one; the port keeps the flat row strips,
in a rank order that is contiguous per host, and records the factorization
in :attr:`Group.hosts`.  Not ported: ``place`` and ``constrain`` (they only
steer GSPMD).
"""
from __future__ import annotations

import contextlib
import socket
import threading

import torch

__all__ = ["Group", "make_group", "use_group", "active_group", "row_strips"]

_state = threading.local()


class Group:
    """Ranks of ``torch.distributed``'s default process group that solve
    together, and the two collectives the decomposed solves use (tests
    substitute a fake).

    :param members: the default-group ranks in strip order (all of them by
        default); this process must be one of them
    :param pg: their process group (``None``: the default group)
    :param hosts: the two-level factorization, one tuple of ranks per host,
        or ``None`` for a flat group
    """

    def __init__(self, members=None, pg=None, hosts=None):
        import torch.distributed as dist

        if members is None:
            members = range(dist.get_world_size())
        self.members = [int(m) for m in members]
        self.rank = self.members.index(dist.get_rank())
        self.world = len(self.members)
        self.pg, self.hosts = pg, hosts
        self.backend = str(dist.get_backend(pg))
        # a process group orders its ranks by default-group rank; the
        # strips follow ``members``
        by_pg = sorted(self.members)
        self._order = [by_pg.index(m) for m in self.members]

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (equal shapes), in strip order."""
        import torch.distributed as dist

        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t, group=self.pg)
        return [out[i] for i in self._order]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, in place; returns ``t``."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.pg)
        return t


def make_group(ranks=None, dcn: bool = None):
    """The group of the default-group ``ranks`` (all by default) that take
    part in a decomposed solve (see
    :func:`sem_tpu_torch.parallel.init_distributed`).  Every rank of the
    default group calls it, as ``torch.distributed.new_group`` requires; a
    rank outside ``ranks`` gets ``None``.

    :param dcn: the two-level layout over hosts (``socket.gethostname()``
        of each rank): ``None`` turns it on when the ranks span more than
        one host and their counts per host are even; ``True`` raises
        ``ValueError`` when only one host takes part or the counts per host
        are uneven.  It orders the strips host by host and records the
        hosts in :attr:`Group.hosts`; the arithmetic is the flat group's
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_group: torch.distributed is not initialized "
                           "(call sem_tpu_torch.parallel.init_distributed)")
    world = dist.get_world_size()
    members = list(range(world)) if ranks is None else sorted(
        {int(r) for r in ranks})
    if not members or not all(0 <= r < world for r in members):
        raise ValueError(f"make_group: ranks {ranks} are not a non-empty "
                         f"subset of the {world} ranks")
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    by_host = {}
    for r in members:
        by_host.setdefault(names[r], []).append(r)
    explicit = dcn is not None
    if dcn is None:
        dcn = len(by_host) > 1
    hosts = None
    if dcn and len(by_host) > 1:
        if len({len(v) for v in by_host.values()}) == 1:
            hosts = tuple(tuple(v) for v in by_host.values())
            members = [r for v in hosts for r in v]
        elif explicit:
            raise ValueError(
                f"make_group(dcn=True): cannot factor {len(members)} ranks "
                f"by host, the counts per host are uneven: "
                f"{ {h: len(v) for h, v in by_host.items()} }")
    elif dcn and explicit:
        raise ValueError("make_group(dcn=True): only one host takes part; "
                         "there is no host boundary to factor")
    pg = None if len(members) == world else dist.new_group(sorted(members))
    if dist.get_rank() not in members:
        return None
    return Group(members, pg, hosts)


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
    ``P`` rows per side.  ``P`` does not bound the split: a strip may be
    thinner than ``P`` rows, and :meth:`sem_tpu_torch.ops.RowStrips.exchange`
    then cuts its halos from as many ranks as hold them.

    A strip may not be empty: ``R > Ngx`` raises ``ValueError``.
    ``sem_tpu``'s mesh replicates a field that does not divide over its
    devices; the port does not, since a kernel's row window needs at least
    one row (``r0 < r1``, ``Window::covered`` in ``csrc/tile.cuh``).  Build
    the group over at most ``Ngx`` ranks (``make_group(ranks=)``).
    """
    if R > Ngx:
        raise ValueError(f"row strips of a {Ngx}-row grid over {R} ranks: "
                         f"{R - Ngx} would be empty, and every rank needs "
                         f"at least one row")
    base, extra = divmod(int(Ngx), int(R))
    bounds, r0 = [], 0
    for r in range(R):
        r1 = r0 + base + (r < extra)
        bounds.append((r0, r1))
        r0 = r1
    return bounds
