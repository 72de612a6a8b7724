"""Entry of the coupled Boussinesq configurations whose requests also report
the program's own counters: the request of
:mod:`portbench.entries.boussinesq`, with the difference of
``sem_tpu_torch.utils.profiling.counters()`` over it added to its stats under
the counters' names (``mda.windows``, ``mda.window_precon.cd_its``, ...).  A
counter that the program does not keep, or has not moved yet in this
process, is absent from the stats, and a reader of it returns None."""
from __future__ import annotations

from portbench.entries import boussinesq


class Entry(boussinesq.Entry):
    def solve(self, params: dict, start, span):
        from sem_tpu_torch.utils.profiling import counters

        before = counters()
        state, stats = super().solve(params, start, span)
        stats.update((k, v - before.get(k, 0))
                     for k, v in counters().items())
        return state, stats
