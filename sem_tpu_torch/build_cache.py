"""The process's registry of the construction products that depend on a
grid's configuration alone.

A solver constructor asks it for the :class:`~sem_tpu_torch.mesh.Grid2D` of
a configuration (:func:`grid`), the :class:`~sem_tpu_torch.fdm.FDM2D` of a
grid, Dirichlet sides and shift (:func:`fdm`) and any other owner of grid
constants (:func:`get`: the spectral Schur data of
:mod:`sem_tpu_torch.models.navier_stokes`).  A later build with the same key
gets the same object, and with it every device constant that an earlier
solve cached on it (:func:`~sem_tpu_torch.utils.tensors.device_const`), so a
sweep over Re or Ra builds and uploads each grid's constants once per
process.  What depends on the problem (Re, Ra, Pr, boundary values, the
pressure pin, σ, the linearization, the MDA and its graphs) stays on each
solver.

* **Bounded**: an LRU over whole grid configurations, at most
  :data:`MAX_GRIDS` of them (a coupled build holds two grids, the level a
  continuation builds ahead two more).  An evicted configuration's owners
  go with the last solver that holds them; :func:`clear` drops every entry.
* **Device memory outlives the solvers**: the entries keep their device
  constants on the card after every solver that used them is gone (about
  0.4 GB for de Vahl Davis' NS P16 64×64 and CD P16 32×32 grids, most of it
  the spectral Schur block); :func:`clear` is how a process gives it back.
* **Read-only host arrays**: every NumPy array the shared owners keep is
  made read-only, so a stray in-place write raises instead of changing the
  next build's answer; the solvers write only into tensors they make.
* **One lock**: ``solve_continued`` builds the next level in a worker
  thread while the main thread solves.  An owner is built under the lock,
  and :func:`~sem_tpu_torch.utils.tensors.device_const` publishes a device
  copy only once it is complete on the card.
* **Counters** ``build.cache_hits`` and ``build.cache_misses``
  (:data:`~sem_tpu_torch.utils.profiling.COUNTERS`): one count per owner
  asked for.
"""
from __future__ import annotations

import threading
import typing
from collections import OrderedDict

from sem_tpu_torch.fdm import FDM2D
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.utils.profiling import COUNTERS

__all__ = ["MAX_GRIDS", "grid", "fdm", "get", "clear"]

#: grid configurations kept at once: the two grids of a coupled build and
#: the two of the level ``solve_continued`` builds ahead of it
MAX_GRIDS = 4

_lock = threading.Lock()
#: configuration ``(P, N_ex, N_ey, L_x, L_y)`` → {key: owner}, least
#: recently used first
_entries: "OrderedDict[tuple, dict]" = OrderedDict()


def get(config: tuple, key, build: typing.Callable[[], typing.Any]):
    """The object ``build()`` made for ``key`` (what it is: ``"grid"``,
    ``"spectral_schur"``, ...) under grid configuration ``config``
    (:meth:`Grid2D._config`), built on the first request (a miss), the same
    object on every later one (a hit); marks ``config`` as the most
    recently used.  ``build`` runs under the registry's lock and must not
    ask the registry itself."""
    with _lock:
        entry = _entries.get(config, {})
        obj = entry.get(key)
        if obj is None:
            obj = entry[key] = build()
            _entries[config] = entry
            COUNTERS["build.cache_misses"] += 1
        else:
            COUNTERS["build.cache_hits"] += 1
        _entries.move_to_end(config)
        while len(_entries) > MAX_GRIDS:
            _entries.popitem(last=False)
        return obj


def grid(P: int, N_ex: int, N_ey: int, L_x: float, L_y: float) -> Grid2D:
    """The grid of a configuration (arguments as :class:`Grid2D`'s)."""
    config = (int(P), int(N_ex), int(N_ey), float(L_x), float(L_y))
    return get(config, "grid", lambda: Grid2D(*config))


def fdm(grid: Grid2D, dirichlet_x=(True, True), dirichlet_y=(True, True),
        alpha: float = 0.0) -> FDM2D:
    """The FDM solver of ``grid`` with these Dirichlet sides and mass shift
    (arguments as :class:`FDM2D`'s)."""
    dx, dy = tuple(map(bool, dirichlet_x)), tuple(map(bool, dirichlet_y))
    return get(grid._config(), ("fdm", dx, dy, float(alpha)),
               lambda: FDM2D(grid, dx, dy, alpha))


def clear():
    """Drop every entry: the next build of any key is a miss.

    This is how a process gets back the device memory of the registry's
    constants, which stay on the card after the solvers that used them are
    gone.  A solver still alive keeps the owners it holds (and their device
    constants) until it goes."""
    with _lock:
        _entries.clear()
