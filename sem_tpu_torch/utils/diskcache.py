"""Best-effort NPZ disk cache for expensive host-side solver constants.

Host-side solver construction is dominated by LAPACK (eigendecompositions of
the 1D pencils, the spectral-Schur boundary-ring inverse), while the results
depend only on the grid configuration.  A copy of ``sem_tpu.utils.diskcache``
with the same switches: ``SEM_TPU_CACHE=0`` disables it and
``SEM_TPU_CACHE_DIR`` sets the directory.  The default directory lies inside
the checkout (``build/sem_tpu_torch/cache``, git-ignored).  The cached arrays
are plain NumPy results of the same host code in both packages, so one
directory may serve both.
"""
from __future__ import annotations

import os
import threading
import typing

import numpy as np

__all__ = ["npz_cached", "cache_dir", "enabled"]


def cache_dir() -> str:
    return os.environ.get("SEM_TPU_CACHE_DIR", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "build", "sem_tpu_torch", "cache"))


def enabled() -> bool:
    return os.environ.get("SEM_TPU_CACHE", "1") != "0"


def npz_cached(key: str, builder: typing.Callable[[], dict]) -> dict:
    """Return ``builder()`` (a dict of NumPy arrays), persisted as
    ``<cache_dir>/<key>.npz``.  Caching is best-effort: any I/O failure
    falls back to building in-process."""
    path = os.path.join(cache_dir(), key + ".npz")
    if enabled() and os.path.exists(path):
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError):
            pass
    out = builder()
    if enabled():
        try:
            os.makedirs(cache_dir(), exist_ok=True)
            # unique per process and thread: solve_continued builds the next
            # level's solvers in a worker thread
            tmp = path + f".tmp{os.getpid()}_{threading.get_ident()}.npz"
            np.savez(tmp, **out)
            os.replace(tmp, path)
        except OSError:
            pass
    return out
