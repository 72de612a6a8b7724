"""Device copies of host NumPy constants, cached on the object that owns them.

Grids, FDM solvers and the spectral Schur block build their constants on the
host in float64 NumPy.  Each operator apply needs them as tensors of the field
dtype on the field's device; :func:`device_const` makes that copy once per
``(key, dtype, device)`` and keeps it on the owner, so the copies live exactly
as long as the object they belong to; grids, FDM solvers and the spectral
Schur data are shared by every build on the same grid
(:mod:`sem_tpu_torch.build_cache`), their host arrays read-only.

:func:`cli_device` is the drivers' (examples, bench, study CLIs) check of the
device they were asked for, :func:`sync` their wait for it before a host
clock is read.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from sem_tpu_torch.utils.profiling import span

__all__ = ["device_const", "cli_device", "sync"]


def device_const(owner, key, host: typing.Callable[[], np.ndarray],
                 dtype: torch.dtype, device) -> torch.Tensor:
    """``host()`` as a tensor of ``dtype`` on ``device``, cached on ``owner``.

    The cast rounds the float64 host array to nearest, like NumPy's
    ``astype`` in the reference package, so f32 constants are bit-identical
    to the reference's.  Making a copy is the span ``build.upload``: the
    host array (computed on first use where it is a cached property) and
    its copy to the device.

    The copy is a blocking one (``non_blocking=False``: torch synchronizes
    the copying stream before ``to`` returns), so a tensor is complete on
    the device before it is published on the owner, and a later build that
    shares the owner (:mod:`sem_tpu_torch.build_cache`) may read it from any
    thread and any stream.  Two threads that miss the same key together
    both copy; the first copy published is the one every caller gets.
    """
    cache = owner.__dict__.setdefault("_device_consts", {})
    k = (key, dtype, torch.device(device))
    t = cache.get(k)
    if t is None:
        with span("build.upload"):
            t = torch.tensor(np.ascontiguousarray(host())).to(device=device,
                                                                  dtype=dtype)
        t = cache.setdefault(k, t)
    return t


def cli_device(name: str) -> torch.device:
    """The device a driver was asked for (``--device``, the card by
    default).  A CUDA device where torch sees no card ends the process with
    a non-zero exit: no driver falls back to the CPU, which runs only when
    asked for (``--device cpu``)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA card for --device {name} "
                         f"(torch.cuda.is_available() is false); pass "
                         f"--device cpu to run on the CPU")
    return device


def sync(device) -> None:
    """Wait for the work enqueued on ``device`` (a no-op off CUDA)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
