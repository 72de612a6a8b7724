"""Device copies of host NumPy constants, cached on the object that owns them.

Grids, FDM solvers and the spectral Schur block build their constants on the
host in float64 NumPy.  Each operator apply needs them as tensors of the field
dtype on the field's device; :func:`device_const` makes that copy once per
``(key, dtype, device)`` and keeps it on the owner, so the copies live exactly
as long as the grid or solver they belong to.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

__all__ = ["device_const"]


def device_const(owner, key, host: typing.Callable[[], np.ndarray],
                 dtype: torch.dtype, device) -> torch.Tensor:
    """``host()`` as a tensor of ``dtype`` on ``device``, cached on ``owner``.

    The cast rounds the float64 host array to nearest, like NumPy's
    ``astype`` in the reference package, so f32 constants are bit-identical
    to the reference's.
    """
    cache = owner.__dict__.setdefault("_device_consts", {})
    k = (key, dtype, torch.device(device))
    t = cache.get(k)
    if t is None:
        t = torch.tensor(np.ascontiguousarray(host())).to(device=device,
                                                              dtype=dtype)
        cache[k] = t
    return t
