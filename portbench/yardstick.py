"""The benchmark's yardstick: the card's published peaks, and the least time
each hand-written kernel could take for one launch (bytes and operations
from its shapes).

The arithmetic is ``bound_us`` of the repository's ``chip_smoke.py`` (kernel
B2 on a whole grid): each input byte read once and each output
byte written once, against the flops of the structurally nonzero band taps
the outputs need; the larger of the two times bounds the launch.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PEAKS", "band_tap_ranges", "b2_bound_s"]

#: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12}


def band_tap_ranges(n: int, P: int):
    """Per row ``i`` of an ``n``-node 1D operator of order ``P``, the band
    taps ``t0[i] <= t < t1[i]`` that can be nonzero: the ``P+1`` nodes of the
    row's element for a node inside an element, the ``2P+1`` nodes of both
    elements for an interface node, cut at the grid's edges."""
    i = np.arange(n)
    l = i % P
    k0 = np.where(l == 0, np.maximum(0, i - P), i - l)
    k1 = np.where(l == 0, np.minimum(n - 1, i + P), i - l + P)
    return k0 - i + P, k1 - i + P + 1


def b2_bound_s(P: int, N_ex: int, N_ey: int):
    """(seconds, "bytes" or "operations"): least time of one float32 launch
    of B2, the NS coupled saddle matvec, on a whole ``N_ex × N_ey`` grid of
    order ``P`` with every wall node a Dirichlet row."""
    Ngx, Ngy = N_ex * P + 1, N_ey * P + 1
    t0, t1 = band_tap_ranges(Ngx, P)
    nx = (t1 - t0).astype(float)
    t0, t1 = band_tap_ranges(Ngy, P)
    ny = (t1 - t0).astype(float)
    nodes = Ngx * Ngy
    consts = 4 * (2 * (2 * P + 1) + 1) * (Ngx + Ngy)  # K, G bands, the mass
    taps = Ngy * nx.sum() + Ngx * ny.sum()
    m = np.zeros((Ngx, Ngy), dtype=bool)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = True
    n_mb = float(m.sum())
    taps_mb = (m.sum(1) * nx).sum() + (m.sum(0) * ny).sum()
    nbytes = 4 * (3 * nodes + 9 * nodes) + nodes + consts
    flops = 2 * (5 * (taps - taps_mb) + taps_mb) \
        + 33 * (nodes - n_mb) + 3 * n_mb
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = flops / PEAKS["f32_flops"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
