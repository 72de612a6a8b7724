"""Where the host time of the B2/B4 wrappers goes, at f32 and at bf16, on
the card.

Run from the root of a checkout: ``python -m sem_tpu_torch.study.wrapper_host``
(a CUDA card is required; the script exits non-zero without one).  On the
inputs ``chip_smoke.py`` gives B2 at P16 64×64 (seed ``grid.N``, a 1-in-7
Dirichlet mask, ``coef`` 37) and B4 on rank 0's strip of two, in turns
f32, bf16, bf16, f32 (a shared host drifts between turns, so the two
dtypes are compared within a pair of turns), it prints one
``[wrapper_host]`` line per kernel with, per turn:

* ``call_us``: host-clock µs per call over 200 back-to-back calls (the
  wrapper's enqueue cost, as ``chip_smoke.py``'s ``host_us``);
* each timed alone with the card idle (median of 200 single calls on the
  host clock, a synchronize after each, outside the timing): the whole
  call (``alone_us``) and its pieces, the operand check (``check_us``),
  the output allocation (``alloc_us``), the constants' addresses
  (``ptrs_us``) and the C entry point's launch with every argument ready
  (``launch_us``; a bf16 one rounds ``coef`` there).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import kernels, sharded
from sem_tpu_torch.parallel import row_strips


def back_to_back_us(fn, n=200) -> float:
    """Host µs per call over n calls with no synchronisation between."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def alone_us(fn, n=200) -> float:
    """Host µs of one call with the card idle, median of n."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * statistics.median(ts)


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_host needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    dev = torch.device("cuda", torch.cuda.current_device())
    grid = Grid2D(16, 64, 64, 1.0, 1.0)
    N = grid.N
    rng = np.random.default_rng(N)
    u, v, w = (rng.standard_normal(N) for _ in range(3))
    q = rng.standard_normal(3 * N)
    jac = [rng.standard_normal(N) for _ in range(4)]
    m = np.zeros(N, bool)
    m[rng.choice(N, size=N // 7, replace=False)] = True
    mb = torch.as_tensor(m, device=dev)
    rows = row_strips(grid.Ngx, 2, grid.P)[0]
    n = (rows[1] - rows[0]) * grid.Ngy
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    for name, entry in (("apply_coupled_system", "sem_apply_coupled_system"),
                        ("apply_coupled_system_sharded",
                         "sem_apply_coupled_system_strip")):
        strip = name.endswith("_sharded")
        split = {}
        for turn, dt in enumerate((torch.float32, torch.bfloat16,
                                   torch.bfloat16, torch.float32)):
            def t(a):
                return torch.as_tensor(a, device=dev).to(dt)
            qt, ul, vl = t(q), t(u), t(v)
            jt = tuple(t(j) for j in jac)
            if strip:
                sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
                qt = sharded.strip_with_halo(grid, rows, qt, 3)
                ul, vl, mk = ul[sl], vl[sl], mb[sl]
                jt = tuple(j[sl] for j in jt)
                args = (grid, rows, qt, ul, vl, jt, mk, 37.0)
                kfn = sharded.apply_coupled_system_sharded
                extra = (rows[0], rows[1] - rows[0],
                         *kernels.row_window_tiles(*rows))
                nn = n
            else:
                mk = mb
                args = (grid, qt, ul, vl, jt, mk, 37.0)
                kfn = kernels.apply_coupled_system_kernel
                extra, nn = (), N
            shapes = [qt.shape] + [(nn,)] * 7
            out = qt.new_empty(3 * nn)
            ptrs = (out.data_ptr(), qt.data_ptr(), ul.data_ptr(),
                    vl.data_ptr(), *(j.data_ptr() for j in jt),
                    mk.data_ptr(),
                    *kernels._band_ptrs(grid, dev, dt), 37.0,
                    *extra, grid.Ngx, grid.Ngy, grid.P)
            sfx = kernels._SUFFIX[dt]
            pieces = {
                "call_us": back_to_back_us(lambda: kfn(*args)),
                "alone_us": alone_us(lambda: kfn(*args)),
                "check_us": alone_us(lambda: kernels._check(
                    name, (qt, ul, vl, *jt, mk), shapes, masks=1)),
                "alloc_us": alone_us(lambda: qt.new_empty(3 * nn)),
                "ptrs_us": alone_us(lambda: kernels._band_ptrs(grid, dev,
                                                               dt)),
                "launch_us": alone_us(lambda: kernels._launch(
                    name, entry, sfx, dev, *ptrs))}
            split[f"{sfx}_{turn}"] = " ".join(
                f"{k}={v:.2f}" for k, v in pieces.items())
        print(f"[wrapper_host] kernel={name} grid=P16_64x64"
              + (f" strip={rows[0]}:{rows[1]}" if strip else "")
              + "".join(f" {k}: {v};" for k, v in split.items())
              + f" smi='{smi}'", flush=True)


if __name__ == "__main__":
    main()
