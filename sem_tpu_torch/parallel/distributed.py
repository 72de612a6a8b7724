"""Multi-process execution: one process per rank over ``torch.distributed``.

Counterpart of ``sem_tpu.parallel.distributed``.  Every process runs the same
script::

    SEM_TPU_COORDINATOR=127.0.0.1:29511 SEM_TPU_NUM_PROCESSES=2 \\
    SEM_TPU_PROCESS_ID=<rank> python my_run.py

    # my_run.py
    import torch
    from sem_tpu_torch.coupling import run_parallel
    from sem_tpu_torch.parallel import init_distributed
    rank, world, device = init_distributed()   # reads the SEM_TPU_* variables
    T, u, v = run_parallel(pts, 1.0, 1.0, ..., device=device)
    torch.distributed.destroy_process_group()  # gloo can abort at exit without

The host control flow (Newton, refinement, FGMRES) runs identically in every
rank: each scalar it branches on is all-reduced or computed from replicated
fields, so it is the same on every rank (checked at the end of each coupled
solve, :func:`assert_replicated`).
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch

__all__ = ["init_distributed", "choose_backend", "gather_global",
           "assert_replicated"]


def choose_backend(num_processes: int, cuda_available: bool,
                   device_count: int) -> str:
    """NCCL when every rank of this host has a card of its own; gloo
    otherwise (CPU runs, or ranks sharing a card, which NCCL refuses)."""
    if cuda_available and device_count >= num_processes:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None, process_id: int = None,
                     backend: str = None, timeout_s: float = 600.0):
    """Initialize the default process group for this process.

    Arguments default to the ``SEM_TPU_COORDINATOR`` (``host:port`` or
    ``tcp://host:port``), ``SEM_TPU_NUM_PROCESSES`` and
    ``SEM_TPU_PROCESS_ID`` environment variables.  ``backend=None`` takes
    :func:`choose_backend`'s rule for the ranks of one host.  Every
    collective waits at most ``timeout_s``: a rank whose control flow
    diverged fails the run instead of hanging it.

    :return: ``(rank, world, device)``; the device is
        ``cuda:{rank % device_count}`` (made the current CUDA device), or
        the CPU where torch sees no card
    """
    import torch.distributed as dist

    addr = coordinator_address or os.environ.get("SEM_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ["SEM_TPU_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["SEM_TPU_PROCESS_ID"])
    if not addr:
        raise ValueError("init_distributed: no coordinator address (set "
                         "SEM_TPU_COORDINATOR=host:port)")
    if "://" not in addr:
        addr = "tcp://" + addr
    cuda = torch.cuda.is_available()
    ndev = torch.cuda.device_count() if cuda else 0
    if backend is None:
        backend = choose_backend(num_processes, cuda, ndev)
    device = torch.device(f"cuda:{process_id % ndev}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size(), device


def gather_global(x: torch.Tensor, group=None) -> np.ndarray:
    """This rank's 1-D piece ``x`` concatenated with every other rank's, in
    rank order, as a NumPy array in every rank (pieces may differ in
    length) — the counterpart of the reference's final MPI gather.  With no
    group (argument or active), ``x`` is already the whole array."""
    from sem_tpu_torch.parallel.sharding import active_group

    group = group if group is not None else active_group()
    if group is None or group.world == 1:
        return x.detach().cpu().numpy()
    n = torch.tensor([x.numel()], dtype=torch.int64, device=x.device)
    sizes = [int(s) for s in group.all_gather(n)]
    buf = torch.zeros(max(sizes), dtype=x.dtype, device=x.device)
    buf[:x.numel()] = x.reshape(-1)
    parts = group.all_gather(buf)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).cpu().numpy()


def assert_replicated(group, values: dict):
    """Raise ``RuntimeError`` unless every rank of ``group`` holds exactly
    the same ``values`` (name → number or 0-d tensor, compared bitwise as
    float64)."""
    names = list(values)
    dev = next((v.device for v in values.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    mine = torch.stack([torch.as_tensor(values[k], dtype=torch.float64,
                                        device=dev).reshape(())
                        for k in names])
    rows = [r.cpu().numpy() for r in group.all_gather(mine)]
    bad = [f"{k}: " + ", ".join(f"rank {r} {rows[r][i]!r}"
                                for r in range(len(rows)))
           for i, k in enumerate(names)
           if any(rows[r][i].tobytes() != rows[0][i].tobytes()
                  for r in range(len(rows)))]
    if bad:
        raise RuntimeError("ranks diverged: " + "; ".join(bad))
