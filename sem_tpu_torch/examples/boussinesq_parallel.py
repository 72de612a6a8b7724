"""Coupled Boussinesq demo over several processes (row-strip execution), on
the port.

Counterpart of the JAX package's ``examples/boussinesq_parallel.py``, which
runs one process over a ``jax.sharding.Mesh`` of every visible device.  The
port's multi-process solve is one process per rank over
``torch.distributed``: this script starts ``--ranks N`` processes of itself
(default 2), each runs :func:`sem_tpu_torch.parallel.init_distributed` (from
the ``SEM_TPU_COORDINATOR`` / ``SEM_TPU_NUM_PROCESSES`` /
``SEM_TPU_PROCESS_ID`` variables it sets for them) and then
:func:`sem_tpu_torch.coupling.run_parallel`.  Each f32 Krylov chunk of the CD
and NS solves runs on row strips (kernels B3 and B4 on the card, halo
exchanges, all-reduced GMRES) and every rank ends with the same replicated
results.  The backend is NCCL where every rank has a card of its own, gloo
otherwise (the CPU, or every rank on ``cuda:0`` of a one-card machine).

Only rank 0 prints; it also prints each rank's kernel launch counts.  A
rank that fails, or ranks that exceed ``RANK_TIMEOUT_S``, end every rank and
give a non-zero exit.

Usage::

    python -m sem_tpu_torch.examples.boussinesq_parallel [--check] \\
        [--quick] [--ranks N] [--device cpu]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

DVD_UMAX, DVD_VMAX = 3.649, 3.697
RANK_TIMEOUT_S = 1800


def main(check=False, quick=False, ranks=2, device="cuda"):
    """Start the ranks, wait for all of them, and return rank 0's results:
    ``umax``, ``vmax`` (scaled by Re·Pr), ``stats`` and ``launches`` (the
    kernel launch counts of each rank)."""
    from sem_tpu_torch.utils import cli_device

    dev = cli_device(device)
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, SEM_TPU_COORDINATOR=f"127.0.0.1:{port}",
               SEM_TPU_NUM_PROCESSES=str(ranks), PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        logs = [None] + [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                         for r in range(1, ranks)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "sem_tpu_torch.examples.boussinesq_parallel",
             "--result", result, "--device", dev.type]
            + ["--check"] * check + ["--quick"] * quick,
            env=dict(env, SEM_TPU_PROCESS_ID=str(r)), stdout=log,
            stderr=subprocess.STDOUT if log else None, text=True)
            for r, log in enumerate(logs)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs)
                  if p.returncode != 0]
        for r, rc in failed:
            if logs[r] is not None:
                logs[r].seek(0)
                tail = logs[r].read().splitlines()[-30:]
                print("\n".join(f"rank{r}| {ln}" for ln in tail),
                      file=sys.stderr)
        for log in logs[1:]:
            log.close()
        if failed:
            late = time.monotonic() >= deadline
            raise SystemExit(
                f"boussinesq_parallel: rank(s) {[r for r, _ in failed]} "
                f"exited {[rc for _, rc in failed]}"
                + (f" (killed after {RANK_TIMEOUT_S} s)" if late else ""))
        with open(result) as fh:
            return json.load(fh)


def rank_main(check, quick, result, device):
    """One rank: ``init_distributed`` from the environment on ``device``
    (``"cuda"`` or ``"cpu"``), then ``run_parallel``; rank 0 prints, checks
    and writes ``result``."""
    import torch
    import torch.distributed as dist

    from sem_tpu_torch.coupling import run_parallel
    from sem_tpu_torch.ops import LAUNCHES
    from sem_tpu_torch.parallel import init_distributed

    rank, world, dev = init_distributed(device=device)
    L_x = L_y = 1.0
    Re, Ra, Pr = 1e3, 1e3, 0.71
    # quick mode: GS coupling at a tiny size (strips of a few rows); the full
    # configuration is JNK at P=4 8×8
    P, N_e, mode = (3, 3, "GS") if quick else (4, 8, "JNK")

    devices = [None] * world
    dist.all_gather_object(devices, str(dev))
    if rank == 0:
        print(f"devices: {devices} ({dist.get_backend()}, {world} ranks)",
              flush=True)
    x_plot, y_plot = np.meshgrid(np.linspace(0, L_x, 101),
                                 np.linspace(0, L_y, 101), indexing="ij")
    T_plot, u_plot, v_plot, _, stats = run_parallel(
        (x_plot, y_plot), L_x, L_y, Re, Ra, Pr, P, N_e, N_e, P, N_e, N_e,
        mode=mode, iprint=rank == 0, return_state=True, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = [None] * world
    dist.all_gather_object(launches, dict(LAUNCHES))
    # leaving with the group alive can abort at interpreter exit (gloo)
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return

    umax = np.max(u_plot) * Re * Pr
    vmax = np.max(v_plot) * Re * Pr
    print(f"u_max*RePr = {umax:.3f}  (de Vahl Davis: {DVD_UMAX})")
    print(f"v_max*RePr = {vmax:.3f}  (de Vahl Davis: {DVD_VMAX})")
    print(f"kernel launches by rank: {launches}", flush=True)
    with open(result, "w") as fh:
        json.dump(dict(umax=float(umax), vmax=float(vmax),
                       stats=stats.as_list(), launches=launches), fh)

    if check:
        tol = 0.05 if quick else 0.02
        assert abs(umax - DVD_UMAX) < tol * DVD_UMAX, f"u_max {umax}"
        assert abs(vmax - DVD_VMAX) < tol * DVD_VMAX, f"v_max {vmax}"
        print("CHECK OK", flush=True)
        return

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.streamplot(x_plot.T, y_plot.T, u_plot.T, v_plot.T, density=3)
    CS = ax.contour(x_plot, y_plot, T_plot, levels=11, colors="k",
                    linestyles="solid")
    ax.clabel(CS, inline=True)
    ax.set_title(f"Ra={Ra:.1e}, P={P}, N_e={N_e} (row strips over "
                 f"{world} ranks)", fontsize="small")
    fig.savefig("temp.png", dpi=fig.dpi)
    print("saved temp.png")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="assert the de Vahl Davis anchors; no plot")
    ap.add_argument("--quick", action="store_true",
                    help="GS at P=3 3x3 (default JNK at P=4 8x8)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="number of processes (default 2)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; each rank on cuda:rank%%cards) or "
                         "cpu (only when asked)")
    ap.add_argument("--result", help=argparse.SUPPRESS)   # set in each rank
    a = ap.parse_args()
    if a.result:
        rank_main(a.check, a.quick, a.result, a.device)
    else:
        main(check=a.check, quick=a.quick, ranks=a.ranks, device=a.device)
