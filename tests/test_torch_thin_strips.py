"""Port parity on strips thinner than the halo: eight gloo ranks on the CPU
run the configurations that ``sem_tpu`` computes under its 8-device mesh
(tests/conftest.py), whose 10- and 13-row grids give strips of one and two
rows at P=3, so that every halo exchange cuts its halos across several
ranks.  Against ``sem_tpu`` and against the port's single-process solve:

* the CD solve of tests/test_sharding.py's ``test_sharded_solver_parity``
  (P=3 4×4, Pe=10, mtol 1e-11), on the f32 strip chunks;
* ``run_parallel`` at the reference example's ``--quick`` configuration
  (``examples/boussinesq_parallel.py``: GS, P=3 3×3, Re=Ra=1e3), pinned to
  the un-fused host program on both sides, as tests/test_torch_parallel.py
  pins its two-rank run."""
import json
import os
import subprocess
import sys
import pathlib
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu import ConvectionDiffusionSolver as JCD
from sem_tpu.coupling import run_parallel as jax_run_parallel
from sem_tpu.parallel.sharding import make_mesh, use_mesh
from sem_tpu_torch import ConvectionDiffusionSolver as TCD
from sem_tpu_torch.coupling import run
from sem_tpu_torch.parallel import row_strips

from tests.test_torch_parallel import (PLOT21, QUICK, _check_run,
                                       _free_port)
from tests.torch_parity import (UNFUSED, one_torch_thread,  # noqa: F401
                                port_unfused)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = 8
RANK_TIMEOUT_S = 300
# tests/test_sharding.py:49-50, and the winds it draws (here from a seed)
CD_THIN = dict(L_x=1.0, L_y=1.0, Pe=10.0, P=3, N_ex=4, N_ey=4, T_W=0.5,
               T_E=-0.5, mtol=1e-11)
CD_SEED = 5
# the reference example's --quick coupling mode
GS_QUICK = dict(QUICK, mode="GS")


def _winds(n):
    rng = np.random.default_rng(CD_SEED)
    return rng.standard_normal(n), rng.standard_normal(n)


_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
out, cfg = sys.argv[2], json.loads(sys.argv[3])
from sem_tpu_torch import ConvectionDiffusionSolver
from sem_tpu_torch.coupling import run_parallel
from sem_tpu_torch.ops import COLLECTIVES, LAUNCHES, RowStrips
from sem_tpu_torch.parallel import init_distributed, make_group, use_group

rank, world, dev = init_distributed(device="cpu")   # the SEM_TPU_* variables
group = make_group()
res = {"rank": rank, "world": world, "device": str(dev)}


def reset():
    for counts in (LAUNCHES, COLLECTIVES):
        for k in counts:
            counts[k] = 0


# the CD solve of the reference's sharding test
rng = np.random.default_rng(cfg["cd_seed"])
reset()
with use_group(group):
    cd = ConvectionDiffusionSolver(device="cpu", **cfg["cd"])
    u, v = (torch.tensor(rng.standard_normal(cd.N)) for _ in range(2))
    T = cd._get_solution(u, v)
np.save(f"{out}/cd_rank{rank}.npy", T.numpy())
res.update(cd_rows=RowStrips(cd.grid, group).rows,
           cd_collectives=dict(COLLECTIVES))

# run_parallel at the reference example's --quick configuration
reset()
pts = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                  indexing="ij")
T, u, v, s, stats = run_parallel(pts, 1.0, 1.0, device="cpu",
                                 return_state=True, **cfg["gs"],
                                 **cfg["unfused"])
np.save(f"{out}/run_rank{rank}.npy", np.stack([T, u, v]))
res.update(stats=stats.as_list(), gmres_iters=stats.gmres_iters,
           collectives=dict(COLLECTIVES), launches=dict(LAUNCHES))
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(res, f)

# leaving with the gloo group alive can abort at interpreter exit
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Eight processes over gloo on the CPU (free port, one thread each,
    ``device="cpu"``), started once and all killed on a failure or after
    ``RANK_TIMEOUT_S``; their results as ``([json] per rank, dir,
    wall_s)``."""
    out = tmp_path_factory.mktemp("eight_ranks")
    port = _free_port()
    cfg = json.dumps({"cd": CD_THIN, "cd_seed": CD_SEED, "gs": GS_QUICK,
                      "unfused": UNFUSED})
    t0 = time.perf_counter()
    procs = []
    try:
        for rank in range(RANKS):
            env = dict(os.environ, SEM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       SEM_TPU_NUM_PROCESSES=str(RANKS),
                       SEM_TPU_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(ROOT), str(out), cfg],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                [0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{o[-4000:]}"
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(RANKS)], out, wall


def test_eight_ranks_hold_strips_thinner_than_p(eight_ranks):
    """The CD grid's 13 rows over 8 ranks: strips of 2 and 1 rows at P=3
    (every halo cut from two to three ranks), on the CPU over gloo; the
    strip chunks ran (halo exchanges, strip gathers, all-reduces) and no
    kernel launch was counted."""
    res, _, _ = eight_ranks
    want = row_strips(13, RANKS, 3)
    assert [r1 - r0 for r0, r1 in want] == [2] * 5 + [1] * 3
    for r, x in enumerate(res):
        assert (x["rank"], x["world"], x["device"]) == (r, RANKS, "cpu")
        assert tuple(x["cd_rows"]) == want[r]
        assert all(n > 0 for n in x["cd_collectives"].values()), x
        assert all(n > 0 for n in x["collectives"].values()), x
        assert not any(x["launches"].values()), x


def test_eight_ranks_cd_matches_reference(eight_ranks):
    """The reference test's CD solve (P=3 4×4, Pe=10, mtol 1e-11) under the
    eight-rank group: T the same bits in every rank, within 1e-10 of
    sem_tpu's under its 8-device mesh and of the port's single process."""
    _, out, _ = eight_ranks
    Ts = [np.load(out / f"cd_rank{r}.npy") for r in range(RANKS)]
    for T in Ts[1:]:
        np.testing.assert_array_equal(T, Ts[0])
    u, v = _winds(Ts[0].size)
    with use_mesh(make_mesh()):
        ref = np.asarray(JCD(**CD_THIN)._get_solution(jnp.asarray(u),
                                                      jnp.asarray(v)))
    single = TCD(device="cpu", **CD_THIN)._get_solution(
        torch.tensor(u), torch.tensor(v)).numpy()
    np.testing.assert_allclose(Ts[0], ref, atol=1e-10)
    np.testing.assert_allclose(Ts[0], single, atol=1e-10)


def test_eight_ranks_gs_quick_matches_reference(eight_ranks, port_unfused):
    """run_parallel GS at the reference example's --quick configuration
    (P=3 3×3: 10 rows, strips of 2 and 1) over eight gloo ranks: the stats
    of sem_tpu.coupling.run_parallel on the 8-device mesh and of the port's
    single process, and their fields within tests/test_torch_parallel.py's
    bounds (T 1e-7, u and v 1e-8), the same in every rank."""
    res, out, _ = eight_ranks
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", "0")
        mp.setenv("SEM_TPU_FUSED_PC", "0")
        T, u, v, _, stats = jax_run_parallel(
            PLOT21, 1.0, 1.0, device_krylov=False, return_state=True,
            **GS_QUICK)
    _check_run(res, out, *map(np.asarray, (T, u, v)), stats.as_list(),
               stats.gmres_iters, ranks=RANKS)
    T, u, v, _, stats = run(PLOT21, 1.0, 1.0, device="cpu",
                            return_state=True, **GS_QUICK)
    _check_run(res, out, T, u, v, stats.as_list(), stats.gmres_iters,
               ranks=RANKS)
