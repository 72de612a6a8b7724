"""Port parity, the multi-process path: kernels B3/B4 on row strips (their
plain versions) against ``sem_tpu``'s sharded Pallas kernels in interpret
mode on the 8 virtual devices of tests/conftest.py, the strip layout and its
collectives, the cross-rank agreement check, and the decomposed solves run
as two processes over gloo against ``sem_tpu`` and against the port's
single-process solve."""
import json
import os
import socket
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu import ConvectionDiffusionSolver as JCD
from sem_tpu.coupling import run_parallel as jax_run_parallel
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu.ops import (apply_coupled_system_pallas_sharded,
                         apply_system_pallas_sharded)
from sem_tpu.parallel.sharding import make_mesh
from sem_tpu_torch import ConvectionDiffusionSolver as TCD
from sem_tpu_torch import NavierStokesSolver as TNS
from sem_tpu_torch.coupling import build_coupled, run
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import _build, kernels, sharded
from sem_tpu_torch.parallel import (assert_replicated, choose_backend,
                                    row_strips, use_group)

from tests.torch_parity import one_torch_thread, t32  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the QUICK configuration and plot points of tests/test_torch_slice.py:31-34
QUICK = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=3, N_ex_cd=3, N_ey_cd=3,
             P_ns=3, N_ex_ns=3, N_ey_ns=3, iprint=False)
PLOT21 = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                     indexing="ij")
# the CD configuration of tests/test_torch_slice.py:114-118 (mixed precision)
CD_KW = dict(Pe=40, P=4, N_ex=8, N_ey=8, T_W=0.5, T_E=-0.5,
             mixed_precision=True)
PLOT31 = np.meshgrid(np.linspace(0, 1, 31), np.linspace(0, 1, 31),
                     indexing="ij")


def _wind():
    return (lambda x, y: y - 0.5, lambda x, y: 0.5 - x)


# ------------------------- strip kernels vs JAX --------------------------- #
GRIDS = [(8, 4), (70, 2)]   # tests/test_pallas_sharded.py:35-36, P=4
_JAX = {}


def _inputs(grid, seed=11):
    rng = np.random.default_rng(seed)
    N = grid.N
    u, v, w = (rng.standard_normal(N).astype(np.float32) for _ in range(3))
    q = rng.standard_normal(3 * N).astype(np.float32)
    jac = [rng.standard_normal(N).astype(np.float32) for _ in range(4)]
    mb = rng.random(N) < 0.2
    return u, v, w, q, jac, mb


def _jax_reference(kind, nex, ney):
    """``sem_tpu``'s sharded Pallas kernel on the 8-device mesh, interpret
    mode (as tests/test_pallas_sharded.py runs it), once per grid."""
    key = (kind, nex, ney)
    if key not in _JAX:
        grid = JGrid2D(P=4, N_ex=nex, N_ey=ney, L_x=1.0, L_y=1.0)
        u, v, w, q, jac, mb = (jnp.asarray(a) if not isinstance(a, list)
                               else tuple(map(jnp.asarray, a))
                               for a in _inputs(grid))
        if kind == "B3":
            out = apply_system_pallas_sharded(grid, u, v, w, 3.0,
                                              mesh=make_mesh(),
                                              interpret=True)
        else:
            out = apply_coupled_system_pallas_sharded(
                grid, q, u, v, jac, mb.astype(jnp.float32), 2.5,
                mesh=make_mesh(), interpret=True)
        _JAX[key] = np.asarray(out)
    return _JAX[key]


def _on_strips(grid, R, strip_out):
    """Concatenate ``strip_out(rows)`` (each ``(nf·nrows·Ngy,)``) over the
    R strips into the whole grid's layout."""
    outs = [strip_out(rows).reshape(-1, (rows[1] - rows[0]) * grid.Ngy)
            for rows in row_strips(grid.Ngx, R, grid.P)]
    return torch.cat(outs, dim=1).reshape(-1)


def _b3_strip(grid, u, v, w):
    def out(rows):
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        return sharded.apply_system_sharded_plain(
            grid, rows, u[sl], v[sl], sharded.strip_with_halo(grid, rows, w),
            3.0)
    return out


def _b4_strip(grid, q, u, v, jac, mb):
    def out(rows):
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        return sharded.apply_coupled_system_sharded_plain(
            grid, rows, sharded.strip_with_halo(grid, rows, q, 3), u[sl],
            v[sl], tuple(j[sl] for j in jac), mb[sl], 2.5)
    return out


@pytest.mark.parametrize("R", [1, 2, 3, 8])
@pytest.mark.parametrize("nex,ney", GRIDS)
def test_b3_strips_match_sharded_pallas(nex, ney, R):
    """Concatenated B3 plain strips (halos cut from the full field, as the
    exchange delivers them) == apply_system_pallas_sharded, 3e-6·scale."""
    grid = Grid2D(4, nex, ney, 1.0, 1.0)
    u, v, w = map(t32, _inputs(grid)[:3])
    ref = _jax_reference("B3", nex, ney)
    got = _on_strips(grid, R, _b3_strip(grid, u, v, w)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-6 * np.abs(ref).max())


@pytest.mark.parametrize("R", [1, 2, 3, 8])
def test_b4_strips_match_sharded_pallas(R):
    """Concatenated B4 plain strips, with a Dirichlet mask and the four
    Jacobian diagonals, == apply_coupled_system_pallas_sharded (P=4 8×4),
    3e-6·scale."""
    grid = Grid2D(4, 8, 4, 1.0, 1.0)
    u, v, _, q, jac, mb = _inputs(grid)
    ref = _jax_reference("B4", 8, 4)
    got = _on_strips(grid, R, _b4_strip(
        grid, t32(q), t32(u), t32(v), tuple(map(t32, jac)),
        torch.as_tensor(mb))).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-6 * np.abs(ref).max())


# ------------------------- layout and dispatch ---------------------------- #
@pytest.mark.parametrize("Ngx,R,P", [(33, 1, 4), (33, 8, 4), (281, 3, 4),
                                     (1025, 2, 16)])
def test_row_strips_cover_the_grid(Ngx, R, P):
    """Contiguous, near-equal (sizes differ by ≤ 1), every strip ≥ P rows."""
    b = row_strips(Ngx, R, P)
    assert b[0][0] == 0 and b[-1][1] == Ngx and len(b) == R
    assert all(b[k][1] == b[k + 1][0] for k in range(R - 1))
    sizes = [r1 - r0 for r0, r1 in b]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= P


class _FakeGroup:
    """Rank ``rank`` of ``world`` with no other process behind it: every
    all-gather returns this rank's tensor for every rank (``rows`` maps a
    rank to a replacement), and each call is recorded."""

    def __init__(self, rank, world, rows=None):
        self.rank, self.world, self.backend = rank, world, "fake"
        self.rows = rows or {}
        self.calls = []

    def all_gather(self, t):
        self.calls.append(("all_gather", tuple(t.shape)))
        return [self.rows[r](t) if r in self.rows else t.clone()
                for r in range(self.world)]

    def all_reduce(self, t):
        self.calls.append(("all_reduce", tuple(t.shape)))
        return t


def test_thin_strips_raise():
    """P=4 on the 33-row grid over 9 ranks gives 3-row strips, thinner than
    the halo: row_strips and building either solver under such a group
    raise ValueError."""
    with pytest.raises(ValueError, match="thin"):
        row_strips(33, 9, 4)
    with use_group(_FakeGroup(0, 9)):
        with pytest.raises(ValueError, match="thin"):
            TCD(1.0, 1.0, Pe=1.0, P=4, N_ex=8, N_ey=4, device="cpu")
        with pytest.raises(ValueError, match="thin"):
            TNS(1.0, 1.0, Re=1.0, Gr=0.0, P=4, N_ex=8, N_ey=4, iprint=[],
                device="cpu")


def test_one_sharded_matvec_is_one_exchange(monkeypatch):
    """A sharded CD matvec and a sharded NS matvec each make exactly one
    collective, the halo exchange (one all-gather of the P boundary rows of
    each field), and no full-field gather — the port's analog of the HLO
    check of tests/test_pallas_sharded.py:66-95."""
    for k in sharded.COLLECTIVES:
        monkeypatch.setitem(sharded.COLLECTIVES, k, 0)
    rng = np.random.default_rng(4)
    cd = TCD(1.0, 1.0, Pe=40.0, P=4, N_ex=8, N_ey=4, device="cpu")
    grid = cd.grid
    f32 = torch.float32
    u, v = (torch.tensor(rng.standard_normal(grid.N), dtype=f32)
            for _ in range(2))
    g = _FakeGroup(1, 3)
    st = sharded.RowStrips(grid, g)
    cd._mv(u, v, 0.5, st)(st.local(u))
    assert g.calls == [("all_gather", (2, 1, grid.P, grid.Ngy))]
    assert sharded.COLLECTIVES == {"halo_exchange": 1, "strip_gather": 0,
                                   "all_reduce": 0}

    ns = TNS(1.0, 1.0, Re=10.0, Gr=0.0, P=4, N_ex=8, N_ey=4, iprint=[],
             device="cpu")
    jac = tuple(torch.tensor(rng.standard_normal(grid.N), dtype=f32)
                for _ in range(4))
    g = _FakeGroup(1, 3)
    st = sharded.RowStrips(ns.grid, g)
    mv, _ = ns._coupled_ops(u, v, jac, f32, st)
    mv(st.local(torch.cat([u, v, u]), 3))
    assert g.calls == [("all_gather", (2, 3, grid.P, grid.Ngy))]
    assert sharded.COLLECTIVES == {"halo_exchange": 2, "strip_gather": 0,
                                   "all_reduce": 0}


def test_sharded_cpu_dispatch_never_builds_or_counts(monkeypatch):
    """On the CPU the B3/B4 wrappers take their plain versions: no nvcc
    build, no launch counted."""
    def no_build():
        raise AssertionError("a CPU tensor must not trigger a CUDA build")

    monkeypatch.setattr(_build, "library", no_build)
    for k in kernels.LAUNCHES:
        monkeypatch.setitem(kernels.LAUNCHES, k, 0)
    grid = Grid2D(4, 8, 4, 1.0, 1.0)
    u, v, w, q, jac, mb = _inputs(grid, 12)
    rows = row_strips(grid.Ngx, 3, grid.P)[1]
    sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
    a3 = (grid, rows, t32(u)[sl], t32(v)[sl],
          sharded.strip_with_halo(grid, rows, t32(w)), 3.0)
    assert torch.equal(sharded.apply_system_sharded(*a3),
                       sharded.apply_system_sharded_plain(*a3))
    a4 = (grid, rows, sharded.strip_with_halo(grid, rows, t32(q), 3),
          t32(u)[sl], t32(v)[sl], tuple(t32(j)[sl] for j in jac),
          torch.as_tensor(mb)[sl], 2.5)
    assert torch.equal(sharded.apply_coupled_system_sharded(*a4),
                       sharded.apply_coupled_system_sharded_plain(*a4))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


@pytest.mark.parametrize("n,cuda,ndev,want", [
    (2, False, 0, "gloo"), (2, True, 1, "gloo"), (2, True, 2, "nccl"),
    (4, True, 8, "nccl")])
def test_backend_follows_card_and_rank_counts(n, cuda, ndev, want):
    assert choose_backend(n, cuda, ndev) == want


def test_cross_rank_check_raises_on_mismatch():
    """The end-of-solve check of the MDA all-gathers stats and field
    checksums: agreeing ranks pass, a rank with one differing value
    raises."""
    _, _, mda = build_coupled(1.0, 1.0, mode="JNK", device="cpu", **QUICK)
    z = torch.zeros
    from sem_tpu_torch.coupling.mda import CoupledState
    s = CoupledState(z(mda.N_cd, dtype=torch.float64),
                     *(z(mda.N_ns, dtype=torch.float64) for _ in range(3)))
    mda._assert_ranks_agree(_FakeGroup(0, 2), s)

    def bump(i):
        def f(t):
            t = t.clone()
            t[i] += 1.0
            return t
        return f

    for i, name in ((2, "nonlinear_iters"), (4, "sum(T)")):
        with pytest.raises(RuntimeError, match=name.replace("(", r"\(")
                           .replace(")", r"\)")):
            mda._assert_ranks_agree(_FakeGroup(0, 2, {1: bump(i)}), s)
    with pytest.raises(RuntimeError, match="ranks diverged"):
        assert_replicated(_FakeGroup(0, 3, {2: bump(0)}), {"x": 1.0})


# -------------------------- two processes, gloo --------------------------- #
_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
out, cfg = sys.argv[2], json.loads(sys.argv[3])
from sem_tpu_torch import ConvectionDiffusionSolver, NavierStokesSolver
from sem_tpu_torch.coupling import run_parallel
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import COLLECTIVES, LAUNCHES, RowStrips, strip_with_halo
from sem_tpu_torch.parallel import (gather_global, init_distributed,
                                    make_group, use_group)

rank, world, dev = init_distributed()          # the SEM_TPU_* variables
group = make_group()
res = {"rank": rank, "world": world, "device": str(dev),
       "backend": group.backend}

def reset():
    for counts in (LAUNCHES, COLLECTIVES):
        for k in counts:
            counts[k] = 0

# the collectives against slicing the full field
grid = Grid2D(4, 8, 4, 1.0, 1.0)
x = torch.tensor(np.random.default_rng(3).standard_normal(3 * grid.N))
st = RowStrips(grid, group)
res["exchange_ok"] = torch.equal(st.exchange(st.local(x, 3), 3),
                                 strip_with_halo(grid, st.rows, x, 3))
res["gather_ok"] = torch.equal(st.gather(st.local(x, 3), 3), x)
res["gather_global"] = gather_global(
    torch.arange(rank + 2, dtype=torch.float64), group).tolist()

# one sharded NS matvec with the real group
ns = NavierStokesSolver(1.0, 1.0, Re=10.0, Gr=0.0, P=4, N_ex=8, N_ey=4,
                        iprint=[], device="cpu")
f32 = torch.float32
st = RowStrips(ns.grid, group)
mv, _ = ns._coupled_ops(x[:grid.N].to(f32), x[grid.N:2 * grid.N].to(f32),
                        tuple(x[:grid.N].to(f32) for _ in range(4)), f32, st)
reset()
mv(st.local(x.to(f32), 3))
res["matvec_collectives"] = dict(COLLECTIVES)

# (a) the standalone CD solve under the group
reset()
wind = (lambda x, y: y - 0.5, lambda x, y: 0.5 - x)
pts31 = np.meshgrid(np.linspace(0, 1, 31), np.linspace(0, 1, 31),
                    indexing="ij")
with use_group(group):
    T = ConvectionDiffusionSolver(1.0, 1.0, device="cpu", **cfg["cd"]).run(
        *wind, pts31)
np.save(f"{out}/cd_rank{rank}.npy", T)
res["cd_collectives"] = dict(COLLECTIVES)

# (b, c) run_parallel, QUICK JNK
reset()
pts21 = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                    indexing="ij")
T, u, v, s, stats = run_parallel(pts21, 1.0, 1.0, mode="JNK", device="cpu",
                                 return_state=True, **cfg["quick"])
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


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two processes over gloo on the CPU (free port, one torch thread
    each, killed on failure or after 300 s), started once; their results as
    ``[(json, dir)]`` per rank."""
    out = tmp_path_factory.mktemp("two_ranks")
    port = _free_port()
    cfg = json.dumps({"cd": CD_KW, "quick": QUICK})
    procs = []
    for rank in range(2):
        env = dict(os.environ, SEM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SEM_TPU_NUM_PROCESSES="2", SEM_TPU_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(ROOT), str(out), cfg],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{o[-4000:]}"
    return [json.loads((out / f"rank{r}.json").read_text()) for r in
            range(2)], out


def test_two_process_collectives(two_ranks):
    """gloo on the CPU; the halo exchange and the strip gather reproduce
    slicing the full field; gather_global concatenates uneven pieces; one
    sharded matvec with the real group is one halo exchange."""
    res, _ = two_ranks
    for r, x in enumerate(res):
        assert (x["rank"], x["world"], x["device"], x["backend"]) == (
            r, 2, "cpu", "gloo")
        assert x["exchange_ok"] and x["gather_ok"]
        assert x["gather_global"] == [0.0, 1.0, 0.0, 1.0, 2.0]
        assert x["matvec_collectives"] == {"halo_exchange": 1,
                                           "strip_gather": 0,
                                           "all_reduce": 0}


def test_two_process_cd_matches_reference(two_ranks):
    """(a) The standalone CD solve (mixed precision, P=4 8×8) under a
    two-rank group: T at the plot points within 1e-10 of sem_tpu's, the
    same in both ranks, on the strip path."""
    res, out = two_ranks
    ref = JCD(1.0, 1.0, **CD_KW).run(*_wind(), PLOT31)
    Ts = [np.load(out / f"cd_rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(Ts[0], Ts[1])
    np.testing.assert_allclose(Ts[0], ref, atol=1e-10)
    assert all(x["cd_collectives"]["halo_exchange"] > 0 for x in res)


def _check_run(res, out, T, u, v, stats, gmres_iters):
    """The bounds of tests/test_torch_slice.py:71-78."""
    for r in range(2):
        Tg, ug, vg = np.load(out / f"run_rank{r}.npy")
        np.testing.assert_allclose(Tg, T, atol=1e-7)
        np.testing.assert_allclose(ug, u, atol=1e-8)
        np.testing.assert_allclose(vg, v, atol=1e-8)
        assert res[r]["stats"] == stats
        assert abs(res[r]["gmres_iters"] - gmres_iters) <= 1


def test_two_process_run_parallel_matches_jax(two_ranks):
    """(b) run_parallel QUICK JNK over two gloo ranks against
    sem_tpu.coupling.run_parallel on the 8-device mesh (un-fused host
    FGMRES, the algorithm the port implements)."""
    res, out = two_ranks
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", "0")
        mp.setenv("SEM_TPU_FUSED_PC", "0")
        T, u, v, _, stats = jax_run_parallel(
            PLOT21, 1.0, 1.0, mode="JNK", device_krylov=False,
            return_state=True, **QUICK)
    _check_run(res, out, *map(np.asarray, (T, u, v)), stats.as_list(),
               stats.gmres_iters)


def test_two_process_run_parallel_matches_single_process(two_ranks):
    """(c) The same two-rank run against the port's single-process run."""
    res, out = two_ranks
    T, u, v, _, stats = run(PLOT21, 1.0, 1.0, mode="JNK", device="cpu",
                            return_state=True, **QUICK)
    _check_run(res, out, T, u, v, stats.as_list(), stats.gmres_iters)


def test_two_process_run_took_the_strip_path(two_ranks):
    """Both ranks ran their f32 matvecs on strips: halo exchanges, strip
    gathers and all-reduces counted in each; no kernel launch counted on the
    CPU (the plain versions never count)."""
    res, _ = two_ranks
    for x in res:
        assert all(n > 0 for n in x["collectives"].values()), x
        assert x["launches"] == dict.fromkeys(kernels.LAUNCHES, 0)
    assert res[0]["collectives"] == res[1]["collectives"]
