"""Port parity, the multi-process path: kernels B3/B4 on row strips (their
plain versions) against ``sem_tpu``'s sharded Pallas kernels in interpret
mode on the 8 virtual devices of tests/conftest.py, the strip layout and its
collectives, the cross-rank agreement check, and the decomposed solves run
as two processes over gloo against ``sem_tpu`` and against the port's
single-process solve."""
import dataclasses
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

from tests.torch_parity import (UNFUSED, one_torch_thread,  # noqa: F401
                                port_unfused, t32)

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
# a PTC march that converges in 18 steps (tests/test_torch_ptc.py)
PTC_KW = dict(Re=1e3, Ra=1e4, Pr=0.71, P_cd=3, N_ex_cd=4, N_ey_cd=4,
              P_ns=3, N_ex_ns=8, N_ey_ns=8, mtol_nonlin=1e-8, iprint=False,
              precon="bj", ptc_dt0=1.0)
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
    """Strips thinner than the halo build: P=4 on the 33-row grid over 9
    ranks gives 3- and 4-row strips, and both solvers are built under such
    a group; only an empty strip raises ValueError (more ranks than rows,
    in row_strips and in either solver's construction)."""
    assert [r1 - r0 for r0, r1 in row_strips(33, 9, 4)] == [4] * 6 + [3] * 3
    with use_group(_FakeGroup(0, 9)):
        TCD(1.0, 1.0, Pe=1.0, P=4, N_ex=8, N_ey=4, device="cpu")
        TNS(1.0, 1.0, Re=1.0, Gr=0.0, P=4, N_ex=8, N_ey=4, iprint=[],
            device="cpu")
    with pytest.raises(ValueError, match="empty"):
        row_strips(33, 34, 4)
    with use_group(_FakeGroup(0, 34)):
        with pytest.raises(ValueError, match="empty"):
            TCD(1.0, 1.0, Pe=1.0, P=4, N_ex=8, N_ey=4, device="cpu")
        with pytest.raises(ValueError, match="empty"):
            TNS(1.0, 1.0, Re=1.0, Gr=0.0, P=4, N_ex=8, N_ey=4, iprint=[],
                device="cpu")


# (Ngx, R, P): strips thinner than P, whose halos span two to eight ranks
THIN = [(10, 8, 3), (13, 8, 3), (33, 9, 4), (33, 16, 4), (65, 64, 8)]


def _exchanged(grid, R, x, nf):
    """Each rank's exchange of its strips of ``x`` over fake groups whose
    all-gather returns what every rank contributed, and each rank's
    group."""
    sent = {}

    def keep(k):
        def f(t):
            sent[k] = t.clone()
            return t
        return f

    for k in range(R):     # what each rank contributes to the all-gather
        st = sharded.RowStrips(grid, _FakeGroup(k, R, {k: keep(k)}))
        st.exchange(st.local(x, nf), nf)
    out = []
    for k in range(R):
        g = _FakeGroup(k, R, {j: (lambda t, j=j: sent[j]) for j in range(R)})
        st = sharded.RowStrips(grid, g)
        out.append((st, st.exchange(st.local(x, nf), nf), g))
    return out


@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("Ngx,R,P", THIN)
def test_thin_strip_exchange_is_the_cut_halo(Ngx, R, P, nf):
    """RowStrips.exchange on strips thinner than P: at every rank the local
    strips with P halo rows per side equal strip_with_halo cut from the
    full field (zeros beyond the grid), with exactly one all-gather of the
    unchanged (2, nf, P, Ngy) edge slabs."""
    grid = Grid2D(P, (Ngx - 1) // P, 2, 1.0, 1.0)
    assert grid.Ngx == Ngx and min(
        r1 - r0 for r0, r1 in row_strips(Ngx, R, P)) < P
    x = torch.tensor(np.random.default_rng(Ngx + R).standard_normal(
        nf * grid.N))
    for st, got, g in _exchanged(grid, R, x, nf):
        assert torch.equal(got, sharded.strip_with_halo(grid, st.rows, x,
                                                        nf))
        assert g.calls == [("all_gather", (2, nf, P, grid.Ngy))]


@pytest.mark.parametrize("Ngx,R,P", THIN)
def test_thin_strip_plain_twins_are_the_whole_grid_rows(Ngx, R, P):
    """B3/B4's plain versions on strips thinner than P, each fed the halo
    the exchange delivers: concatenated, the rows of B1/B2's plain output.
    At bf16 (one rounding of an f32 sum) bit for bit; at f32 within
    2e-7·max|ref|, since the plain versions' einsum products round with
    the shape they are given (thick strips too: R=2 at P4 8×3 differs by
    3.0e-8 relative); the card's kernels give the same bits (chip_smoke.py
    phase 7)."""
    grid = Grid2D(P, (Ngx - 1) // P, 3, 1.0, 1.3)
    u, v, w, q, jac, mb = _inputs(grid, Ngx)
    mb = torch.as_tensor(mb)
    for dt in (torch.float32, torch.bfloat16):
        def c(a):
            return torch.as_tensor(a).to(dt)

        uc, vc, qc, jc = c(u), c(v), c(q), tuple(map(c, jac))
        strips = {k: _exchanged(grid, R, x, nf) for k, x, nf in (
            ("w", c(w), 1), ("q", qc, 3))}
        b3, b4 = [], []
        for (st, w_ext, _), (_, q_ext, _) in zip(strips["w"], strips["q"]):
            sl = slice(st.rows[0] * grid.Ngy, st.rows[1] * grid.Ngy)
            b3.append(sharded.apply_system_sharded_plain(
                grid, st.rows, uc[sl], vc[sl], w_ext, 3.0))
            b4.append(sharded.apply_coupled_system_sharded_plain(
                grid, st.rows, q_ext, uc[sl], vc[sl],
                tuple(j[sl] for j in jc), mb[sl], 2.5).reshape(3, -1))
        got3, got4 = torch.cat(b3), torch.cat(b4, 1).reshape(-1)
        ref3 = kernels.apply_system_plain(grid, uc, vc, c(w), 3.0)
        ref4 = kernels.apply_coupled_system_plain(grid, qc, uc, vc, jc, mb,
                                                  2.5)
        for got, ref in ((got3, ref3), (got4, ref4)):
            assert got.dtype == dt
            if dt == torch.bfloat16:
                assert torch.equal(got, ref)
            else:
                assert float((got - ref).abs().max()) <= \
                    2e-7 * float(ref.abs().max())


def test_init_distributed_takes_the_card_or_raises(monkeypatch):
    """No hidden CPU fallback: where torch sees no card, init_distributed()
    (the card by default) raises before it touches the process group; the
    CPU is taken only when asked for (the rank workers pass
    device="cpu")."""
    import torch.distributed as dist

    from sem_tpu_torch.parallel import init_distributed

    def never(*a, **k):
        raise AssertionError("no process group without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", never)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            init_distributed("127.0.0.1:1", 2, 0, device=dev)
    with pytest.raises(ValueError, match="neither"):
        init_distributed("127.0.0.1:1", 2, 0, device="meta")


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
    from sem_tpu_torch.coupling.mda import CoupledState, MDAStats
    s = CoupledState(z(mda.N_cd, dtype=torch.float64),
                     *(z(mda.N_ns, dtype=torch.float64) for _ in range(3)))
    mda._assert_ranks_agree(_FakeGroup(0, 2), s)
    n_stats = len(dataclasses.fields(MDAStats))   # the checksums follow

    def bump(i):
        def f(t):
            t = t.clone()
            t[i] += 1.0
            return t
        return f

    for i, name in ((2, "nonlinear_iters"), (4, "ptc_accepted"),
                    (n_stats, "sum(T)")):
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
from sem_tpu_torch.coupling import build_coupled, run_parallel
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import COLLECTIVES, LAUNCHES, RowStrips, strip_with_halo
from sem_tpu_torch.parallel import (gather_global, init_distributed,
                                    make_group, use_group)

rank, world, dev = init_distributed(device="cpu")   # the SEM_TPU_* variables
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

# (b, c) run_parallel, QUICK JNK, with the f32 inner iterations of its CD
# and NS solves counted (ROADMAP C3)
inner = {"cd": 0, "ns": 0}

def counting(cls, key, attr):
    orig = cls._get_update

    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        inner[key] += getattr(self, attr).iterations
        return out
    cls._get_update = wrapped

counting(ConvectionDiffusionSolver, "cd", "last_info")
counting(NavierStokesSolver, "ns", "last_schur_info")
reset()
pts21 = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                    indexing="ij")
T, u, v, s, stats = run_parallel(pts21, 1.0, 1.0, mode="JNK", device="cpu",
                                 return_state=True, **cfg["quick"],
                                 **cfg["unfused"])
np.save(f"{out}/run_rank{rank}.npy", np.stack([T, u, v]))
res.update(stats=stats.as_list(), gmres_iters=stats.gmres_iters,
           collectives=dict(COLLECTIVES), launches=dict(LAUNCHES),
           inner=dict(inner))

# (d) PTC under the group: the sigma shift rides through the strip chunks
reset()
with use_group(group):
    _, _, mda = build_coupled(1.0, 1.0, mode="PTC", device="cpu",
                              **cfg["ptc"], **cfg["unfused"])
    s = mda.solve()
    res.update(ptc_stats=mda.stats.as_list(),
               ptc_gmres_iters=mda.stats.gmres_iters,
               ptc_collectives=dict(COLLECTIVES))
    np.save(f"{out}/ptc_rank{rank}.npy", torch.stack([s.u, s.v]).numpy())
    # (e) the flexible chunks run on the strips
    ns5 = NavierStokesSolver(1.0, 1.0, Re=10.0, Gr=0.0, P=4, N_ex=8, N_ey=4,
                             iprint=[], velo_inner=5, device="cpu")
    xp, yp = (torch.as_tensor(a) for a in ns5.points)
    ns5._calc_jacobians(torch.sin(np.pi * xp) * torch.sin(np.pi * yp),
                        xp * (1 - xp) * yp)
    rhs = ns5._get_dresiduals(xp * (1 - xp) * yp * (1 - yp),
                              torch.sin(np.pi * xp) * torch.sin(np.pi * yp)
                              ** 2, torch.cos(np.pi * xp) * yp)
    reset()
    ns5._get_update(*rhs)
    info = ns5.last_schur_info
    res["flex_under_group"] = dict(
        converged=bool(info.converged or info.stalled),
        iterations=int(info.iterations), f64=ns5.f64_fallback_count,
        collectives=dict(COLLECTIVES))
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
    ``[(json, dir)]`` per rank.  Their coupled solves are pinned to the
    un-fused host program (``UNFUSED``), which the tests hold against
    ``sem_tpu``'s."""
    out = tmp_path_factory.mktemp("two_ranks")
    port = _free_port()
    cfg = json.dumps({"cd": CD_KW, "quick": QUICK, "ptc": PTC_KW,
                      "unfused": UNFUSED})
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


def _check_run(res, out, T, u, v, stats, gmres_iters, ranks=2):
    """The bounds of tests/test_torch_slice.py:71-78, in each of the
    ``ranks`` ranks."""
    for r in range(ranks):
        Tg, ug, vg = np.load(out / f"run_rank{r}.npy")
        np.testing.assert_allclose(Tg, T, atol=1e-7)
        np.testing.assert_allclose(ug, u, atol=1e-8)
        np.testing.assert_allclose(vg, v, atol=1e-8)
        assert res[r]["stats"] == stats
        assert abs(res[r]["gmres_iters"] - gmres_iters) <= 1


def test_two_process_run_parallel_matches_jax(two_ranks):
    """(b) run_parallel QUICK JNK over two gloo ranks against
    sem_tpu.coupling.run_parallel on the 8-device mesh, both pinned to the
    un-fused host FGMRES."""
    res, out = two_ranks
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", "0")
        mp.setenv("SEM_TPU_FUSED_PC", "0")
        T, u, v, _, stats = jax_run_parallel(
            PLOT21, 1.0, 1.0, mode="JNK", device_krylov=False,
            return_state=True, **QUICK)
    _check_run(res, out, *map(np.asarray, (T, u, v)), stats.as_list(),
               stats.gmres_iters)


def test_two_process_run_parallel_matches_single_process(two_ranks,
                                                         port_unfused):
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


def test_two_process_ptc_matches_single_process(two_ranks, port_unfused):
    """(d) ``mode="PTC"`` (``velo_inner=0``) under a two-rank group against
    the port's single-process PTC march: equal MDA stats, coupled GMRES
    iterations within 1, u and v within 1e-6, the same in both ranks, on
    the strip path.  (e) A ``velo_inner=5`` linear solve under the group
    runs on the strips: at a smooth linearization, on the tangent residual
    of a smooth field, it converges on the mixed path (no f64 rescue), with
    halo exchanges, strip gathers and all-reduces, the same in both
    ranks."""
    res, out = two_ranks
    _, _, mda = build_coupled(1.0, 1.0, mode="PTC", device="cpu", **PTC_KW)
    s = mda.solve()
    ref = torch.stack([s.u, s.v]).numpy()
    got = [np.load(out / f"ptc_rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], ref, atol=1e-6)
    for x in res:
        assert x["ptc_stats"] == mda.stats.as_list()
        assert abs(x["ptc_gmres_iters"] - mda.stats.gmres_iters) <= 1
        assert all(n > 0 for n in x["ptc_collectives"].values()), x
        flex = x["flex_under_group"]
        assert flex["converged"] and flex["iterations"] > 0, flex
        assert flex["f64"] == 0, flex
        assert all(n > 0 for n in flex["collectives"].values()), flex
    assert res[0]["flex_under_group"] == res[1]["flex_under_group"]


def _inner_counts(monkeypatch, fn, cd_cls, ns_cls, **kw):
    """MDA stats and the summed f32 inner iterations of every CD and NS
    linear solve of ``fn(PLOT21, 1.0, 1.0, mode="JNK", **QUICK, **kw)``."""
    inner = {"cd": 0, "ns": 0}
    for cls, key, attr in ((cd_cls, "cd", "last_info"),
                           (ns_cls, "ns", "last_schur_info")):
        def wrapped(self, *a, _orig=cls._get_update, _k=key, _at=attr, **k):
            out = _orig(self, *a, **k)
            inner[_k] += int(getattr(self, _at).iterations)
            return out
        monkeypatch.setattr(cls, "_get_update", wrapped)
    stats = fn(PLOT21, 1.0, 1.0, mode="JNK", return_state=True, **QUICK,
               **kw)[4]
    monkeypatch.undo()
    return stats.as_list(), inner


def test_two_process_inner_counts_follow_reference(two_ranks, monkeypatch,
                                                   port_unfused):
    """ROADMAP C3: decomposing the solves changes the f32 chunks' inner
    iteration counts through the order of the reductions alone, in sem_tpu
    as in the port.  At QUICK JNK the CD count is the same single-process,
    in sem_tpu's run_parallel on 8 devices and on the port's two ranks (77);
    the NS count moves by a few iterations in both packages (sem_tpu 530 ->
    528, the port 530 -> 532): each decomposed count within 1 % of its
    package's single-process count, and the single-process counts equal."""
    from sem_tpu import (ConvectionDiffusionSolver as JCDS,
                         NavierStokesSolver as JNSS)
    from sem_tpu.coupling import run as jax_run

    res, _ = two_ranks
    monkeypatch.setenv("SEM_TPU_FG_FUSED", "0")
    monkeypatch.setenv("SEM_TPU_FUSED_PC", "0")
    j1 = _inner_counts(monkeypatch, jax_run, JCDS, JNSS, device_krylov=False)
    monkeypatch.setenv("SEM_TPU_FG_FUSED", "0")
    monkeypatch.setenv("SEM_TPU_FUSED_PC", "0")
    j8 = _inner_counts(monkeypatch, jax_run_parallel, JCDS, JNSS,
                       device_krylov=False)
    t1 = _inner_counts(monkeypatch, run, TCD, TNS, device="cpu")
    t2 = [(x["stats"], x["inner"]) for x in res]
    assert t2[0] == t2[1]
    assert j1[0] == j8[0] == t1[0] == t2[0][0]
    assert j1[1] == t1[1], (j1, t1)
    assert j8[1]["cd"] == t2[0][1]["cd"] == t1[1]["cd"]
    for single, decomposed in ((j1, j8), (t1, t2[0])):
        assert abs(decomposed[1]["ns"] - single[1]["ns"]) \
            <= 0.01 * single[1]["ns"], (single, decomposed)
