"""Port parity, the multi-process programs: ``krylov.fgmres(group=)``, the
flexible ``velo_inner`` chunks on row strips (escalation step 1 included),
``fused=True`` and ``device_krylov=True`` under a process group,
``run_parallel(devices=)`` and ``make_group(dcn=)``.  Two processes over
gloo and one single process run the same worker script; the two ranks must
agree bitwise, and they are held against the single process and, where
stated, against ``sem_tpu`` under ``use_mesh(make_mesh())`` on the 8 virtual
devices of tests/conftest.py.  ``device="cpu"`` throughout; tolerances are
stated per test."""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from sem_tpu.coupling import build_coupled as jax_build_coupled
from sem_tpu.parallel.sharding import make_mesh, use_mesh

from tests.torch_parity import UNFUSED

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the QUICK configuration of tests/test_torch_parallel.py:34-35 (P3 3×3)
QUICK = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=3, N_ex_cd=3, N_ey_cd=3,
             P_ns=3, N_ex_ns=3, N_ey_ns=3, iprint=False)
# PTC_KW of tests/test_torch_parallel.py:60-62 with the NS grid cut from
# 8×8 to 4×4: its velo_inner=5 march takes 15 s in one process (34 s at 8×8)
PTC_KW = dict(Re=1e3, Ra=1e4, Pr=0.71, P_cd=3, N_ex_cd=4, N_ey_cd=4,
              P_ns=3, N_ex_ns=4, N_ey_ns=4, mtol_nonlin=1e-8, iprint=False,
              precon="bj", ptc_dt0=1.0)
# the standalone NS solver of cases (b) and (f): QUICK's NS block
NS_KW = dict(Re=1e3, Gr=1e3 / 0.71, P=3, N_ex=3, N_ey=3, iprint=[])

_WORKER = r'''
import contextlib, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
out, cfg = sys.argv[2], json.loads(sys.argv[3])
import sem_tpu_torch.models.navier_stokes as nsm
from sem_tpu_torch import NavierStokesSolver
from sem_tpu_torch.coupling import build_coupled, run, run_parallel
from sem_tpu_torch.krylov import KrylovInfo, fgmres
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import COLLECTIVES, RowStrips
from sem_tpu_torch.parallel import init_distributed, make_group, use_group

f64 = torch.float64
grouped = "SEM_TPU_NUM_PROCESSES" in os.environ
if grouped:
    rank, world, _ = init_distributed(device="cpu")
    group = make_group()
    tag = f"rank{rank}"
else:
    rank, group, tag = 0, None, "single"
res = {}
plot = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                   indexing="ij")


def ctx():
    return use_group(group) if grouped else contextlib.nullcontext()


def save(name, **fields):
    np.savez(f"{out}/{name}_{tag}.npz",
             **{k: np.asarray(v, dtype=np.float64) for k, v in fields.items()})


def reset():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def coupled(name, **kw):
    """run_parallel (run in the single process) of QUICK or PTC_KW: its
    stats, coupled GMRES iterations and state."""
    fn = run_parallel if grouped else run
    *_, s, stats = fn(plot, 1.0, 1.0, device="cpu", return_state=True, **kw)
    res[name] = dict(stats=stats.as_list(), gmres=stats.gmres_iters)
    save(name, T=s.T, u=s.u, v=s.v, p=s.p)


# (a) fgmres on strips: a dense diagonally dominant operator whose rows
# follow the strips of the QUICK NS grid, a fixed and a varying right
# preconditioner
grid = Grid2D(3, 3, 3, 1.0, 1.0)
rng = np.random.default_rng(7)
n = grid.N
A = torch.tensor(np.diag(rng.uniform(1.0, 10.0, n))
                 + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n))
b = torch.tensor(rng.standard_normal(n))
d = 1.0 / torch.diagonal(A)
if grouped:
    st = RowStrips(grid, group)
    lo, hi = (r * grid.Ngy for r in st.rows)
    cut, gather = (lambda x: x[lo:hi]), st.gather
else:
    cut = gather = lambda x: x
A_loc, d_loc = cut(A), cut(d)
for varying in (0, 1):
    calls = [0]

    def pc(r):
        calls[0] += 1
        return r * d_loc ** (1.0 + 0.25 * varying * (calls[0] % 3))

    x, info = fgmres(lambda q: A_loc @ gather(q), cut(b),
                     atol=1e-10 * float(torch.linalg.vector_norm(b)),
                     restart=8, maxiter=200, precon=pc, group=group)
    res[f"fgmres{varying}"] = dict(its=info.iterations,
                                   converged=bool(info.converged))
    save(f"fgmres{varying}", x=gather(x))


def ns_problem():
    """NS_KW linearized at a smooth wind of Boussinesq scale; the tangent
    residual of a smooth field as the right-hand side."""
    ns = NavierStokesSolver(1.0, 1.0, device="cpu", **cfg["ns"])
    xp, yp = (torch.as_tensor(a) for a in ns.points)
    ns._calc_jacobians(0.01 * torch.sin(np.pi * xp) * torch.sin(np.pi * yp),
                       0.01 * xp * (1 - xp) * yp)
    rhs = ns._get_dresiduals(xp * (1 - xp) * yp * (1 - yp),
                             torch.sin(np.pi * xp) * torch.sin(np.pi * yp)
                             ** 2, torch.cos(np.pi * xp) * yp)
    return ns, torch.cat(rhs)


# the flexible f32 chunks of (b) and (f): iterations, converged, stalled
chunks, fgmres_ = [], nsm.fgmres


def logged(*a, **k):
    out = fgmres_(*a, **k)
    chunks.append([out[1].iterations, bool(out[1].converged),
                   bool(out[1].stalled)])
    return out


nsm.fgmres = logged
# (b) the flexible strip chunks at a fixed linearization
with ctx():
    ns, rhs = ns_problem()
    reset()
    x, info = ns._update_coupled_mixed(
        rhs, torch.zeros(ns.N, dtype=f64), 1e-10, velo_inner=5)
res["mixed5"] = dict(its=info.iterations, converged=bool(info.converged),
                     collectives=dict(COLLECTIVES), chunks=chunks[:])
chunks.clear()
save("mixed5", x=x)

# (f) escalation step 1: the plain chunks are made to report a floor at
# their starting iterate (they do not run); the velo_inner=5 retry runs
with ctx():
    ns, rhs = ns_problem()
    orig, retry = ns._update_coupled_mixed, []

    def patched(b_, dp0, mtol, velo_inner=None, x0_full=None):
        if velo_inner is None:
            nb = float(torch.linalg.vector_norm(b_))
            x0 = torch.cat([torch.zeros(2 * ns.N, dtype=f64), dp0])
            return x0, KrylovInfo(converged=False, iterations=1, resnorm=nb,
                                  stalled=True, bnorm=nb)
        retry.append(orig(b_, dp0, mtol, velo_inner=velo_inner,
                          x0_full=x0_full))
        return retry[-1]

    ns._update_coupled_mixed = patched
    ns._get_update(*rhs.split(ns.N), mtol=1e-10)
res["escalation"] = dict(flex=ns.flex_retry_count, f64=ns.f64_fallback_count,
                         retries=len(retry), its=retry[0][1].iterations,
                         converged=bool(retry[0][1].converged),
                         chunks=chunks[:])
nsm.fgmres = fgmres_
save("retry", x=retry[0][0])

# (c) velo_inner=5, JNK and PTC
coupled("jnk5", mode="JNK", velo_inner=5, **cfg["quick"], **cfg["unfused"])
coupled("ptc5", mode="PTC", velo_inner=5, **cfg["ptc"], **cfg["unfused"])

# (d) fused=True, and the collectives of one fused step
with ctx():
    _, _, mda = build_coupled(1.0, 1.0, mode="JNK", fused=True, device="cpu",
                              device_krylov=False, **cfg["quick"])
    s = mda.solve()
    res["fused"] = dict(stats=mda.stats.as_list(),
                        gmres=mda.stats.gmres_iters)
    save("fused", T=s.T, u=s.u, v=s.v, p=s.p)
    start, step, precon_split = mda._fg_fused(mtol=mda.mtol_precon)
    o = start(torch.zeros(mda.DOF, dtype=f64),
              torch.linspace(-1.0, 1.0, mda.DOF, dtype=f64))
    z = precon_split(*o[6:-1])
    reset()
    step(*o[:6], 0, *z)
    res["fused_step_collectives"] = dict(COLLECTIVES)

# the fused preconditioner over the flexible strip chunks
coupled("fused5", mode="JNK", fused=True, device_krylov=False, velo_inner=5,
        **cfg["quick"])

# (e) device_krylov=True
coupled("devk", mode="JNK", device_krylov=True, **cfg["quick"])

# (g) run_parallel(devices=[0]); the single process: QUICK JNK
if grouped:
    r = run_parallel(plot, 1.0, 1.0, mode="JNK", device="cpu",
                     return_state=True, devices=[0], **cfg["quick"])
    res["devices0_none"] = r is None
    if r is not None:
        res["jnk"] = dict(stats=r[4].as_list(), gmres=r[4].gmres_iters)
        save("jnk", T=r[3].T, u=r[3].u, v=r[3].v, p=r[3].p)
    g1 = make_group([1])
    res["ranks1"] = None if g1 is None else [g1.rank, g1.world, g1.members]
    # (h) one host: the automatic layout is flat, dcn=True raises
    res["hosts"] = make_group().hosts
    try:
        make_group(dcn=True)
        res["dcn"] = "built"
    except ValueError as err:
        res["dcn"] = str(err)
else:
    coupled("jnk", mode="JNK", **cfg["quick"])

with open(f"{out}/{tag}.json", "w") as f:
    json.dump(res, f)
if grouped:
    # leaving with the gloo group alive can abort at interpreter exit
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_solve(fused, **kw):
    """``sem_tpu``'s coupled solve under ``use_mesh(make_mesh())`` on the 8
    virtual devices, host FGMRES (``device_krylov=False``) with both fused
    switches at ``fused``: its stats, coupled GMRES iterations and
    state."""
    flag = "1" if fused else "0"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", flag)
        mp.setenv("SEM_TPU_FUSED_PC", flag)
        with use_mesh(make_mesh()):
            _, _, mda = jax_build_coupled(1.0, 1.0, device_krylov=False, **kw)
            s = mda.solve()
    return (dict(stats=mda.stats.as_list(), gmres=mda.stats.gmres_iters),
            {k: np.asarray(getattr(s, k)) for k in "Tuvp"})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two gloo ranks and one single process of the worker (one torch
    thread each, killed on failure or after 300 s), with ``sem_tpu``'s mesh
    runs computed meanwhile.  Returns ``(results by tag, dir, sem_tpu's
    runs)``."""
    out = tmp_path_factory.mktemp("parallel_programs")
    port = _free_port()
    cfg = json.dumps({"quick": QUICK, "ptc": PTC_KW, "ns": NS_KW,
                      "unfused": UNFUSED})
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("SEM_TPU_")}
    base.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    envs = [dict(base, SEM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                 SEM_TPU_NUM_PROCESSES="2", SEM_TPU_PROCESS_ID=str(r))
            for r in range(2)] + [base]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(ROOT), str(out), cfg], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for env in envs]
    outs = []
    try:
        jax = {"jnk5": _jax_solve(False, mode="JNK", velo_inner=5, **QUICK),
               "ptc5": _jax_solve(False, mode="PTC", velo_inner=5,
                                  **PTC_KW),
               "fused": _jax_solve(True, mode="JNK", **QUICK)}
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for tag, (p, o) in zip(("rank0", "rank1", "single"), zip(procs, outs)):
        assert p.returncode == 0, f"{tag} failed:\n{o[-4000:]}"
    res = {tag: json.loads((out / f"{tag}.json").read_text())
           for tag in ("rank0", "rank1", "single")}
    return res, out, jax


def _fields(out, name, tag):
    with np.load(out / f"{name}_{tag}.npz") as z:
        return {k: z[k] for k in z.files}


def _ranks_equal(out, name):
    """Both ranks' fields of ``name``, bitwise equal; returns rank 0's."""
    f0, f1 = (_fields(out, name, f"rank{r}") for r in range(2))
    assert f0.keys() == f1.keys()
    for k in f0:
        np.testing.assert_array_equal(f0[k], f1[k], err_msg=f"{name}.{k}")
    return f0


def _chunks_agree(got, ref):
    """The flexible f32 chunks of two solves, pass by pass: as many chunks,
    each converged or floored (stalled) alike; a converged chunk's
    iterations within ±2 (reduction order, ROADMAP C3), a floored one's
    within a third (where the in-cycle plateau test fires near the f32
    floor moves with the rounding, ROADMAP C7)."""
    assert len(got) == len(ref), (got, ref)
    for (ig, cg, sg), (ir, cr, sr) in zip(got, ref):
        assert (cg, sg) == (cr, sr), (got, ref)
        assert abs(ig - ir) <= (2 if cg else max(2, ir / 3)), (got, ref)


def _close(got, ref, rtol):
    for k in ref:
        scale = max(float(np.max(np.abs(ref[k]))), 1e-300)
        err = float(np.max(np.abs(got[k] - ref[k]))) / scale
        assert err <= rtol, (k, err)


@pytest.mark.parametrize("varying", [0, 1], ids=["fixed", "varying"])
def test_fgmres_on_strips_matches_full(runs, varying):
    """(a) ``fgmres(group=)`` on this rank's strips against ``fgmres`` on
    the full vectors, with a fixed and with a varying right
    preconditioner: equal iterations, x within 1e-10 relative (f64)."""
    res, out, _ = runs
    name = f"fgmres{varying}"
    got = _ranks_equal(out, name)
    assert res["rank0"][name] == res["rank1"][name] == res["single"][name]
    assert res["single"][name]["converged"]
    _close(got, _fields(out, name, "single"), 1e-10)


def test_flexible_strip_chunks_match_single_process(runs):
    """(b) ``_update_coupled_mixed(velo_inner=5)`` at a fixed
    linearization, two ranks against one process: both converge, x within
    1e-6 relative, the f32 chunks as :func:`_chunks_agree` holds them (the
    second floors: 76 iterations in one process, 82 on the ranks); each
    rank ran halo exchanges, strip gathers and all-reduces."""
    res, out, _ = runs
    got = _ranks_equal(out, "mixed5")
    r0, r1, single = (res[t]["mixed5"] for t in ("rank0", "rank1", "single"))
    assert r0 == r1
    assert r0["converged"] and single["converged"]
    _chunks_agree(r0["chunks"], single["chunks"])
    assert all(n > 0 for n in r0["collectives"].values()), r0
    assert single["collectives"] == dict.fromkeys(r0["collectives"], 0)
    _close(got, _fields(out, "mixed5", "single"), 1e-6)


def test_escalation_step_1_under_the_group(runs):
    """(f) A plain solve that reports a floor escalates to the flexible
    ``velo_inner=5`` retry on the strips: one retry in each rank, adopted
    and converged (no f64 rescue), its x within 1e-6 relative of the same
    retry in one process, its f32 chunks as :func:`_chunks_agree` holds
    them."""
    res, out, _ = runs
    got = _ranks_equal(out, "retry")
    esc = [res[t]["escalation"] for t in ("rank0", "rank1", "single")]
    assert esc[0] == esc[1]
    for e in esc:
        assert (e["flex"], e["f64"], e["retries"]) == (1, 0, 1), e
        assert e["converged"], e
    _chunks_agree(esc[0]["chunks"], esc[2]["chunks"])
    _close(got, _fields(out, "retry", "single"), 1e-6)


@pytest.mark.parametrize("name", ["jnk5", "ptc5"])
def test_velo_inner_run_parallel_matches(runs, name):
    """(c) ``run_parallel(velo_inner=5)``, QUICK JNK and the PTC march,
    against the port's single process and against ``sem_tpu``'s mesh run
    (un-fused host FGMRES): equal MDA stats and coupled GMRES iterations,
    the fields within 1e-6 relative."""
    res, out, jax = runs
    got = _ranks_equal(out, name)
    assert res["rank0"][name] == res["rank1"][name] == res["single"][name]
    assert res["rank0"][name] == jax[name][0]
    _close(got, _fields(out, name, "single"), 1e-6)
    _close(got, jax[name][1], 1e-6)


def test_fused_under_the_group_matches(runs):
    """(d) ``fused=True`` under the group against the port's single
    process and against ``sem_tpu``'s mesh run with both fused switches
    on: equal stats, the fields within 1e-6 relative; one fused step runs
    no collective."""
    res, out, jax = runs
    got = _ranks_equal(out, "fused")
    assert res["rank0"]["fused"] == res["rank1"]["fused"] \
        == res["single"]["fused"]
    assert res["rank0"]["fused"]["stats"] == jax["fused"][0]["stats"]
    _close(got, _fields(out, "fused", "single"), 1e-6)
    _close(got, jax["fused"][1], 1e-6)
    for t in ("rank0", "rank1"):
        assert res[t]["fused_step_collectives"] == {
            "halo_exchange": 0, "strip_gather": 0, "all_reduce": 0}


def test_fused_flexible_under_the_group_matches(runs):
    """(d) ``fused=True`` with ``velo_inner=5``: the two-round
    preconditioner over the flexible strip chunks, against the port's
    single process: equal stats and coupled GMRES iterations, the fields
    within 1e-6 relative."""
    res, out, _ = runs
    got = _ranks_equal(out, "fused5")
    assert res["rank0"]["fused5"] == res["rank1"]["fused5"] \
        == res["single"]["fused5"]
    _close(got, _fields(out, "fused5", "single"), 1e-6)


def test_device_krylov_under_the_group_matches(runs):
    """(e) ``device_krylov=True`` under the group against the port's
    single process: equal stats and coupled GMRES iterations, the fields
    within 1e-6 relative (the windows' f64 solves are replicated; only the
    iteration-0 sweep's f32 chunks run on strips)."""
    res, out, _ = runs
    got = _ranks_equal(out, "devk")
    assert res["rank0"]["devk"] == res["rank1"]["devk"] \
        == res["single"]["devk"]
    _close(got, _fields(out, "devk", "single"), 1e-6)


def test_run_parallel_devices_subset(runs):
    """(g) ``run_parallel(devices=[0])``: rank 0 solves alone, a group of
    one rank, so the single-device code, and equals the single process
    bitwise; rank 1 returns ``None``.  ``make_group([1])`` is ``None`` on
    rank 0 and a one-rank group on rank 1."""
    res, out, _ = runs
    assert res["rank0"]["devices0_none"] is False
    assert res["rank1"]["devices0_none"] is True
    assert "jnk" not in res["rank1"]
    assert res["rank0"]["jnk"] == res["single"]["jnk"]
    ref = _fields(out, "jnk", "single")
    for k, a in _fields(out, "jnk", "rank0").items():
        np.testing.assert_array_equal(a, ref[k])
    assert res["rank0"]["ranks1"] is None
    assert res["rank1"]["ranks1"] == [0, 1, [1]]


def test_make_group_dcn_on_one_host(runs):
    """(h) Both ranks on one host: ``make_group()`` is flat (``hosts`` is
    None) and ``make_group(dcn=True)`` raises ``ValueError``."""
    res, _, _ = runs
    for t in ("rank0", "rank1"):
        assert res[t]["hosts"] is None
        assert "only one host" in res[t]["dcn"], res[t]["dcn"]


class _Dist:
    """``torch.distributed`` of one process that believes it is ``rank`` of
    ``world`` ranks on the given hosts (what ``make_group`` reads)."""

    def __init__(self, rank, hosts):
        self.rank, self.hosts, self.groups = rank, hosts, []

    def is_initialized(self):
        return True

    def get_world_size(self):
        return len(self.hosts)

    def get_rank(self):
        return self.rank

    def get_backend(self, pg=None):
        return "fake"

    def all_gather_object(self, out, obj):
        out[:] = self.hosts

    def new_group(self, ranks):
        self.groups.append(ranks)
        return ("pg", tuple(ranks))


@pytest.mark.parametrize("hosts,dcn,want", [
    (["a", "b", "a", "b"], None, ((0, 2), (1, 3))),
    (["a", "b", "a", "b"], True, ((0, 2), (1, 3))),
    (["a", "b", "a", "b"], False, None),
    (["a", "a", "a", "b"], None, None),
    (["a", "a", "a", "b"], True, ValueError),
    (["a", "a", "a", "a"], True, ValueError)])
def test_make_group_host_layout(monkeypatch, hosts, dcn, want):
    """The two-level rules of ``sem_tpu``'s ``make_mesh(dcn=)``: automatic
    over more than one host with even counts per host, flat otherwise;
    ``dcn=True`` raises on one host or uneven counts.  A two-level group
    orders its strips host by host, and its all-gather returns the
    process group's outputs in that order."""
    import torch
    import torch.distributed as tdist
    from sem_tpu_torch.parallel import make_group

    fake = _Dist(1, hosts)
    for name in ("is_initialized", "get_world_size", "get_rank",
                 "get_backend", "all_gather_object", "new_group"):
        monkeypatch.setattr(tdist, name, getattr(fake, name))
    if want is ValueError:
        with pytest.raises(ValueError, match="dcn=True"):
            make_group(dcn=dcn)
        return
    g = make_group(dcn=dcn)
    assert g.hosts == want and g.world == 4 and fake.groups == []
    members = [0, 1, 2, 3] if want is None else [0, 2, 1, 3]
    assert g.members == members and g.rank == members.index(1)

    def all_gather(out, t, group=None):
        for i in range(len(out)):      # process-group order: by rank
            out[i].copy_(t + i)
    monkeypatch.setattr(tdist, "all_gather", all_gather)
    got = [int(t) for t in g.all_gather(torch.zeros(()))]
    assert got == members
    with pytest.raises(ValueError, match="subset"):
        make_group(ranks=[7])
