"""The worker of the multi-process parity modules
(``tests/test_torch_parallel_programs*.py``) and what their fixtures share.

:func:`run_workers` starts two gloo ranks and one single process of this
file on a list of cases, one torch thread each, and computes ``sem_tpu``'s
mesh solves the module compares against meanwhile.  Each case writes its
numbers under its own names into ``<tag>.json`` (``rank0``, ``rank1``,
``single``) and its fields into ``<name>_<tag>.npz``.  The cases, by their
letters in the tests' docstrings:

* ``fgmres`` (a): ``fgmres(group=)`` on strips (``fgmres0``, ``fgmres1``);
* ``mixed5`` (b): the flexible ``velo_inner=5`` strip chunks;
* ``jnk5``, ``ptc5`` (c): ``run_parallel(velo_inner=5)``, JNK and PTC;
* ``fused`` (d): ``fused=True`` and one fused step's collectives
  (``fused``, ``fused_step_collectives``), and over the flexible chunks
  (``fused5``);
* ``devk`` (e): ``device_krylov=True``;
* ``escalation`` (f): escalation step 1 under the group (``escalation``,
  ``retry``);
* ``devices`` (g): ``run_parallel(devices=[0])`` and ``make_group([1])``
  (``devices0_none``, ``jnk``, ``ranks1``; the single process: QUICK JNK);
* ``dcn`` (h): ``make_group(dcn=)`` on one host (``hosts``, ``dcn``).

Run by hand: ``python tests/torch_parallel_worker.py <out dir> <cases>``,
e.g. ``fgmres,mixed5``, with the ``SEM_TPU_*`` variables of a rank or
without them for the single process.  The worker imports no JAX.
``device="cpu"`` throughout.
"""
import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

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
TAGS = ("rank0", "rank1", "single")
#: seconds the fixture waits for its workers
TIMEOUT = 300


# ------------------------------ the worker ------------------------------ #
class _Worker:
    """One process of the worker: a rank of the gloo group (the
    ``SEM_TPU_*`` variables set) or the single process."""

    def __init__(self, out):
        import torch
        from sem_tpu_torch.parallel import init_distributed, make_group

        torch.set_num_threads(1)
        self.out, self.res = out, {}
        self.grouped = "SEM_TPU_NUM_PROCESSES" in os.environ
        if self.grouped:
            rank, _, _ = init_distributed(device="cpu")
            self.group, self.tag = make_group(), f"rank{rank}"
        else:
            self.group, self.tag = None, "single"
        self.plot = np.meshgrid(np.linspace(0, 1, 21),
                                np.linspace(0, 1, 21), indexing="ij")

    def ctx(self):
        from sem_tpu_torch.parallel import use_group

        return (use_group(self.group) if self.grouped
                else contextlib.nullcontext())

    def save(self, name, **fields):
        np.savez(f"{self.out}/{name}_{self.tag}.npz",
                 **{k: np.asarray(v, dtype=np.float64)
                    for k, v in fields.items()})

    def coupled(self, name, **kw):
        """run_parallel (run in the single process) of QUICK or PTC_KW: its
        stats, coupled GMRES iterations and state."""
        from sem_tpu_torch.coupling import run, run_parallel

        fn = run_parallel if self.grouped else run
        *_, s, stats = fn(self.plot, 1.0, 1.0, device="cpu",
                          return_state=True, **kw)
        self.res[name] = dict(stats=stats.as_list(), gmres=stats.gmres_iters)
        self.save(name, T=s.T, u=s.u, v=s.v, p=s.p)

    def finish(self):
        with open(f"{self.out}/{self.tag}.json", "w") as f:
            json.dump(self.res, f)
        if self.grouped:
            # leaving with the gloo group alive can abort at interpreter exit
            import torch.distributed as dist
            dist.barrier()
            dist.destroy_process_group()


def _reset_collectives():
    from sem_tpu_torch.ops import COLLECTIVES

    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def case_fgmres(w):
    """fgmres on strips: a dense diagonally dominant operator whose rows
    follow the strips of the QUICK NS grid, a fixed and a varying right
    preconditioner."""
    import torch
    from sem_tpu_torch.krylov import fgmres
    from sem_tpu_torch.mesh import Grid2D
    from sem_tpu_torch.ops import RowStrips

    grid = Grid2D(3, 3, 3, 1.0, 1.0)
    rng = np.random.default_rng(7)
    n = grid.N
    A = torch.tensor(np.diag(rng.uniform(1.0, 10.0, n))
                     + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n))
    b = torch.tensor(rng.standard_normal(n))
    d = 1.0 / torch.diagonal(A)
    if w.grouped:
        st = RowStrips(grid, w.group)
        lo, hi = (r * grid.Ngy for r in st.rows)
        cut, gather = (lambda x: x[lo:hi]), st.gather
    else:
        cut = gather = lambda x: x  # noqa: E731
    A_loc, d_loc = cut(A), cut(d)
    for varying in (0, 1):
        calls = [0]

        def pc(r):
            calls[0] += 1
            return r * d_loc ** (1.0 + 0.25 * varying * (calls[0] % 3))

        x, info = fgmres(lambda q: A_loc @ gather(q), cut(b),
                         atol=1e-10 * float(torch.linalg.vector_norm(b)),
                         restart=8, maxiter=200, precon=pc, group=w.group)
        w.res[f"fgmres{varying}"] = dict(its=info.iterations,
                                         converged=bool(info.converged))
        w.save(f"fgmres{varying}", x=gather(x))


def _ns_problem():
    """NS_KW linearized at a smooth wind of Boussinesq scale; the tangent
    residual of a smooth field as the right-hand side."""
    import torch
    from sem_tpu_torch import NavierStokesSolver

    ns = NavierStokesSolver(1.0, 1.0, device="cpu", **NS_KW)
    xp, yp = (torch.as_tensor(a) for a in ns.points)
    ns._calc_jacobians(0.01 * torch.sin(np.pi * xp) * torch.sin(np.pi * yp),
                       0.01 * xp * (1 - xp) * yp)
    rhs = ns._get_dresiduals(xp * (1 - xp) * yp * (1 - yp),
                             torch.sin(np.pi * xp) * torch.sin(np.pi * yp)
                             ** 2, torch.cos(np.pi * xp) * yp)
    return ns, torch.cat(rhs)


@contextlib.contextmanager
def _logged_chunks():
    """The flexible f32 chunks of the enclosed solves: iterations,
    converged, stalled."""
    import sem_tpu_torch.models.navier_stokes as nsm

    chunks, fgmres_ = [], nsm.fgmres

    def logged(*a, **k):
        out = fgmres_(*a, **k)
        chunks.append([out[1].iterations, bool(out[1].converged),
                       bool(out[1].stalled)])
        return out

    nsm.fgmres = logged
    try:
        yield chunks
    finally:
        nsm.fgmres = fgmres_


def case_mixed5(w):
    """The flexible strip chunks at a fixed linearization."""
    import torch
    from sem_tpu_torch.ops import COLLECTIVES

    with _logged_chunks() as chunks, w.ctx():
        ns, rhs = _ns_problem()
        _reset_collectives()
        x, info = ns._update_coupled_mixed(
            rhs, torch.zeros(ns.N, dtype=torch.float64), 1e-10,
            velo_inner=5)
    w.res["mixed5"] = dict(its=info.iterations,
                           converged=bool(info.converged),
                           collectives=dict(COLLECTIVES), chunks=chunks)
    w.save("mixed5", x=x)


def case_escalation(w):
    """Escalation step 1: the plain chunks are made to report a floor at
    their starting iterate (they do not run); the velo_inner=5 retry
    runs."""
    import torch
    from sem_tpu_torch.krylov import KrylovInfo

    f64 = torch.float64
    with _logged_chunks() as chunks, w.ctx():
        ns, rhs = _ns_problem()
        orig, retry = ns._update_coupled_mixed, []

        def patched(b_, dp0, mtol, velo_inner=None, x0_full=None):
            if velo_inner is None:
                nb = float(torch.linalg.vector_norm(b_))
                x0 = torch.cat([torch.zeros(2 * ns.N, dtype=f64), dp0])
                return x0, KrylovInfo(converged=False, iterations=1,
                                      resnorm=nb, stalled=True, bnorm=nb)
            retry.append(orig(b_, dp0, mtol, velo_inner=velo_inner,
                              x0_full=x0_full))
            return retry[-1]

        ns._update_coupled_mixed = patched
        ns._get_update(*rhs.split(ns.N), mtol=1e-10)
    w.res["escalation"] = dict(flex=ns.flex_retry_count,
                               f64=ns.f64_fallback_count,
                               retries=len(retry),
                               its=retry[0][1].iterations,
                               converged=bool(retry[0][1].converged),
                               chunks=chunks)
    w.save("retry", x=retry[0][0])


def case_jnk5(w):
    """velo_inner=5, JNK."""
    from tests.torch_parity import UNFUSED

    w.coupled("jnk5", mode="JNK", velo_inner=5, **QUICK, **UNFUSED)


def case_ptc5(w):
    """velo_inner=5, the PTC march."""
    from tests.torch_parity import UNFUSED

    w.coupled("ptc5", mode="PTC", velo_inner=5, **PTC_KW, **UNFUSED)


def case_fused(w):
    """fused=True, the collectives of one fused step, and the fused
    preconditioner over the flexible strip chunks."""
    import torch
    from sem_tpu_torch.coupling import build_coupled
    from sem_tpu_torch.ops import COLLECTIVES

    f64 = torch.float64
    with w.ctx():
        _, _, mda = build_coupled(1.0, 1.0, mode="JNK", fused=True,
                                  device="cpu", device_krylov=False, **QUICK)
        s = mda.solve()
        w.res["fused"] = dict(stats=mda.stats.as_list(),
                              gmres=mda.stats.gmres_iters)
        w.save("fused", T=s.T, u=s.u, v=s.v, p=s.p)
        start, step, precon_split = mda._fg_fused(mtol=mda.mtol_precon)
        o = start(torch.zeros(mda.DOF, dtype=f64),
                  torch.linspace(-1.0, 1.0, mda.DOF, dtype=f64))
        z = precon_split(*o[6:-1])
        _reset_collectives()
        step(*o[:6], 0, *z)
        w.res["fused_step_collectives"] = dict(COLLECTIVES)
    w.coupled("fused5", mode="JNK", fused=True, device_krylov=False,
              velo_inner=5, **QUICK)


def case_devk(w):
    """device_krylov=True."""
    w.coupled("devk", mode="JNK", device_krylov=True, **QUICK)


def case_devices(w):
    """run_parallel(devices=[0]) and make_group([1]); the single process:
    QUICK JNK."""
    from sem_tpu_torch.coupling import run_parallel
    from sem_tpu_torch.parallel import make_group

    if not w.grouped:
        w.coupled("jnk", mode="JNK", **QUICK)
        return
    r = run_parallel(w.plot, 1.0, 1.0, mode="JNK", device="cpu",
                     return_state=True, devices=[0], **QUICK)
    w.res["devices0_none"] = r is None
    if r is not None:
        w.res["jnk"] = dict(stats=r[4].as_list(), gmres=r[4].gmres_iters)
        w.save("jnk", T=r[3].T, u=r[3].u, v=r[3].v, p=r[3].p)
    g1 = make_group([1])
    w.res["ranks1"] = None if g1 is None else [g1.rank, g1.world,
                                               g1.members]


def case_dcn(w):
    """One host: the automatic layout is flat, dcn=True raises."""
    from sem_tpu_torch.parallel import make_group

    if not w.grouped:
        return
    w.res["hosts"] = make_group().hosts
    try:
        make_group(dcn=True)
        w.res["dcn"] = "built"
    except ValueError as err:
        w.res["dcn"] = str(err)


CASES = dict(fgmres=case_fgmres, mixed5=case_mixed5, jnk5=case_jnk5,
             ptc5=case_ptc5, fused=case_fused, devk=case_devk,
             escalation=case_escalation, devices=case_devices, dcn=case_dcn)


def main(out, cases):
    sys.path.insert(0, str(ROOT))
    w = _Worker(out)
    for c in cases:
        CASES[c](w)
    w.finish()


# --------------------------- the fixtures' side --------------------------- #
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_solve(fused, **kw):
    """``sem_tpu``'s coupled solve under ``use_mesh(make_mesh())`` on the 8
    virtual devices of tests/conftest.py, host FGMRES
    (``device_krylov=False``) with both fused switches at ``fused``: its
    stats, coupled GMRES iterations and state."""
    import pytest
    from sem_tpu.coupling import build_coupled as jax_build_coupled
    from sem_tpu.parallel.sharding import make_mesh, use_mesh

    flag = "1" if fused else "0"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", flag)
        mp.setenv("SEM_TPU_FUSED_PC", flag)
        with use_mesh(make_mesh()):
            _, _, mda = jax_build_coupled(1.0, 1.0, device_krylov=False, **kw)
            s = mda.solve()
    return (dict(stats=mda.stats.as_list(), gmres=mda.stats.gmres_iters),
            {k: np.asarray(getattr(s, k)) for k in "Tuvp"})


def run_workers(out, cases, jax_runs):
    """Two gloo ranks and one single process of the worker on ``cases``
    (one torch thread each, killed on failure or after :data:`TIMEOUT`
    s), with ``sem_tpu``'s mesh solves ``jax_runs`` (name: ``(fused,
    kwargs)`` of :func:`jax_solve`) computed meanwhile.  Returns
    ``(results by tag, out, sem_tpu's runs by name)``."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("SEM_TPU_")}
    base.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    envs = [dict(base, SEM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                 SEM_TPU_NUM_PROCESSES="2", SEM_TPU_PROCESS_ID=str(r))
            for r in range(2)] + [base]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(out), ",".join(cases)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for env in envs]
    outs = []
    try:
        jax = {name: jax_solve(fused, **kw)
               for name, (fused, kw) in jax_runs.items()}
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for tag, p, o in zip(TAGS, procs, outs):
        assert p.returncode == 0, f"{tag} failed:\n{o[-4000:]}"
    res = {tag: json.loads((out / f"{tag}.json").read_text())
           for tag in TAGS}
    return res, out, jax


def fields(out, name, tag):
    with np.load(out / f"{name}_{tag}.npz") as z:
        return {k: z[k] for k in z.files}


def ranks_equal(out, name):
    """Both ranks' fields of ``name``, bitwise equal; returns rank 0's."""
    f0, f1 = (fields(out, name, f"rank{r}") for r in range(2))
    assert f0.keys() == f1.keys()
    for k in f0:
        np.testing.assert_array_equal(f0[k], f1[k], err_msg=f"{name}.{k}")
    return f0


def chunks_agree(got, ref):
    """The flexible f32 chunks of two solves, pass by pass: as many chunks,
    each converged or floored (stalled) alike; a converged chunk's
    iterations within ±2 (reduction order, ROADMAP C3), a floored one's
    within a third (where the in-cycle plateau test fires near the f32
    floor moves with the rounding, ROADMAP C7)."""
    assert len(got) == len(ref), (got, ref)
    for (ig, cg, sg), (ir, cr, sr) in zip(got, ref):
        assert (cg, sg) == (cr, sr), (got, ref)
        assert abs(ig - ir) <= (2 if cg else max(2, ir / 3)), (got, ref)


def close(got, ref, rtol):
    for k in ref:
        scale = max(float(np.max(np.abs(ref[k]))), 1e-300)
        err = float(np.max(np.abs(got[k] - ref[k]))) / scale
        assert err <= rtol, (k, err)


def velo_inner_matches(runs, name):
    """(c) ``run_parallel(velo_inner=5)`` of ``name`` (``jnk5``: QUICK JNK,
    ``ptc5``: the PTC march) against the port's single process and against
    ``sem_tpu``'s mesh run (un-fused host FGMRES): equal MDA stats and
    coupled GMRES iterations, the fields within 1e-6 relative."""
    res, out, jax = runs
    got = ranks_equal(out, name)
    assert res["rank0"][name] == res["rank1"][name] == res["single"][name]
    assert res["rank0"][name] == jax[name][0]
    close(got, fields(out, name, "single"), 1e-6)
    close(got, jax[name][1], 1e-6)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2].split(","))
