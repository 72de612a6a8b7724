"""Port parity, the fused and on-device coupled Krylov programs of the MDA:
the fused host-FGMRES step (``fused=True``), the fixed two-round block
preconditioner and the on-device JNK windows (``device_krylov=True``) of
``sem_tpu_torch.coupling.mda`` against the same programs of
``sem_tpu.coupling.mda``, which these tests run as its own tests do (on the
CPU, the environment switches set explicitly).  ``device="cpu"`` throughout;
tolerances are stated per test."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu.coupling import build_coupled as jax_build_coupled
from sem_tpu.coupling.mda import CoupledState as JState
from sem_tpu.coupling.mda import _fgmres as jax_fgmres
from sem_tpu.krylov import _givens_update as jax_givens_update
from sem_tpu_torch.convert import state_from_numpy
from sem_tpu_torch.coupling import build_coupled
from sem_tpu_torch.coupling import mda as tmda
from sem_tpu_torch.coupling.mda import _fgmres
from sem_tpu_torch.krylov import _givens_update_device
from sem_tpu_torch.utils.profiling import COUNTERS

from tests.torch_parity import (one_torch_thread, port_unfused,  # noqa
                                rel_err, t32, t64)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the QUICK configuration and plot points of tests/test_coupling.py:35-38
QUICK = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=3, N_ex_cd=3, N_ey_cd=3,
             P_ns=3, N_ex_ns=3, N_ey_ns=3, iprint=False)
PLOT21 = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                     indexing="ij")
# the PTC configuration of tests/test_ptc.py:146-147
PTC_KW = dict(Re=1e3, Ra=1e4, Pr=0.71, P_cd=3, N_ex_cd=4, N_ey_cd=4,
              P_ns=3, N_ex_ns=8, N_ey_ns=8, mtol_nonlin=1e-8, iprint=False)


def _jax(monkeypatch, fused, **kw):
    """``sem_tpu``'s MDA with its fused host programs switched on or off."""
    flag = "1" if fused else "0"
    monkeypatch.setenv("SEM_TPU_FG_FUSED", flag)
    monkeypatch.setenv("SEM_TPU_FUSED_PC", flag)
    return jax_build_coupled(1.0, 1.0, **kw)


def _linearized_pair(jmda, mda, sigma_dt=None):
    """Both MDAs linearized at sem_tpu's loose Gauss-Seidel sweep from zero
    (carried to the port); with ``sigma_dt`` the PTC mass shifts of that
    pseudo-time step.  Returns the two states."""
    z, zn = jnp.zeros(jmda.N_cd), jnp.zeros(jmda.N_ns)
    js = jmda._gs_sweep(JState(z, zn, zn, zn), mtol=1e-4)
    s = state_from_numpy(js.T, js.u, js.v, js.p, device="cpu")
    for m, st in ((jmda, js), (mda, s)):
        m._residuals(st)    # the wind of the CD linearization
        kw = {}
        if sigma_dt is not None:
            kw = dict(sigma_cd=m.cd_comp.cd._Pe / sigma_dt,
                      sigma_ns=m.ns_comp.ns._Re / sigma_dt)
        m._linearize(st, **kw)
    return js, s


def _smooth_rhs(jmda):
    """``b = J·x`` of a smooth coupled field ``x`` (never a random vector:
    preconditioner parity on random right-hand sides misleads)."""
    cd, ns = jmda.cd_comp.cd, jmda.ns_comp.ns
    xc, yc = cd.points
    xn, yn = ns.points
    x = np.concatenate([np.sin(np.pi * xc) * np.cos(2 * yc),
                        xn * (1 - xn) * yn * (1 - yn),
                        np.sin(np.pi * xn) * np.sin(np.pi * yn) ** 2,
                        np.cos(np.pi * xn) * yn])
    return jmda._apply_linear(jnp.asarray(x))


def test_givens_update_device_matches_reference():
    """The device Givens update against ``sem_tpu.krylov._givens_update``
    over a whole window of random columns (entries past k+1 zero, as in
    the fused step): h, cs, sn, g and the residual to 1e-14 relative."""
    rng = np.random.default_rng(5)
    m = 12
    cs, sn = np.ones(m), np.zeros(m)
    g = np.zeros(m + 1)
    g[0] = 3.0
    jcs, jsn, jg = jnp.asarray(cs), jnp.asarray(sn), jnp.asarray(g)
    tcs, tsn, tg = t64(cs), t64(sn), t64(g)
    for k in range(m):
        h = np.zeros(m + 1)
        h[:k + 2] = rng.standard_normal(k + 2)
        jh, jcs, jsn, jg, jres = jax_givens_update(
            jnp.asarray(h), jcs, jsn, jg, jnp.int32(k), m,
            jnp.asarray(1e-300))
        th, tcs, tsn, tg, tres = _givens_update_device(
            t64(h), tcs, tsn, tg, torch.tensor(k), m)
        for a, b in ((th, jh), (tcs, jcs), (tsn, jsn), (tg, jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                       atol=1e-14)
        assert abs(float(tres) - float(jres)) <= 1e-14 * float(jres)


def _f64_mda(pkg, **mda_kw):
    """QUICK's coupled problem built by hand with both solvers on their
    float64 path, so that the iteration-0 Gauss-Seidel sweep gives the two
    packages the same state to rounding."""
    if pkg == "port":
        from sem_tpu_torch import ConvectionDiffusionSolver as CD
        from sem_tpu_torch import NavierStokesSolver as NS
        from sem_tpu_torch.coupling.components import (
            ConvectionDiffusionComponent as CC, NavierStokesComponent as NC)
        from sem_tpu_torch.coupling.mda import BoussinesqMDA
        dev = dict(device="cpu")
    else:
        from sem_tpu import ConvectionDiffusionSolver as CD
        from sem_tpu import NavierStokesSolver as NS
        from sem_tpu.coupling.components import (
            ConvectionDiffusionComponent as CC, NavierStokesComponent as NC)
        from sem_tpu.coupling.mda import BoussinesqMDA
        dev = {}
    cd = CD(1.0, 1.0, Pe=1e3 * 0.71, P=3, N_ex=3, N_ey=3, T_W=0.5,
            T_E=-0.5, mtol=1e-13, mixed_precision=False, **dev)
    ns = NS(1.0, 1.0, Re=1e3, Gr=1e3 / 0.71, P=3, N_ex=3, N_ey=3,
            mtol=1e-13, mtol_newton=1e-13, iprint=[], mixed_precision=False,
            **dev)
    return cd, ns, BoussinesqMDA(CC(cd, ns), NC(cd, ns), mode="JNK",
                                 **mda_kw)


def _quick_system(mixed):
    """A JNK tangent system at QUICK in both packages (sem_tpu's fused
    programs on; with ``mixed=False`` both solvers on their float64 path),
    ``-F`` and the tolerance of tests/test_coupling.py:101, and sem_tpu's
    fused ``_fgmres`` on it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", "1")
        mp.setenv("SEM_TPU_FUSED_PC", "1")
        if mixed:
            _, _, jmda = jax_build_coupled(1.0, 1.0, mode="JNK",
                                           device_krylov=False, **QUICK)
            _, _, mda = build_coupled(1.0, 1.0, mode="JNK", device="cpu",
                                      **QUICK)
        else:
            jmda = _f64_mda("jax", iprint=False)[2]
            mda = _f64_mda("port", iprint=False)[2]
        js, s = _linearized_pair(jmda, mda)
        jF, F = jmda._residuals(js), mda._residuals(s)
        atol = 1e-9 * float(np.sqrt(mda.DOF))
        jx, jit, jok = jax_fgmres(None, None, -jF, atol=atol,
                                  restart=jmda.restart, maxiter=200,
                                  fused=jmda._fg_fused(mtol=1e-4))
    return mda, F, atol, (np.asarray(jx), jit, jok)


@pytest.fixture(scope="module")
def quick_systems():
    """:func:`_quick_system` by ``mixed``, made on first use."""
    cache = {}

    def get(mixed):
        if mixed not in cache:
            cache[mixed] = _quick_system(mixed)
        return cache[mixed]

    return get


@pytest.mark.parametrize("pc", ["block_jacobi", "fused"])
def test_fused_fgmres_matches_unfused(pc, quick_systems):
    """The fused host-FGMRES program against the un-fused loop on the same
    linearized system (tests/test_coupling.py:90-123): equal iterations, x
    to rtol 1e-10.  ``block_jacobi``: both with the adaptive block-Jacobi
    preconditioner, so only the Krylov program differs; ``fused``: the
    fused program with its two-round preconditioner, as the reference's
    test runs it."""
    mda, F, atol, _ = quick_systems(True)
    precon = lambda r: mda._block_jacobi(r, mtol=1e-4,  # noqa: E731
                                         best_effort=True)
    x_ref, it_ref, ok_ref = _fgmres(mda._apply_linear, precon, -F,
                                    atol=atol, restart=mda.restart,
                                    maxiter=200)
    start, step, pcs = mda._fg_fused(mtol=1e-4)
    if pc == "block_jacobi":
        def pcs(*r):
            return mda._block_jacobi_split(*r, mtol=1e-4, best_effort=True)
    x_f, it_f, ok_f = _fgmres(None, None, -F, atol=atol,
                              restart=mda.restart, maxiter=200,
                              fused=(start, step, pcs))
    assert ok_ref and ok_f
    assert it_f == it_ref
    np.testing.assert_allclose(x_f.numpy(), x_ref.numpy(), rtol=1e-10,
                               atol=1e-12 * atol)
    with pytest.raises(ValueError, match="restart"):
        _fgmres(None, None, -F, atol=atol, restart=mda.restart + 1,
                maxiter=200, fused=(start, step, pcs))


@pytest.mark.parametrize("mixed", [False, True])
def test_fused_fgmres_matches_reference(mixed, quick_systems):
    """The port's fused ``_fgmres`` against sem_tpu's on the same state:
    equal iterations, x to 1e-6 relative.  Float64 solvers: the fused step
    with the block-Jacobi split (the fused preconditioner needs
    mixed-precision solvers); the default mixed solvers: with the two-round
    preconditioner.  The f32 Arnoldi basis rounds differently in XLA and
    torch (the f32 products sum in another order), and the preconditioner
    sees its rows, so x differs at the f32 level, not at 1e-8 (measured
    2.3e-7 and 1.0e-7; ROADMAP Queue C7)."""
    mda, F, atol, (jx, jit, jok) = quick_systems(mixed)
    x, it, ok = _fgmres(None, None, -F, atol=atol, restart=mda.restart,
                        maxiter=200, fused=mda._fg_fused(mtol=1e-4))
    print(f"iterations port {it} sem_tpu {jit}; x rel diff "
          f"{rel_err(x.numpy(), jx):.3e}")
    assert ok and jok and it == jit
    assert rel_err(x.numpy(), jx) <= 1e-6


@pytest.mark.parametrize("velo_inner", [0, 5])
@pytest.mark.parametrize("precon", ["bj", "bgs", "bgs2"])
def test_fused_pc_application_matches_reference(precon, velo_inner,
                                                monkeypatch):
    """One application of the fused two-round preconditioner on ``b = J·x``
    at a σ-shifted QUICK linearization, port against sem_tpu (the
    row-scaled chunks of ``velo_inner=5`` on sem_tpu's row-norm probes):
    dT, du, dv within 1e-4 relative; dp within 1e-3, the difference in the
    direction the coupled Jacobian barely sees (|J·Δz| ≤ 1e-6·|b|; the
    pressure's near-null mode, measured 2e-4–4e-4 in dp against
    1.3e-7–2.1e-7 in |J·Δz|/|b|); CD chunk iterations within ±2, NS within
    a third (the plain f32 chunk creeps near its floor: 42 against 35 at
    ``bj``/0; ROADMAP Queue C7); one counted solve per discipline."""
    kw = dict(QUICK, mode="PTC", precon=precon, velo_inner=velo_inner)
    _, _, jmda = _jax(monkeypatch, True, device_krylov=False, **kw)
    _, _, mda = build_coupled(1.0, 1.0, device="cpu", **kw)
    _linearized_pair(jmda, mda, sigma_dt=0.25)
    jb = _smooth_rhs(jmda)
    b = t64(jb)
    jmda._pc_fused(mtol=1e-4)     # builds sem_tpu's program
    its = {}
    raw = jmda._pc_fused_jit

    def recording(*a):
        out = raw(*a)
        its["jax"] = (int(out[4]), int(out[5]))
        return out

    jmda._pc_fused_jit = recording
    jpc = jmda._pc_fused(mtol=1e-4)
    jout = jpc(*jmda._unpack(jb))
    ns = mda.ns_comp.ns
    if velo_inner:
        ns._lin32()
        ns._dinv32 = t32(np.asarray(jmda.ns_comp.ns._dinv32))
    out = mda._build_pc_fused(velo_inner)(*mda._unpack(b), 1e-4, 1e-4)
    its["port"] = out[4:]
    errs = [rel_err(got.numpy(), np.asarray(ref))
            for got, ref in zip(out[:4], jout)]
    dz = np.concatenate([got.numpy() - np.asarray(ref)
                         for got, ref in zip(out[:4], jout)])
    seen = float(jnp.linalg.norm(jmda._apply_linear(jnp.asarray(dz)))
                 / jnp.linalg.norm(jb))
    print(f"{precon} velo_inner={velo_inner}: its (cd, ns) port "
          f"{its['port']} sem_tpu {its['jax']}; rel err dT, du, dv, dp "
          f"{errs}; |J dz| / |b| {seen:.3e}")
    assert max(errs[:3]) <= 1e-4
    assert errs[3] <= 1e-3 and seen <= 1e-6
    assert abs(its["port"][0] - its["jax"][0]) <= 2
    assert abs(its["port"][1] - its["jax"][1]) <= max(2, its["jax"][1] // 3)
    n = (mda.cd_comp.iter_count_solve, mda.ns_comp.iter_count_solve)
    mda._pc_fused(mtol=1e-4)(*mda._unpack(b))
    assert (mda.cd_comp.iter_count_solve, mda.ns_comp.iter_count_solve) \
        == (n[0] + 1, n[1] + 1)


def _fields(cd, ns, s):
    return [cd._get_interpol(s.T, PLOT21), ns._get_interpol(s.u, PLOT21),
            ns._get_interpol(s.v, PLOT21)]


def test_fused_jnk_solve_matches_reference(monkeypatch, port_unfused):
    """A whole JNK solve at QUICK with ``fused=True`` against sem_tpu's
    default host path (``device_krylov=False``, ``SEM_TPU_FG_FUSED=1``,
    ``SEM_TPU_FUSED_PC=1``): equal MDA stats and coupled GMRES iterations,
    T/u/v at the 21×21 plot points within 1e-7."""
    jcd, jns, jmda = _jax(monkeypatch, True, mode="JNK",
                          device_krylov=False, **QUICK)
    js = jmda.solve()
    cd, ns, mda = build_coupled(1.0, 1.0, mode="JNK", fused=True,
                                device="cpu", **QUICK)
    s = mda.solve()
    assert mda.stats.as_list() == jmda.stats.as_list()
    assert mda.stats.gmres_iters == jmda.stats.gmres_iters
    for got, ref in zip(_fields(cd, ns, s), _fields(jcd, jns, js)):
        np.testing.assert_allclose(got, ref, atol=1e-7)


@pytest.mark.parametrize("mixed", [False, True])
def test_device_jnk_solve_matches_reference(mixed, monkeypatch, capsys):
    """A whole JNK solve at QUICK with ``device_krylov=True`` against
    sem_tpu's on-device windows.  Float64 solvers (the windows' nested
    solves are float64 in both packages either way): equal stats and GMRES
    iterations, the same ``JNK GMRES:`` lines, fields within 1e-8.  The
    default mixed solvers: the two packages' f32 iteration-0 sweeps part by
    ~1e-8 and the windows' loose nested solves (``mtol_precon=1e-4``) carry
    it to a tolerance crossing in the last Newton step (ROADMAP Queue C7:
    [23, 24, 4] / 22 against [22, 23, 4] / 21): equal Newton steps, GMRES
    iterations within 1, fields within 1e-7."""
    monkeypatch.setenv("SEM_TPU_FG_FUSED", "0")
    monkeypatch.setenv("SEM_TPU_FUSED_PC", "0")
    kw = dict(QUICK, iprint=True)
    if mixed:
        jcd, jns, jmda = jax_build_coupled(1.0, 1.0, mode="JNK",
                                           device_krylov=True, **kw)
    else:
        jcd, jns, jmda = _f64_mda("jax", iprint=True, device_krylov=True)
    js = jmda.solve()
    jlines = capsys.readouterr().out.count("JNK GMRES:")
    if mixed:
        cd, ns, mda = build_coupled(1.0, 1.0, mode="JNK", device_krylov=True,
                                    device="cpu", **kw)
    else:
        cd, ns, mda = _f64_mda("port", iprint=True, device_krylov=True)
    s = mda.solve()
    lines = capsys.readouterr().out.count("JNK GMRES:")
    print(f"stats port {mda.stats.as_list()} / {mda.stats.gmres_iters}, "
          f"sem_tpu {jmda.stats.as_list()} / {jmda.stats.gmres_iters}")
    if mixed:
        assert mda.stats.nonlinear_iters == jmda.stats.nonlinear_iters
        assert abs(mda.stats.gmres_iters - jmda.stats.gmres_iters) <= 1
        tol = 1e-7
    else:
        assert mda.stats.as_list() == jmda.stats.as_list()
        assert mda.stats.gmres_iters == jmda.stats.gmres_iters
        assert lines == jlines
        tol = 1e-8
    for got, ref in zip(_fields(cd, ns, s), _fields(jcd, jns, js)):
        np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize("program", ["device_krylov", "fused"])
def test_ptc_programs_match_reference(program, monkeypatch, port_unfused):
    """PTC from zero at Ra=1e4 (``precon='bj'``; the coarse ``bgs``
    marches converge in neither package, ROADMAP C1) with the device
    windows (DOF 2044 ≤ ``PTC_DEVICE_MAX_DOF``) or the fused host programs,
    against sem_tpu's same program: equal steps, stats and coupled GMRES
    iterations."""
    fused = program == "fused"
    kw = dict(PTC_KW, mode="PTC", precon="bj")
    _, _, jmda = _jax(monkeypatch, fused, device_krylov=not fused, **kw)
    js = jmda.solve()
    _, _, mda = build_coupled(1.0, 1.0, device="cpu",
                              **{program: True}, **kw)
    assert mda.DOF <= tmda.PTC_DEVICE_MAX_DOF
    s = mda.solve()
    assert mda.stats.as_list() == jmda.stats.as_list()
    assert mda.stats.gmres_iters == jmda.stats.gmres_iters
    np.testing.assert_allclose(s.u.numpy(), np.asarray(js.u), atol=1e-6)


def test_krylov_econ_fused_spans(monkeypatch, capsys, port_unfused):
    """``krylov_econ --direct --fused`` at QUICK's grids: the spans of the
    fused programs and of the fused preconditioner are printed, and the
    solve gives the stats of a ``fused=True`` solve of the same problem."""
    from sem_tpu_torch.study import krylov_econ

    monkeypatch.setattr(krylov_econ, "KW", dict(
        krylov_econ.KW, N_ex_cd=3, N_ey_cd=3, N_ex_ns=3, N_ey_ns=3))
    monkeypatch.setattr(krylov_econ, "LADDER", (3,))
    got = krylov_econ.main(["--device", "cpu", "--direct", "--fused"])
    out = capsys.readouterr().out
    assert "fused=True" in out
    for span in ("mda.fg_start=", "mda.fg_step=", "mda.pc_fused="):
        assert out.count(span) == 2, out     # the first and the warm solve
    kw = dict(krylov_econ.KW, Ra=1e3, P_cd=3, P_ns=3)
    _, _, mda = build_coupled(1.0, 1.0, device="cpu", fused=True, **kw)
    mda.solve()
    assert got["stats"] == mda.stats.as_list()


_GROUP_WORKER = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from sem_tpu_torch.coupling import build_coupled
from sem_tpu_torch.parallel import init_distributed, make_group, use_group
rank, world, dev = init_distributed("127.0.0.1:{port}", 2, int(sys.argv[1]),
                                    device="cpu")
group = make_group()
quick = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=3, N_ex_cd=6, N_ey_cd=6,
             P_ns=3, N_ex_ns=6, N_ey_ns=6, iprint=False, device="cpu")
with use_group(group):
    for opt in ("device_krylov", "fused"):
        _, _, mda = build_coupled(1.0, 1.0, mode="JNK", **{{opt: True}},
                                  **quick)
        s = mda.solve()
        res = float(torch.linalg.vector_norm(mda._residuals(s)))
        print("SOLVED", opt, group.backend, json.dumps(dict(
            stats=mda.stats.as_list(), gmres_iters=mda.stats.gmres_iters,
            ok=bool(res <= mda.atol_nonlin))), flush=True)
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def test_group_raises_naming_item_6(tmp_path):
    """Under a two-rank gloo group, ``device_krylov=True`` and
    ``fused=True`` both build and solve QUICK JNK at P3 6×6 (the
    residual within atol), with the same stats and coupled GMRES
    iterations in both ranks."""
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_GROUP_WORKER.format(root=ROOT, port=port))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEM_TPU_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    solved = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        lines = [ln.split(" ", 3) for ln in out.splitlines()
                 if ln.startswith("SOLVED")]
        assert [ln[1:3] for ln in lines] == [["device_krylov", "gloo"],
                                             ["fused", "gloo"]], out
        solved.append([json.loads(ln[3]) for ln in lines])
    assert solved[0] == solved[1]
    assert all(r["ok"] for r in solved[0]), solved


@pytest.mark.cuda
def test_cuda_graphed_step_matches_eager():
    """On the card, at QUICK: the captured ``start`` and ``step``
    (``BoussinesqMDA._fused_programs``) against their eager programs on the
    same inputs (V, Z, H, g and the residual within 1e-12 relative), the
    two captured once per MDA and bound anew, not captured again, for a
    new linearization, and a JNK solve with ``fused=True`` giving the
    CPU's stats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused programs are captured as "
                    "CUDA graphs only there")
    dev = torch.device("cuda")
    _, _, mda = build_coupled(1.0, 1.0, mode="JNK", fused=True, device=dev,
                              **QUICK)
    s = mda.solve()
    captures = COUNTERS["mda.captures"]
    mda._linearize(s)
    F = mda._residuals(s)
    mda._fg_fused(mtol=1e-4)
    programs = mda._fg
    # a new linearization binds the programs anew and captures nothing
    mda._linearize(s)
    start, step, pcs = mda._fg_fused(mtol=1e-4)
    assert mda._fg is programs
    start_p, step_p, lin = programs
    assert start_p.graph is not None and step_p.graph is not None
    assert COUNTERS["mda.captures"] - captures == 2
    startf, stepf = mda._build_fg_fused()
    x = 1e-3 * F
    got = [t.clone() for t in start(x, -F)]
    ref = startf(x, -F, *lin)
    zs = pcs(*got[6:-1])
    got_s = [t.clone() for t in step(*start(x, -F)[:6], 0, *zs)]
    # a tensor k, as the captured step's
    ref_s = stepf(*[t.clone() for t in ref[:6]], torch.tensor(0, device=dev),
                  *zs, *lin)
    torch.cuda.synchronize()
    for a, b in zip(got + got_s, list(ref) + list(ref_s)):
        scale = max(float(b.abs().max()), 1e-300)
        assert float((a.double() - b.double()).abs().max()) <= 1e-12 * scale
    # last, so that the checks above run where this one fails (ROADMAP C13)
    _, _, mda_cpu = build_coupled(1.0, 1.0, mode="JNK", fused=True,
                                  device="cpu", **QUICK)
    mda_cpu.solve()
    assert mda.stats.as_list() == mda_cpu.stats.as_list()
