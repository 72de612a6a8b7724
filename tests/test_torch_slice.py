"""Port parity, the whole slice: the CD and NS solvers and the coupled
Boussinesq GS/NJ/JNK solves of ``sem_tpu_torch`` (``device="cpu"``) against
``sem_tpu`` on the same configurations, a warm start carried across the two
packages through ``sem_tpu_torch.convert``, and the rule that the port never
imports JAX."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu import ConvectionDiffusionSolver as JCD
from sem_tpu import NavierStokesSolver as JNS
from sem_tpu.coupling import build_coupled as jax_build_coupled
from sem_tpu.coupling.mda import CoupledState as JState
from sem_tpu_torch import ConvectionDiffusionSolver as TCD
from sem_tpu_torch import NavierStokesSolver as TNS
from sem_tpu_torch.convert import state_from_numpy, state_to_numpy
from sem_tpu_torch.coupling import build_coupled, run

from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the QUICK configuration and plot points of tests/test_coupling.py:35-38
QUICK = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=3, N_ex_cd=3, N_ey_cd=3,
             P_ns=3, N_ex_ns=3, N_ey_ns=3, iprint=False)
PLOT21 = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                     indexing="ij")


def _jax_reference(mode, s0=None):
    """``sem_tpu`` on the algorithm the port implements: host FGMRES
    (``device_krylov=False``) with un-fused iterations and the adaptive
    host-orchestrated block-Jacobi preconditioner."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEM_TPU_FG_FUSED", "0")
        mp.setenv("SEM_TPU_FUSED_PC", "0")
        cd, ns, mda = jax_build_coupled(1.0, 1.0, mode=mode,
                                        device_krylov=False, **QUICK)
        s = mda.solve(s0)
    return cd, ns, mda, s


@pytest.fixture(scope="module")
def reference_runs():
    """sem_tpu's coupled solves, computed once per mode on first use."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = _jax_reference(mode)
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", ["GS", "NJ", "JNK"])
def test_coupled_modes_match_reference(mode, reference_runs):
    """Fields at PLOT21 within the bounds of tests/test_coupling.py:55-57
    (T 1e-7, u/v 1e-8); equal solve counts and nonlinear iterations;
    coupled GMRES iterations within ±1."""
    jcd, jns, jmda, js = reference_runs(mode)
    cd, ns, mda = build_coupled(1.0, 1.0, mode=mode, device="cpu", **QUICK)
    s = mda.solve()
    np.testing.assert_allclose(cd._get_interpol(s.T, PLOT21),
                               jcd._get_interpol(js.T, PLOT21), atol=1e-7)
    np.testing.assert_allclose(ns._get_interpol(s.u, PLOT21),
                               jns._get_interpol(js.u, PLOT21), atol=1e-8)
    np.testing.assert_allclose(ns._get_interpol(s.v, PLOT21),
                               jns._get_interpol(js.v, PLOT21), atol=1e-8)
    assert mda.stats.as_list() == jmda.stats.as_list()
    assert abs(mda.stats.gmres_iters - jmda.stats.gmres_iters) <= 1
    # neither package left the plain f32 chunks
    assert ns.flex_retry_count == jns.flex_retry_count == 0
    assert ns.f64_fallback_count == jns.f64_fallback_count == 0


def test_warm_start_carried_across_packages(reference_runs):
    """A non-zero coupled state from sem_tpu, carried into the port through
    convert.py: equal coupled residual norms (1e-12 relative), and a warm
    JNK solve from it matches the reference's warm solve."""
    _, _, _, js = reference_runs("GS")
    rng = np.random.default_rng(5)
    T, u, v, p = (np.asarray(f) * (1.0 + 0.05 * rng.standard_normal(f.shape))
                  for f in (js.T, js.u, js.v, js.p))
    s0 = state_from_numpy(T, u, v, p, device="cpu")
    for a, b in zip(state_to_numpy(s0), (T, u, v, p)):
        np.testing.assert_array_equal(a, b)
    jcd, jns, jmda, jwarm = _jax_reference(
        "JNK", JState(*(jnp.asarray(f) for f in (T, u, v, p))))
    cd, ns, mda = build_coupled(1.0, 1.0, mode="JNK", device="cpu", **QUICK)
    r_t = float(torch.linalg.vector_norm(mda._residuals(s0)))
    r_j = float(jnp.linalg.norm(jmda._residuals(
        JState(*(jnp.asarray(f) for f in (T, u, v, p))))))
    assert abs(r_t - r_j) <= 1e-12 * r_j
    warm = mda.solve(s0)
    assert mda.stats.as_list() == jmda.stats.as_list()
    for a, b in zip(state_to_numpy(warm), (jwarm.T, jwarm.u, jwarm.v,
                                           jwarm.p)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-8)


@pytest.mark.parametrize("mixed", [True, False])
def test_cd_run_matches_reference(mixed):
    """CD circular flow at P=4 8×8: T at the plot points within 1e-10."""
    kw = dict(Pe=40, P=4, N_ex=8, N_ey=8, T_W=0.5, T_E=-0.5,
              mixed_precision=mixed)
    pts = np.meshgrid(np.linspace(0, 1, 31), np.linspace(0, 1, 31),
                      indexing="ij")
    wind = (lambda x, y: y - 0.5, lambda x, y: 0.5 - x)
    ref = JCD(1.0, 1.0, **kw).run(*wind, pts)
    got = TCD(1.0, 1.0, device="cpu", **kw).run(*wind, pts)
    np.testing.assert_allclose(got, ref, atol=1e-10)


@pytest.mark.parametrize("mixed,atol", [(False, 1e-12), (True, 1e-7)])
def test_ns_lid_cavity_matches_reference(mixed, atol):
    """Standalone NS Newton solve (lid cavity Re=100, P=3 4×4, Newton RMS
    1e-11): the same Newton count as the reference on the same path, and
    velocities against the reference's pure-f64 solution — to roundoff
    (1e-12) on the port's f64 path, to 1e-7 on its mixed f32/f64 path.
    Mixed solves stop at |F| ~ 1e-12 along their own f32 roundoff paths,
    which this saddle system maps to ~1e-8 in the velocities: the
    reference's own mixed and f64 solutions differ by 1.7e-8, the port's
    by 5e-8 (measured when the test was written)."""
    kw = dict(Re=100.0, Gr=0.0, P=3, N_ex=4, N_ey=4, u_N=1.0, iprint=[],
              mtol=1e-12, mtol_newton=1e-11)
    pts = np.meshgrid(np.linspace(0, 1, 11), np.linspace(0, 1, 11),
                      indexing="ij")
    lid = (lambda x, y: 0 * x, pts)
    jns = JNS(1.0, 1.0, mixed_precision=mixed, **kw)
    jns.run(*lid)
    ref = JNS(1.0, 1.0, mixed_precision=False, **kw).run(*lid)
    tns = TNS(1.0, 1.0, device="cpu", mixed_precision=mixed, **kw)
    got = tns.run(*lid)
    assert tns._k == jns._k
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a, b, atol=atol)


def test_unported_options_raise():
    """What is still unported raises ``NotImplementedError`` and names its
    ROADMAP item; the Uzawa solver and the ``'mass'``/``'pcd'`` Schur blocks
    (once ROADMAP item 1) construct."""
    _, ns, _ = build_coupled(1.0, 1.0, mode="JNK", schur_precon="pcd",
                             device="cpu", **QUICK)
    assert ns._schur_precon == "pcd" and ns._fdm_p is not None
    _, ns, _ = build_coupled(1.0, 1.0, mode="JNK", schur_precon="mass",
                             device="cpu", **QUICK)
    assert ns._schur_precon == "mass" and ns._spec is None
    with pytest.raises(NotImplementedError, match="ROADMAP deferred item 5"):
        build_coupled(1.0, 1.0, mode="JNK", device_krylov=True,
                      device="cpu", **QUICK)
    ns = TNS(1.0, 1.0, Re=1.0, Gr=0.0, P=2, N_ex=2, N_ey=2,
             linear_solver="uzawa", device="cpu")
    assert ns._linear_solver == "uzawa"
    with pytest.raises(ValueError):
        build_coupled(1.0, 1.0, mode="XX", device="cpu", **QUICK)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    """No source of the port (nor chip_smoke.py) imports JAX or sem_tpu,
    and importing the package leaves jax out of sys.modules."""
    files = sorted((ROOT / "sem_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "sem_tpu"), (f, mod)
    code = ("import sys, sem_tpu_torch, sem_tpu_torch.coupling, "
            "sem_tpu_torch.convert, sem_tpu_torch.ops, sem_tpu_torch.ptc, "
            "sem_tpu_torch.utils.checkpoint, sem_tpu_torch.parallel, "
            "sem_tpu_torch.assemble; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules), 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_chip_smoke_refuses_without_a_card():
    """Where torch sees no CUDA card, chip_smoke.py exits non-zero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.slow
def test_de_vahl_davis_benchmark_port():
    """The reference configuration (Ra=1e3, P=4 8×8, JNK) on the port:
    de Vahl Davis u_max·RePr ≈ 3.649, v_max·RePr ≈ 3.697 within 1%."""
    pts = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101),
                      indexing="ij")
    T, u, v, state, stats = run(pts, 1.0, 1.0, Re=1e3, Ra=1e3, Pr=0.71,
                                P_cd=4, N_ex_cd=8, N_ey_cd=8,
                                P_ns=4, N_ex_ns=8, N_ey_ns=8, mode="JNK",
                                iprint=False, return_state=True,
                                device="cpu")
    umax, vmax = np.max(u) * 1e3 * 0.71, np.max(v) * 1e3 * 0.71
    assert abs(umax - 3.649) / 3.649 < 0.01, umax
    assert abs(vmax - 3.697) / 3.697 < 0.01, vmax
    assert stats.nonlinear_iters <= 6
