"""Port parity, the examples: ``sem_tpu_torch.examples.*`` run with
``--check`` on the CPU against the JAX package's examples (or the solvers
they call) at the same configuration, and ``boussinesq_parallel`` as two
gloo ranks against the port's single-process solve."""
import numpy as np
import pytest
import torch

from sem_tpu import ConvectionDiffusionSolver as JCD
from sem_tpu import NavierStokesSolver as JNS
from sem_tpu.coupling import run as jax_run
from sem_tpu_torch.coupling import run
from sem_tpu_torch.examples import (boussinesq_parallel,
                                    boussinesq_sequential,
                                    convection_diffusion, navier_stokes)

from tests.torch_parity import one_torch_thread, port_unfused  # noqa: F401


def test_cd_example_matches_reference(capsys):
    """Pe=40, P4 16×16: the port's example passes its check; its T range
    equals the JAX solver's to 1e-10 and its GMRES count lies within the
    two packages' f32-chunk spread (a third, README) of the JAX count."""
    got = convection_diffusion.main(check=True, device="cpu")
    assert "CHECK OK" in capsys.readouterr().out
    cd = JCD(1.0, 1.0, 40.0, 4, 16, 16, T_E=-0.5, T_W=0.5)
    pts = np.meshgrid(np.linspace(0, 1, 51), np.linspace(0, 1, 51),
                      indexing="ij")
    T = cd.run(lambda x, y: y - 0.5, lambda x, y: 0.5 - x, pts)
    assert abs(got["T_min"] - T.min()) <= 1e-10
    assert abs(got["T_max"] - T.max()) <= 1e-10
    ref = int(cd.last_info.iterations)
    assert abs(got["iterations"] - ref) <= ref / 3, (got, ref)
    assert got["asym"] < 1e-8


def _f64_default(monkeypatch, cls):
    """``cls`` (a solver class) built with ``mixed_precision=False`` unless
    the caller says otherwise."""
    orig = cls.__init__

    def init(self, *a, **k):
        k.setdefault("mixed_precision", False)
        orig(self, *a, **k)

    monkeypatch.setattr(cls, "__init__", init)


@pytest.mark.parametrize("mixed,atol", [(True, 1e-5), (False, 1e-6)])
def test_ns_quick_example_matches_reference(mixed, atol, capsys,
                                            monkeypatch):
    """Lid cavity Re=100, P4 8×8: the port's example passes its Ghia check
    with the JAX solver's Newton count, and u at the Ghia points agrees to
    1e-6 on the float64 Krylov path of both packages.  On the default mixed
    path the example's tolerances (linear RMS 1e-7, Newton 1e-5) leave the
    two packages' f32 chunks 6.7e-6 apart there (the near-spurious pressure
    modes amplify a residual ~100-fold in u), so it is held to 1e-5."""
    from sem_tpu_torch import NavierStokesSolver

    if not mixed:
        _f64_default(monkeypatch, NavierStokesSolver)
        _f64_default(monkeypatch, JNS)
    got = navier_stokes.main(check=True, quick=True, device="cpu")
    assert "CHECK OK" in capsys.readouterr().out
    ns = JNS(1.0, 1.0, 100, 0, 4, 8, 8, u_N=1, iprint=[])
    pts = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101),
                      indexing="ij")
    u, _, _ = ns.run(T_func=lambda x, y: 0 * x * y, points_plot=pts)
    ref = np.interp(navier_stokes.GHIA_Y, pts[1][50, :], u[50, :])
    assert got["newton"] == ns._k
    np.testing.assert_allclose(got["u_at_ghia"], ref, rtol=0, atol=atol)


@pytest.mark.parametrize("mode,mixed", [("GS", True), ("GS", False),
                                        ("NJ", True), ("JNK", True)])
def test_sequential_quick_example_matches_reference(mode, mixed, capsys,
                                                    monkeypatch, port_unfused):
    """Heated cavity P4 4×4, each coupling mode: the port's example passes
    its de Vahl Davis check with the stats of ``sem_tpu.coupling.run`` on
    its host FGMRES (un-fused, both packages pinned to that program) and
    u_max·RePr, v_max·RePr to 1e-6.  On the default mixed path GS's inner
    Newton solves end within one iteration of each other per sweep (the f32
    chunks' spread near the Newton tolerance: 20 against 18 over 9 sweeps);
    on the float64 path of both packages the stats are equal."""
    from sem_tpu import ConvectionDiffusionSolver as JCD_
    from sem_tpu_torch import ConvectionDiffusionSolver, NavierStokesSolver

    if not mixed:
        for cls in (NavierStokesSolver, JNS, ConvectionDiffusionSolver,
                    JCD_):
            _f64_default(monkeypatch, cls)
    got = boussinesq_sequential.main(check=True, quick=True, mode=mode,
                                     device="cpu")
    assert "CHECK OK" in capsys.readouterr().out
    monkeypatch.setenv("SEM_TPU_FG_FUSED", "0")
    monkeypatch.setenv("SEM_TPU_FUSED_PC", "0")
    pts = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101),
                      indexing="ij")
    _, u, v, _, stats = jax_run(pts, 1.0, 1.0, 1e3, 1e3, 0.71, 4, 4, 4, 4,
                                4, 4, mode=mode, iprint=False,
                                return_state=True, device_krylov=False)
    ref = stats.as_list()
    if mode == "GS" and mixed:
        assert [got["stats"][0], got["stats"][2]] == [ref[0], ref[2]]
        assert abs(got["stats"][1] - ref[1]) <= ref[2], (got, ref)
    else:
        assert got["stats"] == ref
    assert abs(got["umax"] - np.max(u) * 710.0) <= 1e-6
    assert abs(got["vmax"] - np.max(v) * 710.0) <= 1e-6


def test_parallel_quick_example_matches_single_process(capfd, monkeypatch):
    """``--quick`` (GS, P3 3×3) as two gloo ranks on the CPU: CHECK OK from
    rank 0 alone, and the anchors and stats of the port's single-process
    solve, the anchors to 1e-8."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = boussinesq_parallel.main(check=True, quick=True, ranks=2,
                                   device="cpu")
    out = capfd.readouterr().out
    assert out.count("CHECK OK") == 1 and out.count("devices: ") == 1
    assert len(got["launches"]) == 2
    pts = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101),
                      indexing="ij")
    _, u, v, _, stats = run(pts, 1.0, 1.0, 1e3, 1e3, 0.71, 3, 3, 3, 3, 3, 3,
                            mode="GS", iprint=False, return_state=True,
                            device="cpu")
    assert got["stats"] == stats.as_list()
    assert abs(got["umax"] - np.max(u) * 710.0) <= 1e-8
    assert abs(got["vmax"] - np.max(v) * 710.0) <= 1e-8


@pytest.mark.parametrize("example", [convection_diffusion, navier_stokes,
                                     boussinesq_sequential,
                                     boussinesq_parallel])
def test_examples_need_a_card_by_default(example):
    """Without a card the default device ends the example with a non-zero
    exit before any work; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as exc:
        example.main(check=True)
    assert exc.value.code not in (0, None)
