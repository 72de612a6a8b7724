"""Port parity, the study drivers of ``sem_tpu_torch.study`` against the JAX
package's ``study/`` scripts: ``centerline`` on a field ``.npz`` that
``sem_tpu``'s study writes, the offline SciPy studies ``schur_spectrum`` and
``coupled_pc_diag`` (host only), and ``north_star``, ``krylov_econ``,
``ns_scale`` and ``ptc_band_probe`` with their module-level configurations
patched down to P2-P4.  The port runs on the CPU; with the ``unfused``
fixture both packages run the host FGMRES, un-fused."""
import contextlib
import glob
import importlib.util
import io
import pathlib
import re
import runpy
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sem_tpu
import sem_tpu_torch
from sem_tpu.coupling import build_coupled as jax_build_coupled
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu.utils import save_checkpoint as jax_save_checkpoint
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.study import (centerline, coupled_pc_diag, krylov_econ,
                                 north_star, ns_scale, ptc_band_probe,
                                 schur_spectrum)

from tests.torch_parity import one_torch_thread, port_unfused  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _reference(name):
    """A script of the JAX package's ``study/`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "study" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def unfused(monkeypatch, port_unfused):
    """Both packages on the un-fused host program: ``sem_tpu`` through its
    variables, the port through ``port_unfused``."""
    for k in ("SEM_TPU_FG_FUSED", "SEM_TPU_FUSED_PC",
              "SEM_TPU_DEVICE_KRYLOV_MAX_DOF"):
        monkeypatch.setenv(k, "0")


def _defaults(monkeypatch, cls, **kw):
    """``cls`` constructed with ``kw`` unless the caller says otherwise."""
    orig = cls.__init__

    def init(self, *a, **k):
        for name, value in kw.items():
            k.setdefault(name, value)
        orig(self, *a, **k)

    monkeypatch.setattr(cls, "__init__", init)


def _f64(monkeypatch):
    """Both packages' solvers on their float64 Krylov path, where iteration
    and DGKS resweep counts are deterministic across packages."""
    for cls in (sem_tpu.NavierStokesSolver, sem_tpu_torch.NavierStokesSolver,
                sem_tpu.ConvectionDiffusionSolver,
                sem_tpu_torch.ConvectionDiffusionSolver):
        _defaults(monkeypatch, cls, mixed_precision=False)


# ------------------------------ centerline -------------------------------- #
def test_centerline_matches_reference(tmp_path, monkeypatch, capsys,
                                      unfused):
    """On the ``.npz`` of ``sem_tpu``'s study (JNK, P2 Ne4): the CLI's two
    anchors equal the JAX ``centerline_anchors`` to 1e-12."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "__stdout__", sys.stdout)
    _reference("boussinesq_run").run(P=2, N_e=4, mode="JNK")
    npz = next(f for f in glob.glob("Boussinesq_study/*.npz")
               if not f.endswith(".ckpt.npz"))
    got = centerline.main([npz, "2", "4", "--device", "cpu"])
    with np.load(npz) as z:
        u_e, v_e = z[z.files[1]], z[z.files[2]]
    ref = _reference("centerline").centerline_anchors(u_e, v_e, 2, 4)
    assert "centerline) = " in capsys.readouterr().out
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


# --------------------------- offline SciPy studies ------------------------ #
@pytest.mark.parametrize("wind", [None, "lid"])
def test_schur_build_blocks_match_reference(wind):
    """P4 4×4: every sparse block and mask of ``build_blocks`` equals the JAX
    study's, in the Stokes limit and with a strong wind."""
    grid, jgrid = Grid2D(4, 4, 4, 1.0, 1.0), JGrid2D(4, 4, 4, 1.0, 1.0)
    u = v = None
    if wind:
        x, y = grid.points
        u = np.sin(np.pi * x) ** 2 * np.sin(2 * np.pi * y)
        v = -np.sin(2 * np.pi * x) * np.sin(np.pi * y) ** 2
    got = schur_spectrum.build_blocks(grid, Re=100.0, u=u, v=v)
    ref = _reference("schur_spectrum").build_blocks(jgrid, Re=100.0, u=u,
                                                    v=v)
    for a, b in zip(got[:5], ref[:5]):
        a, b = a.tocsr(), b.tocsr()
        a.sort_indices()
        b.sort_indices()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_allclose(a.data, b.data, rtol=1e-14, atol=1e-14)
    for a, b in zip(got[5:], ref[5:]):
        np.testing.assert_array_equal(a, b)


def test_schur_gmres_counts_match_reference():
    """P4 4×4, lid Re=100: each candidate's GMRES count and final residual
    equal the JAX study's printed ones."""
    cands = ["mass", "specS", "specS+bb", "pcd", "pcd_rev"]
    got = schur_spectrum.run_config(4, 4, lid_re=100, candidates=cands)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _reference("schur_spectrum").run_config(4, 4, lid_re=100,
                                                candidates=cands)
    ref = {m.group(1): (int(m.group(2)), float(m.group(3)))
           for m in re.finditer(r"  (\S+)\s+gmres_iters=\s*(\d+) "
                                r"final_rel=(\S+)", buf.getvalue())}
    assert {k: it for k, (it, _) in got.items()} == \
        {k: it for k, (it, _) in ref.items()}
    for k, (_, res) in got.items():
        assert f"{res:.1e}" == f"{ref[k][1]:.1e}"


def test_coupled_pc_diag_counts_with_reference_blocks(monkeypatch):
    """At P4 3×3 (patched into the module constants), synthetic wind: the
    FGMRES counts and residuals of every candidate are the same whether the
    study's functions are fed the port's ``build_blocks`` or the JAX
    study's."""
    monkeypatch.setattr(coupled_pc_diag, "P", 4)
    monkeypatch.setattr(coupled_pc_diag, "Ne", 3)
    got = coupled_pc_diag.main(["--synthetic"])
    monkeypatch.setattr(coupled_pc_diag, "build_blocks",
                        _reference("schur_spectrum").build_blocks)
    ref = coupled_pc_diag.main(["--synthetic"])
    assert {k: v[0] for k, v in got.items()} == \
        {k: v[0] for k, v in ref.items()}
    for k, (_, res) in got.items():
        assert abs(res - ref[k][1]) <= 1e-8 * max(ref[k][1], 1e-300) + 1e-14


def test_coupled_pc_diag_converged_wind_matches_reference(monkeypatch):
    """The converged lid-cavity wind of the default branch (the port's NS
    solver on the CPU, P4 4×4, Re=100) equals ``sem_tpu``'s on the float64
    Krylov path of both packages to 1e-8."""
    _f64(monkeypatch)
    monkeypatch.setattr(coupled_pc_diag, "Re", 100.0)
    u, v = coupled_pc_diag.converged_wind(Grid2D(4, 4, 4, 1.0, 1.0), "cpu")
    ns = sem_tpu.NavierStokesSolver(1.0, 1.0, Re=100.0, Gr=0.0, P=4, N_ex=4,
                                    N_ey=4, u_N=1.0, iprint=[])
    ju, jv, _ = ns._get_solution(jnp.zeros(ns.N))
    np.testing.assert_allclose(u, np.asarray(ju), rtol=0, atol=1e-8)
    np.testing.assert_allclose(v, np.asarray(jv), rtol=0, atol=1e-8)


@pytest.mark.slow
def test_coupled_pc_diag_full_size_matches_reference(monkeypatch):
    """The JAX study as a script (P8 8×8, Re=400, synthetic wind; run as
    ``__main__``, so that its rows print) against the port's ``main`` at
    its default constants: the same iteration counts and residuals as
    printed.  (The small-size test above covers the same functions.)"""
    monkeypatch.setattr(sys, "argv", ["coupled_pc_diag.py", "--synthetic"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "study" / "coupled_pc_diag.py"),
                       run_name="__main__")
    ref = {m.group(1).strip(): (int(m.group(2)), m.group(3))
           for m in re.finditer(r"^(.+?)\s*: iters=\s*(\d+) rel=(\S+)$",
                                buf.getvalue(), re.M)}
    got = coupled_pc_diag.main(["--synthetic"])
    ref = {re.sub(r"\s*\(exact A_g\)", "", k).replace("gamma=  1",
                                                      "gamma=1"): v
           for k, v in ref.items()}
    assert {k: (it, f"{res:.2e}") for k, (it, res) in got.items()} == ref


# ------------------------- solver-driving studies ------------------------- #
def _small(monkeypatch, mod, ladder, **grids):
    monkeypatch.setattr(mod, "KW", dict(mod.KW, **grids))
    monkeypatch.setattr(mod, "LADDER", ladder)


GRIDS = dict(N_ex_cd=2, N_ey_cd=2, N_ex_ns=4, N_ey_ns=4)


def test_north_star_matches_reference(monkeypatch, capsys, unfused):
    """Ladder P2 → P4 on NS 4×4 / CD 2×2: the per-level stats equal those
    of the JAX study's ``build_levels`` / ``ladder``, and the u-anchor
    agrees to 1e-6."""
    _small(monkeypatch, north_star, (2, 4), **GRIDS)
    got = north_star.main(["--device", "cpu"])
    out = capsys.readouterr().out
    jns = _reference("north_star")
    monkeypatch.setattr(jns, "KW", dict(jns.KW, **GRIDS))
    monkeypatch.setattr(jns, "LADDER", (2, 4))
    s, mda = jns.ladder(jns.build_levels())
    ref_out = capsys.readouterr().out
    stats = [re.findall(r"level P=(\d+): .*stats=(\[.*\])", o)
             for o in (out, ref_out)]
    assert stats[0] == stats[1] * 2        # warm-up and warm ladder
    assert abs(got["u_anchor"] - float(jnp.max(jnp.abs(s.u))) * 710.0) \
        <= 1e-6
    assert got["residual"] <= got["atol"] == pytest.approx(mda.atol_nonlin)


def test_krylov_econ_matches_reference(monkeypatch, unfused):
    """Ladder P2 → P4 on NS 4×4 / CD 2×2 with ``--restart 30``, both
    packages on their float64 Krylov path: per level the stats and the NS
    inner iterations and DGKS resweeps (``KrylovInfo.resweeps``) equal the
    JAX study's ``instrument_ns`` totals on the same ladder."""
    from sem_tpu.coupling.mda import CoupledState
    from sem_tpu.interp import apply_transfer

    _f64(monkeypatch)
    _small(monkeypatch, krylov_econ, (2, 4), **GRIDS)
    got = krylov_econ.main(["--device", "cpu", "--restart", "30"])

    jke = _reference("krylov_econ")
    _defaults(monkeypatch, sem_tpu.NavierStokesSolver, restart=30)
    ref, s, prev = [], None, None
    for P in (2, 4):
        cd, ns, mda = jax_build_coupled(
            1.0, 1.0, P_cd=P, P_ns=P, Re=1e3, Ra=1e3, Pr=0.71, mode="JNK",
            mtol_nonlin=1e-8, iprint=False, **GRIDS)
        tot = jke.instrument_ns(ns)
        if s is not None:
            cd0, ns0 = prev
            s = CoupledState(T=apply_transfer(cd0.grid, cd.grid, s.T),
                             u=apply_transfer(ns0.grid, ns.grid, s.u),
                             v=apply_transfer(ns0.grid, ns.grid, s.v),
                             p=apply_transfer(ns0.grid, ns.grid, s.p))
        s = mda.solve(s)
        ref.append(dict(P=P, stats=mda.stats.as_list(), iters=tot["iters"],
                        resweeps=tot["resweeps"]))
        prev = (cd, ns)
    assert got["levels"] == ref
    assert sum(r["resweeps"] for r in ref) > 0


@pytest.mark.parametrize("mode,precon", [("bouss", "mass"),
                                         ("lid", "spectral")])
def test_ns_scale_matches_reference(mode, precon, capsys, monkeypatch):
    """``run_config`` at P4 4×4 (the lid cavity at Re=100), both packages on
    their float64 Krylov path: the printed Newton count and last inner
    iteration count equal the JAX study's.  (On the mixed path the f32
    chunks' counts spread: 88 against 90 for the lid cavity here.)"""
    _f64(monkeypatch)
    got = ns_scale.run_config(4, 4, precon=precon, Re=100.0, mode=mode,
                              device="cpu")
    _reference("ns_scale").run_config(4, 4, precon=precon, Re=100.0,
                                      mode=mode)
    out = capsys.readouterr().out
    rows = re.findall(r"\[ns_scale\] .* newton=(\d+) last_inner=(\d+) "
                      r"rms=(\S+)", out)
    assert len(rows) == 2
    assert rows[0][:2] == rows[1][:2]
    assert (got["newton"], got["last_inner"]) == tuple(map(int, rows[1][:2]))


def test_ptc_band_probe_matches_reference(tmp_path, unfused, monkeypatch):
    """On a checkpoint ``sem_tpu`` wrote (its JNK state at Ra=1e3, P3, NS
    4×4 / CD 2×2), probed at Ra=1e4 with the block solves of both packages
    on their float64 Krylov path: every (velo_inner, pc, dt) cell runs the
    JAX probe's FGMRES iterations, with its relative residual and
    contraction rate to 1e-4 (both FGMRES keep their bases in float32; with
    the f32 chunks in the block solves too, one cell of eight ends one
    iteration apart)."""
    cd, ns, mda = jax_build_coupled(1.0, 1.0, P_cd=3, N_ex_cd=2, N_ey_cd=2,
                                    P_ns=3, N_ex_ns=4, N_ey_ns=4,
                                    mode="JNK", iprint=False,
                                    device_krylov=False)
    s = mda.solve()
    ckpt = str(tmp_path / "state.ckpt.npz")
    jax_save_checkpoint(ckpt, s, dict(Re=1e3, Ra=1e3, Pr=0.71), mda.stats)
    _f64(monkeypatch)
    kw = dict(Ra=1e4, P=3, N_e=4, dts=(0.9, 3.0), velo_inners=(0, 2),
              pcs=("bj", "bgs"), its=25)
    got = ptc_band_probe.probe(ckpt, device="cpu", **kw)
    ref = _reference("ptc_band_probe").probe(ckpt, **kw)
    assert [r[:4] for r in got] == [tuple(r[:4]) for r in ref]
    np.testing.assert_allclose([r[4:6] for r in got],
                               [r[4:6] for r in ref], rtol=1e-4)


# ---------------------------- no card, no run ---------------------------- #
@pytest.mark.parametrize("run", [
    lambda: north_star.main([]),
    lambda: krylov_econ.main([]),
    lambda: ns_scale.main(["4", "4"]),
    lambda: ptc_band_probe.main(["-ckpt", "missing.ckpt.npz"]),
    lambda: centerline.main(["missing.npz", "4", "4"]),
    lambda: coupled_pc_diag.main([]),
], ids=["north_star", "krylov_econ", "ns_scale", "ptc_band_probe",
        "centerline", "coupled_pc_diag"])
def test_study_drivers_need_a_card_by_default(run):
    """Without a card each driver's default device ends it with a non-zero
    exit before any work; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as exc:
        run()
    assert exc.value.code not in (0, None)
