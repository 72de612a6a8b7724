"""Port parity, the study scripts: ``sem_tpu_torch.utils.profiling`` against
``sem_tpu.utils.profiling``, and the study CLIs of
``sem_tpu_torch.study`` against ``study/`` of the JAX package (the sweep's
file names and stats, a checkpoint written by ``sem_tpu`` read by the port's
``adjoint_hi``).  The port runs with ``-device cpu``."""
import glob
import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu.coupling import build_coupled as jax_build_coupled
from sem_tpu.coupling.implicit import gradients as jax_gradients
from sem_tpu.utils import PhaseTimer as JaxPhaseTimer
from sem_tpu.utils import save_checkpoint as jax_save_checkpoint
from sem_tpu_torch.study import adjoint_hi, boussinesq_run, summarize
from sem_tpu_torch.utils import PhaseTimer, trace

from tests.torch_parity import one_torch_thread, port_unfused  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _spans(timer):
    for name, dt in (("solve", 1.25), ("assembly", 0.5), ("solve", 2.0),
                     ("a_long_phase_name", 0.125)):
        with timer(name):
            _spans.clock += dt


def test_phase_timer_report_equals_reference(monkeypatch):
    """The same spans on a fake clock give the same totals, counts and
    report lines, character for character."""
    _spans.clock = 100.0
    monkeypatch.setattr(time, "perf_counter", lambda: _spans.clock)
    reports = []
    for cls in (JaxPhaseTimer, PhaseTimer):
        timer = cls()
        _spans(timer)
        lines = []
        timer.report(out=lines.append)
        reports.append((dict(timer.totals), dict(timer.counts), lines))
    assert reports[0] == reports[1]
    assert reports[1][2][0] == f"{'solve':<17}  {3.25:10.3f}s  x2"


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace() on the CPU writes one Chrome trace into the directory and
    yields the profiler with its operator sums."""
    logdir = tmp_path / "trace"
    with trace(str(logdir)) as prof:
        torch.ones(64, dtype=torch.float64) @ torch.ones(64,
                                                         dtype=torch.float64)
    files = glob.glob(str(logdir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        assert "traceEvents" in json.load(fh)
    assert any(e.key == "aten::matmul" for e in prof.key_averages())


def _reference_study():
    spec = importlib.util.spec_from_file_location(
        "reference_boussinesq_run", ROOT / "study" / "boussinesq_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["GS", "NJ", "JNK"])
def test_boussinesq_run_matches_reference(tmp_path, monkeypatch, mode,
                                          port_unfused):
    """P2 Ne4: the port writes the files of sem_tpu's title rule (``.log``,
    ``.npz``, ``.stats.json`` and ``.ckpt.npz``) into its ``-outdir``, with
    the stats sem_tpu writes (both pinned to the host FGMRES, un-fused):
    equal for GS and NJ; for JNK equal anchors and
    nonlinear iterations, and discipline solves within 2 per nonlinear
    iteration (the study's fixed coupled tolerance, 1e-13 RMS, sits at the
    f64 floor, where one more FGMRES iteration is roundoff).  summarize
    lists both directories' rows side by side."""
    for k in ("SEM_TPU_FG_FUSED", "SEM_TPU_FUSED_PC",
              "SEM_TPU_DEVICE_KRYLOV_MAX_DOF"):
        monkeypatch.setenv(k, "0")
    monkeypatch.chdir(tmp_path)
    # both scripts tee into sys.__stdout__ and restore sys.stdout to it:
    # keep both on the test's captured stream
    monkeypatch.setattr(sys, "__stdout__", sys.stdout)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    _reference_study().run(P=2, N_e=4, mode=mode, log=True, ckpt=True)
    boussinesq_run.main(["-P", "2", "-Ne", "4", "-mode", mode, "-log",
                         "True", "-ckpt", "True", "-device", "cpu",
                         "-outdir", "torch_out"])
    ref = sorted(os.listdir("Boussinesq_study"))
    got = sorted(os.listdir("torch_out"))
    title = next(f for f in ref if f.endswith(".stats.json"))[:-11]
    assert title.startswith(f"Boussinesq{mode}_1.0e+03~1.0e+03~0.71_2~4_")
    assert got == [title + s for s in (".ckpt.npz", ".log", ".npz",
                                       ".stats.json")]
    assert set(ref) <= set(got)
    stats = [json.loads((tmp_path / d / f"{title}.stats.json").read_text())
             for d in ("Boussinesq_study", "torch_out")]
    if mode == "JNK":
        it_ref, it_got = (s.pop("iters") for s in stats)
        assert it_got[2] == it_ref[2]
        assert all(abs(a - b) <= 2 * it_ref[2]
                   for a, b in zip(it_got, it_ref)), (it_got, it_ref)
    assert stats[0] == stats[1], stats
    with np.load(tmp_path / "torch_out" / f"{title}.npz") as z:
        assert [z[k].shape for k in z.files] == [
            (2, 2, 3, 3), (4, 4, 3, 3), (4, 4, 3, 3), (3,)]
    tag = "GS" if mode == "GS" else "NEWTON"
    logs = [(tmp_path / d / f"{title}.log").read_text().splitlines()
            for d in ("Boussinesq_study", "torch_out")]
    assert [ln.split("\t")[0] for ln in logs[1] if "Boussinesq" in ln] == \
        [ln.split("\t")[0] for ln in logs[0] if "Boussinesq" in ln]
    assert any(ln.startswith(f"Boussinesq {tag}: ") for ln in logs[1])

    lines = []
    monkeypatch.setattr("builtins.print", lambda s: lines.append(s))
    summarize.main("Boussinesq_study", "torch_out", "-device", "cpu")
    rows = [ln.split("|")[2:] for ln in lines[2:]]
    assert len(rows) == 2
    if mode != "JNK":
        assert rows[0] == rows[1]


def test_summarize_without_a_card_fails(tmp_path, monkeypatch):
    """summarize evaluates on the card by default: with no card and no
    ``-device`` it ends with the no-card error instead of running on the
    CPU, and ``-device cpu`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        summarize.main(str(tmp_path))
    summarize.main(str(tmp_path), "-device", "cpu")


def _study_files(out):
    """The file names of a study directory and the stats of its run."""
    names = sorted(os.listdir(out))
    stats = json.loads((out / next(f for f in names
                                   if f.endswith(".stats.json"))).read_text())
    return names, stats


_PINNED_RUN = """
import runpy
from tests.torch_parity import pinned_unfused
with pinned_unfused():
    runpy.run_module("sem_tpu_torch.study.boussinesq_run", run_name="__main__")
"""


def test_backend_mesh_raises(tmp_path, monkeypatch, port_unfused):
    """-backend mesh (P3 Ne4 JNK, with checkpoints): without the
    ``SEM_TPU_*`` variables one process runs the single path and writes
    the files and stats of -backend single; with them, two ranks over gloo
    (each in a directory of its own, the same relative -outdir) end with
    the same stats, and rank 0 alone writes the files (its ``.log``
    included).  Every run is pinned to the un-fused host program (the
    device windows' iteration-0 sweep rounds otherwise on the strips,
    ROADMAP C7)."""
    for k in [k for k in os.environ if k.startswith("SEM_TPU_")]:
        monkeypatch.delenv(k)
    args = ["-P", "3", "-Ne", "4", "-ckpt", "True", "-device", "cpu"]
    single = {}
    for backend in ("single", "mesh"):
        boussinesq_run.main(args + ["-backend", backend, "-outdir",
                                    str(tmp_path / backend)])
        single[backend] = _study_files(tmp_path / backend)
    assert single["mesh"] == single["single"]

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    procs = []
    for r in range(2):
        (tmp_path / f"rank{r}").mkdir()
        env = dict(os.environ, SEM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SEM_TPU_NUM_PROCESSES="2", SEM_TPU_PROCESS_ID=str(r),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PINNED_RUN,
             *args, "-log", "True", "-backend", "mesh", "-outdir", "out"],
            cwd=tmp_path / f"rank{r}", env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    names, stats = _study_files(tmp_path / "rank0" / "out")
    title = single["single"][0][0][:-len(".ckpt.npz")]
    assert names == sorted(single["single"][0] + [title + ".log"])
    assert stats == single["single"][1]
    assert not (tmp_path / "rank1" / "out").exists()
    iters = str(stats["iters"])
    assert all(iters in out for out in outs), outs


def test_adjoint_hi_reads_a_reference_checkpoint(tmp_path, capsys):
    """A state solved and checkpointed by sem_tpu (tests/test_implicit.py's
    configuration): the port's adjoint_hi reads it, finds it converged,
    gives sem_tpu's gradients within 1e-6 relative and d/dRa within 2e-4 of
    its central finite difference."""
    params = dict(Re=200.0, Ra=500.0, Pr=0.71)
    grid = dict(P_cd=2, N_ex_cd=2, N_ey_cd=2, P_ns=2, N_ex_ns=3, N_ey_ns=3)
    cd, ns, mda = jax_build_coupled(1.0, 1.0, mode="GS", mtol_nonlin=1e-11,
                                    mtol_internal=1e-13, iprint=False,
                                    **params, **grid)
    s = mda.solve()
    path = str(tmp_path / "ref.ckpt.npz")
    jax_save_checkpoint(path, s, dict(params, **grid, mode="GS"), mda.stats)
    x = np.concatenate([np.asarray(f) for f in (s.T, s.u, s.v, s.p)])

    def loss(xf):
        return jnp.sum(xf[cd.N:cd.N + 2 * ns.N] ** 2)

    _, ref = jax_gradients(cd, ns, x, loss, params)
    out = adjoint_hi.main(["-ckpt", path, "-fd", "1", "-device", "cpu"])
    printed = capsys.readouterr().out
    assert out["residual_rms"] < 1e-10
    for k, g in ref.items():
        assert out["grads"][k] == pytest.approx(g, rel=1e-6), k
        assert f"  d(loss)/d({k}) = {out['grads'][k]:.8e}" in printed
    assert out["fd"] == pytest.approx(out["grads"]["Ra"], rel=2e-4)
    assert "FD d(loss)/d(Ra) = " in printed
    assert f"{out['iterations']} outer FGMRES iterations" in printed
