"""The harness on the CPU at tiny sizes, in a temporary copy of the
benchmark: the last line's schema, cells, mixes and metrics added as new
files only, and ``correct`` coming out false when the timed path is broken
underneath (the look for a card is skipped: ``run_cell`` is called with the
CPU)."""
import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977

FAULTY = '''"""Kernel-free faults planted in the timed path, for the harness's tests."""
import torch

from portbench.entries.{base} import Entry as Base

FAULT = "{fault}"


class Entry(Base):
    calls = 0

    def solve(self, params, start, span):
        state, stats = super().solve(params, start, span)
        Entry.calls += 1
        if FAULT == "unchanged":      # the solve hands back its start state
            state = start if start is not None else self.to_device(
                {{k: 0 * v for k, v in self.to_host(state).items()}})
        elif FAULT == "altered":      # one value of the answer altered
            host = self.to_host(state)
            host["u"] = host["u"].copy()
            host["u"][host["u"].size // 2] += 1e-6
            state = self.to_device(host)
        elif FAULT == "half" and Entry.calls % 2 == 0:
            # every other request answered with the one before
            state = self.to_device(Entry.last)
        Entry.last = self.to_host(state)
        return state, stats
'''


def make_root(tmp_path: Path, faults=(), extra_metric=False) -> Path:
    """A copy of the benchmark with tiny configurations and cells added as
    new files: ``tiny.sweep`` / ``tiny.walk`` (coupled, P4 4×4),
    ``lid.sweep`` (NS, P4 4×4), a mix ``dummy_walk`` of warm-started
    requests and, per fault, a faulty entry and its cells."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    dvd = json.loads((pb / "configs/dvd_p16.json").read_text())
    dvd.update(P_cd=4, N_ex_cd=4, N_ey_cd=4, P_ns=4, N_ex_ns=4, N_ey_ns=4)
    lid = json.loads((pb / "configs/ghia_p16.json").read_text())
    lid.update(P=4, N_ex=4, N_ey=4)
    (pb / "traffic/dummy_walk.json").write_text(json.dumps(
        {"param": "Ra", "law": "log_walk", "lo": 800.0, "hi": 1250.0,
         "steps_decades": [0.03, 0.06], "warmup": 1000.0,
         "start": "previous", "fixed": {"Pr": 0.71}}))
    configs = {"tiny": dvd, "lid": lid}
    for fault in faults:
        configs[f"tiny_{fault}"] = dict(dvd, entry=f"faulty_{fault}")
        (pb / f"entries/faulty_{fault}.py").write_text(
            FAULTY.format(base="boussinesq", fault=fault))
    cells = []   # (cell, configuration, mix, the real cell it stands for)
    for name, cfg in configs.items():
        (pb / f"configs/{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        if name == "lid":
            cells.append(("lid.sweep", name, "re_sweep", "ghia_p16.sweep"))
        else:
            cells += [(f"{name}.sweep", name, "ra_sweep", "dvd_p16.sweep"),
                      (f"{name}.walk", name, "dummy_walk", "dvd_p16.sweep")]
    for cell, cfg, mix, twin in cells:
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1, "why": "test"})
        for m in bench["per_layer"]:
            if twin in m.get("workloads", ()):
                m["workloads"].append(cell)
    if extra_metric:
        (pb / "metrics/dummy_requests.py").write_text(
            "def read(run):\n    return float(len(run.records))\n")
        bench["per_layer"].append(
            {"name": "dummy_requests", "unit": "requests", "better": "higher",
             "source": "program_counter", "layer": "harness",
             "moves": "time_per_solve_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root, cell, trace=False, seconds=1.0):
    return run.run_cell(cell, SEED, seconds, trace, root=root, device="cpu",
                        t_process=time.perf_counter(), log=lambda m: None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"),
                     faults=("unchanged", "altered", "half"),
                     extra_metric=True)


@pytest.mark.parametrize("cell", ["tiny.sweep", "tiny.walk", "lid.sweep"])
def test_sound_run_is_correct_and_the_line_has_the_contracts_keys(root, cell):
    out = run_tiny(root, cell)
    out.pop("controls")
    out.pop("requests")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"time_per_solve_s", "peak_device_gb",
                                   "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_per_layer_line_reads_counters_and_a_metric_added_as_a_file(root):
    out = run_tiny(root, "tiny.sweep", trace=True)
    m = out["metrics"]
    # no trace on the CPU: the trace's readers find nothing and stay out
    assert {"build_s", "mda_nonlinear_its", "mda_gmres_its",
            "ns_linear_solves", "b2_launches", "dummy_requests"} == set(m)
    assert m["dummy_requests"]["value"] == out["attempted"]
    assert m["mda_nonlinear_its"]["value"] >= 1


def test_mix_added_as_a_file_drives_its_cell(root):
    out = run_tiny(root, "tiny.walk", seconds=1.5)
    ras = [r["params"]["Ra"] for r in out["requests"]]
    assert out["correct"] and ras and all(800 <= x <= 1250 for x in ras)
    assert len(out["requests"]) % 4 == 0   # whole blocks of ±0.03, ±0.06


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half"])
@pytest.mark.parametrize("traffic", ["sweep", "walk"])
def test_a_broken_timed_path_is_not_correct(root, fault, traffic):
    out = run_tiny(root, f"tiny_{fault}.{traffic}", seconds=1.5)
    if fault == "half" and out["attempted"] < 2:
        pytest.fail("the window held one request: nothing was left out")
    assert not out["correct"]
    assert out["checks"]["residual_rms_max"]["value"] \
        > out["checks"]["residual_rms_max"]["limit"]


def test_the_control_is_not_correct(root):
    """The control, the program's answers held in float32, comes out not
    correct through the run's own comparison, on the continuity rows by
    more than three times the sound answers' reading."""
    from portbench import control
    from portbench.generate import requests
    from portbench.trace import Spans

    _, _, cfg, mix = run.load_cell(root, "tiny.sweep")
    entry = run.load_module(root, "entries", cfg["entry"]).Entry(cfg, "cpu")
    answers = []
    for params in itertools.islice(requests(mix, SEED), 2):
        state, _ = entry.solve(params, None, Spans())
        answers.append((params, entry.to_host(state)))
    sound = control.judged(root, cfg, answers, "cpu")
    low = control.judged(root, cfg, answers, "cpu", hold=control.f32)
    assert sound["correct"] and sound["failed"] == 0
    assert not low["correct"] and low["failed"] == len(answers)
    c = "continuity_rms_max"
    assert low["checks"][c]["value"] > 3 * sound["checks"][c]["value"]
    assert low["checks"][c]["value"] > low["checks"][c]["limit"]


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "dvd_p16.sweep", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if p.returncode == 0:
        pytest.skip("a card is present")
    assert p.stdout.strip() == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    paths, a run fails and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "dvd_p16.sweep", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """On the card: a short run of each cell is correct (``-m cuda``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in ("dvd_p16.sweep", "ghia_p16.sweep"):
        p = subprocess.run([sys.executable, "-m", "portbench.run",
                            "--workload", cell, "--seed", str(SEED),
                            "--seconds", "2", "--trace", "0"], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
