"""``BENCHMARK.json`` against the benchmark's contract: keys, names, units,
limits, the files each entry names, and the readers each metric needs."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries_keys_and_names(kind):
    entries = BENCH[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer"):
            assert k not in e or line(e[k])


def test_metric_counts_and_names():
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) \
        == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_files_and_reduced():
    for c in BENCH["configs"]:
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / "portbench/entries" / f"{cfg['entry']}.py").exists()
        assert (ROOT / "portbench/reference"
                / f"{cfg['reference']}.py").exists()
        assert cfg["limits"] and all(float(v) > 0
                                     for v in cfg["limits"].values())
        assert "residual_rms" in cfg["limits"]
        assert cfg["assumed"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_cells():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert line(w["why"])
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").exists()


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        def has(m):
            return "workloads" not in m or w["name"] in m["workloads"]
        e2e = [m["name"] for m in BENCH["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"] if has(m)]
        assert layer
        for m in layer:
            assert m["moves"] in e2e


def test_per_layer_readers_exist():
    for m in BENCH["per_layer"]:
        src = (ROOT / "portbench/metrics" / f"{m['name']}.py").read_text()
        assert "def read(run)" in src
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_budget_of_a_full_check_fits():
    """2 + 14 × cells runs of run_seconds + 60 s, 2 × 90 s of compile per
    cell and 1200 s spare fit into 43200 s, with the full 24 cells."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
