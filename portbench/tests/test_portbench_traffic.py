"""The request generator and the traffic mixes: seeded, deterministic, in
range, and every seed's window covers the range alike."""
import itertools
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench.generate import block_size, load_mix, requests, warmup_request

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
SEEDS = (0, 1, 12345, 2**31 + 17, 2**40 + 3, -5)


def take(mix, seed, n):
    return [r[mix["param"]] for r in itertools.islice(requests(mix, seed), n)]


@pytest.mark.parametrize("name", MIXES)
def test_mix_loads_and_is_deterministic(name):
    mix = load_mix(TRAFFIC / f"{name}.json")
    for seed in SEEDS:
        assert take(mix, seed, 40) == take(mix, seed, 40)
    assert take(mix, 1, 40) != take(mix, 2, 40)


@pytest.mark.parametrize("name", MIXES)
def test_requests_stay_in_range_and_carry_fixed(name):
    mix = load_mix(TRAFFIC / f"{name}.json")
    for seed in SEEDS:
        for r in itertools.islice(requests(mix, seed), 200):
            assert mix["lo"] <= r[mix["param"]] <= mix["hi"]
            for k, v in mix.get("fixed", {}).items():
                assert r[k] == v
    w = warmup_request(mix)
    assert w[mix["param"]] == mix["warmup"]


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_the_same_work(name):
    """Every block of every seed holds the same values (log_uniform) or the
    same steps (log_walk), in another order: seeds differ in order, not in
    the work a window of whole blocks holds."""
    mix = load_mix(TRAFFIC / f"{name}.json")
    B = block_size(mix)
    ref = None
    for seed in SEEDS:
        v = np.array([mix["warmup"]] + take(mix, seed, 5 * B))
        if mix["law"] == "log_walk":
            v = np.round(np.diff(np.log10(v)), 9)
        else:
            v = v[1:]
        blocks = [sorted(b) for b in v.reshape(5, B)]
        ref = ref or blocks[0]
        assert all(np.allclose(b, ref) for b in blocks)


def copy_of_traffic(tmp_path):
    """A copy of the mixes and laws, as a later change would find them."""
    shutil.copytree(TRAFFIC, tmp_path / "traffic")
    shutil.copytree(TRAFFIC.parent / "laws", tmp_path / "laws",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "traffic"


def test_walk_comes_back_each_block(tmp_path):
    traffic = copy_of_traffic(tmp_path)
    (traffic / "walk.json").write_text(json.dumps(
        {"param": "Ra", "law": "log_walk", "lo": 400.0, "hi": 2500.0,
         "steps_decades": [0.02, 0.05], "warmup": 1000.0,
         "start": "previous"}))
    mix = load_mix(traffic / "walk.json")
    B = block_size(mix)
    assert B == 4
    for seed in SEEDS:
        v = take(mix, seed, 4 * B)
        assert v[B - 1] == pytest.approx(mix["warmup"])
        assert v[4 * B - 1] == pytest.approx(mix["warmup"])


def test_a_law_added_as_a_file_drives_a_mix(tmp_path):
    """A new shape of traffic needs a new law file and a mix, and no edit:
    here a ladder of decades, as a continuation sends it."""
    traffic = copy_of_traffic(tmp_path)
    (traffic.parent / "laws" / "ladder.py").write_text(
        "def block(mix):\n    return list(mix['levels'])\n\n\n"
        "def value(previous, item, mix):\n    return item\n")
    (traffic / "ladder.json").write_text(json.dumps(
        {"param": "Ra", "law": "ladder", "lo": 1e3, "hi": 1e5,
         "levels": [1e3, 1e4, 1e5], "warmup": 1e3}))
    mix = load_mix(traffic / "ladder.json")
    assert block_size(mix) == 3
    v = take(mix, 7, 9)
    assert sorted(v[:3]) == sorted(v[3:6]) == [1e3, 1e4, 1e5]


def test_bad_mix_is_refused(tmp_path):
    p = copy_of_traffic(tmp_path) / "bad.json"
    p.write_text(json.dumps({"param": "Ra", "law": "gauss", "lo": 1,
                             "hi": 2, "warmup": 1}))
    with pytest.raises(ValueError):
        load_mix(p)
