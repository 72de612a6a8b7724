"""The one request generator: turns a traffic mix (``traffic/<mix>.json``)
and ``--seed`` into the sequence of requests a closed-loop client sends.

A mix file holds::

    {"param": "Ra",              # the parameter each request sets
     "law": "log_uniform",       # the law of its values: laws/<law>.py
     "lo": 500.0, "hi": 2000.0,  # range of the parameter
     "block": 16,                # further keys that the law reads
     "warmup": 1000.0,           # the warm-up request's value (and the
                                 # value before the first request)
     "start": "zero",            # "zero": every solve from zero;
                                 # "previous": from the previous answer
     "fixed": {"Pr": 0.71}}      # further parameters of every request

A law is a module ``portbench/laws/<law>.py``, found by its name as the
harness finds entries and metric readers, so a new shape of traffic comes
as a new file.  It has ``block(mix)``, the items of one block, and
``value(previous, item, mix)``, the parameter a request sets from the one
before it and its item.

Requests come in blocks that all hold the same items; the seed draws the
order inside each block.  So every seed sends the same set of sizes in
another order, and a window of whole blocks (the harness ends its window on
a block's end) holds the same work whatever the seed.
"""
from __future__ import annotations

import importlib.util
import itertools
import json
from pathlib import Path

import numpy as np

__all__ = ["load_mix", "load_law", "block_size", "requests",
           "warmup_request"]

LAWS = Path(__file__).resolve().parent / "laws"
STARTS = ("zero", "previous")


def load_law(name: str, laws: Path = LAWS):
    """The law module ``<laws>/<name>.py``."""
    path = Path(laws) / f"{name}.py"
    if not name or "/" in name or not path.is_file():
        raise ValueError(f"no traffic law {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_law_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_mix(path) -> dict:
    """The mix of ``path``, with its law's module under ``"_law"``; its
    laws are those beside it, in ``<traffic>/../laws``."""
    path = Path(path)
    mix = json.loads(path.read_text())
    mix["_law"] = load_law(str(mix.get("law", "")),
                           path.resolve().parent.parent / "laws")
    if mix.get("start", "zero") not in STARTS:
        raise ValueError(f"{path}: start must be one of {STARTS}")
    if not 0 < float(mix["lo"]) <= float(mix["hi"]):
        raise ValueError(f"{path}: need 0 < lo <= hi")
    if block_size(mix) < 1:
        raise ValueError(f"{path}: a block needs at least one request")
    return mix


def block_size(mix: dict) -> int:
    """Requests per block."""
    return len(mix["_law"].block(mix))


def warmup_request(mix: dict) -> dict:
    return dict(mix.get("fixed", {}), **{mix["param"]: float(mix["warmup"])})


def requests(mix: dict, seed: int):
    """Endless iterator of request dicts ``{param: value, **fixed}``."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed) % 2**64))
    law, fixed, name = mix["_law"], mix.get("fixed", {}), mix["param"]
    block = np.asarray(law.block(mix), dtype=float)
    value = float(mix["warmup"])
    for _ in itertools.count():
        for x in rng.permutation(block):
            value = float(law.value(value, float(x), mix))
            yield dict(fixed, **{name: value})
