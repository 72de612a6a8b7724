"""Readings that set a cell's correctness limits, on the card.

Usage, from the root of a checkout::

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 --seconds 30

In one process (set-up once), for each seed: the requests that a run of
``--seconds`` would send (whole blocks), solved by the program on the timed
path, and judged by the run's own comparison (:func:`portbench.run.judge`)
twice: the program's answers as they are (the lower readings), and the
control, each answer held in float32, the nearest precision below the
configurations' float64 (the upper readings).  The float32 answer nearest
the program's is the best that a solve carried out in float32 could return,
so its readings are the least such a solve would give.  One JSON line per
seed, with ``correct`` and ``failed`` of both sides, then a summary line
with, for each limited number, the largest lower and the smallest upper
reading over the seeds.
"""
from __future__ import annotations

import os

if __name__ == "__main__":   # as portbench.run sets its process up
    from portbench.run import FEW_THREADS, pin_host

    os.environ.update(FEW_THREADS)
    pin_host()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from portbench.generate import block_size, requests, warmup_request  # noqa
from portbench.run import ROOT, cache_dirs, judge, load_cell, load_module  # noqa
from portbench.trace import Spans  # noqa: E402


def f32(host: dict) -> dict:
    return {k: v.astype(np.float32).astype(np.float64) for k, v in host.items()}


def judged(root, cfg, answers, device, hold=lambda h: h) -> dict:
    """``correct``, ``failed`` and the checks of ``answers`` (pairs of
    request parameters and host answers), each answer passed through
    ``hold`` first, as a run judges its window."""
    records = [{"params": p, "error": None, "host": hold(h)}
               for p, h in answers]
    checks, failed = judge(root, cfg, records, device)
    return {"correct": failed == 0, "failed": failed, "checks": checks,
            "readings": [r.get("readings") for r in records]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    _, cell, cfg, mix = load_cell(ROOT, args.workload)
    os.environ.update(cache_dirs(ROOT))
    entry = load_module(ROOT, "entries", cfg["entry"]).Entry(cfg, device)
    warm = mix.get("start", "zero") == "previous"
    spans = Spans()
    s0, _ = entry.solve(warmup_request(mix), None, spans)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        prev = s0 if warm else None
        gen, B = requests(mix, seed), block_size(mix)
        answers, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < args.seconds or len(answers) % B:
            params = next(gen)
            state, _ = entry.solve(params, prev, spans)
            answers.append((params, entry.to_host(state)))
            prev = state if warm else None
        line = {"seed": seed, "requests": len(answers),
                "params": [p for p, _ in answers],
                "program": judged(ROOT, cfg, answers, device),
                "control": judged(ROOT, cfg, answers, device, hold=f32)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "seeds": len(lines),
               "kind": torch.cuda.get_device_name(device),
               "program_correct": sum(ln["program"]["correct"]
                                      for ln in lines),
               "control_correct": sum(ln["control"]["correct"]
                                      for ln in lines)}
    for k in lines[0]["program"]["checks"]:
        summary[k] = {
            "lower_reading": max(ln["program"]["checks"][k]["value"]
                                 for ln in lines),
            "upper_reading": min(ln["control"]["checks"][k]["value"]
                                 for ln in lines),
            "limit": lines[0]["program"]["checks"][k]["limit"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
