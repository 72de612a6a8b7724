"""Run one cell of ``BENCHMARK.json`` once, on the card, and print one JSON
line.

Usage, from the root of a checkout::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run finds the card (and exits non-zero without one: it never falls back to
the CPU), loads the program's kernel library (built into
``build/sem_tpu_torch/`` of the checkout on the checkout's first run), makes
one warm-up request of the cell's own shapes, then sends whole requests of
the cell's traffic mix in a closed loop until ``--seconds`` have passed and
the last block of requests started has finished (every block of a mix holds
the same work, so every window holds the same work per request).  After the
window it reads the device-memory peak, with ``--trace 1`` solves the
window's first requests again under the profiler, frees the program's state,
times two controls, and judges every answer of the window with the plain
reference.

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit.  The same numbers end
standard error.
"""
from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process was created (0.0 where /proc is absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: the process's start on the ``time.perf_counter`` clock
T_PROCESS = time.perf_counter() - _process_age()

#: one process with few threads: the program's host side is one Python
#: thread, and idle pool threads of the host math libraries would only
#: contend with it for the cores that the card's host shares
FEW_THREADS = {k: "1" for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                                "OPENBLAS_NUM_THREADS")}
#: how many cores the process is pinned to: a fixed set, the last of those
#: it may use, so the host loop does not wander between cores
PIN_CORES = 2


def pin_host():
    """Pin this thread, and every thread it starts later, to ``PIN_CORES``
    fixed cores (left as it is where fewer are allowed)."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > PIN_CORES:
        os.sched_setaffinity(0, cores[-PIN_CORES:])


if __name__ == "__main__":   # before NumPy and torch start their threads
    os.environ.update(FEW_THREADS)
    pin_host()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from portbench.generate import (block_size, load_mix, requests,  # noqa: E402
                                warmup_request)
from portbench.trace import DeviceTrace, Spans, profile_device  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "sem_tpu")
#: untraced seconds of the window's first requests that a traced run solves
#: again under the profiler (at least one request)
TRACE_SECONDS = 4.0
#: the controls: a float32 GEMM of this size and a host loop of this length
GEMM_N, GEMM_REPS, HOST_LOOP = 4096, 20, 2_000_000


@dataclass
class RunRecord:
    """What the metric readers see of one run: each request's record, the
    grid each kernel runs on, and with ``--trace 1`` the trace of the
    requests (indices into ``records``) solved again under the profiler."""
    records: list
    kernel_grids: dict
    trace: DeviceTrace = None
    traced: list = field(default_factory=list)


def cache_dirs(root: Path) -> dict:
    """The program's build and cache directories, fixed paths inside the
    checkout."""
    b = root / "build"
    return {"SEM_TPU_TORCH_BUILD_DIR": str(b / "sem_tpu_torch"),
            "SEM_TPU_CACHE_DIR": str(b / "sem_tpu_torch" / "cache"),
            "TORCH_EXTENSIONS_DIR": str(b / "torch_extensions"),
            "TRITON_CACHE_DIR": str(b / "triton")}


def load_cell(root: Path, name: str):
    """(benchmark, cell, configuration, traffic mix) of cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = load_mix(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, mix


def load_module(root: Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` of ``root``, loaded from its file."""
    path = root / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}", path)
    if spec is None or not path.exists():
        raise SystemExit(f"no {kind} module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _held_gb() -> float:
    """Device memory held by live tensors, in GB (0 off the card)."""
    import torch

    return (torch.cuda.memory_allocated() / 1e9
            if torch.cuda.is_available() else 0.0)


def _request(entry, params, start, spans, launches):
    """One request: its record, its answer on the device and on the host.
    A request that raises is recorded as failed and the loop goes on."""
    t0 = time.perf_counter()
    gc.collect()   # the previous request's solvers hold reference cycles
    gc_s = time.perf_counter() - t0
    for k in launches:
        launches[k] = 0
    spans.reset()
    rec = {"params": params, "error": None, "stats": {}, "launches": None,
           "gc_s": gc_s, "held_gb": _held_gb()}
    try:
        state, stats = entry.solve(params, start, spans)
        host = entry.to_host(state)
        rec.update(stats=stats, launches=dict(launches))
    except Exception as e:  # noqa: BLE001 - the loop must keep running
        rec["error"] = f"{type(e).__name__}: {e}"
        state = host = None
    rec["wall_s"] = time.perf_counter() - t0
    rec["spans"] = dict(spans.current)
    return rec, state, host


def _controls(device) -> dict:
    """A float32 GEMM timed with CUDA events, and a fixed host loop: a
    contended card or host shows beside the numbers."""
    import torch

    out = {}
    if torch.device(device).type == "cuda":
        g = torch.Generator(device=device).manual_seed(0)
        a = torch.randn(GEMM_N, GEMM_N, device=device, generator=g)
        b = torch.randn(GEMM_N, GEMM_N, device=device, generator=g)
        torch.mm(a, b)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(GEMM_REPS):
            torch.mm(a, b)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1) / GEMM_REPS
        out["gemm_f32_ms"] = ms
        out["gemm_f32_tflops"] = 2 * GEMM_N ** 3 / (ms * 1e-3) / 1e12
        del a, b
    t0 = time.perf_counter()
    acc = 0
    for i in range(HOST_LOOP):
        acc += i & 7
    out["host_loop_s"] = time.perf_counter() - t0
    return out


def _card(device) -> dict:
    import torch

    info = {"kind": torch.cuda.get_device_name(device)}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.sm,temperature.gpu",
             "--format=csv,noheader", "-i", str(torch.device(device).index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_clocks_temp"] = q.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit_clocks_temp"] = "not read"
    return info


def judge(root, cfg, records, device):
    """Judge every answer of the window with the plain reference: each
    number that the configuration's ``limits`` names (the RMS of its
    discrete residual, or of a block of its rows), worked out again in
    float64 at the request's parameters.  Each record's ``host`` answer is
    taken out of it.  Returns (checks, failed)."""
    ref = load_module(root, "reference", cfg["reference"])
    limits = {k: float(v) for k, v in cfg["limits"].items()}
    worst = dict.fromkeys(limits, 0.0)
    raised = nonfinite = over = 0
    for rec in records:
        host = rec.pop("host", None)
        if rec["error"] is not None or host is None:
            raised += 1
            continue
        if not all(np.isfinite(v).all() for v in host.values()):
            nonfinite += 1
            continue
        got = ref.readings(cfg, rec["params"], host, device=device)
        rec["readings"] = {k: got[k] for k in limits}
        for k in limits:
            worst[k] = max(worst[k], got[k])
        over += any(not got[k] <= lim for k, lim in limits.items())
    checks = {f"{k}_max": {"value": worst[k], "limit": lim}
              for k, lim in limits.items()}
    checks.update(raised={"value": raised, "limit": 0},
                  nonfinite={"value": nonfinite, "limit": 0})
    return checks, raised + nonfinite + over


def _metric_specs(bench, kind, cell_name):
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def _forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device="cuda", t_process: float = T_PROCESS,
             log=print):
    """One run of cell ``name``; returns the result line as a dict (the
    controls under ``"controls"`` and each request's record under
    ``"requests"``, which :func:`main` does not print)."""
    bench, cell, cfg, mix = load_cell(root, name)
    for k, v in cache_dirs(root).items():
        os.environ[k] = v
    import torch
    from sem_tpu_torch.ops.kernels import LAUNCHES

    device = torch.device(device)
    on_card = device.type == "cuda"
    entry = load_module(root, "entries", cfg["entry"]).Entry(cfg, device)
    warm = mix.get("start", "zero") == "previous"
    spans = Spans()

    # set-up: the library, the first build and the warm-up solve
    rec, state, host = _request(entry, warmup_request(mix), None, spans,
                                LAUNCHES)
    if rec["error"] is not None:
        raise RuntimeError(f"warm-up request failed: {rec['error']}")
    prev_state, prev_host = (state, host) if warm else (None, None)
    del state
    gc.collect()
    gc.freeze()    # what set-up made stays: the collections between requests
    #                only walk what the requests make
    _sync(device)
    setup_s = time.perf_counter() - t_process
    log(f"setup_s={setup_s:.3f} warm-up {rec['wall_s']:.3f} s")

    # the measured window
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    gen, block = requests(mix, seed), block_size(mix)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or len(records) % block:
        params = next(gen)
        rec, state, host = _request(entry, params, prev_state, spans,
                                    LAUNCHES)
        rec["start_host"], rec["host"] = prev_host, host
        records.append(rec)
        if warm and state is not None:
            prev_state, prev_host = state, host
        del state
        if len(records) == block and on_card:
            # the peak of the first block: the same work in every run,
            # however many blocks the window holds
            block_peak = torch.cuda.max_memory_allocated(device)
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if not on_card:
        block_peak = 0
    if bad := _forbidden_modules():
        raise SystemExit(f"forbidden modules loaded: {bad}")
    log(f"window {window_s:.3f} s, {len(records)} requests, "
        f"peak {peak / 1e9:.4f} GB, first block's {block_peak / 1e9:.4f} GB")

    run = RunRecord(records, entry.kernel_grids())
    if trace and on_card:
        done = 0.0
        for i, r in enumerate(records):
            if run.traced and done >= TRACE_SECONDS:
                break
            run.traced.append(i)
            done += r["wall_s"]

        def again():
            for i in run.traced:
                r = records[i]
                start = (entry.to_device(r["start_host"])
                         if r["start_host"] is not None else None)
                _request(entry, r["params"], start, spans, LAUNCHES)

        spans.marking, spans.edges = True, []
        _sync(device)
        t1 = time.perf_counter()
        _, events = profile_device(again)
        run.trace = DeviceTrace(events, spans.edges,
                                time.perf_counter() - t1)
        spans.marking = False
        log(f"traced {len(run.traced)} requests again: wall "
            f"{run.trace.wall_s:.3f} s, busy {run.trace.busy_s:.3f} s, "
            f"{len(run.trace.ops)} device ops, markers "
            f"{'matched' if run.trace.labelled else 'unmatched'}")

    # free the program's state before the reference runs on the card
    del entry, prev_state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    controls = _controls(device)
    if on_card:
        controls.update(_card(device))
    checks, failed = judge(root, cfg, records, device)

    result = {"correct": bool(records) and failed == 0,
              "attempted": len(records), "failed": failed}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    e2e = {"time_per_solve_s": window_s / max(1, len(records)),
           "peak_device_gb": block_peak / 1e9, "setup_s": setup_s}
    for spec in _metric_specs(bench, kind, name):
        if not trace and spec["name"] in e2e:
            value = e2e[spec["name"]]
        else:
            value = load_module(root, "metrics", spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else device.type,
                        "kind": (torch.cuda.get_device_name(device)
                                 if on_card else "cpu"),
                        "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.wall_s)
        ops = sorted(run.trace.kernel_seconds().items(),
                     key=lambda kv: -kv[1])[:10]
        gaps = sorted(run.trace.idle_gaps(), key=lambda g: -g[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in ops],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    result["checks"] = checks
    result["controls"] = controls
    result["requests"] = [{k: r[k] for k in ("params", "wall_s", "gc_s",
                                             "held_gb", "stats", "launches",
                                             "spans", "error", "readings")
                           if k in r}
                          for r in records]
    if bad := _forbidden_modules():
        raise SystemExit(f"forbidden modules loaded: {bad}")
    gc.unfreeze()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    log = lambda msg: print(f"[portbench] {msg}", file=sys.stderr, flush=True)

    bench, cell, _, _ = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card (torch.cuda.is_available() is false): no result")
        return 1
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"the cell needs {cell['chips']} cards, torch sees "
            f"{torch.cuda.device_count()}: no result")
        return 1
    log(f"host cores {sorted(os.sched_getaffinity(0))} of {os.cpu_count()}")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda:0", log=log)
    controls = out.pop("controls")
    for r in out.pop("requests"):
        log(f"request {json.dumps(r)}")
    print(f"[portbench] controls {json.dumps(controls)}", flush=True)
    log(f"controls {json.dumps(controls)}")
    for k, c in out["checks"].items():
        log(f"check {k}={c['value']!r} limit={c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
