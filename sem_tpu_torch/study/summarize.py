"""Summarize study results into an iteration-count table.

Counterpart of the JAX package's ``study/summarize.py``: for each output
directory of :mod:`sem_tpu_torch.study.boussinesq_run` (or of ``sem_tpu``'s
study, whose files have the same names), one markdown row per run with its
``[cd_linear_solves, ns_linear_solves, nonlinear_iters]`` and u-anchor.  Every
field ``.npz`` found (re)writes its compact ``<title>.stats.json`` sidecar
(above Ra ≈ 1e4 with the de Vahl Davis centerline anchors); runs whose
``.npz`` is gone still appear from their sidecar.  With more than one
directory a first column names each row's directory, so two packages' runs
of one configuration sit side by side.

Usage: ``python -m sem_tpu_torch.study.summarize [dir ...] [-device cpu]``
(default ``Boussinesq_study_torch``; the anchors are evaluated on the card
unless ``-device cpu`` asks for the CPU)
"""
import glob
import json
import os
import re
import sys

import numpy as np
import torch

from sem_tpu_torch.study.boussinesq_run import OUTDIR


def parse_title(name):
    """(mode, Re, Ra, Pr, P, Ne) from a study run title, or None."""
    m = re.match(r"Boussinesq(GS|NJ|JNK|PTC)_([0-9.e+~-]+)_(\d+)~(\d+)_",
                 name)
    if not m:
        return None
    mode, phys, P, Ne = m.group(1), m.group(2), m.group(3), m.group(4)
    Re, Ra, Pr = phys.split("~")
    return mode, float(Re), float(Ra), float(Pr), int(P), int(Ne)


def centerline_anchors(u_e, v_e, P, N_e, Re=1e3, Pr=0.71, L=1.0, n=2001,
                       device="cuda"):
    """(u_max·RePr on x=L/2, v_max·RePr on y=L/2) from element-scattered
    velocity fields (the study's ``.npz`` layout), evaluated on ``device``
    (the card by default): the values the de Vahl Davis (1983) benchmark
    reports (34.73 / 68.59 at Ra=1e5, 64.63 / 219.36 at Ra=1e6); at high Ra
    the domain maxima lie off the centerlines."""
    from sem_tpu_torch.interp import PointEvaluator
    from sem_tpu_torch.mesh import Grid2D

    grid = Grid2D(P, N_e, N_e, L, L)

    def to_global(f_e):
        # element-scattered -> global (any owner copy works: C0 continuity)
        g = np.zeros(grid.N)
        g[grid.gidx_flat] = np.asarray(f_e).reshape(-1)
        return torch.as_tensor(g, dtype=torch.float64, device=device)

    line = np.linspace(0.0, L, n)
    half = np.array([0.5 * L])
    u_line = PointEvaluator(grid, np.meshgrid(half, line, indexing="ij"))(
        to_global(u_e))
    v_line = PointEvaluator(grid, np.meshgrid(line, half, indexing="ij"))(
        to_global(v_e))
    return (float(np.max(np.abs(u_line))) * Re * Pr,
            float(np.max(np.abs(v_line))) * Re * Pr)


def row_from_npz(f, device="cuda"):
    """Full-accuracy row from a field .npz; refreshes its .stats.json.  The
    centerline anchors are evaluated on ``device``."""
    name = os.path.basename(f)[:-4]
    cfg = parse_title(name)
    if cfg is None:
        return None
    mode, Re, Ra, Pr, P, Ne = cfg
    with np.load(f) as z:
        arrs = [z[k] for k in z.files]
    iters = next(a for a in arrs if a.ndim == 1 and a.size in (3, 4))
    u_e, v_e = arrs[1], arrs[2]
    if Ra > 1.1e4:
        # the domain u-max exceeds the centerline u-max at high Ra
        u_anchor, v_anchor = centerline_anchors(u_e, v_e, P, Ne, Re=Re,
                                                Pr=Pr, device=device)
        kind = "centerline"
    else:
        u_anchor = float(np.abs(u_e).max()) * Re * Pr
        v_anchor = float(np.abs(v_e).max()) * Re * Pr
        kind = "domain_max"
    stats = dict(mode=mode, Re=Re, Ra=Ra, Pr=Pr, P=P, Ne=Ne,
                 iters=[int(x) for x in iters],
                 u_anchor=round(u_anchor, 4), v_anchor=round(v_anchor, 4),
                 anchor_kind=kind)
    with open(f[:-4] + ".stats.json", "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats


def rows_of(d, device="cuda"):
    """``{title: stats}`` of one output directory (anchors on ``device``)."""
    stats_by_title = {}
    # sidecars first (the durable record) ...
    for f in sorted(glob.glob(os.path.join(d, "*.stats.json"))):
        title = os.path.basename(f)[: -len(".stats.json")]
        try:
            with open(f) as fh:
                stats_by_title[title] = json.load(fh)
        except (OSError, ValueError):
            continue
    # ... then any live .npz refreshes its sidecar
    for f in sorted(glob.glob(os.path.join(d, "*.npz"))):
        if f.endswith(".ckpt.npz"):  # mid-solve checkpoint, not a result
            continue
        s = row_from_npz(f, device)
        if s is not None:
            stats_by_title[os.path.basename(f)[:-4]] = s
    return stats_by_title


def main(*args):
    """``args``: the directories, and ``-device <name>`` (``cuda`` by
    default; no card ends the process unless ``-device cpu``)."""
    from sem_tpu_torch.utils import cli_device

    args = list(args)
    name = "cuda"
    if "-device" in args:
        i = args.index("-device")
        name = args[i + 1]
        del args[i:i + 2]
    device = cli_device(name)
    dirs = tuple(args) or (OUTDIR,)
    rows = [(d, s) for d in dirs for s in rows_of(d, device).values()]
    rows.sort(key=lambda r: (r[1]["Re"], r[1]["Ra"], r[1]["P"], r[1]["Ne"],
                             r[1]["mode"], r[0]))
    lead = "| dir " if len(dirs) > 1 else ""
    print(lead + "| mode | Re | Ra | P | Ne | [cd, ns, nonlinear] "
          "| u_max·Re·Pr |")
    print("|---" * (7 + (len(dirs) > 1)) + "|")
    for d, s in rows:
        tag = "*" if s.get("anchor_kind") == "centerline" else ""
        print((f"| {d} " if lead else "")
              + f"| {s['mode']} | {s['Re']:.0e} | {s['Ra']:.0e} | {s['P']} "
              f"| {s['Ne']} | {s['iters']} | {s['u_anchor']}{tag} |")


if __name__ == "__main__":
    main(*sys.argv[1:])
