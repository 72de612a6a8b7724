"""Checkpoint / resume of coupled solver state.

Counterpart of ``sem_tpu.utils.checkpoint`` with the same on-disk format
(version 1), so a state written by either package resumes in the other: a
single ``.npz`` with the float64 fields ``T``, ``u``, ``v``, ``p``, optionally
``iters`` (``[cd_solves, ns_solves, nonlinear_iters, gmres_iters]``), and
``meta``, a JSON string with the format version, the configuration that
generated the state and optional ``extras`` (solver-controller scalars such
as the PTC pseudo-time step ``ptc_dt``).  The configuration is verified on
load: resuming onto a mismatched discretization raises instead of silently
interpolating.
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state, config: dict, stats=None,
                    extras: dict = None) -> None:
    """Persist a coupled iterate.

    :param path: target ``.npz`` path
    :param state: :class:`sem_tpu_torch.coupling.mda.CoupledState` (or any
        object with T/u/v/p tensor attributes)
    :param config: the configuration dict that generated the state (verified
        on load)
    :param stats: optional ``MDAStats`` to carry iteration counters
    :param extras: optional JSON-able scalars to carry solver-controller
        state across resumes (e.g. ``ptc_dt``: a resumed march that restarts
        the SER ramp at Δt₀ re-crawls the cheap steps it already took)
    """
    meta = {"version": _FORMAT_VERSION, "config": config}
    if extras:
        meta["extras"] = extras
    arrays = {k: getattr(state, k).detach().cpu().numpy()
              for k in ("T", "u", "v", "p")}
    if stats is not None:
        arrays["iters"] = np.array([stats.cd_solves, stats.ns_solves,
                                    stats.nonlinear_iters, stats.gmres_iters])
    np.savez(path, meta=json.dumps(meta), **arrays)


def load_checkpoint(path: str, expect_config: dict = None,
                    with_extras: bool = False, device="cuda"):
    """Load a coupled iterate; returns ``(CoupledState, config, iters)``,
    plus the saved ``extras`` dict as a fourth element when
    ``with_extras=True``.

    :param expect_config: if given, raises ValueError on any mismatch with
        the stored configuration
    :param device: torch device of the state's tensors
    """
    from sem_tpu_torch.coupling.mda import CoupledState

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('version')}")
        config = meta["config"]
        if expect_config is not None:
            mismatched = {k: (config.get(k), v) for k, v in
                          expect_config.items() if config.get(k) != v}
            if mismatched:
                raise ValueError(f"checkpoint config mismatch: {mismatched}")
        state = CoupledState(*(torch.as_tensor(z[k], device=device)
                               for k in ("T", "u", "v", "p")))
        iters = z["iters"].tolist() if "iters" in z else None
        extras = meta.get("extras", {})
    if with_extras:
        return state, config, iters, extras
    return state, config, iters
