"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

The reference package ``sem_tpu`` (JAX, on the CPU under ``tests/conftest.py``)
and the port ``sem_tpu_torch`` (torch, ``device="cpu"``) get the same inputs,
made with NumPy from a seed; arrays cross between them as NumPy.
"""
import contextlib

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small solves run fastest on one thread, and the test workers share
    the machine's cores with JAX's own thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64, device=CPU)


def t32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=CPU)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _jax_probes(n, dtype, k=8):
    """The ±1 probes ``sem_tpu.krylov.rownorm_estimate`` draws from
    ``PRNGKey(0)``."""
    import jax

    keys = jax.random.split(jax.random.PRNGKey(0), k)
    return np.stack([np.asarray(jax.random.rademacher(k_, (n,), dtype=dtype))
                     for k_ in keys])


#: the port's un-fused host program: the host FGMRES with the adaptive
#: block-Jacobi sweep, which ``sem_tpu`` runs with ``SEM_TPU_FG_FUSED=0
#: SEM_TPU_FUSED_PC=0`` and ``device_krylov=False`` (worker processes pass
#: it explicitly)
UNFUSED = dict(fused=False, device_krylov=False)


@contextlib.contextmanager
def pinned_unfused():
    """Pin the port's coupled Krylov program to :data:`UNFUSED` wherever a
    caller leaves ``fused`` or ``device_krylov`` at its default (``None``,
    the reference's choice by problem size); an explicit ``True`` stays as
    given.  The patch is on the class, so CLIs run in this process are
    pinned too.  Imports nothing of JAX: a worker process of the port can
    use it."""
    from sem_tpu_torch.coupling import mda as tmda

    init = tmda.BoussinesqMDA.__init__

    def pinned(self, *a, fused=None, device_krylov=None, **k):
        init(self, *a,
             fused=UNFUSED["fused"] if fused is None else fused,
             device_krylov=(UNFUSED["device_krylov"] if device_krylov is None
                            else device_krylov), **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmda.BoussinesqMDA, "__init__", pinned)
        yield


@pytest.fixture
def port_unfused():
    """:func:`pinned_unfused` for one test: the parity tests that hold the
    port against ``sem_tpu`` pinned to its un-fused host program.  It has
    its own ``MonkeyPatch``, so a test's ``monkeypatch.undo()`` leaves it
    in place."""
    with pinned_unfused():
        yield
