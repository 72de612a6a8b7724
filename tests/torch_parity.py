"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

The reference package ``sem_tpu`` (JAX, on the CPU under ``tests/conftest.py``)
and the port ``sem_tpu_torch`` (torch, ``device="cpu"``) get the same inputs,
made with NumPy from a seed; arrays cross between them as NumPy.
"""
import jax
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
    keys = jax.random.split(jax.random.PRNGKey(0), k)
    return np.stack([np.asarray(jax.random.rademacher(k_, (n,), dtype=dtype))
                     for k_ in keys])
