"""Port parity, kernel layer: the plain PyTorch versions of kernels B1/B2
against ``sem_tpu``'s Pallas kernels (interpret mode, as tests/test_pallas.py
runs them), the dispatch rules of ``sem_tpu_torch.ops.kernels``, and — on a
CUDA card only — each CUDA kernel against its plain version."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu import operators as jops
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu.ops import apply_coupled_system_pallas, apply_system_pallas
from sem_tpu_torch import operators as tops
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import _build, kernels

from tests.torch_parity import one_torch_thread, rel_err, t32, t64  # noqa: F401

SIZES = [(4, 8), (7, 5), (7, 40)]


def _inputs(grid, seed):
    rng = np.random.default_rng(seed)
    N = grid.N
    u, v, w = (rng.standard_normal(N) for _ in range(3))
    q = rng.standard_normal(3 * N)
    jac = [rng.standard_normal(N) for _ in range(4)]
    mb = np.zeros(N, bool)
    mb[rng.choice(N, size=N // 7, replace=False)] = True
    return u, v, w, q, jac, mb


@pytest.mark.parametrize("P,Ne", SIZES)
def test_plain_b1_matches_pallas(P, Ne):
    """f32, atol = 2e-5·max|ref| (the bound of tests/test_pallas.py)."""
    cfg = (P, Ne, Ne, 1.0, 1.3)
    u, v, w = _inputs(JGrid2D(*cfg), 21)[:3]
    f32 = jnp.float32
    ref = np.asarray(apply_system_pallas(
        JGrid2D(*cfg), jnp.asarray(u, f32), jnp.asarray(v, f32),
        jnp.asarray(w, f32), jnp.float32(7.5), True))
    got = kernels.apply_system_plain(Grid2D(*cfg), t32(u), t32(v), t32(w),
                                     7.5).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)))


@pytest.mark.parametrize("P,Ne", SIZES)
def test_plain_b2_matches_pallas(P, Ne):
    """f32, random Dirichlet mask (N/7 rows) and Jacobian diagonals;
    atol = 2e-5·max|ref|."""
    cfg = (P, Ne, Ne, 1.0, 1.3)
    u, v, _, q, jac, mb = _inputs(JGrid2D(*cfg), 22)
    f32 = jnp.float32
    ref = np.asarray(apply_coupled_system_pallas(
        JGrid2D(*cfg), jnp.asarray(q, f32), jnp.asarray(u, f32),
        jnp.asarray(v, f32), tuple(jnp.asarray(j, f32) for j in jac),
        jnp.asarray(mb), jnp.float32(37.0), True))
    got = kernels.apply_coupled_system_plain(
        Grid2D(*cfg), t32(q), t32(u), t32(v), tuple(map(t32, jac)),
        torch.as_tensor(mb), 37.0).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)))


@pytest.mark.parametrize("P,Ne", [(3, 3), (4, 8)])
def test_f64_dispatch_takes_the_dense_path(P, Ne):
    """float64 fields go to the dense two-matmul path, which matches the
    reference's dense path to 1e-12 relative."""
    cfg = (P, Ne, Ne, 1.0, 1.3)
    jg, tg = JGrid2D(*cfg), Grid2D(*cfg)
    u, v, w, q, jac, mb = _inputs(jg, 23)
    ref = np.asarray(jops.apply_system(jg, *map(jnp.asarray, (u, v, w)),
                                       7.5))
    got = kernels.apply_system_best(tg, t64(u), t64(v), t64(w), 7.5)
    assert rel_err(got, ref) <= 1e-12
    mbt = torch.as_tensor(mb)
    got = kernels.apply_coupled_system_best(tg, t64(q), t64(u), t64(v),
                                            tuple(map(t64, jac)), mbt, 37.0)
    dense = tops.apply_coupled_system(tg, t64(q), t64(u), t64(v),
                                      tuple(map(t64, jac)), mbt, 37.0)
    assert torch.equal(got, dense)


def test_cpu_dispatch_never_builds_or_counts(monkeypatch):
    """On the CPU the wrappers take the plain versions: no nvcc build is
    attempted and the launch counters stay 0."""
    def no_build():
        raise AssertionError("a CPU tensor must not trigger a CUDA build")

    monkeypatch.setattr(_build, "library", no_build)
    for k in kernels.LAUNCHES:
        monkeypatch.setitem(kernels.LAUNCHES, k, 0)
    grid = Grid2D(4, 3, 3, 1.0, 1.0)
    u, v, w, q, jac, mb = _inputs(grid, 24)
    mbt = torch.as_tensor(mb)
    out = kernels.apply_system_best(grid, t32(u), t32(v), t32(w), 2.0)
    ref = kernels.apply_system_plain(grid, t32(u), t32(v), t32(w), 2.0)
    assert torch.equal(out, ref)
    kernels.apply_system_kernel(grid, t32(u), t32(v), t32(w), 2.0)
    out = kernels.apply_coupled_system_best(grid, t32(q), t32(u), t32(v),
                                            tuple(map(t32, jac)), mbt, 3.0)
    ref = kernels.apply_coupled_system_plain(grid, t32(q), t32(u), t32(v),
                                             tuple(map(t32, jac)), mbt, 3.0)
    assert torch.equal(out, ref)
    kernels.apply_coupled_system_kernel(grid, t32(q), t32(u), t32(v),
                                        tuple(map(t32, jac)), mbt, 3.0)
    assert kernels.LAUNCHES == {"apply_system": 0, "apply_coupled_system": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("P,Ne", [(4, 8), (7, 5), (16, 64)])
def test_cuda_kernels_match_plain(P, Ne):
    """Each CUDA kernel against its plain version on the card (f32,
    atol = 2e-5·max|ref|); float64 on the card is refused by the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    grid = Grid2D(P, Ne, Ne, 1.0, 1.3)
    u, v, w, q, jac, mb = _inputs(grid, 25)

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    n0 = dict(kernels.LAUNCHES)
    got = kernels.apply_system_kernel(grid, c(u), c(v), c(w), 7.5)
    ref = kernels.apply_system_plain(grid, c(u), c(v), c(w), 7.5)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 2e-5 * scale
    mbt = torch.as_tensor(mb, device=dev)
    args = (c(q), c(u), c(v), tuple(map(c, jac)), mbt, 37.0)
    got = kernels.apply_coupled_system_kernel(grid, *args)
    ref = kernels.apply_coupled_system_plain(grid, *args)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 2e-5 * scale
    assert kernels.LAUNCHES["apply_system"] == n0["apply_system"] + 1
    assert (kernels.LAUNCHES["apply_coupled_system"]
            == n0["apply_coupled_system"] + 1)
    with pytest.raises(TypeError):
        kernels.apply_system_kernel(grid, *(c(a).double() for a in (u, v, w)),
                                    7.5)
