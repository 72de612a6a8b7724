"""Port parity, basis layer: the GLL basis and every Grid2D array of
``sem_tpu_torch`` are bit-identical to ``sem_tpu``'s, and the compact band
storage the CUDA kernels read reproduces the assembled 1D operators exactly."""
import numpy as np
import pytest

from sem_tpu import gll as jgll
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu_torch import gll as tgll
from sem_tpu_torch.convert import GRID_ARRAYS, grid_from_sem_tpu_config
from sem_tpu_torch.ops.kernels import band_storage

from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("P", [1, 2, 3, 4, 7, 8, 16])
def test_gll_basis_bit_identical(P):
    a, b = jgll.basis(P), tgll.basis(P)
    for name in ("nodes", "weights", "D", "K", "G"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    xi = np.linspace(-1, 1, 13)
    np.testing.assert_array_equal(tgll.standard_evaluation_matrix(P, xi),
                                  jgll.standard_evaluation_matrix(P, xi))


@pytest.mark.parametrize("cfg", [(3, 3, 3, 1.0, 1.0), (4, 8, 8, 1.0, 1.0),
                                 (5, 6, 7, 1.0, 1.3), (16, 4, 2, 2.0, 1.0)])
def test_grid_arrays_bit_identical(cfg):
    ref = JGrid2D(*cfg)
    grid = grid_from_sem_tpu_config(*cfg, reference=ref)   # raises on drift
    for name in GRID_ARRAYS:
        np.testing.assert_array_equal(getattr(grid, name),
                                      np.asarray(getattr(ref, name)))
    for side in "WESN":
        np.testing.assert_array_equal(grid.side_mask(side),
                                      ref.side_mask(side))


def test_grid_check_detects_mismatch():
    with pytest.raises(ValueError):
        grid_from_sem_tpu_config(3, 3, 3, 1.0, 1.0,
                                 reference=JGrid2D(3, 3, 3, 1.0, 1.1))


@pytest.mark.parametrize("cfg", [(4, 8, 8, 1.0, 1.3), (7, 5, 3, 1.0, 1.0),
                                 (16, 3, 2, 1.0, 1.0)])
def test_band_storage_reproduces_1d_operators(cfg):
    """Unpacking AB[i, t] = A[i, i-P+t] gives back K1x/G1x/K1y/G1y exactly."""
    grid = JGrid2D(*cfg)
    P = grid.P
    for A in (grid.K1x, grid.G1x, grid.K1y, grid.G1y):
        n = A.shape[0]
        AB = band_storage(A, P)
        assert AB.shape == (n, 2 * P + 1)
        dense = np.zeros_like(A)
        for i in range(n):
            for t in range(2 * P + 1):
                k = i - P + t
                if 0 <= k < n:
                    dense[i, k] = AB[i, t]
                else:
                    assert AB[i, t] == 0.0
        np.testing.assert_array_equal(dense, A)


def test_band_storage_rejects_out_of_band_entries():
    A = np.eye(6)
    A[0, 5] = 1.0
    with pytest.raises(ValueError):
        band_storage(A, 2)
