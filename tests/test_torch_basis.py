"""Port parity, basis layer: the GLL basis and every Grid2D array of
``sem_tpu_torch`` are bit-identical to ``sem_tpu``'s, and the compact band
storage the CUDA kernels read reproduces the assembled 1D operators exactly;
the explicit global matrices of ``sem_tpu_torch.assemble`` are bit-identical
to ``sem_tpu.assemble``'s."""
import numpy as np
import pytest

from sem_tpu import assemble as jasm
from sem_tpu import gll as jgll
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu_torch import assemble as tasm
from sem_tpu_torch import gll as tgll
from sem_tpu_torch.mesh import Grid2D as TGrid2D
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


@pytest.mark.parametrize("cfg", [(3, 3, 4, 1.2, 0.9), (5, 2, 2, 1.0, 1.0)])
def test_assembled_matrices_bit_identical(cfg):
    """``sem_tpu_torch.assemble`` against ``sem_tpu.assemble``: ``data``,
    ``indices`` and ``indptr`` of every global matrix, of the generic
    assembler's matrix, and of both ``ConvectionTensor`` contractions are
    exactly equal; the vector and rank-3 forms too."""
    ref_g, grid = JGrid2D(*cfg), TGrid2D(*cfg)
    rng = np.random.default_rng(9)

    def same_csr(a, b):
        a.sort_indices()
        b.sort_indices()
        assert a.shape == b.shape
        for name in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))

    same_csr(tasm.global_mass_matrix(grid), jasm.global_mass_matrix(ref_g))
    same_csr(tasm.global_stiffness_matrix(grid),
             jasm.global_stiffness_matrix(ref_g))
    for a, b in zip(tasm.global_gradient_matrices(grid),
                    jasm.global_gradient_matrices(ref_g)):
        same_csr(a, b)
    u, f = rng.standard_normal(grid.N), rng.standard_normal(grid.N)
    for a, b in zip(tasm.global_convection_matrices(grid),
                    jasm.global_convection_matrices(ref_g)):
        assert isinstance(a, tasm.ConvectionTensor)
        assert a.shape == b.shape == (grid.N,) * 3
        same_csr(a.left(u).tocsr(), b.left(u).tocsr())
        same_csr(a.right(f).tocsr(), b.right(f).tocsr())
    P1 = grid.P + 1
    lead = (grid.N_ex, grid.N_ey)
    A4 = rng.standard_normal(lead + (P1,) * 2)
    np.testing.assert_array_equal(tasm.assemble(grid, A4),
                                  jasm.assemble(ref_g, A4))
    A6 = rng.standard_normal(lead + (P1,) * 4)
    same_csr(tasm.assemble(grid, A6), jasm.assemble(ref_g, A6))
    if grid.P <= 3:     # (P+1)^6 values per element
        A8 = rng.standard_normal(lead + (P1,) * 6)
        got, ref = tasm.assemble(grid, A8), jasm.assemble(ref_g, A8)
        assert got["shape"] == ref["shape"]
        np.testing.assert_array_equal(got["coords"], ref["coords"])
        np.testing.assert_array_equal(got["data"], ref["data"])
    with pytest.raises(ValueError):
        tasm.assemble(grid, np.zeros((1, 1, 2, 2)))


def test_assembled_system_matches_matrix_free_apply():
    """``K + Pe·(diag(u) Gx + diag(v) Gy)`` from ``assemble.py`` applied to a
    vector equals the port's matrix-free ``operators.apply_system`` (f64,
    1e-12 relative): the operator ``chip_smoke.py`` holds against kernel B1
    on the card."""
    import torch
    from sem_tpu_torch import operators as tops

    grid = TGrid2D(4, 5, 3, 1.0, 1.3)
    rng = np.random.default_rng(2)
    u, v, w = (rng.standard_normal(grid.N) for _ in range(3))
    Cx, Cy = tasm.global_convection_matrices(grid)
    A = tasm.global_stiffness_matrix(grid) + 7.5 * (Cx.left(u) + Cy.left(v))
    t = [torch.tensor(a, dtype=torch.float64) for a in (u, v, w)]
    ref = tops.apply_system(grid, *t, 7.5).numpy()
    assert np.max(np.abs(A @ w - ref)) <= 1e-12 * np.max(np.abs(ref))
