"""Port parity, kernel layer: the plain PyTorch versions of kernels B1/B2
against ``sem_tpu``'s Pallas kernels (interpret mode, as tests/test_pallas.py
runs them), the dispatch rules and row-window launch geometry of
``sem_tpu_torch.ops.kernels``, and — on a CUDA card only — each CUDA kernel
(B1-B4) against its plain version.  The strip kernels' plain versions are
held against JAX in tests/test_torch_parallel.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu import operators as jops
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu.ops import apply_coupled_system_pallas, apply_system_pallas
from sem_tpu_torch import operators as tops
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import _build, kernels, sharded
from sem_tpu_torch.parallel import row_strips

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


@pytest.mark.parametrize("P,Ne", [(1, 4), (2, 3), (3, 5), (4, 8), (5, 7),
                                  (7, 5), (16, 4), (64, 2)])
def test_band_tap_ranges_cover_every_nonzero(P, Ne):
    """The taps the CUDA kernels B1/B2 run (``band_tap_ranges``, the formula
    of ``tap_span`` in csrc/tile.cuh) hold every nonzero of K1x, G1x, K1y
    and G1y; a band product over those taps alone, ascending, equals the
    full band product bit for bit at f64 and the dense product to 1e-13;
    and B1/B2's interleaved coefficient tables are the band storage plus
    zero padding."""
    grid = Grid2D(P, Ne, Ne + 1, 1.0, 1.3)
    w = np.random.default_rng(P * Ne).standard_normal(max(grid.Ngx,
                                                          grid.Ngy))
    for A in (grid.K1x, grid.G1x, grid.K1y, grid.G1y):
        n = A.shape[0]
        t0, t1 = kernels.band_tap_ranges(n, P)
        AB = kernels.band_storage(A, P)
        t = np.arange(2 * P + 1)[None, :]
        assert not np.any(AB[(t < t0[:, None]) | (t >= t1[:, None])])
        assert np.all(t1 - t0 == np.where(np.arange(n) % P == 0,
                                          t1 - t0, P + 1))
        full, part = np.zeros(n), np.zeros(n)
        for i in range(n):
            for tt in range(2 * P + 1):
                k = i - P + tt
                if 0 <= k < n:
                    full[i] += AB[i, tt] * w[k]
                    if t0[i] <= tt < t1[i]:
                        part[i] += AB[i, tt] * w[k]
        assert np.array_equal(full, part)
        dense = A @ w[:n]
        assert np.max(np.abs(part - dense)) <= 1e-13 * np.max(np.abs(dense))
    c = kernels.tile_coefficients(grid, torch.device("cpu"))
    for name, K, G, n in (("kgx", grid.K1x, grid.G1x, grid.Ngx),
                          ("kgy", grid.K1y, grid.G1y, grid.Ngy)):
        kg = c[name].numpy()
        assert kg.dtype == np.float32
        assert kg.shape == (n + kernels.TILE, 2 * P + 1, 2)
        assert np.array_equal(kg[:n, :, 0],
                              kernels.band_storage(K, P).astype(np.float32))
        assert np.array_equal(kg[:n, :, 1],
                              kernels.band_storage(G, P).astype(np.float32))
        assert not np.any(kg[n:])


def test_kernels_refuse_orders_above_p_max():
    """B1/B2 take 1 <= P <= 64 (the reference's limit) and say so; the check
    is made before anything is built or launched."""
    grid = Grid2D(kernels.P_MAX + 1, 1, 1, 1.0, 1.0)
    with pytest.raises(ValueError, match="P <= 64"):
        kernels._band_ptrs(grid, torch.device("cpu"))


@pytest.mark.parametrize("Ngx,R,P", [(33, R, 4) for R in range(1, 9)] + [
    (281, 3, 4), (1025, 2, 16), (1025, 4, 16), (36, 3, 7)])
def test_row_window_tiles_cover_each_strip(Ngx, R, P):
    """The tile rows that B1-B4 launch on each strip of ``row_strips``
    (``row_window_tiles``; tile row k starts at grid row k·TILE): the first
    is the lattice tile that holds the strip's first row, never a tile
    started at that row; together they write each of the strip's rows once,
    and each writes at least one; and every input row that a written row's
    nonzero taps read (``band_tap_ranges``) lies inside the strip's buffer
    ``[r0-P, r1+P)`` and inside its tile's staged rows, the tile with ``P``
    halo rows."""
    T = kernels.TILE
    t0, t1 = kernels.band_tap_ranges(Ngx, P)
    for r0, r1 in row_strips(Ngx, R, P):
        first, n = kernels.row_window_tiles(r0, r1)
        assert first * T == r0 - r0 % T and n >= 1
        written = np.zeros(Ngx, int)
        for s in range(first * T, (first + n) * T, T):
            lo, hi = max(s, r0), min(s + T, r1)
            assert lo < hi
            written[lo:hi] += 1
            for i in range(lo, hi):
                k0, k1 = i - P + t0[i], i - P + t1[i]   # rows [k0, k1)
                assert r0 - P <= k0 and k1 <= r1 + P
                assert s - P <= k0 and k1 <= s + T + P
        assert np.all(written[r0:r1] == 1)
        assert not written[:r0].any() and not written[r1:].any()


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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


CUDA_SIZES = [(3, 5), (5, 7), (7, 5), (4, 8), (16, 32), (16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,Ne", CUDA_SIZES)
def test_cuda_kernels_match_plain(P, Ne):
    """Each CUDA kernel against its plain version on the card (f32,
    atol = 2e-5·max|ref|), on grids whose sides (Ne·P+1, (Ne+1)·P+1) are
    no multiple of the 32-node tile, at orders with (4, 16) and without a
    compile-time kernel, with a random Dirichlet mask; float64 on the card
    is refused by the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    grid = Grid2D(P, Ne, Ne + 1, 1.0, 1.3)
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


@pytest.mark.cuda
@pytest.mark.parametrize("P,Ne", CUDA_SIZES)
def test_cuda_row_window_r1_equals_whole_grid(P, Ne):
    """B3/B4 on one strip (R=1: the whole grid through the row-window entry
    point, with P zero halo rows) against B1/B2: the same kernel, the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    grid = Grid2D(P, Ne, Ne + 1, 1.0, 1.3)

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    u, v, w, q, jac, mb = _inputs(grid, 27)
    u, v, w, q, jac = c(u), c(v), c(w), c(q), tuple(map(c, jac))
    mb = torch.as_tensor(mb, device=dev)
    rows = row_strips(grid.Ngx, 1, P)[0]
    assert rows == (0, grid.Ngx)
    assert torch.equal(
        kernels.apply_system_kernel(grid, u, v, w, 7.5),
        sharded.apply_system_sharded(grid, rows, u, v,
                                     sharded.strip_with_halo(grid, rows, w),
                                     7.5))
    assert torch.equal(
        kernels.apply_coupled_system_kernel(grid, q, u, v, jac, mb, 37.0),
        sharded.apply_coupled_system_sharded(
            grid, rows, sharded.strip_with_halo(grid, rows, q, 3), u, v, jac,
            mb, 37.0))


@pytest.mark.cuda
@pytest.mark.parametrize("P,Ne,R", [(4, 8, 2), (4, 8, 4), (16, 64, 2),
                                    (3, 5, 3), (7, 5, 2), (16, 32, 4),
                                    (4, 8, 3)])
def test_cuda_strip_kernels_match_plain(P, Ne, R):
    """Kernels B3/B4 on each of R row strips (halos cut from the full field)
    against their plain versions on the card (f32, atol = 2e-5·max|ref|)
    and, concatenated, against B1/B2 (the same kernel: equal bits).  The
    cases take compile-time (4, 16) and runtime (3, 7) orders, and strips
    that start inside an element and inside a 32-row tile (R=3 at P4 8×8:
    rows 11 and 22; R=4 at P16 32×32: rows 129, 257, 385)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    grid = Grid2D(P, Ne, Ne, 1.0, 1.3)
    u, v, w, q, jac, mb = _inputs(grid, 26)

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    u, v, w, q, jac = c(u), c(v), c(w), c(q), tuple(map(c, jac))
    mb = torch.as_tensor(mb, device=dev)
    n0 = dict(kernels.LAUNCHES)
    b3, b4 = [], []
    for rows in row_strips(grid.Ngx, R, P):
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        a3 = (grid, rows, u[sl], v[sl],
              sharded.strip_with_halo(grid, rows, w), 7.5)
        a4 = (grid, rows, sharded.strip_with_halo(grid, rows, q, 3), u[sl],
              v[sl], tuple(j[sl] for j in jac), mb[sl], 37.0)
        for fn, pfn, a, out in (
                (sharded.apply_system_sharded,
                 sharded.apply_system_sharded_plain, a3, b3),
                (sharded.apply_coupled_system_sharded,
                 sharded.apply_coupled_system_sharded_plain, a4, b4)):
            got, ref = fn(*a), pfn(*a)
            torch.cuda.synchronize()
            assert float((got - ref).abs().max()) <= \
                2e-5 * float(ref.abs().max())
            out.append(got.reshape(-1, sl.stop - sl.start))
    assert torch.equal(torch.cat(b3, 1).reshape(-1),
                       kernels.apply_system_kernel(grid, u, v, w, 7.5))
    assert torch.equal(torch.cat(b4, 1).reshape(-1),
                       kernels.apply_coupled_system_kernel(
                           grid, q, u, v, jac, mb, 37.0))
    assert kernels.LAUNCHES["apply_system_sharded"] == \
        n0["apply_system_sharded"] + R
    assert kernels.LAUNCHES["apply_coupled_system_sharded"] == \
        n0["apply_coupled_system_sharded"] + R
    with pytest.raises(TypeError):
        sharded.apply_system_sharded(*((a.double() if torch.is_tensor(a)
                                        else a) for a in a3))
