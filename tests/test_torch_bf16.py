"""Port parity at bfloat16: kernels B1-B4 on bf16 fields, as ``sem_tpu``'s
four Pallas kernels take them, the bf16 band blocks their tensor-core
kernels read, and the Krylov solvers' bf16 basis storage.

The plain versions of B1/B2 (and B3/B4 on row strips) at bf16 against the
reference's Pallas kernels at bf16 in interpret mode (B3/B4 under the
8-device CPU mesh of tests/conftest.py), within one bf16 ulp: the function
is the reference kernel's (bf16 operands and constants, f32 arithmetic, one
rounding at the output), and only the order of the f32 sums differs.  On a
CUDA card only, each CUDA kernel against its plain version at bf16."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu.ops import (apply_coupled_system_pallas,
                         apply_coupled_system_pallas_sharded,
                         apply_system_pallas, apply_system_pallas_sharded)
from sem_tpu.ops.pallas_kernels import _banded_constants_stag
from sem_tpu.parallel.sharding import make_mesh
from sem_tpu_torch import krylov as tkry
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import _build, kernels, sharded
from sem_tpu_torch.parallel import row_strips

from tests.test_torch_kernels import CUDA_SIZES, SIZES
from tests.test_torch_kernels import _inputs as _kernel_inputs
from tests.test_torch_parallel import GRIDS, _on_strips
from tests.test_torch_parallel import _inputs as _strip_inputs
from tests.torch_parity import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
#: one bf16 ulp relative (8 significant bits), and an absolute floor for
#: outputs that cancel to near zero
RTOL = 2.0 ** -7
ATOL_REL = 1e-5


def _bf(a, device="cpu") -> torch.Tensor:
    """A NumPy array rounded to bf16 (to nearest even)."""
    return torch.as_tensor(np.asarray(a, np.float64)).to(device=device,
                                                         dtype=BF16)


def _jbf(t: torch.Tensor):
    """The same bf16 values for JAX (exact through f32)."""
    return jnp.asarray(t.float().cpu().numpy(), jnp.bfloat16)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().cpu().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _assert_within_one_ulp(got, ref):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL_REL * np.max(np.abs(ref)))


def _b12_args(grid, seed, device="cpu"):
    """B1's and B2's bf16 arguments from tests/test_torch_kernels.py's
    inputs: ``(u, v, w, 7.5)`` and ``(q, u, v, jac, mb, 37.0)``."""
    u, v, w, q, jac, mb = _kernel_inputs(grid, seed)
    u, v, w, q = (_bf(a, device) for a in (u, v, w, q))
    jac = tuple(_bf(j, device) for j in jac)
    mb = torch.as_tensor(mb, device=device)
    return (u, v, w, 7.5), (q, u, v, jac, mb, 37.0)


# ------------------------ plain versions vs Pallas ------------------------ #
@pytest.mark.parametrize("P,Ne", SIZES)
def test_plain_b1_bf16_matches_pallas(P, Ne):
    """B1's plain version at bf16 == apply_system_pallas at bf16 (interpret
    mode), within one bf16 ulp (rtol 2^-7, atol 1e-5·max|ref|); a bf16
    result.  (The band products in bf16 arithmetic miss by ~5e-3-9e-3 of
    max|ref|.)"""
    cfg = (P, Ne, Ne, 1.0, 1.3)
    (u, v, w, c), _ = _b12_args(Grid2D(*cfg), 21)
    ref = apply_system_pallas(JGrid2D(*cfg), _jbf(u), _jbf(v), _jbf(w),
                              jnp.bfloat16(c), True)
    got = kernels.apply_system_plain(Grid2D(*cfg), u, v, w, c)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    _assert_within_one_ulp(got, ref)


@pytest.mark.parametrize("P,Ne", SIZES)
def test_plain_b2_bf16_matches_pallas(P, Ne):
    """B2's plain version at bf16 (random Dirichlet mask, Jacobian
    diagonals) == apply_coupled_system_pallas at bf16, within one bf16
    ulp."""
    cfg = (P, Ne, Ne, 1.0, 1.3)
    _, (q, u, v, jac, mb, c) = _b12_args(Grid2D(*cfg), 22)
    ref = apply_coupled_system_pallas(
        JGrid2D(*cfg), _jbf(q), _jbf(u), _jbf(v), tuple(map(_jbf, jac)),
        jnp.asarray(mb.numpy()), jnp.bfloat16(c), True)
    got = kernels.apply_coupled_system_plain(Grid2D(*cfg), q, u, v, jac, mb,
                                             c)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    _assert_within_one_ulp(got, ref)


def test_plain_bf16_rounds_the_pointwise_operands_as_pallas_does():
    """Pallas casts u, v (B1) and ul, vl, jac (B2) to the field dtype: f32
    pointwise operands with bf16 fields give the all-bf16 call's result."""
    grid = Grid2D(4, 3, 3, 1.0, 1.3)
    (u, v, w, c), (q, ul, vl, jac, mb, c2) = _b12_args(grid, 28)
    u32, v32 = (torch.as_tensor(a) for a in _kernel_inputs(grid, 28)[:2])
    assert torch.equal(kernels.apply_system_plain(grid, u32, v32, w, c),
                       kernels.apply_system_plain(grid, u, v, w, c))
    jac32 = tuple(torch.as_tensor(j) for j in _kernel_inputs(grid, 28)[4])
    assert torch.equal(
        kernels.apply_coupled_system_plain(grid, q, u32, v32, jac32, mb, c2),
        kernels.apply_coupled_system_plain(grid, q, ul, vl, jac, mb, c2))


# ----------------------- strip versions vs Pallas ------------------------ #
_JAX = {}


def _strip_args_bf16(grid):
    u, v, w, q, jac, mb = _strip_inputs(grid)
    return (_bf(u), _bf(v), _bf(w), _bf(q), tuple(map(_bf, jac)),
            torch.as_tensor(mb))


def _jax_sharded_bf16(kind, nex, ney):
    """``sem_tpu``'s sharded Pallas kernel at bf16 on the 8-device mesh,
    interpret mode, once per grid."""
    key = (kind, nex, ney)
    if key not in _JAX:
        grid = JGrid2D(P=4, N_ex=nex, N_ey=ney, L_x=1.0, L_y=1.0)
        u, v, w, q, jac, mb = _strip_args_bf16(Grid2D(4, nex, ney, 1.0, 1.0))
        if kind == "B3":
            out = apply_system_pallas_sharded(
                grid, _jbf(u), _jbf(v), _jbf(w), jnp.bfloat16(3.0),
                mesh=make_mesh(), interpret=True)
        else:
            out = apply_coupled_system_pallas_sharded(
                grid, _jbf(q), _jbf(u), _jbf(v), tuple(map(_jbf, jac)),
                jnp.asarray(mb.numpy()).astype(jnp.bfloat16),
                jnp.bfloat16(2.5), mesh=make_mesh(), interpret=True)
        assert out.dtype == jnp.bfloat16
        _JAX[key] = out
    return _JAX[key]


def _b3(grid, u, v, w):
    def out(rows):
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        return sharded.apply_system_sharded_plain(
            grid, rows, u[sl], v[sl], sharded.strip_with_halo(grid, rows, w),
            3.0)
    return out


def _b4(grid, q, u, v, jac, mb):
    def out(rows):
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        return sharded.apply_coupled_system_sharded_plain(
            grid, rows, sharded.strip_with_halo(grid, rows, q, 3), u[sl],
            v[sl], tuple(j[sl] for j in jac), mb[sl], 2.5)
    return out


@pytest.mark.parametrize("R", [1, 2, 3, 8])
@pytest.mark.parametrize("nex,ney", GRIDS)
def test_b3_bf16_strips_match_sharded_pallas(nex, ney, R):
    """Concatenated B3 plain strips at bf16 == apply_system_pallas_sharded
    at bf16, within one bf16 ulp; and the same bits as the whole-grid plain
    B1 at bf16."""
    grid = Grid2D(4, nex, ney, 1.0, 1.0)
    u, v, w, *_ = _strip_args_bf16(grid)
    got = _on_strips(grid, R, _b3(grid, u, v, w))
    assert got.dtype == BF16
    _assert_within_one_ulp(got, _jax_sharded_bf16("B3", nex, ney))
    assert torch.equal(got, kernels.apply_system_plain(grid, u, v, w, 3.0))


@pytest.mark.parametrize("R", [1, 2, 3, 8])
def test_b4_bf16_strips_match_sharded_pallas(R):
    """Concatenated B4 plain strips at bf16 (Dirichlet mask, Jacobian
    diagonals) == apply_coupled_system_pallas_sharded at bf16 (P=4 8×4),
    within one bf16 ulp; and the whole-grid plain B2's bits."""
    grid = Grid2D(4, 8, 4, 1.0, 1.0)
    u, v, _, q, jac, mb = _strip_args_bf16(grid)
    got = _on_strips(grid, R, _b4(grid, q, u, v, jac, mb))
    assert got.dtype == BF16
    _assert_within_one_ulp(got, _jax_sharded_bf16("B4", 8, 4))
    assert torch.equal(got, kernels.apply_coupled_system_plain(
        grid, q, u, v, jac, mb, 2.5))


# ------------------------------- dispatch --------------------------------- #
def test_bf16_coef_rounds_as_torch_does():
    """The launches' host rounding of ``coef`` to bf16 is torch's cast, at
    ties, at the overflow edge and for non-finite values."""
    rng = np.random.default_rng(30)
    xs = np.concatenate([
        rng.standard_normal(2000) * np.exp(rng.uniform(-30, 30, 2000)),
        [0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
         3.4e38, 3.3895e38, 1e39, -1e39, np.inf, -np.inf, np.nan, 1e-45,
         7.5, 37.0]])
    want = torch.as_tensor(xs).to(BF16).double().numpy()
    got = np.array([kernels._bf16_coef(x) for x in xs])
    assert np.array_equal(got, want, equal_nan=True)
    assert np.array_equal(np.signbit(got), np.signbit(want))
    assert kernels._bf16_coef(torch.tensor(7.3)) == float(
        torch.tensor(7.3).to(BF16))



def test_bf16_cpu_calls_never_build_or_count(monkeypatch):
    """bf16 on the CPU: the wrappers and dispatchers take the plain
    versions (bf16 results), no nvcc build is attempted and no launch is
    counted."""
    def no_build():
        raise AssertionError("a CPU tensor must not trigger a CUDA build")

    monkeypatch.setattr(_build, "library", no_build)
    for k in kernels.LAUNCHES:
        monkeypatch.setitem(kernels.LAUNCHES, k, 0)
    grid = Grid2D(4, 3, 3, 1.0, 1.0)
    a1, a2 = _b12_args(grid, 24)
    ref1 = kernels.apply_system_plain(grid, *a1)
    ref2 = kernels.apply_coupled_system_plain(grid, *a2)
    for fn, a, ref in ((kernels.apply_system_best, a1, ref1),
                       (kernels.apply_system_kernel, a1, ref1),
                       (kernels.apply_coupled_system_best, a2, ref2),
                       (kernels.apply_coupled_system_kernel, a2, ref2)):
        out = fn(grid, *a)
        assert out.dtype == BF16 and torch.equal(out, ref)
    rows = row_strips(grid.Ngx, 2, grid.P)[0]
    sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
    u, v, w, c = a1
    out = sharded.apply_system_sharded(
        grid, rows, u[sl], v[sl], sharded.strip_with_halo(grid, rows, w), c)
    assert out.dtype == BF16 and torch.equal(out, ref1[sl])
    q, ul, vl, jac, mb, c2 = a2
    out = sharded.apply_coupled_system_sharded(
        grid, rows, sharded.strip_with_halo(grid, rows, q, 3), ul[sl],
        vl[sl], tuple(j[sl] for j in jac), mb[sl], c2)
    assert out.dtype == BF16
    assert torch.equal(out.reshape(3, -1),
                       ref2.reshape(3, -1)[:, sl])
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_bf16_constants_are_rounded_and_f32_tables_keep_their_bits():
    """A bf16 launch reads K1x, G1x, K1y, G1y as bf16 band blocks holding
    the f32 tables' values rounded to bf16, and m1x, m1y rounded to bf16 and
    held as f32, cached beside (not instead of) the f32 tables, which stay
    the f64 constants rounded to f32."""
    grid = Grid2D(5, 3, 4, 1.0, 1.3)
    P, cpu = grid.P, torch.device("cpu")
    t32 = kernels.tile_coefficients(grid, cpu)
    blocks = kernels.band_blocks(grid, cpu)
    c32 = kernels.band_operators(grid, torch.float32, cpu)
    c16 = kernels.band_operators(grid, BF16, cpu)
    for k in c32:
        assert c16[k].dtype == torch.float32 and c32[k].dtype == torch.float32
        assert torch.equal(c16[k], c32[k].to(BF16).float())
    Q = kernels.mma_geometry(P)[0]
    for name, tab, n in (("bx", t32["kgx"], grid.Ngx),
                         ("by", t32["kgy"], grid.Ngy)):
        assert blocks[name].dtype == BF16 and tab.dtype == torch.float32
        i = torch.arange(n)[:, None]
        k = i - P + torch.arange(2 * P + 1)[None, :]     # band tap t's node
        ok = (k >= 0) & (k < n)
        t, r, c = i // 32, i % 32, k - 32 * (i // 32) + Q
        for op in (0, 1):
            got = blocks[name][t.expand_as(k), op, r.expand_as(k),
                               c.clamp(min=0)]
            assert torch.equal(got[ok], tab[:n, :, op][ok].to(BF16))
    assert torch.equal(c32["m1x"], torch.tensor(grid.m1x).float())
    assert torch.equal(t32["kgx"][:grid.Ngx, :, 0], torch.as_tensor(
        kernels.band_storage(grid.K1x, grid.P)).float())
    assert kernels.tile_coefficients(grid, cpu)["kgx"] is t32["kgx"]
    assert kernels.band_blocks(grid, cpu)["bx"] is blocks["bx"]


def test_band_ptrs_hand_b1_and_b3_the_band_blocks(monkeypatch):
    """At bf16 every kernel's constants are the bf16 band blocks of
    ``band_blocks`` and the bf16-rounded masses (B1 and B3 run their band
    products on the tensor cores, as B2 and B4 do); at f32 the coefficient
    pairs of ``tile_coefficients``.  The B1 and B3 wrappers hand their C
    entry points exactly those addresses (traced on ``meta`` tensors, which
    take the card's path with no data and no launch)."""
    grid = Grid2D(4, 3, 4, 1.0, 1.3)
    cpu = torch.device("cpu")
    blocks = kernels.band_blocks(grid, cpu)
    c16 = kernels.band_operators(grid, BF16, cpu)
    want = tuple(t.data_ptr() for t in (blocks["bx"], blocks["by"],
                                        c16["m1x"], c16["m1y"]))
    assert kernels._band_ptrs(grid, cpu, BF16) == want
    t32 = kernels.tile_coefficients(grid, cpu)
    c32 = kernels.band_operators(grid, torch.float32, cpu)
    assert kernels._band_ptrs(grid, cpu) == tuple(
        t.data_ptr() for t in (t32["kgx"], t32["kgy"], c32["m1x"],
                               c32["m1y"]))
    band_ptrs, launched = kernels._band_ptrs, []

    def on_cpu(g, device, dtype=torch.float32):
        assert device.type == "meta"
        return band_ptrs(g, cpu, dtype)

    def launch(name, entry, sfx, device, *args):
        launched.append((entry, sfx, args[4:8]))

    for mod in (kernels, sharded):
        monkeypatch.setattr(mod, "_band_ptrs", on_cpu)
        monkeypatch.setattr(mod, "_launch", launch)

    def meta(n):
        return torch.empty(n, dtype=BF16, device="meta")

    N, P, Ngy = grid.N, grid.P, grid.Ngy
    kernels.apply_system_kernel(grid, meta(N), meta(N), meta(N), 7.5)
    rows = row_strips(grid.Ngx, 2, P)[1]
    n = (rows[1] - rows[0]) * Ngy
    sharded.apply_system_sharded(grid, rows, meta(n), meta(n),
                                 meta(n + 2 * P * Ngy), 7.5)
    assert launched == [("sem_apply_system", "bf16", want),
                        ("sem_apply_system_strip", "bf16", want)]


@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_orders_above_p_max_take_the_dense_route(monkeypatch, dt):
    """Above P_MAX (P=65) the dispatchers of B1/B2 and the strip wrappers of
    B3/B4 take the dense path on whatever device the fields are (traced on
    ``meta`` tensors, which take the card's path with no data): no launch,
    no kernel constants read, outputs of the fields' dtype and shape.  At
    P=64 the same four calls launch their kernels.  The kernels' own raise
    above 64 stays (test_kernels_refuse_orders_above_p_max)."""
    launched = []

    def ptrs(grid, device, dtype=torch.float32):
        launched.append(("band_ptrs", grid.P))
        return (0,) * 4

    def launch(name, entry, sfx, device, *args):
        launched.append((name, sfx))

    for mod in (kernels, sharded):
        monkeypatch.setattr(mod, "_band_ptrs", ptrs)
        monkeypatch.setattr(mod, "_launch", launch)

    def meta(n, dtype=dt):
        return torch.empty(n, dtype=dtype, device="meta")

    def four_calls(P):
        grid = Grid2D(P, 2, 1, 1.0, 1.0)
        N, Ngy = grid.N, grid.Ngy
        rows = row_strips(grid.Ngx, 3, P)[1]
        n = (rows[1] - rows[0]) * Ngy
        h = 2 * P * Ngy
        jac = tuple(meta(n) for _ in range(4))
        return [
            (kernels.apply_system_best(grid, meta(N), meta(N), meta(N), 3.0),
             N),
            (kernels.apply_coupled_system_best(
                grid, meta(3 * N), meta(N), meta(N),
                tuple(meta(N) for _ in range(4)), meta(N, torch.bool), 3.0),
             3 * N),
            (sharded.apply_system_sharded(grid, rows, meta(n), meta(n),
                                          meta(n + h), 3.0), n),
            (sharded.apply_coupled_system_sharded(
                grid, rows, meta(3 * (n + h)), meta(n), meta(n), jac,
                meta(n, torch.bool), 3.0), 3 * n)]

    for out, n in four_calls(kernels.P_MAX + 1):
        assert out.device.type == "meta" and out.dtype == dt
        assert out.shape == (n,)
    assert launched == []
    four_calls(kernels.P_MAX)
    sfx = "f32" if dt == torch.float32 else "bf16"
    assert [x for x in launched if x[0] != "band_ptrs"] == [
        (name, sfx) for name in ("apply_system", "apply_coupled_system",
                                 "apply_system_sharded",
                                 "apply_coupled_system_sharded")]


# ------------------- band blocks of the tensor-core B2/B4 ------------------ #
BLOCK_SIZES = [(4, 8), (7, 5), (16, 4), (9, 7)]


@pytest.mark.parametrize("P,Ne", BLOCK_SIZES)
def test_band_blocks_hold_the_pallas_bf16_band_values(P, Ne):
    """The bf16 band blocks that B2/B4 stage at bf16 (``band_blocks``) hold
    the values ``sem_tpu``'s Pallas kernel rounds with ``astype(bfloat16)``
    (``_banded_constants_stag(grid, "bfloat16")``, 128-row staggered
    blocks) bit for bit, zeros outside the band, and the plain versions' bf16
    band tables."""
    cfg = (P, Ne, Ne + 1, 1.0, 1.3)
    grid = Grid2D(*cfg)
    bx, by, *_ = _banded_constants_stag(JGrid2D(*cfg), "bfloat16")
    bx, by = (np.asarray(b).astype(np.float32) for b in (bx, by))
    blocks = kernels.band_blocks(grid, "cpu")
    band = kernels.band_operators(grid, BF16, "cpu")
    Q, nk, pitch = kernels.mma_geometry(P)
    H, B = 64, 128
    for name, n in (("bx", grid.Ngx), ("by", grid.Ngy)):
        ours = blocks[name].float().numpy()
        assert blocks[name].dtype == BF16
        assert ours.shape == (-(-n // 32), 2, 32, pitch)
        t, op, r, c = np.meshgrid(*map(np.arange, ours.shape), indexing="ij")
        a, b = 32 * t + r, 32 * t - Q + c          # operator row, column
        inband = (a < n) & (b >= 0) & (b < n) & (np.abs(a - b) <= P)
        assert not ours[~inband].any()
        a, b, op, got = a[inband], b[inband], op[inband], ours[inband]
        blk = a // B
        if name == "bx":    # bx[i][op·B + kr, cc] = op(i·B + kr, i·B + cc - H)
            want = bx[blk, op * B + a % B, b - blk * B + H]
            tab = np.stack([band["kxb"].numpy(), band["gxb"].numpy()])
            plain = tab[op, a, b - a + P]
        else:               # by[j][rr, op·B + cc] = opᵀ(j·B + rr - H, j·B + cc)
            want = by[blk, b - blk * B + H, op * B + a % B]
            tab = np.stack([band["kybT"].numpy(), band["gybT"].numpy()])
            plain = tab[op, b - a + P, a]
        assert np.array_equal(got, want)
        assert np.array_equal(got, plain)
        assert np.count_nonzero(got) > 0


def _chunks(first, m, n, P, origin):
    """The k chunks B2/B4's tensor-core kernel runs for nodes first ..
    first+m-1 of an n-node line (``chunk_range`` in ``csrc/mma.cuh``), as
    staged indices [16·c0, 16·(c1+1))."""
    t0, t1 = kernels.band_tap_ranges(n, P)
    last = min(first + m - 1, n - 1)
    k0, k1 = first - P + t0[first], last - P + t1[last] - 1
    return 16 * ((k0 - origin) // 16), 16 * ((k1 - origin) // 16 + 1)


@pytest.mark.parametrize("P,Ne", [(4, 9), (8, 5), (16, 3), (7, 6)])
def test_band_blocks_cover_every_tap(P, Ne):
    """Every tap that ``band_tap_ranges`` gives a row of an operator (the
    taps the f32 kernels run) lies in the staged columns of the row's band
    block and holds the operator's value there, rounded to bf16; every
    other value of the block is zero.  P = 4, 8 and 16 (the compile-time
    orders of the tensor-core kernels) and 7 (a runtime order)."""
    grid = Grid2D(P, Ne, Ne + 1, 1.0, 1.3)
    blocks = kernels.band_blocks(grid, "cpu")
    Q, nk, pitch = kernels.mma_geometry(P)
    for name, A, op in (("bx", grid.K1x, 0), ("bx", grid.G1x, 1),
                        ("by", grid.K1y, 0), ("by", grid.G1y, 1)):
        n = A.shape[0]
        t0, t1 = kernels.band_tap_ranges(n, P)
        block = blocks[name][:, op].float().numpy()
        covered = np.zeros(block.shape, bool)
        for i in range(n):
            t = np.arange(t0[i], t1[i])
            k = i - P + t
            c = k - 32 * (i // 32) + Q
            assert 0 <= c.min() and c.max() < 16 * nk
            want = torch.as_tensor(A[i, k]).to(BF16).float().numpy()
            assert np.array_equal(block[i // 32, i % 32, c], want)
            covered[i // 32, i % 32, c] = True
        assert not block[~covered].any()
        assert np.count_nonzero(block) > 0


@pytest.mark.parametrize("P,Ne", BLOCK_SIZES + [(1, 40), (64, 2)])
def test_band_block_chunks_hold_every_nonzero(P, Ne):
    """Every nonzero coefficient of a warp's 16 rows (x sums) or 8 columns
    (y sums) lies in the k chunks that the tensor-core kernel runs for them,
    and those chunks lie in the staged window of 16·nk nodes."""
    grid = Grid2D(P, Ne, Ne + 1, 1.0, 1.3)
    blocks = kernels.band_blocks(grid, "cpu")
    Q, nk, _ = kernels.mma_geometry(P)
    assert nk * 16 >= Q + 32 + P
    for name, A, m in (("bx", grid.K1x, 16), ("bx", grid.G1x, 16),
                       ("by", grid.K1y, 8), ("by", grid.G1y, 8)):
        n = A.shape[0]
        for i0 in range(0, n, 32):
            for first in range(i0, min(i0 + 32, n), m):
                lo, hi = _chunks(first, m, n, P, i0 - Q)
                assert 0 <= lo and hi <= 16 * nk
                rows = A[first:min(first + m, n)]
                cols = np.nonzero(rows.any(axis=0))[0] - (i0 - Q)
                assert cols.min() >= lo and cols.max() < hi
        assert blocks[name].shape[0] == -(-n // 32)


# --------------------------- on the card only ----------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("P,Ne", CUDA_SIZES)
def test_cuda_kernels_bf16_match_plain(P, Ne):
    """B1-B4 at bf16 on the card against their plain versions, within one
    bf16 ulp; B3/B4 on R=3 strips, concatenated, the whole-grid kernel's
    bits; each launch counted under its ``_bf16`` name; float16 fields and
    mixed dtypes refused by the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    grid = Grid2D(P, Ne, Ne + 1, 1.0, 1.3)
    a1, a2 = _b12_args(grid, 29, dev)
    n0 = dict(kernels.LAUNCHES)
    got1 = kernels.apply_system_kernel(grid, *a1)
    got2 = kernels.apply_coupled_system_kernel(grid, *a2)
    assert got1.dtype == got2.dtype == BF16
    _assert_within_one_ulp(got1, kernels.apply_system_plain(grid, *a1))
    _assert_within_one_ulp(got2, kernels.apply_coupled_system_plain(grid,
                                                                    *a2))
    u, v, w, c = a1
    q, ul, vl, jac, mb, c2 = a2
    b3, b4 = [], []
    strips = row_strips(grid.Ngx, min(3, grid.Ngx // P), P)
    for rows in strips:
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        a3 = (grid, rows, u[sl], v[sl],
              sharded.strip_with_halo(grid, rows, w), c)
        a4 = (grid, rows, sharded.strip_with_halo(grid, rows, q, 3), ul[sl],
              vl[sl], tuple(j[sl] for j in jac), mb[sl], c2)
        for fn, pfn, a, out in (
                (sharded.apply_system_sharded,
                 sharded.apply_system_sharded_plain, a3, b3),
                (sharded.apply_coupled_system_sharded,
                 sharded.apply_coupled_system_sharded_plain, a4, b4)):
            got = fn(*a)
            _assert_within_one_ulp(got, pfn(*a))
            out.append(got.reshape(-1, sl.stop - sl.start))
    assert torch.equal(torch.cat(b3, 1).reshape(-1), got1)
    assert torch.equal(torch.cat(b4, 1).reshape(-1), got2)
    for name, n in (("apply_system", 1), ("apply_coupled_system", 1),
                    ("apply_system_sharded", len(strips)),
                    ("apply_coupled_system_sharded", len(strips))):
        assert kernels.LAUNCHES[name + "_bf16"] == n0[name + "_bf16"] + n
        assert kernels.LAUNCHES[name] == n0[name]
    with pytest.raises(TypeError):
        kernels.apply_system_kernel(grid, *(a.half() for a in a1[:3]), c)
    with pytest.raises(TypeError):
        kernels.apply_system_kernel(grid, u.float(), v, w, c)
    with pytest.raises(TypeError):
        kernels.apply_coupled_system_kernel(grid, q, ul, vl,
                                            (jac[0].float(),) + jac[1:], mb,
                                            c2)
    with pytest.raises(TypeError):
        sharded.apply_system_sharded(*((x.half() if torch.is_tensor(x)
                                        else x) for x in a3))


def _ulps(got, ref) -> torch.Tensor:
    """bf16 ulps between two bf16 tensors: the distance of their values on
    the ordered line of bf16 bit patterns."""
    def line(t):
        b = t.contiguous().view(torch.int16).int() & 0xFFFF
        return torch.where(b >= 0x8000, 0x8000 - b, b)
    return (line(got) - line(ref)).abs()


def _check_one_ulp_above_floor(got, ref):
    """At most one bf16 ulp between ``got`` and ``ref`` per element wherever
    they differ by more than the absolute floor 1e-5·max|ref| (outputs that
    cancel to near zero are held to that floor)."""
    assert got.dtype == BF16
    floor = ATOL_REL * float(ref.float().abs().max())
    far = (_ulps(got, ref) > 1) & ((got.float() - ref.float()).abs() > floor)
    assert not bool(far.any()), int(far.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("Ne", [32, 64])
@pytest.mark.parametrize("R", [1, 2, 4])
def test_cuda_b1_b3_bf16_tensor_cores_within_one_ulp(R, Ne):
    """B1 and B3 at bf16 (the tensor-core kernel) at P16 32×32 and 64×64
    against their plain versions: at most one bf16 ulp per output element
    above the absolute floor 1e-5·max|ref|; the R strips, concatenated, give
    the whole-grid launch's bits; every launch counted at bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    grid = Grid2D(16, Ne, Ne, 1.0, 1.0)
    (u, v, w, c), _ = _b12_args(grid, 32, dev)
    n0 = dict(kernels.LAUNCHES)
    got = kernels.apply_system_best(grid, u, v, w, c)
    _check_one_ulp_above_floor(got, kernels.apply_system_plain(grid, u, v, w,
                                                               c))
    parts = []
    strips = row_strips(grid.Ngx, R, grid.P)
    for rows in strips:
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        a = (grid, rows, u[sl], v[sl], sharded.strip_with_halo(grid, rows, w),
             c)
        out = sharded.apply_system_sharded(*a)
        _check_one_ulp_above_floor(out,
                                   sharded.apply_system_sharded_plain(*a))
        parts.append(out)
    assert torch.equal(torch.cat(parts), got)
    assert kernels.LAUNCHES["apply_system_bf16"] == n0["apply_system_bf16"] + 1
    assert (kernels.LAUNCHES["apply_system_sharded_bf16"]
            == n0["apply_system_sharded_bf16"] + len(strips))
    assert kernels.LAUNCHES["apply_system"] == n0["apply_system"]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 4])
def test_cuda_b2_b4_bf16_tensor_cores_within_one_ulp(R):
    """B2 and B4 at bf16 (the tensor-core kernel) at P16 64×64 against their
    plain versions: at most one bf16 ulp per output element where the
    output is above the absolute floor 1e-5·max|ref| (outputs that cancel
    to near zero are held to that floor); the R strips, concatenated, give
    the whole-grid launch's bits; every launch counted at bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    grid = Grid2D(16, 64, 64, 1.0, 1.0)
    _, (q, ul, vl, jac, mb, c) = _b12_args(grid, 31, dev)
    n0 = dict(kernels.LAUNCHES)
    check = _check_one_ulp_above_floor
    got = kernels.apply_coupled_system_best(grid, q, ul, vl, jac, mb, c)
    check(got, kernels.apply_coupled_system_plain(grid, q, ul, vl, jac, mb,
                                                  c))
    parts = []
    strips = row_strips(grid.Ngx, R, grid.P)
    for rows in strips:
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        a = (grid, rows, sharded.strip_with_halo(grid, rows, q, 3), ul[sl],
             vl[sl], tuple(j[sl] for j in jac), mb[sl], c)
        out = sharded.apply_coupled_system_sharded(*a)
        check(out, sharded.apply_coupled_system_sharded_plain(*a))
        parts.append(out.reshape(3, -1))
    assert torch.equal(torch.cat(parts, 1).reshape(-1), got)
    assert (kernels.LAUNCHES["apply_coupled_system_bf16"]
            == n0["apply_coupled_system_bf16"] + 1)
    assert (kernels.LAUNCHES["apply_coupled_system_sharded_bf16"]
            == n0["apply_coupled_system_sharded_bf16"] + len(strips))


@pytest.mark.cuda
def test_cuda_bf16_entry_points_round_coef():
    """B1-B4 at bf16 round the f32 ``coef`` they are given to bf16 in their
    entry points: a ``coef`` off the bf16 grid gives the bits of the same
    launch with ``_bf16_coef(coef)``, within one bf16 ulp of the plain
    versions (which round it on the host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    grid = Grid2D(8, 4, 5, 1.0, 1.3)
    (u, v, w, _), (q, ul, vl, jac, mb, _) = _b12_args(grid, 37, dev)
    rows = row_strips(grid.Ngx, 2, grid.P)[1]
    sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
    calls = (
        (kernels.apply_system_kernel, kernels.apply_system_plain,
         (grid, u, v, w)),
        (kernels.apply_coupled_system_kernel,
         kernels.apply_coupled_system_plain, (grid, q, ul, vl, jac, mb)),
        (sharded.apply_system_sharded, sharded.apply_system_sharded_plain,
         (grid, rows, u[sl], v[sl], sharded.strip_with_halo(grid, rows, w))),
        (sharded.apply_coupled_system_sharded,
         sharded.apply_coupled_system_sharded_plain,
         (grid, rows, sharded.strip_with_halo(grid, rows, q, 3), ul[sl],
          vl[sl], tuple(j[sl] for j in jac), mb[sl])))
    for c in (7.3, 37.3, -0.1):
        assert kernels._bf16_coef(c) != c
        for fn, pfn, a in calls:
            got = fn(*a, c)
            assert torch.equal(got, fn(*a, kernels._bf16_coef(c)))
            _assert_within_one_ulp(got, pfn(*a, c))


@pytest.mark.cuda
def test_cuda_mma_geometry_is_the_librarys():
    """The host's mirror of the tensor-core kernels' staged geometry
    (``mma_geometry``, which lays out ``band_blocks``) is the library's at
    every order the kernels take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for P in range(1, kernels.P_MAX + 1):
        assert kernels.library_mma_geometry(P) == kernels.mma_geometry(P)


# -------------------------- Krylov basis storage -------------------------- #
def _reference_rng():
    """tests/test_krylov_fdm.py's module RNG (seed 42) as its fgmres test
    finds it: after the draws of the tests before it in the file."""
    rng = np.random.default_rng(42)

    def random_system(n, sym=False):      # its _random_system's draws
        rng.standard_normal((n, n))
        if not sym:
            rng.standard_normal((n, n))
        rng.standard_normal(n)

    random_system(80)
    random_system(80, sym=True)
    rng.standard_normal((120, 120))       # test_gmres_restarted
    rng.standard_normal(120)
    random_system(120)
    random_system(50)
    random_system(60)
    rng.standard_normal((60, 60))         # test_gmres_dgks_eta_...
    rng.standard_normal(60)
    return rng


@pytest.mark.parametrize("solver", ["fgmres", "gmres"])
def test_krylov_bf16_basis_and_varying_precon(solver):
    """The port's counterpart of tests/test_krylov_fdm.py::
    test_fgmres_basis_dtype_and_varying_precon: ``basis_dtype=bfloat16``
    (bf16 Arnoldi basis, f32 arithmetic) on the same system, the same
    varying right preconditioner for ``fgmres`` (plain ``gmres`` takes the
    linear one, the same damping without the variation), and the same
    assertions."""
    rng = _reference_rng()
    n = 96
    A = 10.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    x_true = rng.standard_normal(n)
    b = (A @ x_true).astype(np.float32)
    At = torch.as_tensor(A, dtype=torch.float32)

    def varying(r):
        return r / 10.0 * (1.0 + 0.3 * torch.sin(torch.sum(torch.abs(r))))

    kw = dict(atol=1e-4, restart=30, maxiter=300, basis_dtype=BF16)
    if solver == "fgmres":
        x, info = tkry.fgmres(lambda v: At @ v, torch.as_tensor(b),
                              precon=varying, **kw)
    else:
        x, info = tkry.gmres(lambda v: At @ v, torch.as_tensor(b),
                             precon=lambda r: r / 10.0, **kw)
    assert info.converged
    got = x.numpy().astype(np.float64)
    assert np.linalg.norm(A @ got - np.asarray(b, np.float64)) <= 1e-4
    np.testing.assert_allclose(got, x_true, rtol=2e-4, atol=2e-4)
