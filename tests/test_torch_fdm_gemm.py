"""The f32 eigenbasis transform of the FDM preconditioner in even-odd form
(``sem_tpu_torch.ops.gemm``, ``csrc/evenodd_passes.cu``), and the spectral
Schur block's transform, which keeps its ``torch.matmul`` code.

On the CPU: CPU and float64 fields keep the plain ``torch.matmul`` code, bit
for bit, and launch nothing; the even-odd form of the real bases keeps
their transform; the chain's wiring (the even-odd split and merge, the
Dirichlet corrections in the passes, the folded layouts of its four
products, the spectral diagonals), run with the plain passes on the CPU,
agrees with the plain code.  ``cuda``-marked, on the card: the chain's
error against float64 within 1.5 times the plain f32 path's, two runs and a
CUDA graph's replay equal to the bit (also after other σ on the same
owner), the passes equal to their plain twins, and the counters.
"""
import numpy as np
import pytest
import torch

from sem_tpu_torch import FDM2D, NavierStokesSolver
from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import LAUNCHES, gemm
from sem_tpu_torch.utils.profiling import COUNTERS

SIGMA = 0.37


def _fdm_cases():
    g = Grid2D(3, 4, 5, 1.0, 1.3)
    return {"dirichlet": FDM2D(g),
            "x_only": FDM2D(g, (True, True), (False, False), alpha=0.5),
            "neumann": FDM2D(g, (False, False), (False, False)),
            # Dirichlet on one side: no symmetry, the plain chain
            "west_only": FDM2D(g, (True, False), (True, True))}


def _fdm_before(f, r, sigma=None):
    """``FDM2D.__call__``'s plain path as it was before the chain."""
    grid = f.grid
    batch = r.shape[:-1]
    R = r.reshape(batch + (grid.Ngx, grid.Ngy))
    x0, x1, y0, y1 = f._x0, f._x1, f._y0, f._y1
    if f._has_boundary:
        from sem_tpu_torch.operators import grid_const
        Rb = torch.where(torch.tensor(f._bmask), R, 0.0)
        K1x = grid_const(grid, "K1x", r.dtype, r.device)
        K1y = grid_const(grid, "K1y", r.dtype, r.device)
        m1x_i = grid_const(grid, "m1x", r.dtype, r.device)[x0:x1]
        m1y_i = grid_const(grid, "m1y", r.dtype, r.device)[y0:y1]
        Rint = R[..., x0:x1, y0:y1].clone()
        if x0 == 1:
            Rint -= (K1x[x0:x1, 0][:, None] * R[..., 0:1, y0:y1]) * m1y_i
        if x1 == grid.Ngx - 1:
            Rint -= (K1x[x0:x1, grid.Ngx - 1][:, None]
                     * R[..., grid.Ngx - 1:grid.Ngx, y0:y1]) * m1y_i
        if y0 == 1:
            Rint -= (R[..., x0:x1, 0:1] * K1y[y0:y1, 0][None, :]) \
                * m1x_i[:, None]
        if y1 == grid.Ngy - 1:
            Rint -= (R[..., x0:x1, grid.Ngy - 1:grid.Ngy]
                     * K1y[y0:y1, grid.Ngy - 1][None, :]) * m1x_i[:, None]
    else:
        Rint = R
    Zx = torch.tensor(f._Zx, dtype=r.dtype)
    Zy = torch.tensor(f._Zy, dtype=r.dtype)
    W = Zx.T @ (Rint @ Zy)
    W = W * f._ginv_t(sigma, r)
    Uint = Zx @ (W @ Zy.T)
    if not f._has_boundary:
        return Uint.reshape(batch + (grid.N,))
    Rb[..., x0:x1, y0:y1] = Uint
    return Rb.reshape(batch + (grid.N,))


def _rhs(n, batch, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(batch + (n,)), dtype=dtype)


@pytest.mark.parametrize("case", ["dirichlet", "x_only", "neumann",
                                  "west_only"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sigma", [None, SIGMA])
def test_fdm_on_the_cpu_keeps_its_matmul_bits(case, dtype, sigma):
    """CPU fields, f32 and f64, one field and a batch: the bits of the
    ``torch.matmul`` code as it was, and no launch of the passes."""
    f = _fdm_cases()[case]
    before = LAUNCHES["evenodd_pass"], COUNTERS["fdm.gemm_launches"]
    for batch in ((), (2,)):
        r = _rhs(f.grid.N, batch, dtype)
        assert torch.equal(f(r, sigma=sigma), _fdm_before(f, r, sigma))
    assert (LAUNCHES["evenodd_pass"], COUNTERS["fdm.gemm_launches"]) == before


def test_dispatch_takes_only_float32_on_the_card():
    """The even-odd chain takes f32 fields on a CUDA device; f64 fields on
    the card and every CPU field keep the plain path (no card needed to
    decide)."""
    assert gemm.takes("cuda", torch.float32)
    assert gemm.takes(torch.device("cuda", 0), torch.float32)
    assert not gemm.takes("cuda", torch.float64)
    assert not gemm.takes("cpu", torch.float32)
    assert not gemm.takes("cpu", torch.float64)


def _ns(device="cpu", dtype=torch.float64, P=3, Ne=4):
    return NavierStokesSolver(1.0, 1.0, Re=50.0, Gr=0.0, P=P, N_ex=Ne,
                              N_ey=Ne, u_N=1.0, iprint=[], dtype=dtype,
                              device=device)


def _spectral_before(ns, dtype, rp, sigma):
    """``_spectral``'s ``torch.matmul`` code, written out."""
    from sem_tpu_torch.models.navier_stokes import _edges_get, _edges_set_
    grid = ns.grid
    Ngx, Ngy = grid.Ngx, grid.Ngy

    def c(name, dt=dtype):
        return ns._spec.const(name, dt, ns.device)

    Zx, Zy = c("Zx"), c("Zy")
    K1e, K1yTe = c("K1e"), c("K1yTe")
    m1y = ns._g("m1y", dtype)
    m1x_in = ns._g("m1x", dtype)[1:-1]
    nz = c("nz", torch.bool)
    esafe, ksum, Kbb_inv = c("esafe"), c("ksum"), c("Kbb_inv")
    ginv = torch.where(nz, (ksum + sigma) / esafe, 0.0)
    r_int = torch.where(ns._mb_or_pin, 0.0, rp).reshape(Ngx, Ngy)
    W = Zx.T @ (r_int @ Zy)
    dp_z = Zx @ ((ginv * W) @ Zy.T)
    _edges_set_(dp_z, torch.zeros(2 * Ngy + 2 * (Ngx - 2), dtype=dtype))
    zrows = (K1e @ dp_z) * m1y[None, :]
    zcols = (dp_z[1:-1, :] @ K1yTe) * m1x_in[:, None]
    zb = torch.cat([zrows[0], zrows[1], zcols[:, 0], zcols[:, 1]])
    rb = _edges_get(rp.reshape(Ngx, Ngy))
    dp = _edges_set_(dp_z, Kbb_inv @ (rb - zb)).reshape(-1)
    dp[ns._pin] = rp[ns._pin]
    return dp


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
def test_spectral_on_the_cpu_keeps_its_matmul_bits(dtype, sigma):
    """The 'spectral' Schur apply on the CPU: the bits of the matmul code
    as it was, and no launch."""
    ns = _ns()
    before = LAUNCHES["evenodd_pass"], COUNTERS["fdm.gemm_launches"]
    rp = _rhs(ns.N, (), dtype, seed=3)
    assert torch.equal(ns._spectral(dtype)(rp, sigma),
                       _spectral_before(ns, dtype, rp, sigma))
    assert (LAUNCHES["evenodd_pass"], COUNTERS["fdm.gemm_launches"]) == before


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.fixture
def chain_on_the_cpu(monkeypatch):
    """The solvers take the even-odd chain for CPU fields of every dtype,
    its passes the plain twins: the chain's wiring without a card."""
    monkeypatch.setattr(gemm, "takes", lambda device, dtype: True)


@pytest.mark.parametrize("case", ["dirichlet", "x_only", "neumann",
                                  "west_only"])
@pytest.mark.parametrize("sigma", [None, SIGMA])
def test_chain_wiring_matches_the_fdm(case, sigma, chain_on_the_cpu):
    """FDM2D through the chain (in even-odd form on the symmetric cases;
    the plain products where a basis has none) against the matmul code as
    it was, for one field and a batch of two: in float64 to 1e-12, in
    float32 f32 rounding apart."""
    f = _fdm_cases()[case]
    b = gemm.bases(f, lambda: f._Zx, lambda: f._Zy, "cpu")
    assert (b is None) == (case == "west_only")
    for batch in ((), (2,)):
        r = _rhs(f.grid.N, batch, torch.float64, seed=1)
        want = _fdm_before(f, r, sigma)
        assert _rel(f(r, sigma=sigma), want) < 1e-12
        got = f(r.float(), sigma=sigma)
        assert got.shape == r.shape and got.dtype == torch.float32
        assert _rel(got, want) < 2e-5


@pytest.mark.parametrize("n", [1, 2, 5, 6])
def test_parity_of_symmetric_and_other_bases(n):
    """``parity``: the even and odd columns of a basis symmetric about its
    middle row, zero-padded; None for one that is not."""
    rng = np.random.default_rng(n)
    half = rng.standard_normal((n - n // 2, n))
    Z = np.concatenate([half, half[:n // 2][::-1]])    # every column even
    Z[:, 1::2] = np.concatenate([half[:n // 2], np.zeros((n % 2, n)),
                                 -half[:n // 2][::-1]])[:, 1::2]
    got = gemm.parity(Z)
    if n < 2:
        assert got is None
        return
    Zp, (even, odd) = got
    assert list(even) == list(range(0, n, 2))
    assert list(odd) == list(range(1, n, 2))
    assert Zp.shape == (2, n - n // 2, max(len(even), len(odd)))
    np.testing.assert_array_equal(Zp[0, :, :len(even)], Z[:n - n // 2, 0::2])
    np.testing.assert_array_equal(Zp[1, :n // 2, :len(odd)], Z[:n // 2, 1::2])
    Z[0, 0] += 1.0
    assert gemm.parity(Z) is None


def _whole(Zp, modes, n):
    """The basis (``n`` rows, the modes' columns) that ``parity``'s
    halves stand for: each half mirrored, the odd one with its sign."""
    h = n // 2
    Z = np.zeros((n, sum(map(len, modes))))
    for par, m in enumerate(modes):
        top = Zp[par, :n - h, :len(m)]
        Z[:n - h, m] = top
        Z[n - h:, m] = (1 - 2 * par) * top[:h][::-1]
    return Z


@pytest.mark.parametrize("basis", ["dirichlet_x", "neumann_y",
                                   "neumann_x"])
def test_even_odd_form_keeps_the_real_transforms(basis):
    """The even-odd form of real FDM bases (P8 on 8×8 elements: the
    Dirichlet-Neumann pencils of the CD field, the all-Neumann pencil of
    ``'pcd'``): every column even or odd within ``PARITY_TOL`` of its
    largest entry, and the 1D operator ``Z diag(d) Zᵀ`` kept to 1e-12 of
    its largest entry."""
    grid = Grid2D(8, 8, 8, 1.0, 1.0)
    if basis == "neumann_x":
        f = FDM2D(grid, (False, False), (False, False))
    else:
        f = FDM2D(grid, (True, True), (False, False))
    Z, values = (f._Zy, f._ly) if basis == "neumann_y" else (f._Zx, f._lx)
    d = 1.0 / (1.0 + values)
    Zp, modes = gemm.parity(Z)
    assert sorted(np.concatenate(modes)) == list(range(Z.shape[1]))
    W = _whole(Zp, modes, Z.shape[0])
    cols = np.concatenate(modes)
    plain = np.abs(Z[:, cols] - W[:, cols]).max(axis=0)
    split = np.abs(Z).max(axis=0)[cols] * gemm.PARITY_TOL
    assert np.all(plain <= split)
    kept = (Z * d) @ Z.T
    again = (W * d) @ W.T
    assert np.abs(again - kept).max() <= 1e-12 * np.abs(kept).max()


@pytest.mark.parametrize("shape", [(1, 5, 7), (2, 6, 4), (3, 1, 2)])
def test_prepare_and_finish_passes_invert_each_other(shape):
    """The plain split pass (its even-odd split of a window with the
    corrections, laid out ``(ax, r, f, by, l)`` and zero past the halves,
    each half scaled as the transform's bases scale it: a pair sum counts
    its pair twice) and the merge pass (reading ``(by, ax, r, f, l)``) give
    the window back, the field's values around it; the split's odd middle
    rows and columns are 0."""
    B, p, q = shape
    rng = np.random.default_rng(2)
    F = torch.tensor(rng.standard_normal((B, p + 2, q + 1)))
    window = (1, 0, p, q)
    corr = gemm.Corrections(cw=torch.tensor(rng.standard_normal(p)),
                            m1y=torch.tensor(rng.standard_normal(q)))
    R = gemm._rhs_plain(F, window, corr)
    want = F[:, 1:p + 1, :q].clone()
    want -= (corr.cw[:, None] * F[:, 0:1, :q]) * corr.m1y
    assert torch.equal(R, want)
    P, Q = p - p // 2, q - q // 2
    Pp, Qp = P + 3, Q + 1
    split = gemm._split_plain(F, window, corr, Pp, Qp)
    assert split.shape == (2, Pp, B, 2, Qp)
    assert torch.all(split[:, P:] == 0) and torch.all(split[..., Q:] == 0)
    h = split.permute(2, 0, 3, 1, 4)                   # f, ax, by, r, l
    if p % 2:
        assert torch.all(h[:, 1, :, P - 1] == 0)
    if q % 2:
        assert torch.all(h[:, :, 1, :, Q - 1] == 0)
    wx = torch.ones(Pp, dtype=torch.float64)
    wy = torch.ones(Qp, dtype=torch.float64)
    wx[:p // 2] = 0.5
    wy[:q // 2] = 0.5
    U = (h * wx[:, None] * wy).permute(2, 1, 3, 0, 4)  # by, ax, r, f, l
    out = torch.full_like(F, 7.0)
    gemm._merge_plain(out, U, F, window)
    assert torch.allclose(out[:, 1:p + 1, :q], R, rtol=1e-14, atol=1e-14)
    rest, around = out.clone(), F.clone()
    rest[:, 1:p + 1, :q] = 0.0
    around[:, 1:p + 1, :q] = 0.0
    assert torch.equal(rest, around)


def test_passes_refuse_rows_past_32_bits():
    """The passes count a field's rows in 32 bits: a batch whose rows pass
    that raises before any launch."""
    F = torch.empty(1, 1, 1).expand(2 ** 29, 2, 1)
    out = torch.empty(1, 1, 1).expand(2 ** 29, 2, 1)
    before = LAUNCHES["evenodd_pass"]
    with pytest.raises(ValueError, match="32 bits"):
        gemm._pass(True, F, None, out, (0, 0, 2, 1), gemm.Corrections(),
                   4, 4)
    assert LAUNCHES["evenodd_pass"] == before


def test_diagonal_layout_follows_the_modes():
    """``Bases.matrix`` and ``Bases.vector`` lay per-mode host data out as
    ``(by, ax, i, 1, j)``: entry ``[by, ax, i, 0, j]`` the value at the
    ``i``-th x mode of parity ``ax`` and the ``j``-th y mode of parity
    ``by``, ``pad`` past the modes; the vectors broadcast to the same."""
    f = FDM2D(Grid2D(2, 3, 2, 1.0, 1.5), (True, True), (False, False))
    b = gemm.bases(f, lambda: f._Zx, lambda: f._Zy, "cpu",
                   dtype=torch.float64)
    g = b.matrix(f, "ginv_layout", lambda: f._ginv, -1.0)
    lx = b.vector(f, "lx_layout", 0, lambda: f._lx, -1.0)
    ly = b.vector(f, "ly_layout", 1, lambda: f._ly, -1.0)
    Sp, Tp = b.zx.shape[2], b.zy.shape[2]
    assert g.shape == (2, 2, Sp, 1, Tp)
    assert lx.shape == (1, 2, Sp, 1, 1) and ly.shape == (2, 1, 1, 1, Tp)
    for ax, mx in enumerate(b.modes_x):
        for by, my in enumerate(b.modes_y):
            for i in range(Sp):
                for j in range(Tp):
                    inside = i < len(mx) and j < len(my)
                    want = f._ginv[mx[i], my[j]] if inside else -1.0
                    assert float(g[by, ax, i, 0, j]) == want
        for i in range(Sp):
            want = f._lx[mx[i]] if i < len(mx) else -1.0
            assert float(lx[0, ax, i, 0, 0]) == want
    for by, my in enumerate(b.modes_y):
        for j in range(Tp):
            want = f._ly[my[j]] if j < len(my) else -1.0
            assert float(ly[by, 0, 0, 0, j]) == want


# ------------------------------- the card -------------------------------- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the passes have no CPU build")
    return torch.device("cuda")


#: the card cases: (grid (P, Ne_x, Ne_y), Dirichlet x, Dirichlet y, batch)
CARD_FDM = {"velocity_1023x2": ((16, 64, 64), (True, True), (True, True), 2),
            "cd_511x513": ((16, 32, 32), (True, True), (False, False), 1),
            "small_23": ((3, 8, 8), (True, True), (True, True), 1),
            "pcd_1025": ((16, 64, 64), (False, False), (False, False), 1)}


def _card_fdm(name):
    (P, nx, ny), dx, dy, batch = CARD_FDM[name]
    return FDM2D(Grid2D(P, nx, ny, 1.0, 1.0), dx, dy), batch


def _errors(apply, x64, monkeypatch):
    """(chain, plain f32 path) error of ``apply`` on the f32 cast of
    ``x64`` against ``apply(x64)``, both relative to the f64 result's
    maximum."""
    ref = apply(x64)
    x = x64.float()
    got = apply(x)
    with monkeypatch.context() as m:
        m.setattr(gemm, "takes", lambda device, dtype: False)
        lib = apply(x)
    return _rel(got, ref), _rel(lib, ref)


def _replays(apply, x, other_sigmas, sigma):
    """A CUDA graph of ``apply(static, sigma)`` captured after an eager
    warm-up, replayed on new values after eager applies at
    ``other_sigmas`` on the same owner: (replay, eager) results."""
    static = x.clone()
    apply(static, sigma)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = apply(static, sigma)
    for s in other_sigmas:
        apply(x, s)
    static.copy_(x * 0.5)
    graph.replay()
    torch.cuda.synchronize()
    return out, apply(x * 0.5, sigma)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_FDM))
@pytest.mark.parametrize("sigma", [None, SIGMA])
def test_fdm_kernel_on_the_card(name, sigma, monkeypatch):
    """FDM2D at the main path's shapes and a small grid: the even-odd
    chain's error against f64 at most 1.5 times the plain f32 path's, two
    runs bitwise equal, a CUDA graph's replay bitwise the eager result, and
    the counters moved (two passes a transform)."""
    dev = _card()
    f, batch = _card_fdm(name)
    x64 = _rhs(f.grid.N, (batch,), torch.float64, seed=7).to(dev)
    err, lib = _errors(lambda r: f(r, sigma=sigma), x64, monkeypatch)
    assert err <= 1.5 * lib, (err, lib)
    x = x64.float()
    chains, launches = (COUNTERS["fdm.gemm_launches"],
                        LAUNCHES["evenodd_pass"])
    one, two = f(x, sigma=sigma), f(x, sigma=sigma)
    assert COUNTERS["fdm.gemm_launches"] == chains + 2
    assert LAUNCHES["evenodd_pass"] == launches + 4
    assert torch.equal(one, two)
    got, want = _replays(lambda r, s: f(r, sigma=s), x, (), sigma)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("owner", ["fdm", "schur"])
def test_graph_replays_after_other_sigmas_on_its_owner(owner):
    """A graph captured at one σ replays bitwise the eager result after
    eager applies at two other σ on the same FDM2D or Schur block (what a
    PTC march does between a chunk's capture and its replays): the graph
    reads no diagonal that a later σ could free.  The Schur block keeps its
    ``torch.matmul`` code; the case holds it to the same rule."""
    dev = _card()
    if owner == "fdm":
        f = FDM2D(Grid2D(16, 32, 32, 1.0, 1.0), (True, True), (True, True))
        x = _rhs(f.grid.N, (2,), torch.float32, seed=9).to(dev)

        def apply(r, s):
            return f(r, sigma=s)
    else:
        ns = _ns(dev, P=16, Ne=32)
        x = _rhs(ns.N, (), torch.float32, seed=10).to(dev)
        apply = ns._spectral(torch.float32)
    got, want = _replays(apply, x, (1.5, 2.5), SIGMA)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1023, 1023), (1, 511, 513),
                                   (1, 23, 22), (3, 1, 2)])
def test_passes_on_the_card_equal_their_plain_twins(shape):
    """The split and merge kernels against ``_split_plain`` and
    ``_merge_plain`` on the same f32 data, to the bit: a window with
    corrections on every side, odd and even sides."""
    dev = _card()
    B, p, q = shape
    gen = torch.Generator().manual_seed(12)
    F = torch.randn(B, p + 2, q + 2, generator=gen).to(dev)
    window = (1, 1, p, q)
    corr = gemm.Corrections(*(torch.randn(n, generator=gen).to(dev)
                              for n in (p, p, q, q, p, q)))
    P, Q = p - p // 2, q - q // 2
    Pp, Qp = -(-P // 4) * 4, -(-Q // 4) * 4
    R = F.new_empty((2, Pp, B, 2, Qp))
    gemm._pass(False, F, None, R, window, corr, Pp, Qp)
    assert torch.equal(R, gemm._split_plain(F, window, corr, Pp, Qp))
    U = torch.randn(2, 2, Pp, B, Qp, generator=gen).to(dev)
    out, want = torch.empty_like(F), torch.empty_like(F)
    gemm._pass(True, F, U, out, window, corr, Pp, Qp)
    gemm._merge_plain(want, U, F, window)
    assert torch.equal(out, want)
