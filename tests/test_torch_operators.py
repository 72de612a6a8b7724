"""Port parity, operator layer: every matrix-free operator of
``sem_tpu_torch.operators`` (and the cross-mesh transfer / point evaluation of
``sem_tpu_torch.interp``) against ``sem_tpu`` in float64, relative error
≤ 1e-13 (same algebra, summation order may differ)."""
import numpy as np
import pytest
import jax.numpy as jnp

from sem_tpu import interp as jinterp
from sem_tpu import operators as jops
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu_torch import interp as tinterp
from sem_tpu_torch import operators as tops
from sem_tpu_torch.mesh import Grid2D

from tests.torch_parity import one_torch_thread, rel_err, t64  # noqa: F401

TOL = 1e-13
CFGS = [(3, 3, 3, 1.0, 1.0), (4, 8, 8, 1.0, 1.3), (7, 5, 3, 2.0, 1.0)]


def _fields(grid, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(grid.N) for _ in range(k)]


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("name", ["apply_mass", "apply_stiffness",
                                  "apply_grad_x", "apply_grad_y",
                                  "conv_diag_x", "conv_diag_y"])
def test_linear_operators_match(cfg, name):
    jg, tg = JGrid2D(*cfg), Grid2D(*cfg)
    (w,) = _fields(jg, 1, 1)
    ref = np.asarray(getattr(jops, name)(jg, jnp.asarray(w)))
    got = getattr(tops, name)(tg, t64(w)).numpy()
    assert rel_err(got, ref) <= TOL


@pytest.mark.parametrize("cfg", CFGS)
def test_convection_and_system_match(cfg):
    jg, tg = JGrid2D(*cfg), Grid2D(*cfg)
    u, v, w = _fields(jg, 3, 2)
    ref = np.asarray(jops.apply_convection(jg, *map(jnp.asarray, (u, v, w))))
    assert rel_err(tops.apply_convection(tg, t64(u), t64(v), t64(w)),
                   ref) <= TOL
    ref = np.asarray(jops.apply_system(jg, *map(jnp.asarray, (u, v, w)),
                                       7.5))
    assert rel_err(tops.apply_system(tg, t64(u), t64(v), t64(w), 7.5),
                   ref) <= TOL


@pytest.mark.parametrize("cfg", CFGS)
def test_gather_scatter_match(cfg):
    jg, tg = JGrid2D(*cfg), Grid2D(*cfg)
    (w,) = _fields(jg, 1, 3)
    np.testing.assert_array_equal(tops.gather(tg, t64(w)).numpy(),
                                  np.asarray(jops.gather(jg, jnp.asarray(w))))
    ue = np.random.default_rng(4).standard_normal((jg.N_e, jg.P + 1,
                                                   jg.P + 1))
    ref = np.asarray(jops.scatter_sum_segment(jg, jnp.asarray(ue)))
    assert rel_err(tops.scatter_sum(tg, t64(ue)), ref) <= TOL


@pytest.mark.parametrize("cfg", CFGS)
def test_coupled_dense_matches_operator_composition(cfg):
    """The dense two-matmul coupled saddle matvec (the f64 path of the NS
    solver) against the reference operators composed term by term."""
    jg, tg = JGrid2D(*cfg), Grid2D(*cfg)
    N = jg.N
    rng = np.random.default_rng(5)
    q, ul, vl = rng.standard_normal(3 * N), *_fields(jg, 2, 6)
    jac = _fields(jg, 4, 7)
    mb = np.zeros(N, bool)
    mb[rng.choice(N, size=N // 7, replace=False)] = True
    Re = 37.0
    J = jnp.asarray
    du, dv, dp = J(q[:N]), J(q[N:2 * N]), J(q[2 * N:])

    def sysapply(w):
        return (jops.apply_stiffness(jg, w)
                + Re * jops.apply_convection(jg, J(ul), J(vl), w))

    jxx, jxy, jyx, jyy = map(J, jac)
    dru = sysapply(du) + jxx * du + jxy * dv + jops.apply_grad_x(jg, dp)
    drv = sysapply(dv) + jyx * du + jyy * dv + jops.apply_grad_y(jg, dp)
    drc = jops.apply_grad_x(jg, du) + jops.apply_grad_y(jg, dv)
    ref = np.concatenate([np.where(mb, q[:N], dru), np.where(mb, q[N:2 * N],
                                                             drv),
                          np.where(mb, jops.apply_stiffness(jg, dp), drc)])
    import torch
    got = tops.apply_coupled_system(tg, t64(q), t64(ul), t64(vl),
                                    tuple(map(t64, jac)),
                                    torch.as_tensor(mb), Re)
    assert rel_err(got, ref) <= TOL


def test_transfer_and_point_evaluation_match():
    src_cfg, dst_cfg = (4, 3, 2, 1.0, 2.0), (3, 5, 4, 1.0, 2.0)
    js, jd = JGrid2D(*src_cfg), JGrid2D(*dst_cfg)
    ts, td = Grid2D(*src_cfg), Grid2D(*dst_cfg)
    (f,) = _fields(js, 1, 8)
    ref = np.asarray(jinterp.apply_transfer(js, jd, jnp.asarray(f)))
    assert rel_err(tinterp.apply_transfer(ts, td, t64(f)), ref) <= TOL
    pts = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 2, 7),
                      indexing="ij")
    ref = jinterp.PointEvaluator(js, pts)(jnp.asarray(f))
    assert rel_err(tinterp.PointEvaluator(ts, pts)(t64(f)), ref) <= TOL


@pytest.mark.parametrize("cfg", CFGS)
def test_grid_and_flat_form_match(cfg):
    """``grid_form`` gives the reference's ``(Ngx, Ngy)`` array and
    ``flat_form`` undoes it."""
    jg, tg = JGrid2D(*cfg), Grid2D(*cfg)
    (w,) = _fields(jg, 1, 9)
    ref = np.asarray(jops.grid_form(jg, jnp.asarray(w)))
    got = tops.grid_form(tg, t64(w))
    assert got.shape == ref.shape == (tg.Ngx, tg.Ngy)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tops.flat_form(got).numpy(),
                                  np.asarray(jops.flat_form(jnp.asarray(ref))))
    np.testing.assert_array_equal(tops.flat_form(got).numpy(), w)


def test_eval_field_matches_reference():
    """``eval_field`` (one-shot ``PointEvaluator``) against ``sem_tpu``'s at
    tensor-product points, ≤ 1e-13 relative, as a NumPy array of the points'
    shape."""
    cfg = (4, 3, 2, 1.0, 2.0)
    jg, tg = JGrid2D(*cfg), Grid2D(*cfg)
    (f,) = _fields(jg, 1, 10)
    pts = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 2, 7),
                      indexing="ij")
    ref = jinterp.eval_field(jg, jnp.asarray(f), pts)
    got = tinterp.eval_field(tg, t64(f), pts)
    assert isinstance(got, np.ndarray) and got.shape == (9, 7)
    assert rel_err(got, ref) <= TOL
