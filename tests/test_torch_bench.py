"""Port parity, the benchmark script: ``sem_tpu_torch.bench`` against the
JAX package's root ``bench.py`` (the CSR baseline's assembly, the timed
chain of applies, the JSON line's keys) and the pin, which never touches
``BASELINE.json``."""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import bench as jax_bench
from sem_tpu.mesh import Grid2D as JGrid2D
from sem_tpu.ops import apply_system_best as jax_apply_system_best
from sem_tpu_torch import bench
from sem_tpu_torch.mesh import Grid2D

from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(HEADLINE=dict(P=4, N_ex=8, N_ey=8),
            _CMP_CONFIG=dict(P=4, N_ex=4, N_ey=4),
            SOLVE=dict(P=4, N_e=4), HEADLINE_ITERS=3, CMP_ITERS=3,
            CSR_ITERS=2)


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """The bench at P4 sizes, its build directory (the pin's home) in
    ``tmp_path``."""
    for k, v in TINY.items():
        monkeypatch.setattr(bench, k, v)
    monkeypatch.setenv("SEM_TPU_TORCH_BUILD_DIR", str(tmp_path))
    return tmp_path


def test_csr_matches_reference():
    """P4 4×4: the host CSR of ``(K + Pe·conv)`` is the one the JAX bench
    assembles: the same pattern, values to 1e-12."""
    _, A = bench.csr_apply_rate(Grid2D(4, 4, 4, 1.0, 1.0), iters=1,
                                repeats=1)
    _, B = jax_bench.csr_apply_rate(JGrid2D(4, 4, 4, 1.0, 1.0), iters=1,
                                    repeats=1)
    A.sort_indices()
    B.sort_indices()
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_allclose(A.data, B.data, rtol=0,
                               atol=1e-12 * np.abs(B.data).max())


def test_chain_matches_reference():
    """P4 8×8, float32: the chain ``x ← c·(A x)`` after 5 applies, from the
    seeded wind and three power steps, equals the JAX bench's chain (the
    same steps on ``sem_tpu.ops.apply_system_best``) to 2e-5·max."""
    grid = Grid2D(4, 8, 8, 1.0, 1.0)
    u, v, x, c = bench.chain_inputs(grid, torch.float32, "cpu")
    got = bench.chain(grid, u, v, x, c, 5).numpy()

    jg = JGrid2D(4, 8, 8, 1.0, 1.0)
    ju = jnp.asarray(np.random.default_rng(0).standard_normal(jg.N),
                     jnp.float32)
    jv = jnp.asarray(np.random.default_rng(1).standard_normal(jg.N),
                     jnp.float32)
    pe = jnp.asarray(40.0, jnp.float32)
    jx = ju / jnp.linalg.norm(ju)
    for _ in range(3):
        y = jax_apply_system_best(jg, ju, jv, jx, pe)
        lam = float(jnp.linalg.norm(y))
        jx = y / lam
    for _ in range(5):
        jx = (1.0 / lam) * jax_apply_system_best(jg, ju, jv, jx, pe)
    ref = np.asarray(jx)
    assert abs(c - 1.0 / lam) <= 1e-6 / lam
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


def _reference_keys():
    """The keys of the JSON line of the root ``bench.py``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    line = next(n for n in ast.walk(main) if isinstance(n, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == "metric"
                        for k in n.keys))
    return {k.value for k in line.keys}


def test_bench_line_has_every_reference_key(tiny, capsys):
    """The port's JSON line (P4 sizes, on the CPU) carries every key of the
    JAX line, plus the CSR's source and the card's name and power limit;
    with no pin the CSR rate is measured inline."""
    line = bench.main(device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert _reference_keys() <= set(line)
    assert {"csr_source", "card", "power_limit"} <= set(line)
    assert line["csr_source"] == "inline" and line["card"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert abs(line["coupled_solve_u_anchor"] - 3.6119) < 1e-3


def test_pin_csr_leaves_baseline_json_alone(tiny, capsys):
    """``--pin-csr`` writes ``csr_pinned.json`` into the build directory,
    leaves ``BASELINE.json`` byte for byte, and the next bench reads the
    pin."""
    before = (ROOT / "BASELINE.json").read_bytes()
    rate = bench.pin_csr_baseline(repeats=1)
    assert (ROOT / "BASELINE.json").read_bytes() == before
    pin = json.loads((tiny / "csr_pinned.json").read_text())
    assert pin["gdof_s"] == rate and pin["config"] == "p4_4x4_f64_csr_host"
    line = bench.main(device="cpu")
    assert line["csr_source"].startswith("pinned ")
    assert line["csr_pinned_gdof_s"] == rate
    assert (ROOT / "BASELINE.json").read_bytes() == before


def test_bench_needs_a_card_by_default(tiny):
    """Without a card the bench exits non-zero and prints no line, unless
    ``--device cpu`` is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
