"""Port parity, ``run_parallel(velo_inner=5)`` of QUICK JNK under a
two-rank gloo group: two processes over gloo and one single process run
the worker of ``tests/torch_parallel_worker.py`` on this case alone, held
against each other and against ``sem_tpu``'s run under
``use_mesh(make_mesh())`` on the 8 virtual devices of tests/conftest.py.
The PTC march is held in ``tests/test_torch_parallel_programs_ptc.py``,
the other multi-process programs in ``tests/test_torch_parallel_programs.py``.
``device="cpu"`` throughout."""
import pytest

from tests.torch_parallel_worker import QUICK, run_workers, velo_inner_matches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's case ``jnk5``, with ``sem_tpu``'s un-fused mesh run:
    ``(results by tag, dir, sem_tpu's runs)``."""
    return run_workers(
        tmp_path_factory.mktemp("parallel_programs_jnk"), ["jnk5"],
        {"jnk5": (False, dict(mode="JNK", velo_inner=5, **QUICK))})


@pytest.mark.parametrize("name", ["jnk5"])
def test_velo_inner_run_parallel_matches(runs, name):
    """(c) ``run_parallel(velo_inner=5)``, QUICK JNK: equal MDA stats and
    coupled GMRES iterations in the ranks, the single process and
    ``sem_tpu``, the fields within 1e-6 relative
    (:func:`tests.torch_parallel_worker.velo_inner_matches`)."""
    velo_inner_matches(runs, name)
