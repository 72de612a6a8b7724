"""What the benchmark imports: nothing of JAX or of the JAX package, compared
by whole top-level module names (so ``sem_tpu_torch`` passes), and in the
references nothing of the program under test."""
import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sem_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "functools", "numpy", "torch", "portbench"}
    assert top_level_imports(path) <= allowed
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_run_time_check_compares_whole_names(monkeypatch):
    """The check a run makes once its window has closed: ``sem_tpu_torch``
    begins with ``sem_tpu`` and passes; ``sem_tpu`` and ``jax`` do not."""
    import sys
    import types

    from portbench import run

    monkeypatch.setitem(sys.modules, "sem_tpu_torch_x", types.ModuleType("x"))
    assert run._forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sem_tpu.coupling", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run._forbidden_modules() == ["jax", "sem_tpu"]
