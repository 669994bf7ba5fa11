"""Nothing under portbench/ imports JAX or the JAX package, and the plain
references import nothing of the program: compared by whole top-level
module names (`maxk_tpu_torch` starts with `maxk_tpu` but is not it)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "maxk_tpu"}
PROGRAM = "maxk_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert "maxk_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "maxk_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert "portbench" not in top_level_imports(path)


def test_only_program_module_imports_the_program():
    users = {p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py")
             if PROGRAM in top_level_imports(p) and "tests" not in p.relative_to(HERE).parts}
    assert users == {"program.py"}


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from portbench import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "maxk_tpu", types.ModuleType("maxk_tpu"))
    monkeypatch.setitem(sys.modules, "maxk_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == ["maxk_tpu"]
