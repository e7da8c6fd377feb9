"""Nothing under cardbench/ imports JAX, the JAX package or the JAX
package's benchmarks, and the reference imports nothing of the program;
top-level module names are compared whole (``repro_torch`` is not
``repro``)."""

import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted((ROOT / "cardbench").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_names_are_compared_whole():
    assert "repro_torch" not in FORBIDDEN and "repro" in FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "cardbench" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
