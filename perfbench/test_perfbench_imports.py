"""Nothing under ``perfbench/`` imports JAX or the JAX package, and the
plain references import nothing of the port: top-level module names
compared whole (``repro_torch`` begins with ``repro``)."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert _imported(path) <= {"__future__", "math", "torch", "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "perfbench"):
            assert node.module.startswith("perfbench.reference"), node.module


def test_whole_name_comparison_keeps_the_port():
    from perfbench import run
    assert "repro_torch".split(".")[0] not in run.FORBIDDEN
    assert "repro.core".split(".")[0] in run.FORBIDDEN
