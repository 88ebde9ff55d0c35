"""Nothing under ``perfbench/`` imports JAX or the JAX package (whole
top-level names: the port's ``repro_torch`` begins with ``repro``) or
reads the ``benchmarks/`` folder, and the reference imports nothing of
the program."""
import ast
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in PERFBENCH.rglob("*.py") if "tests" not in p.parts)


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _strings(path: Path) -> list:
    """String literals that are not docstrings or comments."""
    tree = ast.parse(path.read_text())
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(PERFBENCH)))
def test_no_jax(path):
    assert not _imported(path) & {"jax", "jaxlib", "flax", "repro",
                                  "benchmarks"}
    assert not [s for s in _strings(path) if "benchmarks" in s]


@pytest.mark.parametrize("path", [p for p in FILES
                                  if "reference" in p.parts],
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert _imported(path) <= {"__future__", "dataclasses", "enum", "math",
                               "typing", "numpy", "torch", "perfbench"}
