"""What the benchmark may import: no module of portbench names JAX, jaxlib,
flax or the JAX package (whole top-level names: the port's package name
begins with the JAX package's), and the reference imports nothing of the
measured program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((harness.HERE / "reference").glob("*.py"))


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert imported_tops(path) <= {"__future__", "numpy", "torch", "math"}, path


def test_forbidden_names_are_whole():
    assert "radar_sounder_crw_tpu_torch" not in harness.FORBIDDEN
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN for m in harness.forbidden_modules())
