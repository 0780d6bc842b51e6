"""No file of the benchmark imports JAX, its libraries or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the measured
program or of the harness around it."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fewshot_vit_tpu"}


def imported(path: Path):
    """(top-level name, level) of every import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not {name for name, _ in imported(path)} & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name, level in imported(path):
        assert name not in ("fewshot_vit_tpu_torch", "benchmark"), name
        # relative imports stay inside the reference package
        assert level <= 1, (name, level)


def test_the_scan_sees_the_port_as_a_name_of_its_own():
    assert "fewshot_vit_tpu_torch".split(".")[0] not in FORBIDDEN
