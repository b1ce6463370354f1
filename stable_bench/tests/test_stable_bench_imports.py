"""Nothing of the benchmark imports JAX or the JAX package (``repro``),
compared by whole top-level name, and the reference imports nothing of the
program either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "control.py", "check.py", "datagen.py", "roofline.py"])
def test_judging_side_imports_nothing_of_the_program(name):
    assert "repro_torch" not in top_level_imports(BENCH / name)


def test_whole_names_are_compared(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.api\nfrom repro_torch import api\nimport jaxtyping\n")
    assert not top_level_imports(f) & FORBIDDEN
    f.write_text("from repro.core import auto\n")
    assert top_level_imports(f) & FORBIDDEN == {"repro"}
