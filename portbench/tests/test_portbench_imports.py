"""Nothing under portbench/ imports JAX, flax or the JAX package, and the
reference imports nothing of the program; a run refuses modules of
either once loaded."""

import ast
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(ROOT.rglob("*.py"))


def imported_top_levels(path: Path) -> set:
    """The top-level names (before the first dot) of every module the
    file imports, relative imports aside."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_files_found():
    assert len(FILES) > 20
    assert ROOT / "run.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = imported_top_levels(path) & set(harness.FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted((ROOT / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_no_program(path):
    names = imported_top_levels(path)
    assert "awr_tpu_torch" not in names and not names & set(
        harness.FORBIDDEN)


def test_scan_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import awr_tpu_torch.serving\nfrom awr_tpu.ops import x\n"
                 "import jax.numpy as jnp\nimport flaxen\n")
    assert imported_top_levels(f) == {"awr_tpu_torch", "awr_tpu", "jax",
                                      "flaxen"}


def test_foreign_modules():
    loaded = ["torch", "awr_tpu_torch", "awr_tpu_torch.serving", "jaxtyping",
              "flaxen", "numpy"]
    assert harness.foreign_modules(loaded) == []
    assert harness.foreign_modules(loaded + ["jax.numpy", "awr_tpu.ops",
                                             "flax", "jaxlib"]) == [
        "awr_tpu.ops", "flax", "jax.numpy", "jaxlib"]
