"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``cotengra_tpu_torch`` is not
``cotengra_tpu``), and the reference, the generators and the checks
import nothing of the program."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "cotengra_tpu"}
INDEPENDENT = ("reference", "networks", "checks")


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted((ROOT / "tnbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path",
    [p for p in SOURCES if p.parent.name in INDEPENDENT],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_reference_side_imports_no_program(path):
    assert "cotengra_tpu_torch" not in _imports(path)


def test_whole_name_comparison():
    from tnbench.harness import forbidden_loaded

    assert "cotengra_tpu_torch" not in forbidden_loaded()


def test_a_tiny_run_loads_no_jax(tiny_root):
    """A whole run of each tiny cell on the CPU in a fresh process that
    refuses JAX and the JAX package: nothing loads them."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {sorted(FORBIDDEN)!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
from tnbench import harness
for cell in ("m20-slices", "lattice-values", "m20-slice-tasks"):
    res = harness.run_cell({str(tiny_root)!r}, cell, 7, 0.2, False, "cpu")
    assert res["correct"], res
assert not harness.forbidden_loaded(), harness.forbidden_loaded()
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-3000:]
