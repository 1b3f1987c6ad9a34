"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level names compared whole:
the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

from portbench import run

MODULES = sorted(run.BENCH_DIR.rglob("*.py"))
PORT = "pinn_depthestimation_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(run.BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & run.FORBIDDEN


@pytest.mark.parametrize("path", sorted((run.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PORT not in names and "portbench" not in names
    assert names <= {"__future__", "math", "numpy", "torch"}


def test_the_check_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import pinn_depthestimation_tpu_torch.ops\nfrom jax import numpy\n"
                     "import importlib\nimportlib.import_module('flax.linen')\n")
    assert top_level_imports(probe) & run.FORBIDDEN == {"jax", "flax"}
    probe.write_text("from pinn_depthestimation_tpu.ops import kernels\n")
    assert top_level_imports(probe) & run.FORBIDDEN == {"pinn_depthestimation_tpu"}
