"""What the benchmark loads: a cell's whole run in a fresh process loads no
module whose top-level name is `jax`, `jaxlib`, `flax` or `medvae_tpu`
(compared whole: the port's `medvae_tpu_torch` begins with the JAX
package's name), and the plain reference imports nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.common import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "medvae_tpu"}

CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests.tiny import tiny_cell
from portbench import run
result, _ = run.execute(tiny_cell({cell!r}), 5, 0.3, False, "cpu")
print(json.dumps({{"correct": result["correct"], "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("cell", ["gan224.train", "flagship224.serve"])
def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    proc = subprocess.run([sys.executable, "-c", CHILD.format(root=str(ROOT), cell=cell)], capture_output=True,
                          text=True, timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] in (True, False)  # a whole run, to its result
    assert "medvae_tpu_torch" in out["modules"]
    assert not FORBIDDEN & set(out["modules"]), FORBIDDEN & set(out["modules"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = set(_imports(path))
    assert "medvae_tpu_torch" not in tops and not FORBIDDEN & tops, tops


def test_no_benchmark_file_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not FORBIDDEN & set(_imports(path)), path
