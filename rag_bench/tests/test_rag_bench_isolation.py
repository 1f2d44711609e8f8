"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's own name begins with the JAX
package's), and the reference loads nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from rag_bench import spec

_RUN = """
import sys, time
sys.path.insert(0, {root!r})
from rag_bench import run
from rag_bench.tests.conftest import tiny
cell = tiny("trec-covid-171k.course-b256", rows=1500, batch=8, sample=8)
res = run.run_cell(cell, 3, 0.1, False, "cpu", time.perf_counter())
assert res["correct"]
print("loaded:" + ",".join(run.forbidden_modules()))
"""

_REF = """
import sys
sys.path.insert(0, {root!r})
import rag_bench.reference.hybrid, rag_bench.reference.oracle
print("loaded:" + ",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"classmate_rag_tpu_torch", "classmate_rag_tpu",
                        "jax", "jaxlib", "flax"}})))
"""


def _fresh(code):
    proc = subprocess.run([sys.executable, "-c",
                           code.format(root=str(spec.CHECKOUT))],
                          capture_output=True, text=True, timeout=600,
                          cwd=spec.CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1].split("loaded:", 1)[1]


def test_a_run_loads_no_jax():
    assert _fresh(_RUN) == ""


def test_reference_loads_nothing_of_the_program():
    assert _fresh(_REF) == ""


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_name_no_jax():
    bad = {"jax", "jaxlib", "flax", "classmate_rag_tpu"}
    for path in spec.BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & bad, path
        if "reference" in path.parts:
            assert "classmate_rag_tpu_torch" not in tops, path
