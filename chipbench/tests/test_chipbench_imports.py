"""Nothing the benchmark runs loads JAX or the JAX package (``repro``), by
whole top-level module name, and the plain reference imports nothing of the
program.  The run is a subprocess, so other test files' imports cannot
leak into it."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "chipbench"

SCRIPT = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import chipbench
from chipbench import harness
names = []
for m in pkgutil.walk_packages(chipbench.__path__, "chipbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
        names.append(m.name)
for p in sorted((harness.ROOT / "chipbench" / "metrics").glob("*.py")):
    harness.reader(harness.ROOT, p.stem)
from chipbench.tests import tiny
res = tiny.run("eval.paper16.greedy-262144")
assert res["correct"], res
assert "repro_torch" in sys.modules
print(json.dumps({"imported": names, "forbidden": harness.forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_nothing_loads_jax_or_the_jax_package():
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "chipbench.reference.env" in got["imported"] and "chipbench.drivers.train" in got["imported"]
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").glob("*.py")):
        assert not _imports(p) & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, p.name


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for p in sorted(BENCH.rglob("*.py")):
        assert not _imports(p) & {"repro", "jax", "jaxlib", "flax"}, p
