"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Modules are compared by their
whole top-level name: ``moco_flow_tpu_torch`` starts with
``moco_flow_tpu``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "moco_flow_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_reference_sources_import_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert "moco_flow_tpu_torch" not in tops, f
        assert "benchmark" not in tops, f


def _fresh(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter from the repository's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _fresh("import benchmark.reference")
    assert not tops & (FORBIDDEN | {"moco_flow_tpu_torch"})


def test_cpu_dry_run_loads_no_jax():
    """Both cells through the harness on the CPU at small sizes, with and
    without the trace; the harness's own check finds nothing either."""
    tops = _fresh(
        "from benchmark import cells, run\n"
        "from benchmark.tests.small import SMALL, CELLS, SEED\n"
        "m = cells.load_manifest()\n"
        "for c in CELLS:\n"
        "    for t in (False, True):\n"
        "        r = run.run_cell(m, c, SEED, 0.0, t, device='cpu',"
        " override=SMALL)\n"
        "        assert r['correct'], r\n"
        "assert not run.forbidden_modules()\n")
    assert "moco_flow_tpu_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN
