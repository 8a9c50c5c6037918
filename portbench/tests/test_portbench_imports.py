"""Nothing the harness runs has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` is the program),
and the reference loads nothing of the program."""
import ast
import subprocess
import sys

from portbench.tests.conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for f in BENCH.rglob("*.py"):
        assert not set(_imports(f)) & FORBIDDEN, f


def test_reference_and_frozen_import_nothing_of_the_program():
    for d in ("reference", "_frozen"):
        for f in (BENCH / d).glob("*.py"):
            assert "repro_torch" not in set(_imports(f)), f


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{ROOT}/src",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_a_run_loads_no_forbidden_module(reduced_copy):
    code = f"""
import sys, torch
torch.set_num_threads(1)
from portbench.harness.manifest import load_cell, load_module
from pathlib import Path
run = load_module(Path("{BENCH}") / "run.py")
cell = load_cell("vgg16.offline", bench_dir=Path("{reduced_copy}") / "portbench")
run.run(cell, 3, 0.5, False, "cpu")
for m in cell.per_layer:
    load_module(Path("{BENCH}") / "metrics" / (m["name"] + ".py"))
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    tops = _loaded(code)
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_no_program_module():
    code = """
import sys
import portbench.reference.vgg16, portbench.reference.resnet50
import portbench.harness.check
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""
    tops = _loaded(code)
    assert "repro_torch" not in tops and not tops & FORBIDDEN
