"""The port stands alone: it never imports JAX or the JAX package.

Importing every module of `repro_torch` (`repro_torch.analysis` among
them), `chip_smoke.py`, `calibrate_torch.py` and `serve_ab.py` in a fresh
interpreter
must leave ``jax`` and ``repro`` out of ``sys.modules``, and no source
under ``src/repro_torch/`` may even name them.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import calibrate_torch
import serve_ab
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
missing = {"repro_torch.analysis.diagnostics", "repro_torch.analysis.ir",
           "repro_torch.launch.faults", "repro_torch.core.accel_model",
           "repro_torch.core.calibration", "repro_torch.kernels.plan",
           "repro_torch.analysis.contracts",
           "repro_torch.analysis.intervals", "repro_torch.analysis.lint",
           "repro_torch.utils.roofline", "repro_torch.utils.cost",
           "repro_torch.launch.dryrun", "repro_torch.parallel.compression",
           "repro_torch.parallel.pipeline", "repro_torch.models.cnn"} - \
    set(names)
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 15 else 0)
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_source_names_jax_or_the_reference():
    pattern = re.compile(r"\bjax\b|\bjaxlib\b|\brepro\.")
    offenders = []
    for path in sorted(PORT.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh"):
            for n, line in enumerate(path.read_text().splitlines(), 1):
                if pattern.search(line):
                    offenders.append(f"{path.relative_to(ROOT)}:{n}: {line}")
    for script in ("chip_smoke.py", "calibrate_torch.py", "serve_ab.py"):
        text = (ROOT / script).read_text()
        if re.search(r"^\s*(import|from)\s+(jax|repro)\b", text, re.M):
            offenders.append(f"{script} imports jax or repro")
    assert not offenders, "\n".join(offenders)
