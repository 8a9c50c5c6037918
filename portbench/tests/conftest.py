"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
from the repo root.  CPU tests run the harness at reduced sizes; tests
marked ``gpu`` need a card and skip without one (decided in the `card`
fixture)."""
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture
def reduced_copy(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and portbench/) whose
    configurations are cut to 32 px and 4-image waves and whose traffic
    draws from 8 images at 40 arrivals a second, for CPU runs."""
    import json
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for f in (root / "portbench" / "configs").glob("*.json"):
        d = json.loads(f.read_text())
        d.update(image_size=32, num_classes=16 if "vgg" in f.name else 200,
                 width=4)
        f.write_text(json.dumps(d))
    for f in (root / "portbench" / "traffic").glob("*.json"):
        d = json.loads(f.read_text())
        d["pool"] = 8
        if "rate_per_s" in d:
            d["rate_per_s"] = 40
        f.write_text(json.dumps(d))
    return root


def add_cell(root, name: str, config: str, traffic: str,
             metrics: tuple = ()) -> None:
    """Add the cell ``name`` to the manifest of the copy at ``root``,
    reporting the harness's end-to-end ``metrics`` (each an entry of its
    own, unit ms) besides ``setup_s``."""
    import json
    path = root / "BENCHMARK.json"
    m = json.loads(path.read_text())
    m["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": 1,
                           "why": "a cell of the test only"})
    for metric in metrics:
        m["end_to_end"].append({"name": metric, "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": [name]})
    path.write_text(json.dumps(m))


def load_run():
    """portbench/run.py as a module."""
    from portbench.harness.manifest import load_module
    return load_module(BENCH / "run.py")
