"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration (``configs``:
its file) and a traffic mix (``traffic/<name>.json``, whose ``kind``
names the generator ``traffic/<kind>.py``).  A metric is reported in a
cell where its ``workloads`` list the cell, or where it has no such list
(a per-layer metric without one goes where its ``moves`` is reported).
A per-layer metric's reader is ``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell", "cell_of", "load_module"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents, with its name
    chips: int
    end_to_end: list        # the manifest's entries reported in this cell
    per_layer: list
    run_seconds: int
    bench_dir: Path


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Path | None = None,
              bench_dir: Path | None = None) -> Cell:
    """The cell ``name`` of the manifest (``BENCHMARK.json`` at the root)
    with its configuration and traffic files read."""
    bench_dir = bench_dir or BENCH_DIR
    manifest = manifest or bench_dir.parent / "BENCHMARK.json"
    m = json.loads(manifest.read_text())
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest.name}; have "
                       f"{sorted(cells)}")
    return cell_of(m, cells[name], bench_dir)


def cell_of(m: dict, w: dict, bench_dir: Path | None = None) -> Cell:
    """The cell of the workload entry ``w`` under the manifest ``m``,
    with its configuration and traffic files read (``w`` need not be one
    of the manifest's own: `sweep` runs a mix that no cell runs yet)."""
    bench_dir = bench_dir or BENCH_DIR
    name = w["name"]
    cfg_entry = next(c for c in m["configs"] if c["name"] == w["config"])
    config = json.loads((bench_dir.parent / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["name"] = w["traffic"]
    e2e = [x for x in m["end_to_end"] if _in_cell(x, name)]
    e2e_names = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"]
                 if (name in x["workloads"] if "workloads" in x
                     else x["moves"] in e2e_names)]
    return Cell(name, config, traffic, w["chips"], e2e, per_layer,
                m["run_seconds"], bench_dir)


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` as a module of its own (a name with dots,
    such as ``dispatch_ms.train``, is not an importable module name)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_file_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
