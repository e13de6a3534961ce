"""Find a cell's parts by name: BENCHMARK.json names each cell's
configuration and traffic; the configuration's file is the one it lists,
the traffic is ``portbench/traffic/<traffic>.json``, which names its kind,
the code that drives that kind of request, ``portbench/kinds/<kind>.py``;
each per-layer metric's reader is ``portbench/metrics/<metric>.py``. A new
configuration, mix, kind of traffic or metric is a new file and a new
entry, never an edit."""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)      # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(workload, root, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


@functools.lru_cache(maxsize=None)
def _module(folder: str, name: str, root: Path):
    """``portbench/<folder>/<name>.py``, loaded once."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(root)}")
    modname = f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
    return _module("metrics", metric, Path(root)).read


def kind(traffic: dict, root: Path = ROOT):
    """The ``Mix`` class of ``portbench/kinds/<kind>.py``, the kind that
    the traffic file names."""
    return _module("kinds", traffic["kind"], Path(root)).Mix
