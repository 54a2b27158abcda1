"""A cell of ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix. The configuration's file
is found through the ``configs`` entry of ``BENCHMARK.json`` (or of a
``pending/<cell>.json``: a cell measured and kept out of the benchmark,
whose entries a later change moves into it); the mix is
``traffic/<mix>.json``, whose ``driver`` key names the module of
``drivers/`` that runs it; the limits of the correctness check are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def catalog(root: str = ROOT) -> Dict[str, Any]:
    """``BENCHMARK.json`` with the entries of every ``pending/*.json``."""
    out = benchmark(root)
    folder = os.path.join(HERE, "pending")
    for name in sorted(os.listdir(folder)):
        extra = load_json(os.path.join(folder, name))
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            out[key] = out[key] + extra[key]
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]        # the configuration's file, as it is run
    traffic: Dict[str, Any]       # traffic/<mix>.json
    limits: Dict[str, float]      # limits/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = catalog(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json or pending/; "
                       f"there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits={k: float(v["limit"]) for k, v in limits["numbers"].items()},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from
    what the run recorded, or None where it finds nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def per_layer_values(cell: Cell, run) -> Dict[str, Optional[float]]:
    """Every per-layer metric of the cell that its reader finds, by name."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
