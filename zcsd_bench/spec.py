"""What a cell is: its entry in ``BENCHMARK.json`` and the files it names.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json``, a plain reference ``reference/<name>.py`` (named
by the configuration's ``"reference"`` key) and a per-layer metric
``metrics/<metric>.py`` with a ``read(trace)`` function. Adding any of them
is adding a file; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list      # metric entries of BENCHMARK.json this cell reports
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import one file by path (its name may hold ``-`` or ``.``)."""
    spec = importlib.util.spec_from_file_location(f"zcsd_bench._{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = benchmark if benchmark is not None else load_json(REPO / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(
        workload=w,
        config=load_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reference(config: dict) -> ModuleType:
    return load_module(HERE / "reference" / f"{config['reference']}.py")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py").read
