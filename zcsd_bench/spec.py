"""What a cell is: its entry in ``BENCHMARK.json`` and the files it names.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json``, a kind ``kinds/<kind>.py`` (named by the
configuration's ``"kind"`` key), a plain reference ``reference/<name>.py``
(named by its ``"reference"`` key) and a per-layer metric
``metrics/<metric>.py`` with a ``read(trace)`` function. Adding any of them
is adding a file; nothing here changes.

A kind file is what the harness knows of one kind of deployment, as plain
module functions:

- ``make_data(config, seed, device)``: the deployment's data, from ``seed``;
- ``Deployment(config, data, device)``: the port built from the
  configuration and given the data: ``run(command)`` is one client call,
  ``(answer, the port's stats for it)`` (``stats.cache_misses``, where
  there, counts the programs the port built for it); ``launches()`` sums
  the port's launch counters of the configuration's kernel; ``close()``
  releases the port;
- ``commands(config, traffic, seed)``: one client's endless command stream,
  the same for the same seed (the harness draws it again after the window
  for the check), and ``warmup(config, traffic)``: the commands that warm
  every shape the mix uses. A command carries ``nbytes``, the bytes it
  reads;
- ``ROOT_SPAN``: the port's span around one command, whose ``cmd`` tag
  groups the command's spans;
- ``LAYER_METRICS``: the per-layer metrics listed for some cells
  (``"workloads"``) that every cell of the kind reports, listed or not, so
  a new cell of the kind is one entry of ``BENCHMARK.json``;
- ``cut_for_tests(config, traffic)``: the configuration and mix cut to a
  CPU test's size, so that the reference's control meets answers it gets
  wrong there;
- ``FAULTS``: ``{name: (plant, must)}``: a context manager that plants the
  fault in the timed path, and ``must(result, config, traffic)``, what it
  does to a run's checks besides making ``correct`` false.

A reference file gives ``answers(data, config, commands, control=False)``,
its answer to each command (``control``: one step below the configuration's
precision); ``check(records, answers)``, the numbers ``correct`` is decided
on, ``{name: (value, limit)}``, and how many answers are wrong; and
``work(config, command)``, a command's ``(bytes, operations)`` for the
roofline (``bound.py``).
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


def _applies(metric: dict, cell: str, kind_metrics=()) -> bool:
    """Unlisted, listed for ``cell``, or one of its kind's metrics."""
    return cell in metric.get("workloads", [cell]) or metric["name"] in kind_metrics


def cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = benchmark if benchmark is not None else load_json(REPO / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    own = getattr(kind(config), "LAYER_METRICS", ())
    return Cell(
        workload=w,
        config=config,
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name, own)])


def kind(config: dict) -> ModuleType:
    return load_module(HERE / "kinds" / f"{config['kind']}.py")


def reference(config: dict) -> ModuleType:
    return load_module(HERE / "reference" / f"{config['reference']}.py")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py").read
