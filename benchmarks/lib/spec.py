"""Everything a cell needs, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and the metrics;
each cell's pieces are files found by the names it gives:

  configs/<config>.json     the model configuration (sizes, bundle, shifts)
  traffic/<traffic>.json    the traffic mix's parameters, for lib/traffic.py,
                            with the name of the driver that runs it
  drivers/<driver>.py       a kind of run (the offline job, the camera
                            loop): ``run`` and ``frames_of``
  workloads/<cell>.json     the cell's own parameters (over the mix's) and
                            the limits of the comparison that decides
                            ``correct``
  metrics/<metric>.py       one reader per per-layer metric

Adding a configuration, a mix, a driver, a cell or a metric is adding
files: nothing here or in ``run.py`` names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
BENCHMARK_JSON = os.path.join(ROOT, "BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: str = BENCHMARK_JSON) -> dict:
    return load_json(path)


def config_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "configs", name + ".json")


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", name + ".json")


def workload_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "workloads", name + ".json")


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", name + ".py")


def driver_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "drivers", name + ".py")


@dataclasses.dataclass
class Cell:
    """One cell: its entry in ``BENCHMARK.json``, its configuration, and its
    traffic parameters (the mix's, with the cell file's over them)."""

    name: str
    entry: dict
    config: dict
    params: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def driver(self) -> str:
        return self.params["driver"]


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists; without the key, an end-to-end metric is every cell's, and a
    per-layer metric is every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return reports(moved, cell, bench)
    return True


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name``: its entry in ``BENCHMARK.json``, or, for a cell
    file that ``BENCHMARK.json`` does not list (yet), one chip and the
    configuration and traffic its own file names."""
    bench = bench if bench is not None else benchmark()
    own = load_json(workload_path(name))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        entry = {"name": name, "config": own["config"],
                 "traffic": own["traffic"], "chips": 1}
    params = dict(load_json(traffic_path(entry["traffic"])))
    params.update(own.get("params", {}))
    return Cell(name=name, entry=entry,
                config=load_json(config_path(entry["config"])),
                params=params, limits=own["limits"],
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name, bench)],
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, name, bench)])


def _module(path: str, name: str) -> ModuleType:
    """The module at ``path``, loaded once under ``name``."""
    loaded = sys.modules.get(name)
    if loaded is not None and getattr(loaded, "__file__", None) == path:
        return loaded
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reader(name: str) -> ModuleType:
    """The per-layer metric's reader, ``metrics/<name>.py``: a module with
    ``LAYER``, ``UNIT``, ``SOURCE``, ``MOVES`` and ``read(ctx)``, which
    returns the metric's value or None where the run has nothing to read."""
    return _module(metric_path(name), "benchmarks.metrics." + name.replace(".", "_"))


def driver(name: str) -> ModuleType:
    """The driver ``drivers/<name>.py``: a module with ``run(cell, seed,
    seconds, trace, device)``, which makes one run and returns its
    ``lib.outcome.Outcome``, and ``frames_of(cell, seed)``, the distinct
    frames a run of ``seed`` hands the program (what the controls of
    ``control.py`` answer)."""
    return _module(driver_path(name), "benchmarks.drivers." + name.replace(".", "_"))
