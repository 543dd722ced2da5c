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
  reference/<name>.py       the plain reference and its comparison, named
                            by the configuration's ``reference`` (``cnn``
                            where it names none)
  bundles/<maker>.py        writes a bundle drawn from a seed, named by a
                            configuration whose ``bundle`` is
                            ``{"maker": <maker>, "seed": <n>}``

Adding a configuration family, a mix, a driver, a cell or a metric is
adding files: nothing here or in ``run.py`` names one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
BENCHMARK_JSON = os.path.join(ROOT, "BENCHMARK.json")
# seeded bundles, each written once: beside the program's kernel cache
# (``lib/device.KERNEL_CACHE``) under the checkout's git-ignored ``build/``
BUNDLE_CACHE = os.path.join(ROOT, "build", "bundles")


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


def reference_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "reference", name + ".py")


def bundle_maker_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "bundles", name + ".py")


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

    @property
    def reference(self) -> str:
        return self.config.get("reference", "cnn")


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


def reference(name: str) -> ModuleType:
    """The reference ``reference/<name>.py``: a module with ``NUMBERS``,
    the names its comparison gives; ``compare(cell, outcome, device)``,
    which runs the plain reference on ``outcome.frames`` (in blocks of the
    cell's ``reference_block``) and returns those numbers over
    ``outcome.answers``; and ``controls(cell, frames, device)``, which
    returns ``{control: numbers}`` of the lower-precision controls on
    ``frames`` (what ``control.py`` prints)."""
    return _module(reference_path(name), "benchmarks.reference." + name.replace(".", "_"))


def frame_shape(config: dict) -> tuple[int, int, int]:
    """(channels, size, size) of the configuration's frames: its
    ``input`` where it gives one, else one channel at the first layer's
    size. The generator draws square frames only."""
    if "input" in config:
        shape = config["input"]
    else:
        size = config["layer_configs"][0][2]
        shape = (1, size, size)
    c, h, w = (int(v) for v in shape)
    if h != w:
        raise ValueError(f"input {config['input']}: frames are square")
    return c, h, w


def bundle_dir(config: dict) -> str:
    """The directory of the configuration's bundle, which the program and
    the reference both read. A string ``bundle`` is a directory of the
    tree (relative to the checkout's root, or absolute). A seeded one,
    ``{"maker": <name>, "seed": <n>}``, lies in ``BUNDLE_CACHE`` under a
    name of the configuration's name, the seed and a digest of the
    maker's file (``bundles/<name>.py``) and the configuration; set-up
    writes it there (``make_bundle``)."""
    bundle = config["bundle"]
    if isinstance(bundle, str):
        return bundle if os.path.isabs(bundle) else os.path.join(ROOT, bundle)
    digest = hashlib.sha256()
    with open(bundle_maker_path(bundle["maker"]), "rb") as f:
        digest.update(f.read())
    digest.update(json.dumps(config, sort_keys=True).encode())
    return os.path.join(BUNDLE_CACHE, f"{config['name']}-{int(bundle['seed'])}-"
                                      f"{digest.hexdigest()[:16]}")


def make_bundle(config: dict) -> None:
    """Writes a seeded bundle where ``bundle_dir`` finds none: ``make(config,
    seed, path)`` of the maker's file as it is now, into a directory that
    an atomic rename puts in place, so that no run finds half a bundle.
    A string ``bundle`` is there already."""
    bundle, path = config["bundle"], bundle_dir(config)
    if isinstance(bundle, str) or os.path.isdir(path):
        return
    os.makedirs(BUNDLE_CACHE, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".", dir=BUNDLE_CACHE)
    name = "benchmarks.bundles." + bundle["maker"].replace(".", "_")
    sys.modules.pop(name, None)  # the maker as its file is now
    try:
        _module(bundle_maker_path(bundle["maker"]), name).make(
            config, int(bundle["seed"]), tmp)
        os.rename(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"setup: wrote the bundle {path}", file=sys.stderr, flush=True)
