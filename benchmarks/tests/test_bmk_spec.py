"""Every file ``BENCHMARK.json`` names is found by its name and parses, and
the file keeps to the benchmark's contract."""

from __future__ import annotations

import json
import os
import re

import pytest
import torch

from benchmarks.lib import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert os.path.getsize(spec.BENCHMARK_JSON) <= 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"]] + METRICS)
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_end_to_end_bounds():
    """The accepted metrics are all there, and every metric, those that
    later cells bring too, keeps to the contract's bounds."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) >= {"detect_fps", "detect_fps.wide", "frame_p95_ms", "setup_s"}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = spec.cell(cell)
    assert c.entry["chips"] == 1
    assert c.config["name"] == c.entry["config"]
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], "moves a metric the cell lacks")
    assert set(c.limits) == set(spec.reference(c.reference).NUMBERS)
    own = spec.load_json(spec.workload_path(cell))
    assert (own["config"], own["traffic"]) == (c.entry["config"], c.entry["traffic"])
    drv = spec.driver(c.driver)
    assert callable(drv.run) and callable(drv.frames_of)
    assert "reference_block" in c.params


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = os.path.join(spec.ROOT, config["file"])
    assert config["file"].startswith("benchmarks/")
    with open(path) as f:
        body = json.load(f)
    assert body["name"] == config["name"]
    assert config["reduced"] == []
    assert body["source"] == config["source"]
    bundle = body["bundle"]
    if isinstance(bundle, str):  # a directory of the tree; else drawn from a seed
        assert os.path.exists(os.path.join(spec.ROOT, bundle, "weights.bin"))
    else:
        assert set(bundle) == {"maker", "seed"}
        assert os.path.exists(spec.bundle_maker_path(bundle["maker"]))
    assert os.path.exists(spec.reference_path(body.get("reference", "cnn")))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    r = spec.reader(metric)
    assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert r.read({}) is None, "a reader with nothing to read returns None"


@pytest.mark.parametrize("mix", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_traffic_file_is_data(mix):
    with open(spec.traffic_path(mix)) as f:
        params = json.load(f)
    assert "driver" in params and "trace_seconds" in params


def test_added_files_are_found_without_edits(tmp_path, monkeypatch):
    """A new configuration, mix, cell and metric are files; the loader
    finds them by the names a BENCHMARK.json gives."""
    for sub in ("configs", "traffic", "workloads", "metrics", "drivers"):
        (tmp_path / sub).mkdir()
    base = spec.cell("lyr3-std.offline")
    (tmp_path / "configs" / "new-net.json").write_text(json.dumps(base.config))
    (tmp_path / "traffic" / "new-mix.json").write_text(
        json.dumps({**base.params, "batch": 8}))
    (tmp_path / "workloads" / "new-net.new-mix.json").write_text(
        json.dumps({"params": {"n_pools": 2}, "limits": base.limits}))
    (tmp_path / "metrics" / "new.metric.py").write_text(
        "LAYER = 'x'\nUNIT = 'ms'\nSOURCE = 'host_clock'\nMOVES = 'setup_s'\n"
        "def read(ctx):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new-net.new-mix", "config": "new-net",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new.metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "x",
                               "moves": "setup_s", "workloads": ["new-net.new-mix"]})
    monkeypatch.setattr(spec, "BENCH_DIR", str(tmp_path))
    c = spec.cell("new-net.new-mix", bench)
    assert c.params["batch"] == 8 and c.params["n_pools"] == 2
    assert [m["name"] for m in c.per_layer] == ["new.metric"]
    assert spec.reader("new.metric").read({}) == 1.0


ECHO_DRIVER = """
import numpy as np
import torch

from benchmarks.lib import traffic
from benchmarks.lib.outcome import Answers, Outcome
from benchmarks.reference.cnn import Reference, control_answers


def frames_of(cell, seed):
    return traffic.frames(seed, "echo", int(cell.params["n"]), cell.config["img_size"])


def run(cell, seed, seconds, trace, dev):
    frames = frames_of(cell, seed)
    probs, boxes = Reference(cell.config, dev).detect(
        torch.from_numpy(frames), len(frames))
    answers = control_answers(probs, boxes)
    return Outcome(measured={m["name"]: 1.0 for m in cell.end_to_end},
                   attempted=len(frames), failed=0, frames=frames,
                   answers=Answers(np.arange(len(frames)), answers),
                   lost=0, kind="cpu", count=1, memory_peak_bytes=0, ctx={},
                   trace=None)
"""


def test_an_added_driver_runs_a_cell_without_edits(tmp_path, monkeypatch):
    """A new kind of run is a module under ``drivers/`` that its mix names:
    the run and the controls find it by that name alone. (The moved
    directory's configuration names its reference, a module that takes
    the CAM comparison's own.)"""
    from benchmarks import control, run
    from benchmarks.reference import cnn
    from benchmarks.tests.tiny import tiny_config

    for sub in ("configs", "traffic", "workloads", "drivers", "reference"):
        (tmp_path / sub).mkdir()
    (tmp_path / "reference" / "cam.py").write_text(
        "from benchmarks.reference.cnn import NUMBERS, compare, controls\n")
    config = {**tiny_config(tmp_path), "reference": "cam"}
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(config))
    (tmp_path / "traffic" / "echo.json").write_text(
        json.dumps({"driver": "echo-loop", "n": 3, "reference_block": 3}))
    (tmp_path / "drivers" / "echo-loop.py").write_text(ECHO_DRIVER)
    limits = spec.cell("lyr3-std.offline").limits
    (tmp_path / "workloads" / "tiny.echo.json").write_text(
        json.dumps({"config": "tiny", "traffic": "echo", "limits": limits}))
    monkeypatch.setattr(spec, "BENCH_DIR", str(tmp_path))
    c = spec.cell("tiny.echo")
    res = run.run_cell(c, 2**40 + 1, 0.1, False, torch.device("cpu"))
    assert res["correct"] and res["attempted"] == 3, res["checks"]
    assert set(res["metrics"]) == {"setup_s"}
    assert set(control.readings(c, 5, torch.device("cpu"))) == set(cnn.CONTROLS)
