"""A configuration family brought as new files only: its own reference and
comparison (``reference/<name>.py``), its frame shape (``input``) and a
bundle drawn from a seed (``bundles/<maker>.py``), run through
``run.run_cell`` and the offline driver as they are. Also: the generator's
one-channel draw as it was, and the CAM comparison's numbers as the
harness computed them before it took the comparison from the
configuration's reference module."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from benchmarks import run
from benchmarks.lib import program, spec, traffic
from benchmarks.reference.cnn import Reference, compare
from benchmarks.tests.tiny import offline_in_rounds, tiny_cell, tiny_config

CPU = torch.device("cpu")
SEED = 2**31 + 99

# A toy family: 3-channel frames; the program answers each frame's channel
# sums and their product with a seeded weight vector from its bundle.
TOY_CONFIG = {"name": "rgb-toy", "input": [3, 8, 8], "reference": "toy",
              "bundle": {"maker": "toy", "seed": 5}}
TOY_MAKER = """
import os

import numpy as np


def make(config, seed, path):
    w = np.random.default_rng(seed).standard_normal(config["input"][0])
    np.save(os.path.join(path, "w.npy"), w)
"""
TOY_REFERENCE = """
import os

import numpy as np
import torch

from benchmarks.lib import spec

NUMBERS = ("sum_miss", "score_err", "lost")
OFF = {off}  # added to the weights: a reference that disagrees


def _reference(config, frames):
    frames = frames.cpu().numpy() if torch.is_tensor(frames) else frames
    sums = frames.astype(np.int64).sum(axis=(2, 3))
    w = np.load(os.path.join(spec.bundle_dir(config), "w.npy")) + OFF
    return sums, sums.astype(np.float64) @ w


def compare(cell, outcome, device):
    {imports}
    sums, score = _reference(cell.config, outcome.frames)
    frame = outcome.answers.frame
    got_sums, got_score = outcome.answers.outputs
    return {{"sum_miss": float((got_sums != sums[frame]).any(axis=1).mean()),
            "score_err": float(np.abs(got_score - score[frame]).max()),
            "lost": float(outcome.lost)}}


def controls(cell, frames, device):
    sums, score = _reference(cell.config, frames)
    low = score.astype(np.float16).astype(np.float64)
    return {{"fp16": {{"sum_miss": 0.0, "score_err": float(np.abs(low - score).max()),
                     "lost": 0.0}}}}
"""
TOY_LIMITS = {"sum_miss": 0.0, "score_err": 1e-9, "lost": 0}


class ToyEngine:
    """The program's stand-in for the toy family: it reads the same
    bundle directory the reference reads."""

    def __init__(self, config):
        self.w = torch.from_numpy(np.load(os.path.join(spec.bundle_dir(config), "w.npy")))

    def detect_device(self, x):
        sums = x.to(torch.int64).sum(dim=(2, 3))
        return None, None, sums, sums.to(torch.float64) @ self.w


def _keep_modules(monkeypatch, names) -> None:
    """After the test, each module of ``names`` as it was in
    ``sys.modules`` before it, or none: a moved benchmark directory's
    modules load under the same names from other files."""
    for name in names:
        monkeypatch.setitem(sys.modules, name, sys.modules.get(name))
        if sys.modules[name] is None:
            del sys.modules[name]


def _bench_dir(tmp_path, monkeypatch) -> str:
    """A benchmark directory holding a copy of every file of this one and
    an empty ``bundles/``, with ``spec`` pointed at it and the seeded
    bundles written under ``tmp_path``."""
    bench = tmp_path / "bench"
    names = ["benchmarks.bundles.toy", "benchmarks.bundles.tiny", "jax",
             *(f"benchmarks.reference.{r}" for r in ("toy", "toy-off", "toy-jax"))]
    for sub in ("configs", "traffic", "workloads", "drivers", "metrics", "reference"):
        (bench / sub).mkdir(parents=True)
        for f in os.listdir(os.path.join(spec.BENCH_DIR, sub)):
            if f.endswith((".json", ".py")):
                shutil.copy(os.path.join(spec.BENCH_DIR, sub, f), bench / sub / f)
            if f.endswith(".py"):
                names.append(f"benchmarks.{sub}.{f[:-3].replace('.', '_')}")
    (bench / "bundles").mkdir()
    _keep_modules(monkeypatch, names)
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench))
    monkeypatch.setattr(spec, "BUNDLE_CACHE", str(tmp_path / "build" / "bundles"))
    return str(bench)


def _toy(tmp_path, monkeypatch, reference="toy", limits=TOY_LIMITS) -> spec.Cell:
    """The toy family's files added to the benchmark; its offline cell."""
    bench = _bench_dir(tmp_path, monkeypatch)
    with open(os.path.join(bench, "configs", "rgb-toy.json"), "w") as f:
        json.dump({**TOY_CONFIG, "reference": reference}, f)
    for name, off, imports in (("toy", 0.0, ""), ("toy-off", 1.0, ""),
                               ("toy-jax", 0.0, "import jax  # noqa: F401")):
        with open(os.path.join(bench, "reference", name + ".py"), "w") as f:
            f.write(TOY_REFERENCE.format(off=off, imports=imports))
    with open(os.path.join(bench, "bundles", "toy.py"), "w") as f:
        f.write(TOY_MAKER)
    with open(os.path.join(bench, "workloads", "rgb-toy.offline.json"), "w") as f:
        json.dump({"config": "rgb-toy", "traffic": "offline",
                   "params": {"batch": 4, "shipped_per_pool": 0,
                              "reference_block": 4, "trace_seconds": 0.1},
                   "limits": limits}, f)
    monkeypatch.setattr(program, "make_engine", lambda config, dev: (ToyEngine(config), None))
    cell = spec.cell("rgb-toy.offline")
    offline_in_rounds(monkeypatch, cell)
    return cell


@pytest.mark.parametrize("reference,correct", [("toy", True), ("toy-off", False)])
def test_a_family_brings_its_own_reference(tmp_path, monkeypatch, reference, correct):
    """The module the configuration names decides ``correct``: the toy
    reference passes the toy program, and one that disagrees fails it
    (the CAM comparison could not even read the toy's two outputs)."""
    cell = _toy(tmp_path, monkeypatch, reference)
    assert spec.frame_shape(cell.config) == (3, 8, 8)
    frames = spec.driver(cell.driver).frames_of(cell, SEED)
    assert frames.shape == (2 * 4, 3, 8, 8) and frames.dtype == np.uint8
    res = run.run_cell(cell, SEED, 0.2, False, CPU)
    assert res["correct"] is correct, res["checks"]
    assert list(res["checks"]) == ["sum_miss", "score_err", "lost"]
    assert res["attempted"] >= 10 * 4 and list(res["metrics"]) == ["setup_s"]
    if not correct:
        assert res["checks"]["score_err"]["value"] > 1e-9
    found = run.spec.reference(cell.reference).controls(cell, frames, CPU)
    assert set(found) == {"fp16"} and found["fp16"]["score_err"] > 1e-9


def test_a_reference_that_loads_jax_gives_no_result(tmp_path, monkeypatch):
    """What the configuration's reference module loads, here a module named
    ``jax`` (a stub) that its ``compare`` imports, is in ``sys.modules``
    when the run looks for forbidden modules: the run gives no result."""
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    cell = _toy(tmp_path, monkeypatch, "toy-jax")
    assert "jax" not in sys.modules
    assert run.run_cell(cell, SEED, 0.1, False, CPU) == {"forbidden": ["jax"]}


@pytest.mark.parametrize("limits,unpaired", [
    ({**TOY_LIMITS, "ghost": 1.0}, ("ghost", "value")),
    ({k: v for k, v in TOY_LIMITS.items() if k != "score_err"}, ("score_err", "limit")),
], ids=["limit without a number", "number without a limit"])
def test_numbers_and_limits_pair(tmp_path, monkeypatch, limits, unpaired):
    res = run.run_cell(_toy(tmp_path, monkeypatch, limits=limits), SEED, 0.2, False, CPU)
    assert not res["correct"], res["checks"]
    name, missing = unpaired
    assert res["checks"][name][missing] is None
    others = {k: c for k, c in res["checks"].items() if k != name}
    assert all(c["value"] <= c["limit"] for c in others.values()), others


def test_a_seeded_bundle_is_written_once(tmp_path, monkeypatch, capsys):
    """Written by the first run, found by the second, written anew when
    the maker's file changes; never a half-written directory left."""
    cell = _toy(tmp_path, monkeypatch)

    def run_once():
        res = run.run_cell(cell, SEED, 0.1, False, CPU)
        assert res["correct"], res["checks"]
        return capsys.readouterr().err.count("setup: wrote the bundle"), sorted(
            os.listdir(spec.BUNDLE_CACHE))

    wrote, dirs = run_once()
    assert wrote == 1 and len(dirs) == 1 and dirs[0].startswith("rgb-toy-5-")
    assert os.listdir(os.path.join(spec.BUNDLE_CACHE, dirs[0])) == ["w.npy"]
    assert run_once() == (0, dirs)
    with open(spec.bundle_maker_path("toy"), "a") as f:
        f.write("# another maker\n")
    wrote, again = run_once()
    assert wrote == 1 and len(again) == 2 and dirs[0] in again


def test_the_program_reads_a_seeded_bundle(tmp_path, monkeypatch):
    """The CNN family itself from a seeded bundle: the program
    (``program.load_model``) and the plain reference read the same
    directory, and the run is correct."""
    cell = tiny_cell(tmp_path, "lyr3-std.offline", batch=4, shipped_per_pool=1,
                     reference_block=4, trace_seconds=0.1)
    bench = _bench_dir(tmp_path, monkeypatch)
    with open(os.path.join(bench, "bundles", "tiny.py"), "w") as f:
        f.write("from benchmarks.tests.tiny import write_bundle\n\n\n"
                "def make(config, seed, path):\n    write_bundle(path, seed)\n")
    cell.config = {**cell.config, "bundle": {"maker": "tiny", "seed": 0}}
    offline_in_rounds(monkeypatch, cell)
    res = run.run_cell(cell, SEED, 0.2, False, CPU)
    assert res["correct"], res["checks"]
    d = spec.bundle_dir(cell.config)
    assert os.path.dirname(d) == spec.BUNDLE_CACHE
    model = program.load_model(cell.config)
    want = tiny_config(tmp_path / "dir")  # the same draw, as a directory bundle
    assert np.array_equal(np.asarray(model.fc_weight),
                          np.load(os.path.join(want["bundle"], "fc_weight.npy")))


# sha256 of the draws, recorded with the generator of the parent commit
PARENT_DRAWS = {
    (2**31 + 5, "pools", 3, 16): "8f0898597e9e4ccc8f461c3a849937275aed5cc44eaf1f174c5533b226f99fde",
    (7, "camera", 2, 32): "363005d6f32f3560599d8969b68d1b3da0a4b7736a6a49df1bf5a8a05a6cf1ef",
}


@pytest.mark.parametrize("draw", sorted(PARENT_DRAWS), ids=str)
def test_one_channel_frames_are_drawn_as_before(draw):
    frames = traffic.frames(*draw, channels=1)
    assert frames.shape == (draw[2], draw[3], draw[3])
    assert hashlib.sha256(frames.tobytes()).hexdigest() == PARENT_DRAWS[draw]
    assert np.array_equal(frames, traffic.frames(*draw))


def test_frames_of_three_channels():
    frames = traffic.frames(SEED, "pools", 4, 16, channels=3)
    assert frames.shape == (4, 3, 16, 16) and frames.dtype == np.uint8
    assert np.array_equal(frames, traffic.frames(SEED, "pools", 4, 16, channels=3))
    with pytest.raises(ValueError, match="gray"):
        traffic.with_shipped(frames, SEED, "pools", "unused", 1)
    assert traffic.with_shipped(frames, SEED, "pools", "unused", 0) is frames


def _old_numbers(ref_probs, ref_boxes, frame, pred, conf, probs, bbox, lost=0):
    """The harness's comparison before it moved into ``reference/cnn.py``,
    as it was."""
    frame = np.asarray(frame, np.int64)
    pred = np.asarray(pred, np.int64)
    n, k = len(frame), ref_probs.shape[1]
    if n == 0:
        return {"pred_gap": 0.0, "prob_err": 0.0, "box_miss": 0.0,
                "lost": float(lost)}
    valid = (pred >= 0) & (pred < k)
    safe = np.where(valid, pred, 0)
    rp = ref_probs[frame]
    picked = rp[np.arange(n), safe]
    gap = np.where(valid, rp.max(axis=1) - picked, 1.0)
    err = np.maximum(np.abs(np.asarray(probs, np.float64) - rp).max(axis=1),
                     np.abs(np.asarray(conf, np.float64) - picked))
    err = np.where(valid, err, 1.0)
    want_box = ref_boxes[frame, safe]
    miss = ~valid | (np.asarray(bbox, np.int64) != want_box).any(axis=1)
    return {"pred_gap": float(np.nan_to_num(gap, nan=1.0).max()),
            "prob_err": float(np.nan_to_num(err, nan=1.0).max()),
            "box_miss": float(miss.mean()),
            "lost": float(lost)}


TINY = {"offline": ("lyr3-std.offline", {"batch": 8, "shipped_per_pool": 2,
                                         "reference_block": 8}),
        "camera": ("lyr3-std.camera", {"pool": 16, "warm_frames": 2,
                                       "reference_block": 8})}


@pytest.mark.parametrize("altered", [False, True], ids=["as run", "altered"])
@pytest.mark.parametrize("kind", sorted(TINY))
def test_cam_compare_gives_the_old_numbers(tmp_path, monkeypatch, kind, altered):
    name, params = TINY[kind]
    cell = tiny_cell(tmp_path, name, **params)
    if kind == "offline":
        offline_in_rounds(monkeypatch, cell)
    outcome = spec.driver(cell.driver).run(cell, SEED, 0.3, False, CPU)
    pred, conf, probs, bbox = (np.array(o) for o in outcome.answers.outputs)
    if altered:  # numbers that are not all 0: a class, a box and a probability
        pred[0] = (pred[0] + 1) % probs.shape[1]  # moved (a loaded CPU's camera
        bbox[-1] += 1  # window may answer a single frame)
        probs[-1] *= 0.5
        outcome.answers.outputs = (pred, conf, probs, bbox)
        outcome.lost = 3
    frames = outcome.frames
    frames = torch.from_numpy(frames) if isinstance(frames, np.ndarray) else frames
    ref_probs, ref_boxes = Reference(cell.config, CPU).detect(frames, 8)
    old = _old_numbers(ref_probs, ref_boxes, outcome.answers.frame, pred, conf,
                       probs, bbox, lost=outcome.lost)
    assert compare(cell, outcome, CPU) == old
    assert all(v > 0 for v in old.values()) == altered
