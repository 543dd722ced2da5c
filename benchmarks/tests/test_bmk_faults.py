"""Whole runs of each kind of cell on the CPU at a tiny size, past the
harness's look for a card: a sound run comes out correct, and a run whose
timed path is broken underneath comes out not correct, for each fault the
cells can have: an answer altered where it is produced; half of the batch
left out; a step that hands back its last state unchanged. The offline
job's window is sized in rounds (``tiny.offline_in_rounds``), so that
every run compares answers of every pool, however loaded the CPU."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmarks import run
from benchmarks.tests.tiny import offline_in_rounds, tiny_cell
from tpu_cnn_torch.engine.cuda import CUDAEngine

CPU = torch.device("cpu")
CELLS = {
    "offline": ("lyr3-std.offline", {"batch": 8, "shipped_per_pool": 2,
                                     "reference_block": 8, "trace_seconds": 0.2}),
    "camera": ("lyr3-std.camera", {"pool": 16, "warm_frames": 2,
                                   "reference_block": 8, "trace_seconds": 0.2}),
}


def altered(out):
    pred = out[2].clone()
    pred[0] = (pred[0] + 1) % out[4].shape[1]
    return (*out[:2], pred, *out[3:])


def half_left_out(out):
    """Every other row's answer left out (zeros), so that a batch of two
    requests already loses one."""
    def cut(t):
        t = t.clone()
        t[1::2] = 0
        return t
    return (*out[:2], *(cut(t) for t in out[2:]))


class Stale:
    """Hands back the previous call's answers (the first call's own)."""

    def __init__(self):
        self.last = None

    def __call__(self, out):
        prev, self.last = self.last, out
        if prev is None or prev[2].shape != out[2].shape:
            return out
        return prev


FAULTS = {"altered": lambda: altered, "half": lambda: half_left_out,
          "stale": Stale}


def _run(tmp_path, monkeypatch, kind, fault=None, trace=False, slow_s=0.0):
    """One run of the tiny cell; ``fault`` breaks the engine's detect,
    and each detect takes ``slow_s`` seconds more, as on a loaded CPU."""
    name, params = CELLS[kind]
    cell = tiny_cell(tmp_path, name, **params)
    if kind == "offline":
        offline_in_rounds(monkeypatch, cell)
    if fault is not None or slow_s:
        inner = CUDAEngine.detect_device
        broken = FAULTS[fault]() if fault is not None else (lambda out: out)

        def detect_device(self, x, with_feats=False):
            time.sleep(slow_s)
            return broken(inner(self, x, with_feats))

        monkeypatch.setattr(CUDAEngine, "detect_device", detect_device)
    return run.run_cell(cell, 2**31 + 17, 0.6, trace, CPU)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_sound_run_is_correct(tmp_path, monkeypatch, kind):
    res = _run(tmp_path, monkeypatch, kind)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e = {m["name"] for m in run.spec.cell(CELLS[kind][0]).end_to_end}
    assert set(res["metrics"]) == e2e
    assert all(np.isfinite(m["value"]) for m in res["metrics"].values())


@pytest.mark.parametrize("kind,fault", [(k, f) for k in sorted(CELLS) for f in sorted(FAULTS)
                                        if (k, f) != ("camera", "half")])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, kind, fault):
    """(A camera frame is a batch of one: it has no half to leave out.)"""
    res = _run(tmp_path, monkeypatch, kind, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct_on_a_slow_cpu(tmp_path, monkeypatch, fault):
    """A detect of 0.25 s: a 0.6 s window dispatches two or three rounds,
    before this seed's first kept round (round 3). The window sized in
    rounds still compares a kept round of every pool."""
    res = _run(tmp_path, monkeypatch, "offline", fault, slow_s=0.25)
    assert not res["correct"], res["checks"]
    cell = run.spec.cell(CELLS["offline"][0])
    rounds = cell.params["keep_every"] * cell.params["n_pools"]
    assert res["attempted"] >= rounds * CELLS["offline"][1]["batch"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_traced_run(tmp_path, monkeypatch, kind):
    res = _run(tmp_path, monkeypatch, kind, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_offline_keeps_answers_of_every_pool_and_buffer(tmp_path, monkeypatch):
    """At the cell's own n_pools, inflight and keep_every, the kept rounds
    cover every frame of every pool, through every result buffer."""
    cell = tiny_cell(tmp_path, "lyr3-std.offline", batch=4, shipped_per_pool=1)
    own = run.spec.cell("lyr3-std.offline").params
    for key in ("n_pools", "inflight", "keep_every"):
        assert cell.params[key] == own[key]
    drv = run.spec.driver("offline")
    job = drv.Offline(cell, 2**33 + 9, CPU)
    kept = []
    resolve = job._resolve

    def spy(item, keep):
        n = len(job.kept)
        resolve(item, keep)
        if len(job.kept) > n:
            kept.append((item[0] % job.n_pools, item[0] % job.inflight))
    monkeypatch.setattr(job, "_resolve", spy)
    while len(kept) < job.n_pools * job.inflight:
        job.window(0.05)
    assert {p for p, _ in kept} == set(range(job.n_pools))
    assert {b for _, b in kept} == set(range(job.inflight))
    answered = np.concatenate([a.frame for a in job.kept])
    assert set(answered) == set(range(len(job.frames)))


def test_offline_refuses_a_keep_rate_that_skips_pools(tmp_path):
    cell = tiny_cell(tmp_path, "lyr3-std.offline", batch=4, shipped_per_pool=1,
                     keep_every=2)
    with pytest.raises(ValueError, match="keep_every"):
        run.spec.driver("offline").Offline(cell, 1, CPU)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_run_that_keeps_no_answer_is_not_correct(tmp_path, monkeypatch, kind):
    """A window that keeps no answer (no kept round, no camera frame's
    answer) compares nothing, and a run that compared nothing is not
    correct, however sound the path."""
    name, params = CELLS[kind]
    cell = tiny_cell(tmp_path, name, **params)
    driver = run.spec.driver(cell.driver)
    cls = driver.Offline if kind == "offline" else driver.Camera
    inner = cls.window
    if kind == "offline":
        monkeypatch.setattr(cls, "window", lambda self, s, keep=True: inner(self, s, False))
    else:
        monkeypatch.setattr(cls, "window", lambda self, s, answers=None: inner(self, s))
    res = run.run_cell(cell, 2**31 + 17, 0.3, False, CPU)
    assert res["attempted"] > 0 and not res["correct"], res["checks"]
    assert {k: c["value"] for k, c in res["checks"].items()} == {
        "pred_gap": 1.0, "prob_err": 1.0, "box_miss": 1.0, "lost": 0.0}
