"""A tiny configuration and its cells for the CPU tests: the registry's
``lyr3-tiny`` geometry (32x32 frames, 16-32-64 channels) with a seeded
bundle written to a temporary directory; and the offline job's window
sized in rounds, so that what a test compares does not hang on the CPU's
speed."""

from __future__ import annotations

import json
import os

import numpy as np

from benchmarks.lib import spec
from tpu_cnn_torch.utils.weights import encode_weights

LAYERS = [[1, 16, 32], [16, 32, 16], [32, 64, 8]]
SHIFTS = [4, 7, 8]


def write_bundle(d: str, seed: int = 0) -> None:
    """The tiny net's bundle, drawn from ``seed``, into the directory
    ``d``: weights, classifier, classes, shifts and four test frames."""
    rs = np.random.default_rng(seed)
    kernels = [rs.integers(-40, 41, size=(oc, ic, 3, 3)).astype(np.int8)
               for ic, oc, _ in LAYERS]
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "weights.bin"), "wb") as f:
        f.write(encode_weights(kernels))
    np.save(os.path.join(d, "fc_weight.npy"),
            (rs.standard_normal((6, 64 * 16)) * 0.5).astype(np.float32))
    np.save(os.path.join(d, "fc_bias.npy"), np.zeros(6, np.float32))
    with open(os.path.join(d, "classes.json"), "w") as f:
        json.dump([f"c{i}" for i in range(6)], f)
    for i in range(4):  # shipped test frames
        rs.integers(0, 256, size=(32, 32), dtype=np.uint8).tofile(
            os.path.join(d, f"test_image_{i}_class{i}.bin"))
    with open(os.path.join(d, "shifts.json"), "w") as f:
        json.dump(SHIFTS, f)


def tiny_config(tmp_path) -> dict:
    d = os.path.join(str(tmp_path), "bundle")
    write_bundle(d)
    base = spec.load_json(spec.config_path("lyr3-std"))
    return {**base, "name": "lyr3-tiny", "variant": "lyr3-tiny",
            "layer_configs": LAYERS, "shifts": SHIFTS, "img_size": 32,
            "bundle": d}


def tiny_cell(tmp_path, cell: str, **params) -> spec.Cell:
    """``cell`` of BENCHMARK.json on the tiny configuration, with
    ``params`` over its own."""
    c = spec.cell(cell)
    c.config = tiny_config(tmp_path)
    c.params.update(params)
    return c


def offline_in_rounds(monkeypatch, cell: spec.Cell) -> int:
    """Sizes every window of the offline job in rounds: a window goes on,
    a window of its seconds at a time, until it has dispatched
    ``keep_every`` x ``n_pools`` rounds or more, however slowly this CPU
    runs them. Rounds 0 to that number less one hold a kept round of
    every pool (``keep_every`` is prime to ``n_pools``), so a run always
    compares answers of every pool. Returns that number of rounds."""
    rounds = int(cell.params["keep_every"]) * int(cell.params["n_pools"])
    offline = spec.driver("offline")
    inner = offline.Offline.window

    def window(self, seconds, keep=True):
        total = inner(self, seconds, keep)
        while total["rounds"] < rounds:
            more = inner(self, seconds, keep)
            total = {k: total[k] + more[k] for k in total}
        return total

    monkeypatch.setattr(offline.Offline, "window", window)
    return rounds
