"""The generator: one seed, one draw; other seeds, other draws."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

from benchmarks.lib import spec, traffic

SEEDS = (0, 7, 2**31 + 5, 2**70 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_frames_repeat_for_a_seed(seed):
    a = traffic.frames(seed, "pools", 4, 32)
    assert a.dtype == np.uint8 and a.shape == (4, 32, 32)
    assert np.array_equal(a, traffic.frames(seed, "pools", 4, 32))


def test_frames_differ_across_seeds_and_streams():
    draws = [traffic.frames(s, "pools", 2, 32) for s in SEEDS]
    for i in range(len(draws)):
        for j in range(i):
            assert not np.array_equal(draws[i], draws[j])
    assert not np.array_equal(traffic.frames(1, "pools", 2, 32),
                              traffic.frames(1, "camera", 2, 32))


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_each_mix_draws_its_frames_from_the_seed(cell):
    c = spec.cell(cell)
    fn = spec.driver(c.driver).frames_of
    a, b = fn(c, 3), fn(c, 4)
    channels, size, _ = spec.frame_shape(c.config)
    frame = (size, size) if channels == 1 else (channels, size, size)
    assert a.shape == b.shape and a.shape[1:] == frame
    assert np.array_equal(a, fn(c, 3)) and not np.array_equal(a, b)


def test_shipped_frames_among_the_noise():
    cell = spec.cell("lyr3-std.offline")
    frames = spec.driver(cell.driver).frames_of(cell, 8)
    bundle = os.path.join(spec.ROOT, cell.config["bundle"])
    shipped = {np.fromfile(p, np.uint8).tobytes()
               for p in glob.glob(os.path.join(bundle, "test_image_*.bin"))}
    hits = sum(f.tobytes() in shipped for f in frames)
    assert hits == cell.params["n_pools"] * cell.params["shipped_per_pool"]
