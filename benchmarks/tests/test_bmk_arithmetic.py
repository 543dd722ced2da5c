"""The frozen arithmetic and the window statistics."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmarks.lib import check, roofline, spec, stats
from benchmarks.reference import cnn


@pytest.mark.parametrize("name,macs", [("lyr3-std", 40_108_032),
                                       ("lyr4-wide", 235_929_600)])
def test_macs_per_frame(name, macs):
    config = spec.load_json(spec.config_path(name))
    assert roofline.macs_per_image(config["layer_configs"]) == macs
    assert config["macs_per_frame"] == macs


def test_bounds_at_batch_1536():
    l3 = spec.load_json(spec.config_path("lyr3-std"))["layer_configs"]
    ms, by = roofline.layers_bound(l3, 1536, roofline.feature_map_bytes(l3))
    assert by == "operations" and abs(ms - 0.06225) < 1e-4
    l4 = spec.load_json(spec.config_path("lyr4-wide"))["layer_configs"]
    ms, by = roofline.layers_bound(l4, 1536, roofline.feature_map_bytes(l4))
    assert by == "operations" and abs(ms - 0.3662) < 1e-3
    assert roofline.feature_map_bytes(l3) == 64 * 16 * 16


def test_rate_is_over_the_whole_window():
    assert stats.rate(1000, 10.0) == 100.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_failed_request_counts_as_late():
    # 100 requests: the 95th percentile is the 95th fastest
    assert stats.percentile([1.0] * 95 + [math.inf] * 5, 95) == 1.0
    assert stats.percentile([1.0] * 94 + [math.inf] * 6, 95) == stats.MISSING_MS
    # a failure never pulls a percentile down
    assert stats.percentile([5.0, 6.0, math.inf], 50) == 6.0
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.0


def _answers(k=6, n=5):
    rng = np.random.default_rng(0)
    p = rng.random((n, k))
    p /= p.sum(axis=1, keepdims=True)
    boxes = rng.integers(0, 128, (n, k, 4))
    return p, boxes


def test_numbers_catch_a_wrong_answer():
    probs, boxes = _answers()
    pred, conf, pr, bbox = cnn.control_answers(probs, boxes)
    frame = np.arange(len(pred))
    ok = cnn.numbers(probs, boxes, frame, pred, conf, pr, bbox)
    assert ok == {"pred_gap": 0.0, "prob_err": 0.0, "box_miss": 0.0, "lost": 0.0}
    limits = {"pred_gap": 1e-5, "prob_err": 1e-5, "box_miss": 0.0, "lost": 0}
    assert check.judge(ok, limits)[0]
    wrong = pred.copy()
    wrong[2] = (wrong[2] + 1) % 6
    bad = cnn.numbers(probs, boxes, frame, wrong, conf, pr, bbox)
    assert bad["pred_gap"] > 0 and bad["box_miss"] == 0.2
    assert not check.judge(bad, limits)[0]
    lost = cnn.numbers(probs, boxes, frame, pred, conf, pr, bbox, lost=1)
    assert not check.judge(lost, limits)[0]
    out_of_range = pred.copy()
    out_of_range[0] = 99
    assert cnn.numbers(probs, boxes, frame, out_of_range, conf, pr,
                         bbox)["prob_err"] == 1.0
    assert not check.judge(ok, {})[0], "a number with no limit fails"
    dropped = {k: v for k, v in ok.items() if k != "box_miss"}
    fine, checks = check.judge(dropped, limits)
    assert not fine, "a limit with no number fails"
    assert checks["box_miss"] == {"value": None, "limit": 0.0}
    assert list(checks) == list(cnn.NUMBERS[:2]) + ["lost", "box_miss"]
    assert not check.judge({}, {})[0], "nothing compared is not correct"
