"""Metrics/observability — the reference's console stats, structured: the
port's copy of ``tpu_cnn.utils.metrics``.

The reference reports per-class accuracy + confusion matrices
(``software/retrain_classifier.py:240-268``), feature statistics
(``dump_fpga_features.py:122-129``), and live per-stage timings. Here:
a JSONL metrics sink usable by every app, plus the shared report helpers.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np


class JsonlMetrics:
    """Append-only JSONL metrics log. One record per ``log`` call."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, name: str, value: Any, **tags: Any) -> None:
        if not self.path:
            return
        rec = {"ts": time.time(), "metric": name, "value": value, **tags}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def feature_stats(features: np.ndarray) -> dict:
    """Range/mean/nonzero/active-channel stats of a (N, C, S) uint8 dump."""
    ch_means = features.astype(np.float64).mean(axis=(0, 2))
    return {
        "min": int(features.min()),
        "max": int(features.max()),
        "mean": float(features.astype(np.float64).mean()),
        "nonzero_frac": float((features > 0).mean()),
        "active_channels": int((ch_means > 1.0).sum()),
        "num_channels": int(features.shape[1]),
    }


def accuracy_report(
    preds: np.ndarray, labels: np.ndarray, class_names: list[str] | None = None
) -> dict:
    """Overall + per-class accuracy and the confusion matrix."""
    uniq = np.unique(labels)
    names = class_names or [str(c) for c in range(int(labels.max()) + 1)]
    per_class = {
        names[c]: float((preds[labels == c] == c).mean()) for c in uniq
    }
    conf = np.zeros((len(uniq), len(uniq)), dtype=int)
    for i, t in enumerate(uniq):
        for j, p in enumerate(uniq):
            conf[i, j] = int(((labels == t) & (preds == p)).sum())
    return {
        "accuracy": float((preds == labels).mean()),
        "per_class": per_class,
        "confusion": conf.tolist(),
        "classes": [names[c] for c in uniq],
    }
