"""The multi-object detection filters on host arrays: the JAX engine
module's ``presence_scores``, ``detections_above`` and
``instance_detections``, copied. ``engine.cuda`` and the deployable's
loader (``tpu_cnn_torch.deploy``) both use them; this module imports
nothing that builds a model."""

from __future__ import annotations

import numpy as np

from tpu_cnn_torch.ops import detect_head


# the multi-object filter's floor when neither the caller nor the bundle
# (multi_thresh.json) gives one
DEFAULT_MULTI_THRESH = 0.15


def presence_scores(res) -> np.ndarray:
    """The (B, K) presence matrix the multi-object filter thresholds: the
    presence head's sigmoid scores when the bundle ships one, else the
    softmax probabilities."""
    sc = getattr(res, "scores", None)
    return sc if sc is not None else res.probs


def detections_above(probs_row, boxes_row, threshold):
    """One image's multi-object detections: [(class_idx, prob, (x1, y1,
    x2, y2)), ...] for every class with prob >= its threshold (a scalar or
    a per-class vector), by descending probability."""
    thr = np.broadcast_to(np.asarray(threshold, np.float64),
                          (len(probs_row),))
    dets = [(int(k), float(probs_row[k]), tuple(int(v) for v in boxes_row[k]))
            for k in range(len(probs_row)) if probs_row[k] >= thr[k]]
    dets.sort(key=lambda d: -d[1])
    return dets


def instance_detections(probs_row, boxes_row, inst_boxes_row,
                        inst_counts_row, threshold,
                        min_pixels: int | None = None,
                        min_frac: float | None = None):
    """One image's multi-instance detections: for every class with prob >=
    its threshold, one detection per watershed component with at least
    ``min_pixels`` pixels and ``min_frac`` of the class's largest; the
    class box instead unless two or more survive. Sorted by descending
    probability, then instance size."""
    if min_pixels is None:
        min_pixels = detect_head.INSTANCE_MIN_PIXELS
    if min_frac is None:
        min_frac = detect_head.INSTANCE_MIN_FRAC
    thr = np.broadcast_to(np.asarray(threshold, np.float64),
                          (len(probs_row),))
    dets = []
    for k in range(len(probs_row)):
        if probs_row[k] < thr[k]:
            continue
        floor = max(min_pixels, 1,
                    int(np.ceil(min_frac * int(np.max(inst_counts_row[k])))))
        inst = [(int(k), float(probs_row[k]), tuple(int(v) for v in b), int(c))
                for b, c in zip(inst_boxes_row[k], inst_counts_row[k])
                if c >= floor]
        if len(inst) < 2:
            inst = [(int(k), float(probs_row[k]),
                     tuple(int(v) for v in boxes_row[k]), 0)]
        dets.extend(inst)
    dets.sort(key=lambda d: (-d[1], -d[3]))
    return [(k, p, b) for k, p, b, _ in dets]
