"""The comparison that decides ``correct``.

The program's answers (pred, conf, probs, bbox per frame) are held against
the plain reference's class probabilities and per-class CAM boxes of the
same frames (``reference/cnn.py``), by four numbers:

- ``pred_gap``: the widest gap by which the reference's probability of the
  class the program picked lies below the reference's best, over every
  answer (0 where the program picked the reference's best class; a near
  tie can read a little above 0 without a wrong answer);
- ``prob_err``: the largest absolute difference between the program's
  probabilities (and conf) and the reference's;
- ``box_miss``: the share of answers whose box differs from the
  reference's box for the class the program picked;
- ``lost``: answers that never came (a request with no response at all).

Each cell file gives each number its limit (``limits``); a run is correct
when every number is at most its limit. ``PERF.md`` gives the readings each
limit was set from.
"""

from __future__ import annotations

import sys

import numpy as np

NUMBERS = ("pred_gap", "prob_err", "box_miss", "lost")


def numbers(ref_probs: np.ndarray, ref_boxes: np.ndarray, frame: np.ndarray,
            pred: np.ndarray, conf: np.ndarray, probs: np.ndarray,
            bbox: np.ndarray, lost: int = 0) -> dict[str, float]:
    """The four numbers over n answers. ``ref_probs`` (U, K) and
    ``ref_boxes`` (U, K, 4) are the reference's per distinct frame;
    ``frame`` (n,) says which distinct frame each answer is for; ``pred``
    (n,), ``conf`` (n,), ``probs`` (n, K) and ``bbox`` (n, 4) are the
    program's answers."""
    frame = np.asarray(frame, np.int64)
    pred = np.asarray(pred, np.int64)
    n, k = len(frame), ref_probs.shape[1]
    if n == 0:
        return {"pred_gap": 0.0, "prob_err": 0.0, "box_miss": 0.0,
                "lost": float(lost)}
    valid = (pred >= 0) & (pred < k)
    safe = np.where(valid, pred, 0)
    rp = ref_probs[frame]  # (n, K)
    picked = rp[np.arange(n), safe]
    gap = np.where(valid, rp.max(axis=1) - picked, 1.0)
    err = np.maximum(np.abs(np.asarray(probs, np.float64) - rp).max(axis=1),
                     np.abs(np.asarray(conf, np.float64) - picked))
    err = np.where(valid, err, 1.0)
    want_box = ref_boxes[frame, safe]  # (n, 4)
    miss = ~valid | (np.asarray(bbox, np.int64) != want_box).any(axis=1)
    return {"pred_gap": float(np.nan_to_num(gap, nan=1.0).max()),
            "prob_err": float(np.nan_to_num(err, nan=1.0).max()),
            "box_miss": float(miss.mean()),
            "lost": float(lost)}


def control_answers(ref_probs: np.ndarray, ref_boxes: np.ndarray):
    """A control's own answers from its probabilities and boxes: the
    argmax class, its probability and its box -> (pred, conf, probs,
    bbox)."""
    pred = ref_probs.argmax(axis=1)
    rows = np.arange(len(pred))
    return pred, ref_probs[rows, pred], ref_probs, ref_boxes[rows, pred]


def judge(found: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Whether every number is within its limit, and the numbers beside
    their limits (the result line's ``checks``). A number with no limit
    fails: every number is compared."""
    checks = {name: {"value": found[name], "limit": limits.get(name)}
              for name in NUMBERS}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def print_checks(checks: dict) -> None:
    """The numbers compared beside their limits, one line each, on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
