"""Statistics of one measured window.

A rate is the work completed inside the window over the whole window's
length. A latency percentile is taken over every request or frame due in
the window; one that failed, was refused or never came counts as
infinitely late, so it can push a percentile up but never pull it down.
"""

from __future__ import annotations

import math
from typing import Sequence

# what a percentile that lands on a missing request reports: JSON has no
# infinity, and a latency of 1e12 ms stands for "never"
MISSING_MS = 1e12


def rate(completed: float, window_s: float) -> float:
    """Work completed inside the window per second of the whole window."""
    if window_s <= 0:
        raise ValueError(f"window of {window_s} s")
    return completed / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``, in
    which ``math.inf`` stands for a missing answer; ``MISSING_MS`` where it
    lands on one."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    k = max(0, math.ceil(q / 100.0 * len(ordered)) - 1)
    v = ordered[k]
    return MISSING_MS if math.isinf(v) else float(v)
