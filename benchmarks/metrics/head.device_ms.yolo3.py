"""Device ms a round of everything that is not the net's kernels in the offline job on yolov3-416: the [yolo] head's kernel and the results' copies to the host."""

from __future__ import annotations

from benchmarks.lib import yolo3_counts
from benchmarks.lib.trace import device_seconds

LAYER = "head"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "detect_fps"


def read(ctx):
    trace, rounds = ctx.get("trace"), ctx.get("trace_rounds")
    if not trace or not rounds or trace["busy_s"] <= 0:
        return None
    return device_seconds(trace, lambda n: n not in yolo3_counts.NET_KERNELS) * 1e3 / rounds
