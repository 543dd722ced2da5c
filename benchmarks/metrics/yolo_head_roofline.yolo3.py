"""The [yolo] head kernel's share of its roofline in the offline job on yolov3-416: its least ms a round (`lib/yolo3_counts.head_bound_ms`: the bytes it must move at 3.35 TB/s, a sector of each box's objectness, the rest of the rows of the configuration's calibrated candidates a frame, the answers written) over the device ms a round of `yolo_head_kernel`; none where the program has no such kernel."""

from __future__ import annotations

from benchmarks.lib import yolo3_counts
from benchmarks.lib.trace import device_seconds

LAYER = "head"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "detect_fps"


def read(ctx):
    trace, rounds = ctx.get("trace"), ctx.get("trace_rounds")
    if not trace or not rounds:
        return None
    head_s = device_seconds(trace, lambda n: n == yolo3_counts.HEAD_KERNEL)
    if head_s <= 0:
        return None
    bound = yolo3_counts.head_bound_ms(ctx["config"]["layer_configs"],
                                       int(ctx["params"]["batch"]),
                                       int(ctx["config"]["max_det"]),
                                       yolo3_counts.candidates_per_frame(ctx["config"]))
    return bound / (head_s * 1e3 / rounds) * 100.0
