"""The [yolo] head kernel's share of its roofline in the offline job on yolov7-640: its least ms a round (`lib/yolo7_counts.head_bound_ms`, YOLOv3's yardstick: a 32-byte sector of each of 25,200 boxes' objectness, the rest of the rows of the configuration's calibrated candidates a frame, the 300 answers written, at 3.35 TB/s) over the device ms a round of `yolo_head_kernel`; none where the program has no such kernel."""

from __future__ import annotations

from benchmarks.lib import yolo7_counts
from benchmarks.lib.trace import device_seconds

LAYER = "head"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "detect_fps"


def read(ctx):
    trace, rounds = ctx.get("trace"), ctx.get("trace_rounds")
    if not trace or not rounds:
        return None
    head_s = device_seconds(trace, lambda n: n == yolo7_counts.HEAD_KERNEL)
    if head_s <= 0:
        return None
    bound = yolo7_counts.head_bound_ms(ctx["config"]["layer_configs"],
                                       int(ctx["params"]["batch"]),
                                       int(ctx["config"]["max_det"]),
                                       yolo7_counts.candidates_per_frame(ctx["config"]))
    return bound / (head_s * 1e3 / rounds) * 100.0
